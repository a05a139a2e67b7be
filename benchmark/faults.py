"""Faults planted under the timed path, for the checks' calibration
(`calibrate.py`) and their test: each wraps a built program and must make
`correct` come out false.

  half     the call sees the first half of the batch's rows only: a
           train step's loss is the mean over the rest; an infer call
           answers the second half with the first half's masks.
  alter    an answer altered where it is produced: sample 0's mask
           probabilities become 1 - p.
  frozen   a train step that leaves its state unchanged: the weights are
           put back after every update.
"""

from __future__ import annotations

import torch


def _rows(batch, n):
    return {k: v[:n] for k, v in batch.items()}


class _Wrap:
    def __init__(self, program):
        self.program = program

    def leaves(self):
        return self.program.leaves()

    def first_moment(self, leaf):
        return self.program.first_moment(leaf)


class Half(_Wrap):
    def __call__(self, batch):
        n = len(batch["words"])
        out = self.program(_rows(batch, n // 2))
        if isinstance(out, float):
            return out
        return torch.cat([out, out])[:n]


class Alter(_Wrap):
    def __call__(self, batch):
        out = self.program(batch)
        if isinstance(out, float):
            return out
        out = out.clone()
        out[0] = 1.0 - out[0]
        return out


class Frozen(_Wrap):
    def __call__(self, batch):
        saved = [t.detach().clone() for _, t in self.leaves()]
        loss = self.program(batch)
        with torch.no_grad():
            for (_, t), s in zip(self.leaves(), saved):
                t.copy_(s)
        return loss


FAULTS = {"half": Half, "alter": Alter, "frozen": Frozen}

# the faults each kind of cell can have
CELL_FAULTS = {"infer": ("half", "alter"), "train": ("half", "frozen")}
