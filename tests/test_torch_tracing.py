"""The program's stage spans (``utils/profiling.py``'s `span`), on the CPU
at a TINY geometry of the flagship and the video model.

- Under ``torch.profiler.profile(activities=[CPU])``, `Model.forward`
  records one ``cmpc.forward`` and `Trainer.step` one ``cmpc.step``, with
  the stages inside it in call order, each inside its parent's interval
  and none overlapping the next.  The names are the contract that
  ``utils/profile_forward.py`` and PERF.md read.
- Without a profiler, `span` returns the one shared no-op context and a
  call builds no ``record_function``.
- `utils.profile_forward.stage_rows` on synthetic intervals: each device
  operation under the innermost span around its launch call (a second
  thread's launches inside ``cmpc.backward`` too), outside every span, or
  unlinked; a stage's own device and idle time.  `stage_kernels` on
  hand-made profile events: each stage's device time and operations by
  name.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmpc_refseg_torch.api import build_model, build_trainer
from cmpc_refseg_torch.utils import profiling
from cmpc_refseg_torch.utils.profile_forward import (profiled_stages,
                                                    stage_kernels,
                                                    stage_rows)

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, res4_blocks=2,
            batch_size=2)
MODELS = {"image": ("CMPC_model", {}),
          "video": ("CMPC_video_mm_tgraph_allvec",
                    dict(num_frames=8, sampled_frames=(0, 2, 4, 6, 7)))}
FORWARD = ("cmpc.backbone", "cmpc.text", "cmpc.head", "cmpc.fusion",
           "cmpc.decode")
STAGES = {"forward": ("cmpc.forward", ("cmpc.feed",) + FORWARD),
          "step": ("cmpc.step", ("cmpc.feed",) + FORWARD
                   + ("cmpc.loss", "cmpc.backward", "cmpc.update"))}


def _call(model, kind):
    """(the built forward or step, a seeded batch for it)."""
    name, extra = MODELS[model]
    build = build_trainer if kind == "step" else build_model
    program = build(name, device="cpu", **TINY, **extra)
    cfg = program.cfg
    rng = np.random.default_rng(0)
    b = cfg.batch_size
    words = np.zeros((b, cfg.num_steps), np.int32)
    words[:, :3] = rng.integers(3, cfg.vocab_size, (b, 3))
    lead = (b, cfg.num_frames) if cfg.video else (b,)
    image = rng.integers(0, 256, (*lead, cfg.H, cfg.W, 3), dtype=np.uint8)
    key = "clip" if cfg.video else "im"
    batch = {"words": words, "seq_len": np.full((b,), 3, np.int32)}
    if kind == "step":
        batch.update({f"{key}_u8": image, "target_u8": (
            rng.random((b, cfg.H, cfg.W, 1)) > 0.7).astype(np.uint8)})
        return program.step, batch
    batch[key] = image.astype(np.float32) - 100.0
    return program.forward, batch


@pytest.mark.parametrize("kind", sorted(STAGES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_spans_nest_in_call_order(model, kind):
    call, batch = _call(model, kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(batch)
    spans = sorted(((ev.name, ev.time_range.start, ev.time_range.end)
                    for ev in prof.events() if ev.name.startswith("cmpc.")),
                   key=lambda s: s[1])
    root, stages = STAGES[kind]
    assert [s for s in spans if s[0] == root] == spans[:1], spans
    _, start, end = spans[0]
    children = spans[1:]
    assert tuple(n for n, _, _ in children) == stages
    for (name, s, e), (_, s_next, _) in zip(children,
                                            children[1:] + [(None, end,
                                                             None)]):
        assert start <= s <= e <= end, name
        assert e <= s_next, name
    rows = profiled_stages(prof, 1)
    assert sorted(rows) == sorted((root,) + stages)
    assert all(r[0] == 1 and r[1] > 0 and r[3] == 0 for r in rows.values())


def test_span_is_off_without_a_profiler(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("cmpc.a") is profiling.span("cmpc.b") \
        is profiling._OFF
    built = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: built.append(name))
    call, batch = _call("image", "forward")
    out = call(batch)
    assert built == [] and out.sigm.shape == (2, 32, 32, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.span("cmpc.on")
    assert built == ["cmpc.on"]


def test_stage_rows_by_hand():
    spans = [("cmpc.step", 0.0, 100.0), ("cmpc.feed", 0.0, 10.0),
             ("cmpc.backward", 50.0, 90.0)]
    # launches: the feed's copy, the backward's first kernel from the main
    # thread and its second from the autograd engine's, Adam in the step's
    # own time, the caller's readback outside every span
    launch_at = {1: 1.0, 2: 55.0, 3: 60.0, 4: 95.0, 5: 120.0}
    ops = [(3, 70.0, 80.0), (1, 5.0, 8.0), (2, 56.0, 70.0), (4, 96.0, 99.0),
           (5, 121.0, 125.0), (9, 130.0, 131.0)]
    rows = stage_rows(spans, launch_at, ops, 2)
    # [spans, host ms, device ms, ops, idle ms] per call; busy [5, 8],
    # [56, 80], [96, 99], [121, 125], [130, 131] (us)
    want = {"cmpc.step": [0.5, 0.05, 0.0015, 0.5, (40 + 6 + 1) / 2e3],
            "cmpc.feed": [0.5, 0.005, 0.0015, 0.5, 7 / 2e3],
            "cmpc.backward": [0.5, 0.02, 0.012, 1.0, 16 / 2e3],
            "outside": [0, 0.0, 0.002, 0.5, (21 + 5) / 2e3],
            "unlinked": [0, 0.0, 0.0005, 0.5, 0.0]}
    assert sorted(rows) == sorted(want)
    for name, row in want.items():
        assert rows[name] == pytest.approx(row), name


def test_stage_kernels_by_hand():
    """`stage_kernels` on a profile's events: spans, launch calls and
    device operations linked by correlation ID, each operation's time
    under the innermost span around its launch, per call, by name."""
    def ev(name, start, end, cid=0, device="DeviceType.CPU"):
        return SimpleNamespace(name=name, id=cid, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))
    cuda = "DeviceType.CUDA"
    events = [ev("cmpc.step", 0, 100), ev("cmpc.backward", 50, 90),
              ev("cudaLaunchKernel", 10, 11, 1),
              ev("cudaLaunchKernel", 60, 61, 2),
              ev("cudaLaunchKernel", 70, 71, 3),
              ev("gemm_bf16", 12, 20, 1, cuda), ev("gemm_bf16", 62, 66, 2,
                                                   cuda),
              ev("add", 72, 80, 3, cuda), ev("copy", 120, 124, 9, cuda)]
    got = stage_kernels(SimpleNamespace(events=lambda: events), 2)
    # [device ms, operations] per call
    assert got == {"cmpc.step": {"gemm_bf16": [0.004, 0.5]},
                   "cmpc.backward": {"gemm_bf16": [0.002, 0.5],
                                     "add": [0.004, 0.5]},
                   "unlinked": {"copy": [0.002, 0.5]}}
