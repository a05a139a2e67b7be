"""The system under test, cmpc_refseg_torch, as the benchmark drives it: the
only module of the benchmark that imports the program.

`InferProgram`: `api.Model.forward` on a batch, its masks' probabilities
copied to the host.  `TrainProgram`: `api.Trainer.step` on a uint8 host
batch, its loss read back.  The program gets the benchmark's raw
parameters and prepares them itself (`prepare_params`,
`train_state_from_params`).
"""

from __future__ import annotations


def port_config(conf: dict, mix: dict):
    """The program's ModelConfig of a configuration file at the mix's
    batch; every dimension the file's 'model' states must be the
    config's."""
    from cmpc_refseg_torch.config import get_config
    cfg = get_config(conf["registry"], batch_size=mix["batch"],
                     **conf["overrides"])
    for key, want in conf["model"].items():
        got = getattr(cfg, key)
        if (list(got) if isinstance(got, tuple) else got) != want:
            raise ValueError(f"{conf['name']}: {key} is {got!r} in the "
                             f"program's config, {want!r} in the file")
    return cfg


class InferProgram:
    def __init__(self, cfg, params, device):
        from cmpc_refseg_torch import api
        from cmpc_refseg_torch.models.model import (init_model_state,
                                                    prepare_params)
        self.model = api.Model(cfg, prepare_params(params, cfg),
                               init_model_state(cfg, device=device), device)

    def __call__(self, batch):
        """The batch's sigm [B, H, W] f32 on the host."""
        return self.model.forward(batch).sigm[..., 0].cpu()


class TrainProgram:
    def __init__(self, cfg, params, device):
        from cmpc_refseg_torch import api
        from cmpc_refseg_torch.models.model import init_model_state
        from cmpc_refseg_torch.train.trainer import train_state_from_params
        self.trainer = api.Trainer(cfg, train_state_from_params(
            params, cfg, init_model_state(cfg, device=device)))

    def __call__(self, batch):
        """One update; the step's total loss as a float."""
        return float(self.trainer.step(batch)["loss_total"])

    def leaves(self):
        """(path, tensor) of the trainable tree."""
        from cmpc_refseg_torch.train.optimizer import named_leaves
        return list(named_leaves(self.trainer.state.trainable))

    def first_moment(self, leaf):
        return self.trainer.state.optimizer.state[leaf]["exp_avg"]


def launch_counts() -> dict:
    """The program's own count of each kernel wrapper's launches."""
    from cmpc_refseg_torch.ops import kernels
    return kernels.launch_counts()
