"""The ranks of tests/test_torch_parallel.py: spawned processes that import
torch and the port only (the JAX references run in the test's process).

`serve` joins a gloo group through a file:// rendezvous and runs the
commands it is sent (`COMMANDS`), putting (rank, result) on the result
queue, or (rank, ('error', traceback)) where one raised.  The `cli`
command leaves that group and runs the port's command line as torchrun
would start the rank (its environment set), then joins a new group."""

import os
import signal
import traceback

import numpy as np
import torch


def _leaves(tree):
    from cmpc_refseg_torch.train.optimizer import named_leaves
    return {p: leaf.detach().numpy().copy() for p, leaf in named_leaves(tree)}


def _state(cfg, start):
    from cmpc_refseg_torch.convert import train_state_from_jax
    from cmpc_refseg_torch.train.trainer import create_train_state
    if start is None:
        return create_train_state(0, cfg, device="cpu")
    return train_state_from_jax(start["trainable"], start["frozen"],
                                start["mu"], start["nu"], start["count"],
                                cfg, model_state=start.get("model_state"),
                                device="cpu")


def train(name, geo, batches, start=None):
    """DP steps of config `name` over the global `batches` (each rank
    steps on its rows), from seed 0 or a JAX snapshot `start`.  Per step:
    the metrics, the trainable leaves, Adam's first moments and the BN
    moving statistics."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.parallel.mesh import shard_batch
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import make_train_step
    cfg = get_config(name, **geo)
    state = _state(cfg, start)
    step = make_train_step(cfg)
    out = []
    for batch in batches:
        metrics = step(state, shard_batch(batch))
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "leaves": _leaves(state.trainable),
            "exp_avg": {p: state.optimizer.state[leaf]["exp_avg"].numpy().copy()
                        for p, leaf in named_leaves(state.trainable)
                        if leaf in state.optimizer.state},
            "model_state": _leaves(state.model_state),
            "step": state.step})
    return out


def evaluate(name, geo, batches, own_group=False):
    """`evaluate_sharded` of seed-0 weights over the group, or with
    `own_group` over a group of this rank alone (each rank makes one
    group per rank, as new_group requires)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models.model import init_model, init_model_state
    from cmpc_refseg_torch.train.evaluator import evaluate_sharded
    cfg = get_config(name, **geo)
    mesh = dist.group.WORLD
    if own_group:
        groups = [dist.new_group([r]) for r in range(dist.get_world_size())]
        mesh = groups[dist.get_rank()]
    return evaluate_sharded(cfg, init_model(0, cfg, device="cpu"),
                            init_model_state(cfg, device="cpu"),
                            iter(batches), mesh=mesh, device="cpu")


class _SignalReader:
    """Seeded collated batches; on rank `victim` the `at`-th read sends
    this process SIGTERM, as a scheduler preempting one rank would."""

    def __init__(self, cfg, victim, at):
        from cmpc_refseg_torch.parallel.mesh import process_index
        self.cfg, self.reads = cfg, 0
        self.rng = np.random.default_rng(5 + process_index())
        self.kill = process_index() == victim
        self.at = at

    def read_collated(self, bs):
        self.reads += 1
        if self.kill and self.reads == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        cfg, rng = self.cfg, self.rng
        text = np.zeros((bs, cfg.num_steps), np.int64)
        text[:, :3] = rng.integers(3, cfg.vocab_size, (bs, 3))
        return {"im_batch": rng.integers(0, 256, (bs, cfg.H, cfg.W, 3),
                                         dtype=np.uint8),
                "mask_batch": rng.random((bs, cfg.H, cfg.W)) > 0.6,
                "text_batch": text, "seq_length": np.full((bs,), 3)}


def preempt(name, geo, max_iter, victim, at):
    """`train_loop` where rank `victim` is sent SIGTERM during its
    `at`-th read: (steps done, reads)."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.train.trainer import train_loop
    cfg = get_config(name, **geo)
    reader = _SignalReader(cfg, victim, at)
    state = train_loop(cfg, reader, max_iter=max_iter, device="cpu",
                       log_every=1000)
    return state.step, reader.reads


def cli(argvs, port, init_file):
    """This rank's `cli.main(argvs[rank])` under torchrun's environment
    variables (every rank on the CPU, LOCAL_RANK 0), between leaving the
    serving group and joining a new one through `init_file`: the steps
    the run ended at."""
    import torch.distributed as dist

    from cmpc_refseg_torch import cli as tcli
    from cmpc_refseg_torch.parallel.mesh import (initialize_distributed,
                                                 process_count,
                                                 process_index)
    rank, world = process_index(), process_count()
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        return tcli.main(argvs[rank]).step
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        initialize_distributed(f"file://{init_file}", world, rank,
                               device="cpu")


COMMANDS = {"train": train, "evaluate": evaluate, "preempt": preempt,
            "cli": cli}


def gpu_step(rank, init_file, geo, batch, results):
    """One DP step of the flagship at `geo` on cuda:0, 2 ranks over gloo,
    this rank's half of `batch`: (rank, {'loss', 'grad', 'weights'}), the
    global loss, the all-reduced gradient and the weights after the step
    flattened (float64), or (rank, traceback)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.parallel.mesh import (initialize_distributed,
                                                 shard_batch)
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import (create_train_state,
                                                 make_train_step)
    try:
        dev = initialize_distributed(f"file://{init_file}", 2, rank,
                                     backend="gloo", device="cuda")
        cfg = get_config("CMPC_model", **geo)
        state = create_train_state(0, cfg, device=dev)
        metrics = make_train_step(cfg)(state, shard_batch(batch))
        leaves = [p for _, p in named_leaves(state.trainable)]

        def flat(ts):
            return torch.cat([t.detach().reshape(-1) for t in ts]).double(
                ).cpu().numpy()
        out = {"loss": float(metrics["loss_total"]),
               "grad": flat(p.grad for p in leaves), "weights": flat(leaves)}
        dist.destroy_process_group()
    except Exception:
        out = traceback.format_exc()
    results.put((rank, out))


def serve(rank, world, init_file, commands, results):
    """Join the group, then run commands until None arrives."""
    import torch.distributed as dist

    from cmpc_refseg_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(2)
    initialize_distributed(f"file://{init_file}", world, rank, device="cpu")
    try:
        while True:
            cmd = commands.get()
            if cmd is None:
                break
            name, kw = cmd
            try:
                out = COMMANDS[name](**kw)
            except Exception:
                out = ("error", traceback.format_exc())
            results.put((rank, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
