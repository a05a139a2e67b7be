"""The ranks of tests/test_torch_parallel.py and tests/test_torch_tp.py:
spawned processes that import torch and the port only (the JAX
references run in the test's process).

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

    def __init__(self, cfg, victim, at, seed=None):
        from cmpc_refseg_torch.parallel.mesh import process_index
        self.cfg, self.reads = cfg, 0
        self.rng = np.random.default_rng(
            5 + (process_index() if seed is None else seed))
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


def _numpy(tensors, paths):
    return {p: t.detach().cpu().numpy().copy() for p, t in zip(paths, tensors)}


def _tp_record(state, paths, reduced):
    """The layout's state as one process would hold it (collective; rank
    0 gets it and returns it): weights, Adam's moments and count,
    and the update's reduced gradient by path; and this rank's own
    storage: its stored leaves, the segment's and the moments' sizes."""
    from cmpc_refseg_torch.train.optimizer import named_leaves
    zero = state.zero
    whole = zero.consolidate()
    adam = state.optimizer.state.get(zero.master, {})
    # the entries of this rank's segment past the flat vector's end
    pad = slice(max(0, zero.numel - zero.mesh.rank * zero.segment), None)
    out = {"stored": {p: t.detach().numpy().copy()
                      for p, t in named_leaves(state.trainable)},
           "segment": zero.master.numel(),
           "pad": [t.detach()[pad].abs().sum().item()
                   for t in (zero.master, *zero.moments()[:2])],
           "moment_sizes": [adam[k].numel() for k in ("exp_avg",
                                                      "exp_avg_sq")
                            if k in adam],
           "model_state": _leaves(state.model_state), "step": state.step}
    if whole is not None:
        weights, mu, nu, count = whole
        out.update(leaves=_numpy(weights, paths), exp_avg=_numpy(mu, paths),
                   exp_avg_sq=_numpy(nu, paths), adam_step=count,
                   grad=None if reduced is None else _numpy(
                       state.zero.unflatten(reduced), paths))
    return out


def tp_train(name, geo, batches, start=None, shape=(2, 2), min_dim=16,
             restore=None, save=None, report_start=False):
    """Steps of config `name` on a (data x model) layout of the world
    (`shape`), each rank on its data slot's rows of the global `batches`,
    from seed 0 or a JAX snapshot `start` laid out by
    `shard_train_state`, or restored from the checkpoint directory
    `restore`.  Per step (after the state at the start, with
    `report_start`): `_tp_record`, with the mean gradient the update took
    (None at a micro-step that updates nothing), the metrics, and the
    ranks of this rank's data and model groups.  With `save`, the state
    after the steps is checkpointed there (rank 0 writes)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.parallel.mesh import (all_gather_flat, make_mesh,
                                                 shard_batch)
    from cmpc_refseg_torch.train.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import (make_train_step,
                                                 shard_train_state)
    cfg = get_config(name, **geo)
    mesh = make_mesh(shape)
    state = shard_train_state(_state(cfg, start), mesh, min_dim=min_dim)
    if restore is not None:
        restore_checkpoint(restore, state)
    paths = [p for p, _ in named_leaves(state.trainable)]
    segments = []
    state.optimizer.register_step_pre_hook(
        lambda *_: segments.append(state.zero.master.grad.clone()))
    step = make_train_step(cfg)
    groups = {"data": dist.get_process_group_ranks(mesh.data),
              "model": dist.get_process_group_ranks(mesh.model)
              if mesh.model is not None else [mesh.rank]}
    out = [_tp_record(state, paths, None)] if report_start else []
    for batch in batches:
        done = len(segments)
        metrics = step(state, shard_batch(batch, mesh))
        reduced = all_gather_flat(segments[-1]) \
            if len(segments) > done else None
        out.append({**_tp_record(state, paths, reduced), "groups": groups,
                    "metrics": {k: float(v) for k, v in metrics.items()}})
    if save is not None:
        save_checkpoint(save, state, state.step)
    return out


def tp_loop(name, geo, max_iter, checkpoint_dir, shape=(2, 2), min_dim=16):
    """`train_loop` of a state laid out on `shape` from seed 0, the ranks
    of a data slot reading the same rows (a reader seeded by the data
    index), a snapshot at `max_iter`: `_tp_record` of the state after."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.parallel.mesh import make_mesh
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import (create_train_state,
                                                 shard_train_state,
                                                 train_loop)
    cfg = get_config(name, **geo)
    mesh = make_mesh(shape)
    state = shard_train_state(create_train_state(0, cfg, device="cpu"),
                              mesh, min_dim=min_dim)
    reader = _SignalReader(cfg, victim=-1, at=0, seed=mesh.data_index)
    state = train_loop(cfg, reader, max_iter=max_iter, state=state,
                       log_every=1000, snapshot_every=max_iter,
                       checkpoint_dir=checkpoint_dir)
    return _tp_record(state, [p for p, _ in named_leaves(state.trainable)],
                      None)


def tp_evaluate(name, geo, batches, shape=(2, 2)):
    """`evaluate_sharded` of seed-0 weights over the world of a layout
    (which must raise) and over its data group: ('raised', results)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models.model import init_model, init_model_state
    from cmpc_refseg_torch.parallel.mesh import make_mesh
    from cmpc_refseg_torch.train.evaluator import evaluate_sharded
    cfg = get_config(name, **geo)
    mesh = make_mesh(shape)
    params = init_model(0, cfg, device="cpu")
    model_state = init_model_state(cfg, device="cpu")
    try:
        evaluate_sharded(cfg, params, model_state, iter(batches),
                         mesh=dist.group.WORLD, device="cpu")
        raised = None
    except ValueError as e:
        raised = str(e)
    return raised, evaluate_sharded(cfg, params, model_state, iter(batches),
                                    mesh=mesh, device="cpu")


COMMANDS = {"train": train, "evaluate": evaluate, "preempt": preempt,
            "cli": cli, "tp_train": tp_train, "tp_loop": tp_loop,
            "tp_evaluate": tp_evaluate}


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
