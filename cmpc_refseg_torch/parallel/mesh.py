"""Process groups and the collectives of data-parallel training.

The counterpart of the JAX package's parallel/mesh.py (:55-124).  JAX runs
one global-batch program over a device mesh and lets GSPMD insert the
gradient all-reduce; the port runs one process per device (torchrun's
layout), each on its rows of the global batch, and reduces by hand: the
gradients once per update in one flat buffer, the logged metrics, the
ASPP decoder's BN batch moments (differentiable, so the backward is the
global batch's), the evaluation sums and the preemption flag.  The
port's kernels are per rank, so JAX's data_parallel_dispatch has no
counterpart.

Every collective here runs on the default process group but for the
host-side agreement (`host_group`); `shard_batch` may split over another
group.  Where none is initialized the helpers are the single-process
identity.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cmpc_refseg_torch.convert import resolve_device


def local_device(device=None) -> torch.device:
    """This rank's device: `device` (CUDA when None, raising without it),
    `cuda:LOCAL_RANK` where it names no index, made current on CUDA."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device=None) -> torch.device:
    """Join the process group; call once, before any device use.  The
    arguments default to torchrun's environment (`env://`, RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), whose absence
    raises.  `device` as `local_device`; 'cpu' runs there.  The backend
    is NCCL on CUDA and gloo on the CPU unless `backend` says otherwise:
    `backend="gloo"` lets several ranks share one card, which NCCL
    refuses.  A backend that fails to initialise raises.  Returns the
    rank's device."""
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize_distributed: {', '.join(missing)} not set; "
                "launch with torchrun (torchrun --nproc_per_node N ...) or "
                "pass init_method, world_size and rank")
        init_method = "env://"
    device = local_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, **kw)
    return device


def distributed() -> bool:
    """True in a process group (of any size): the train step then reduces
    its gradients and metrics over it."""
    return dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_process() -> bool:
    """True on the process that logs and writes checkpoints (rank 0)."""
    return process_index() == 0


def local_batch_size(global_batch: int, group=None) -> int:
    """Each rank's rows of a global batch split over `group` (the default
    group when None); raises where they do not divide evenly."""
    count = dist.get_world_size(group) if dist.is_initialized() else 1
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{count} processes")
    return global_batch // count


def shard_batch(batch: dict, group=None) -> dict:
    """This rank's rows of a global batch (every array's leading
    dimension) split over `group` (the default group when None), in rank
    order: rank r of R takes rows [r * b, (r + 1) * b) of b = B / R, the
    rows the JAX package's make_array_from_process_local_data gives
    process r.  Raises in a process outside `group`."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch arrays disagree on their rows: {rows}")
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    if rank < 0:
        raise ValueError("shard_batch: this process is not in the group")
    local = local_batch_size(rows.pop(), group)
    start = rank * local
    return {k: v[start:start + local] for k, v in batch.items()}


def all_reduce_mean_(tensors) -> None:
    """Replace each of `tensors` (one dtype, one device) by its mean over
    the ranks, in place, through one flat buffer: one collective."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(process_count())
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the sum of the ranks'
    gradients, so each rank gets the global loss's gradient of its input."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x):
    """The differentiable sum of `x` over the ranks."""
    return _AllReduceSum.apply(x)


_HOST_GROUPS = {}


def host_group():
    """A gloo group of the default group's ranks for agreements made on
    the host: the default group where it is gloo, else one made at the
    first call after each init (every rank makes that call at the same
    point, as `train_loop` does).  A CPU tensor reduced over it does not
    wait on the CUDA stream, as an NCCL reduction read by .item() would."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _HOST_GROUPS:
        _HOST_GROUPS.clear()
        _HOST_GROUPS[world] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[world]


def agree_any(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (one max all-reduce
    on the host, `host_group`): how the ranks agree to stop at one
    iteration."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def check_replicated(tensors, what: str = "weights") -> None:
    """Raise on every rank unless `tensors` are bit-equal on all ranks:
    rank 0's flat copy is broadcast and compared, and the verdict agreed
    (`agree_any`)."""
    if process_count() == 1:
        return
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    if agree_any(not torch.equal(flat, ref)):
        raise RuntimeError(f"the ranks' {what} differ: every rank must "
                           "start from the same seed or checkpoint")
