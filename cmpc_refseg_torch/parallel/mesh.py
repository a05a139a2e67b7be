"""Process groups, the (data x model) rank layout, and the collectives of
data-parallel and tensor-parallel training.

The counterpart of the JAX package's parallel/mesh.py (:55-163).  JAX runs
one global-batch program over a device mesh and lets GSPMD insert the
gradient all-reduce; the port runs one process per device (torchrun's
layout), each on its rows of the global batch, and reduces by hand: the
gradients once per update in one flat buffer, the logged metrics, the
ASPP decoder's BN batch moments (differentiable, so the backward is the
global batch's), the evaluation sums and the preemption flag.  The
port's kernels are per rank, so JAX's data_parallel_dispatch has no
counterpart.

Every collective here runs on the default process group but for the
host-side agreement (`host_group`) and the layout's groups; `shard_batch`
may split over another group.  Where none is initialized the helpers are
the single-process identity.

The layout (`make_mesh`): the world's d * m ranks as a (data, model)
grid, rank r at data index r // m and model index r % m, the order in
which the JAX package reshapes its devices (:76-88).  The m ranks of one
data index (its model group) read the same rows; the d ranks of one model
index (its data group) split the batch.  Tensor parallelism shards storage
only: `tp_shardings` says which trainable leaves are stored split over the
model group (JAX's `tp_leaf_rule`, :128-163), and the train step gathers
them whole before its forward, so every kernel runs on full weights, as
GSPMD gathers the weights into the JAX package's custom calls.  The
optimizer state is ZeRO-sharded over the whole world
(``train/optimizer.py::ZeroAdam``).
"""

from __future__ import annotations

import dataclasses
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
    dimension) split over `group` (the default group when None; a `Mesh`'s
    data group), in rank order: rank r of R takes rows [r * b, (r + 1) * b)
    of b = B / R, the rows the JAX package's
    make_array_from_process_local_data gives process r.  Raises in a
    process outside `group`."""
    if isinstance(group, Mesh):
        group = group.data
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


def check_replicated(tensors, what: str = "weights", group=None) -> None:
    """Raise on every rank unless `tensors` are bit-equal on all ranks of
    `group` (the default group when None): the copy of the group's first
    rank is broadcast and compared, and the verdict agreed over the world
    (`agree_any`), so every rank of the world calls this, each with its
    own group."""
    if process_count() == 1:
        return
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(ref, src=src, group=group)
    if agree_any(not torch.equal(flat, ref)):
        raise RuntimeError(f"the ranks' {what} differ: every rank must "
                           "start from the same seed or checkpoint")


# ---------------------------------------------------------------------------
# the (data x model) layout
# ---------------------------------------------------------------------------

_LAYOUTS = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data x model) layout of the world.

    `shape` (d, m); `data`: the group of the d ranks of this rank's model
    index, which split a batch; `model`: the group of the m ranks of this
    rank's data index, which hold the same rows and split the engaged
    leaves' storage (None when m is 1).  The groups are None without a
    process group."""
    shape: tuple
    data: object = None
    model: object = None

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def world_size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        return process_index()

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size


def make_mesh(shape=None) -> Mesh:
    """The layout of the default group's W ranks as `shape` (d, m), d * m
    = W (a 1-D shape (W,), or None, is data-only: (W, 1)).  Collective:
    every rank calls it, and every rank makes every group, in one order
    (data groups by model index, then model groups by data index), as
    ``dist.new_group`` requires.  The layout becomes the world's, which
    `data_group` reads.  Without a process group, the layout of one."""
    world = process_count()
    shape = tuple(shape) if shape is not None else (world,)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"layout {shape} for a world of {world} processes")
    d, m = shape
    if not dist.is_initialized():
        return Mesh((1, 1))
    r = dist.get_rank()
    if m == 1:
        mesh = Mesh(shape, data=dist.group.WORLD)
    else:
        data = [dist.new_group([i * m + j for i in range(d)])
                for j in range(m)]
        model = [dist.new_group(list(range(i * m, (i + 1) * m)))
                 for i in range(d)]
        mesh = Mesh(shape, data=data[r % m], model=model[r // m])
    _LAYOUTS.clear()
    _LAYOUTS[dist.group.WORLD] = mesh
    return mesh


def data_group(group):
    """The group over which rows split and per-row sums reduce: a `Mesh`'s
    data group, or `group` itself.  Under a layout whose model axis is
    wider than 1, a group with two ranks of one data index raises (the
    world, say): its m ranks of a data slot hold the same rows, so a sum
    over it would count each row m times."""
    if isinstance(group, Mesh):
        return group.data
    layout = _LAYOUTS.get(dist.group.WORLD) if dist.is_initialized() \
        else None
    if layout is not None and layout.model_size > 1:
        slots = [r // layout.model_size
                 for r in dist.get_process_group_ranks(group)]
        if len(set(slots)) != len(slots):
            raise ValueError(
                f"a group of ranks {dist.get_process_group_ranks(group)} "
                f"under a {layout.shape} layout holds rows twice: pass the "
                "layout (or its data group)")
    return group


def tp_leaf_dim(path, shape, model_size: int, min_dim: int = 512):
    """The dim of a trainable leaf that tensor parallelism splits over the
    model axis, or None (the leaf is stored whole): the dim holding the
    JAX package's last one (its output channels), where it is at least
    `min_dim` wide and divides by `model_size` (`tp_leaf_rule`).  The
    port keeps the head's HWIO / [in, out] layout, so that is the last
    dim, but a backbone kernel 'w' (trainable under conv5) is OIHW here:
    dim 0."""
    if not len(shape):
        return None
    dim = 0 if path[0] == "backbone" and path[-1] == "w" else len(shape) - 1
    if shape[dim] >= min_dim and shape[dim] % model_size == 0:
        return dim
    return None


def tp_shardings(tree, mesh: Mesh, *, min_dim: int = 512):
    """`tree` (leaves with a .shape) mapped to each leaf's `tp_leaf_dim`
    under `mesh`'s model axis: the same structure, an int or None at each
    leaf."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, prefix + (i,)) for i, v in enumerate(node)]
        return tp_leaf_dim(prefix, tuple(node.shape), mesh.model_size,
                           min_dim)
    return walk(tree, ())


def reduce_scatter_mean(flat: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's segment of the mean of `flat` over `group`'s R ranks:
    `flat` (1-D, its length a multiple of R) cut into R segments in rank
    order, segment r summed over the ranks onto rank r, then / R."""
    count = dist.get_world_size(group)
    out = flat.new_empty(flat.numel() // count)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out.div_(count)


def all_gather_flat(segment: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' 1-D `segment`s of `group` concatenated in rank order."""
    out = segment.new_empty(segment.numel() * dist.get_world_size(group))
    dist.all_gather_into_tensor(out, segment.contiguous(), group=group)
    return out


def gather_flat(segment: torch.Tensor) -> Optional[torch.Tensor]:
    """The world's 1-D `segment`s concatenated in rank order on rank 0
    only (a gather: the other ranks hold nothing more); None there."""
    count = dist.get_world_size()
    if dist.get_rank() != 0:
        dist.gather(segment.contiguous(), dst=0)
        return None
    out = segment.new_empty(segment.numel() * count)
    dist.gather(segment.contiguous(), list(out.chunk(count)), dst=0)
    return out


def gather_shards(shards, dims, mesh: Mesh) -> list:
    """The full tensors of `shards`, each the rank's contiguous slice
    along its dim in `dims`, gathered over `mesh`'s model group in one
    collective and joined in model-rank order."""
    shards = list(shards)
    if not shards:
        return []
    pieces = all_gather_flat(torch.cat([s.detach().reshape(-1)
                                        for s in shards]), mesh.model)
    pieces = pieces.view(mesh.model_size, -1)
    out, offset = [], 0
    for s, dim in zip(shards, dims):
        n = s.numel()
        out.append(torch.cat([p.view_as(s) for p in
                              pieces[:, offset:offset + n]], dim=dim))
        offset += n
    return out
