"""Meshes and collectives: the port's plumbing for the JAX package's mesh
axes and ``jax.lax`` collectives, which GSPMD places implicitly and the port
places explicitly.

Meshes. ``MeshSpec`` is a shape-only mesh (axis names and sizes, as a JAX
mesh's ``axis_names`` and ``shape``): it needs no processes, so the specs of
the 16 x 16 and 2 x 16 x 16 production meshes can be computed on one CPU.
``DistMesh`` adds the processes: one group per axis, built by
``torch.distributed.device_mesh.init_device_mesh``, one group per set of
axes, this rank's coordinates and the device its tensors live on. The
global ranks are laid out row-major over the axis names, as
``jax.make_mesh`` lays out devices.

Transport rule. The caller picks the backend in ``init_process_group`` and
nothing switches it silently:

* an NCCL group takes device tensors: a collective runs on the card;
* a gloo group takes host copies: gloo reduces host tensors (its CUDA
  support is partial), so every collective copies its input to the host,
  runs there and copies the result back to the input's device. The maths
  stays on the card; only the exchange goes through the host.

A failed ``init_process_group`` raises. ``STATS`` counts the bytes each rank
hands to each kind of collective (a tensor's ``numel * element_size`` per
call; an all-gather hands in its shard and gets the group's size times as
much back), for the step's byte budget (``chip_smoke.py``, phase DT).

Autograd operators. A replicated value on the ``model`` axis follows
Megatron's convention: every rank of the group computes the same loss, so
``copy_to`` (identity forward, all-reduce backward) goes before a
column-sharded product and ``reduce_from`` (all-reduce forward, identity
backward) after a row-sharded one. ``all_reduce_sum`` (all-reduce both
ways) is the exact adjoint where each rank's loss is its own share of a
sum, as on the data axes. ``gather_shards`` (all-gather forward,
reduce-scatter backward) gathers an FSDP shard; ``gather_replicated``
(all-gather forward, own slice backward) and ``slice_replicated`` (own
slice forward, all-gather backward) move a leaf between sharded and
replicated under Megatron's convention. ``exchange`` is one P2P hop
(``dist.batch_isend_irecv``); the pipeline's backward sends its grads
back through the same hops."""
from __future__ import annotations

import datetime
import itertools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.utils import resolve_device

STATS: dict = {}


def reset_stats():
    STATS.clear()


def _count(kind: str, t: torch.Tensor):
    STATS[kind] = STATS.get(kind, 0) + t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# process group and meshes
# ---------------------------------------------------------------------------


def init_process_group(init_method: str, world_size: int, rank: int, backend: str = "nccl",
                       timeout_s: float = 600.0):
    """Join the job: ``backend`` "nccl" (the default: one card per rank,
    the card ``rank % device_count`` made current) or "gloo" (host
    transport, any device). ``init_method`` is an address the caller gives
    (``tcp://localhost:<port>`` or ``file://<path>``). Raises on any
    failure; nothing falls back to another backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs CUDA; pass backend='gloo' for the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


class MeshSpec:
    """Axis names and sizes, no processes (a JAX mesh's ``axis_names`` and
    ``shape``). Everything that only computes specs takes one."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} differ in rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class DistMesh(MeshSpec):
    """A mesh of processes over ``device_mesh`` (a torch ``DeviceMesh``),
    this rank's tensors on ``device``. ``group(axes)`` is the group of the
    ranks that differ only on ``axes`` (one name or several, in mesh
    order); ``coord(axes)`` this rank's index in it (row-major over
    ``axes``). A rank outside the mesh has ``member`` False."""

    def __init__(self, device_mesh, device):
        names = device_mesh.mesh_dim_names
        super().__init__(tuple(device_mesh.mesh.shape), names)
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        ranks = device_mesh.mesh.cpu().numpy()
        where = [tuple(i) for i in zip(*(ranks == dist.get_rank()).nonzero())]
        self.member = bool(where)
        self._coords = dict(zip(names, where[0])) if where else {}
        self._groups = {}
        # every set of two or more axes: one group per coset, made
        # by every rank in the same order (``dist.new_group`` is collective)
        for k in range(2, len(names) + 1):
            for sub in itertools.combinations(range(len(names)), k):
                rest = [i for i in range(len(names)) if i not in sub]
                moved = ranks.transpose(rest + list(sub)).reshape(
                    -1, math.prod(ranks.shape[i] for i in sub))
                for row in moved:
                    g = dist.new_group([int(r) for r in row])
                    if dist.get_rank() in row:
                        self._groups[tuple(names[i] for i in sub)] = g

    def coord(self, axes) -> int:
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + int(self._coords[a])
        return idx

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def group(self, axes):
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device=None) -> DistMesh:
    """The process mesh over the whole job (``init_device_mesh``; the world
    size must equal the mesh's size). Tensors live on ``device`` (CUDA
    unless the caller names another); the mesh's device type is the
    transport's: "cuda" over NCCL, "cpu" over gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call comm.init_process_group first")
    device = resolve_device(device)
    dtype = "cpu" if dist.get_backend() == "gloo" else "cuda"
    dm = init_device_mesh(dtype, tuple(shape), mesh_dim_names=tuple(axis_names))
    return DistMesh(dm, device)


def sub_mesh(ranks, axis_names: Sequence[str], device=None) -> DistMesh:
    """A mesh over some of the job's ranks (an array of global ranks, one
    dim per axis); every rank of the job calls it. A rank outside it gets a
    mesh with ``member`` False."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    dtype = "cpu" if dist.get_backend() == "gloo" else "cuda"
    dm = DeviceMesh(dtype, torch.as_tensor(ranks), mesh_dim_names=tuple(axis_names))
    return DistMesh(dm, device)


# ---------------------------------------------------------------------------
# collectives (functional: the input is never written)
# ---------------------------------------------------------------------------


def _host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of x where the group's transport takes it."""
    x = x.detach()
    if _host(group) and x.device.type != "cpu":
        return x.to("cpu").contiguous()
    return x.clone(memory_format=torch.contiguous_format)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x.detach().clone()
    w = _wire(x, group)
    _count("all_reduce", w)
    dist.all_reduce(w, op=_OPS[op], group=group)
    return w.to(x.device)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    w = _wire(x, group)
    _count("all_gather", w)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim).to(x.device)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the group, then this rank's 1/n of ``dim``. NCCL runs
    ``reduce_scatter_tensor``; gloo (whose reduce-scatter older versions
    lack) an all-reduce and a slice."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    r = dist.get_rank(group)
    if _host(group):
        size = x.shape[dim] // n
        return all_reduce(x, group).narrow(dim, r * size, size).contiguous()
    w = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((w.shape[0] // n,) + w.shape[1:], dtype=w.dtype, device=w.device)
    _count("reduce_scatter", w)
    dist.reduce_scatter_tensor(out, w, group=group)
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x from the group's rank ``src`` on every rank (x gives the shape and
    dtype elsewhere)."""
    if dist.get_world_size(group) == 1:
        return x.detach().clone()
    w = _wire(x, group)
    _count("broadcast", w)
    dist.broadcast(w, src=dist.get_global_rank(group, src), group=group)
    return w.to(x.device)


def exchange(send: Optional[torch.Tensor], to: Optional[int], recv_like: Optional[torch.Tensor],
             frm: Optional[int], group) -> Optional[torch.Tensor]:
    """One P2P hop inside ``group``: send ``send`` to group rank ``to`` and
    receive a tensor shaped like ``recv_like`` from group rank ``frm``
    (either may be None), in one ``batch_isend_irecv``."""
    ops, out, buf = [], None, None
    if send is not None:
        w = _wire(send, group)
        _count("p2p", w)
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, to), group))
    if recv_like is not None:
        buf = torch.empty_like(_wire(recv_like, group))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if buf is not None:
        out = buf.to(recv_like.device)
    return out


# ---------------------------------------------------------------------------
# autograd operators
# ---------------------------------------------------------------------------


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.group).contiguous(), None, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def copy_to(x, group):
    """Identity forward, all-reduce backward (Megatron's f)."""
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce forward, identity backward (Megatron's g)."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def all_reduce_sum(x, group):
    """All-reduce forward and backward: the adjoint when each rank's loss is
    its share of a sum."""
    return x if _trivial(group) else _AllReduceSum.apply(x, group)


def gather_shards(x, dim: int, group):
    """All-gather forward, reduce-scatter (sum) backward: an FSDP shard."""
    return x if _trivial(group) else _GatherShards.apply(x, dim, group)


def gather_replicated(x, dim: int, group):
    """All-gather forward, this rank's slice of the grad backward: a
    sharded leaf used whole where every rank computes the same thing."""
    return x if _trivial(group) else _GatherReplicated.apply(x, dim, group)


def slice_replicated(x, dim: int, group):
    """This rank's slice forward, all-gather of the slices' grads backward:
    a replicated leaf used sliced (an FFN bias, the per-head ``T_hat``)."""
    return x if _trivial(group) else _SliceReplicated.apply(x, dim, group)
