"""A cell's step lowered for one rank: what ``launch.steps.lower_cell``
returns, the port's counterpart of the JAX package's
``lower_cell(...).compile()``.

The port has no compiler to ask, so a cell is lowered by running one rank's
real step once on the ``meta`` device (shapes and dtypes, no storage) over a
``comm.RankMesh`` of that rank, under counters. It is the step the card
runs; only the device and the mesh differ:

* flops: each executed op's by ``torch.utils.flop_counter``'s formulas
  (matrix products, convolutions, attention; an elementwise op counts 0);
  K1 and K2 count their own work (``stlt_scan.work``,
  ``relevance_flash.work``, registered here as their ops' formulas);
* bytes accessed: each executed op's operands plus its results (in eager
  torch every op reads and writes device memory, so this is the port's own
  count); a view or an allocation counts 0, K1 and K2 their work's bytes;
* collectives: ``comm``'s counters (``STATS``, ``CALLS``,
  ``RESULT_BYTES``), which count a shape-only collective as the transports
  count a real one;
* launches: each dispatch of K1's and K2's ops (the wrappers' own
  counters count launches on the card only);
* live memory: the storages alive on the rank's device (a view shares its
  storage, so it adds nothing), their peak over the step. It is an upper
  bound of the card's: under a dispatch mode autograd treats every tensor
  as a subclass, so it sums a grad's two paths out of place (the card sums
  in place) and takes the out-of-place branch of the backward formulas that
  have one (a logits-sized buffer more at stlt-base's DT1 peak).

K1's and K2's counts read values that a shape-only run does not have (the
snapshot's valid lengths, the node and key masks), so on ``meta`` they
count the most a call can take: every row's snapshot at N, every node and
key live (``SHAPE_ONLY_BOUNDS``). The MoE's slot table is sized at the
capacity (``tensor_parallel.apply_moe_ep``).
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.distributed import comm
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import relevance_flash, stlt_scan

SHAPE_ONLY_BOUNDS = ("K1 counts every row's carry snapshot at N and K2 every node and key "
                     "live (their shape-only upper bounds); a MoE's slot table holds the "
                     "capacity")
# comm's kinds under the JAX dry-run's names
JAX_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter", "p2p": "collective-permute",
             "broadcast": "collective-broadcast"}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")


def _k1_work(x_shape, pre_shape) -> tuple:
    (BH, N, d), (_, S, C) = x_shape, pre_shape
    prods, decay, nbytes = stlt_scan.work(BH, N, d, C, S)
    return prods + decay, nbytes


def _k2_work(x_shape, lm_shape, causal: bool) -> tuple:
    (BH, N, dh), S = x_shape, lm_shape[-1]
    score, pv, nbytes = relevance_flash.work(BH, N, S, dh, causal)
    return score + pv, nbytes


@register_flop_formula(torch.ops.repro_torch.stlt_scan)
def _k1_flops(gate, x, m, a, b, pre, *_, out_shape=None, **__) -> int:
    return int(_k1_work(x, pre)[0])


@register_flop_formula(torch.ops.repro_torch.relevance_flash)
def _k2_flops(x, v, log_mag, theta, mk, km, causal, *_, out_shape=None, **__) -> int:
    return int(_k2_work(x, log_mag, causal)[0])


KERNEL_BYTES = {
    torch.ops.repro_torch.stlt_scan: lambda gate, x, m, a, b, pre, *_: _k1_work(
        x.shape, pre.shape)[1],
    torch.ops.repro_torch.relevance_flash: lambda x, v, lm, th, mk, km, causal: _k2_work(
        x.shape, lm.shape, causal)[1]}
KERNELS = {torch.ops.repro_torch.stlt_scan: "stlt_scan",
           torch.ops.repro_torch.relevance_flash: "relevance_flash"}
_ALLOCS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
           torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors}.values())


def _key(x):
    """A hashable key of an op's arguments' metadata: a tensor's shape,
    strides, dtype and device; a scalar with its type."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return (type(x), x)


_FRESH: dict = {}


def _fresh(func) -> bool:
    """Whether ``func`` returns new tensors only (no view, nothing written):
    its outputs' shapes, strides and dtypes are then a function of its
    arguments' metadata."""
    if func not in _FRESH:
        sch = func._schema
        _FRESH[func] = (not func.is_view and not sch.is_mutable and bool(sch.returns)
                        and all(str(r.type) == "Tensor" for r in sch.returns))
    return _FRESH[func]


def _aliases(outs, ins) -> bool:
    mine = {t.untyped_storage()._cdata for t in ins}
    return any(t.untyped_storage()._cdata in mine for t in outs)


class _Counter(TorchDispatchMode):
    """Counts the flops and bytes of every op dispatched under it, the
    dispatches of K1's and K2's ops (``launches``), and the live bytes of
    the storages on ``meta`` (each held from the op that made it until it
    is freed) and their peak. An op on ``meta`` that returns new tensors
    is run once per metadata key: a repeat (a loop's body) gets fresh
    tensors of the remembered shapes, strides and dtypes, with the
    remembered counts (elsewhere, values are data)."""

    def __init__(self):
        super().__init__()
        self.flops, self.bytes, self.launches = 0, 0, dict.fromkeys(KERNELS.values(), 0)
        self.live, self.now, self.peak, self.memo = {}, 0, 0, {}

    def hold(self, t: torch.Tensor):
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key):
        self.now -= self.live.pop(key, 0)

    def _run(self, func, args, kwargs):
        """(out, flops, bytes) of one call of ``func``."""
        out = func(*args, **kwargs)
        packet, outs = func._overloadpacket, _tensors(out)
        flops = (flop_registry[packet](*args, **kwargs, out_val=out) if packet in flop_registry
                 else 0)
        if packet in KERNEL_BYTES:
            nbytes = KERNEL_BYTES[packet](*args, **kwargs)
        elif func.is_view or packet in _ALLOCS:
            nbytes = 0
        else:
            nbytes = sum(_nbytes(t) for t in _tensors([args, kwargs]) + outs)
        return out, flops, nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket in KERNELS:
            self.launches[KERNELS[func._overloadpacket]] += 1
        key = None
        if _fresh(func):
            key = (func, _key(args), _key(kwargs))
            try:
                hash(key)
            except TypeError:
                key = None
        if key is not None and key in self.memo:
            metas, seq, flops, nbytes = self.memo[key]
            outs = [torch.empty_strided(sz, st, dtype=dt, device=dev) for sz, st, dt, dev in metas]
            out = seq(outs) if seq else outs[0]
        else:
            out, flops, nbytes = self._run(func, args, kwargs)
            outs, ins = _tensors(out), _tensors([args, kwargs])
            if key is not None and _aliases(outs, ins):
                _FRESH[func], key = False, None   # a view its schema does not declare
            if key is not None and all(t.device.type == "meta" for t in ins + outs):
                self.memo[key] = ([(t.shape, t.stride(), t.dtype, t.device) for t in outs],
                                  type(out) if isinstance(out, (list, tuple)) else None,
                                  flops, nbytes)
        self.flops += flops
        self.bytes += nbytes
        for t in outs:
            self.hold(t)
        return out


@dataclasses.dataclass
class MemoryAnalysis:
    """Bytes on the rank's device, under the JAX package's names: the
    arguments, the outputs, the peak of the live bytes over the step less
    the arguments (``temp``), the donated arguments the outputs replace
    (``alias``), and the peak itself."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    peak_memory_in_bytes: int
    generated_code_size_in_bytes: int = 0


class Compiled:
    """What one shape-only run of a rank's step counted: ``memory_analysis()``,
    ``cost_analysis()`` (``flops``, ``bytes accessed``) and
    ``collectives()`` under the JAX dry-run's names; ``handed_in`` and
    ``calls`` (``comm.STATS`` and ``comm.CALLS`` of the run, by comm's
    kinds), ``launches`` (each kernel's op dispatches) and ``seconds``."""

    def __init__(self, memory: MemoryAnalysis, flops: int, nbytes: int, handed_in: dict,
                 calls: dict, result_bytes: dict, launches: dict, seconds: float):
        self._memory, self._cost = memory, {"flops": float(flops), "bytes accessed": float(nbytes)}
        self.handed_in, self.calls, self.result_bytes = handed_in, calls, result_bytes
        self.launches, self.seconds = launches, seconds

    def memory_analysis(self) -> MemoryAnalysis:
        return self._memory

    def cost_analysis(self) -> dict:
        return dict(self._cost)

    def collectives(self) -> dict:
        """{JAX's kind: {bytes (the result's, per device), count,
        handed_in_bytes}}, ``total_bytes`` and ``handed_in_bytes`` over
        them."""
        out = {k: {"bytes": 0, "count": 0, "handed_in_bytes": 0} for k in COLLECTIVES}
        for kind, name in JAX_KINDS.items():
            out[name] = {"bytes": self.result_bytes.get(kind, 0),
                         "count": self.calls.get(kind, 0),
                         "handed_in_bytes": self.handed_in.get(kind, 0)}
        out["total_bytes"] = sum(v["bytes"] for v in out.values())
        out["handed_in_bytes"] = sum(self.handed_in.values())
        return out


def _local_args(prog, mesh) -> tuple:
    """The rank's arguments: its shards of the stand-ins under the specs (a
    train step's optimizer state from ``opt_init``, its step 0)."""
    shards = [sh.local_slices(a, s, mesh) for a, s in zip(prog.args, prog.in_shardings)]
    if prog.kind == "train":
        shards[1], shards[3] = prog.opt_init(shards[0]), 0
    return tuple(shards)


class Lowered:
    """A cell's program on one rank of a ``comm.RankMesh`` (on ``meta``);
    ``compile()`` runs it once under the counters."""

    def __init__(self, prog, mesh: comm.RankMesh):
        if not isinstance(mesh, comm.RankMesh):
            raise ValueError(f"a cell lowers on a comm.RankMesh, not {mesh!r}")
        self.prog, self.mesh = prog, mesh

    def compile(self) -> Compiled:
        """Run the rank's step once; ``comm``'s counters are as they were
        before when this returns."""
        prog = self.prog
        saved = [dict(d) for d in (comm.STATS, comm.CALLS, comm.RESULT_BYTES)]
        t0 = time.time()
        args = _local_args(prog, self.mesh)
        counter = _Counter()
        for t in _tensors(args):
            counter.hold(t)
        arg_bytes = counter.now
        donated = _storage_bytes([t for i in prog.donate_argnums for t in _tensors(args[i])])
        comm.reset_stats()
        try:
            with counter:
                out = prog.fn(*args)
            handed_in, calls, results = dict(comm.STATS), dict(comm.CALLS), dict(comm.RESULT_BYTES)
        finally:
            for d, old in zip((comm.STATS, comm.CALLS, comm.RESULT_BYTES), saved):
                d.clear()
                d.update(old)
        memory = MemoryAnalysis(arg_bytes, _storage_bytes(_tensors(out)),
                                counter.peak - arg_bytes, donated, counter.peak)
        return Compiled(memory, counter.flops, counter.bytes, handed_in, calls, results,
                        dict(counter.launches), time.time() - t0)
