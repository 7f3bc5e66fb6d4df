"""Sharded serving: the slot pool laid over a 1-D ``("data",)`` serve mesh,
the port of the JAX package's ``serving/multihost.py``.

Layout (H hosts x K slots each; global slot g = h*K + local):

    decode pool   [ host0: rows 0..K-1 | host1: rows K..2K-1 | ... ]
    prefill pool  [ the same layout, a second slot-shaped pool          ]
    params        replicated

Host-local pieces stay host-local, as in a multi-host deployment:

* **Admission queues**: arrivals are dealt to the least-loaded host's queue
  (queued + live + pending, read before the tick's admission; the lowest
  host id wins ties); each host admits from its own queue into its own
  rows only.
* **Scheduler bookkeeping**: one :class:`Scheduler` per host over its K
  rows; per-request stats carry the ``host`` that served them.
* **Prefix cache**: a :class:`ReplicatedPrefixCache`, one cache per shard;
  warmed (pinned) entries replicate to every shard, per-request boundary
  snapshots go to the owning host's shard only.

Every tick runs at most ONE ``[H*K, chunk]`` masked prefill dispatch and
ONE ``[H*K]`` decode step (or one ``[H*K, k+1]`` verify): the function the
JAX package's ``shard_map`` of the same row-independent dispatches
computes, each host's K rows a contiguous range. The lone-pending
``[1, chunk]`` shortcut is off, so the trace stays two-shape (``[H*K,
chunk]`` and ``warm_prefix``'s ``[1, chunk]``). Slot splicing goes by
global id: host h's rows are the range h*K .. h*K + K - 1, so the id is
its owner's row.

Two forms serve the same function. The one-process form (a ``ServeMesh``)
puts every host on ONE device (the CPU, or one GPU): its hosts' row ranges
are ranges of one pool on that device, and the engine is one process, as
the JAX engine is. The process form (a ``comm.DistMesh`` with a
``("data",)`` axis: ``make_serve_mesh(H, processes=True)`` in a job of H
ranks) is the JAX engine's SPMD program as a pod runs it, one process per
host: rank h is host h and keeps, on its own device, its ``_Host`` queue
and Scheduler, its K-row pools (``[K, chunk]`` prefill, ``[K]`` decode or
``[K, k+1]`` verify dispatches) and its prefix-cache shard (a
``PrefixCache``; each rank warms the shared prompt into its own). Every rank gets the same
requests and arrivals, and what the one-process engine decides for all
hosts at once is decided on every rank from the same inputs: one all-gather
of four integers a tick (each host's tick advance, queued, live and
pending rows) feeds the least-loaded route, the idle fast-forward, the
global tick and the end of the run, and the SLO ladder's queue depth.
``slo_gap_ms`` reads each rank's own wall clock, so the process form
refuses it (ROADMAP Queue 1 item 7). A spec draft and ``AdaptiveK`` are
per row, so each rank's rows decide alone. At the end the ranks all-gather
the streams and per-request stats.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.serving.engine import ServeEngine, _Host, _ServeRun
from repro_torch.serving.prefix_cache import PrefixCache, ReplicatedPrefixCache
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A 1-D serve mesh: one device per host on its ``"data"`` axis."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}


ROADMAP_SLO_GAP = ("ROADMAP Queue 1 item 7: the SLO ladder's wall-gap trigger in the "
                   "process form")


def make_serve_mesh(n_hosts: int, device=None, processes: bool = False):
    """The serving mesh: 1-D ``("data",)`` over ``n_hosts`` hosts. With
    ``processes`` the process form, a ``comm.DistMesh`` of one rank per host
    on ``device`` in a job of ``n_hosts`` ranks (no process group, or a job
    of another size, raises); otherwise the one-process ``ServeMesh``, every
    host on ``device`` (CUDA unless the caller names another)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1 (got {n_hosts})")
    if not processes:
        return ServeMesh(devices=(resolve_device(device),) * n_hosts)
    if not dist.is_initialized():
        raise RuntimeError(f"the process form of a {n_hosts}-host serve mesh needs a "
                           f"job of {n_hosts} ranks (comm.init_process_group, torchrun)")
    if dist.get_world_size() != n_hosts:
        raise ValueError(f"a serve mesh of {n_hosts} hosts in a job of "
                         f"{dist.get_world_size()} ranks: one rank per host")
    return comm.make_mesh((n_hosts,), ("data",), device)


class ShardedServeEngine(ServeEngine):
    """Slot-level continuous batching with the slot pool sharded over a
    ``("data",)`` mesh: per-host admission queues and Schedulers feed
    per-host row ranges of the single batched prefill/decode dispatches.

    Construction fixes the fleet (``n_hosts x slots_per_host`` slots), so
    ``serve`` takes no ``slots``/``mode``/``coalesce``: admission is always
    the coalesced two-shape path. Greedy streams equal the single-host
    engine's on the same requests; sampled requests draw from the same
    per-request streams (``sampler.GumbelStreams``)."""

    # the sharded trace stays [B, chunk] plus warm_prefix's [1, chunk]
    _fast_single_prefill = False

    def __init__(self, params, cfg: ModelConfig, *, mesh: Optional[ServeMesh] = None,
                 n_hosts: Optional[int] = None, slots_per_host: int = 4,
                 max_len: int = 4096, temperature: float = 0.0,
                 eos_id: int = -1, top_k: int = 0, prefill_chunk: int = 256,
                 prefix_cache: Optional[ReplicatedPrefixCache] = None,
                 spec_k: int = 0, spec_draft: str = "ngram",
                 spec_draft_nodes: int = 4, spec_adaptive: bool = False,
                 spec_accept_floor: float = 0.4, spec_adapt_window: int = 8,
                 spec_adapt_recovery: int = 4,
                 serve_nodes: Optional[int] = None, slo_gap_ms: float = 0.0,
                 slo_queue_depth: int = 0, slo_degrade=(),
                 slo_recovery_ticks: int = 8, noise=None, device=None):
        """``mesh`` (``make_serve_mesh``; else one of ``n_hosts`` hosts, 1
        when None, on ``device``) fixes the hosts; every other argument is
        ``ServeEngine``'s."""
        if prefill_chunk < 1:
            raise ValueError(
                "ShardedServeEngine admits through the chunked two-shape "
                f"path only: prefill_chunk must be >= 1 (got {prefill_chunk})")
        if slots_per_host < 1:
            raise ValueError(f"slots_per_host must be >= 1 (got {slots_per_host})")
        if isinstance(prefix_cache, PrefixCache) and not isinstance(mesh, comm.DistMesh):
            raise TypeError(
                "ShardedServeEngine routes cache traffic per shard: pass a "
                "ReplicatedPrefixCache (or None), not a bare PrefixCache")
        if mesh is None:
            mesh = make_serve_mesh(n_hosts if n_hosts is not None else 1, device)
        self.group = None   # the process form's "data" group
        if isinstance(mesh, comm.DistMesh):
            if tuple(mesh.axis_names) != ("data",):
                raise ValueError(f"a serve mesh has one axis, 'data' (got {mesh.axis_names})")
            if slo_gap_ms > 0:
                raise NotImplementedError(
                    "slo_gap_ms reads each rank's own wall clock, which would split the "
                    f"ranks' tick sequences: the process form refuses it ({ROADMAP_SLO_GAP})")
            if isinstance(prefix_cache, ReplicatedPrefixCache):
                raise TypeError("a rank of the process form keeps its own shard: pass a "
                                "PrefixCache (or None), not a ReplicatedPrefixCache")
            self.group = mesh.group("data")
            mesh_device = mesh.device
        else:
            devices = {torch.device(d) for d in mesh.devices}
            if len(devices) > 1:
                raise NotImplementedError(
                    f"a one-process serve mesh over {len(devices)} distinct devices: "
                    "every host of it sits on one device; serve distinct devices with "
                    "one process per host (make_serve_mesh(..., processes=True) in a job)")
            mesh_device, = devices
        if device is not None and torch.device(device) != mesh_device:
            raise ValueError(f"device {device} differs from the mesh's {mesh_device}")
        super().__init__(params, cfg, max_len=max_len, temperature=temperature,
                         eos_id=eos_id, top_k=top_k, prefill_chunk=prefill_chunk,
                         prefix_cache=prefix_cache, serve_nodes=serve_nodes,
                         spec_k=spec_k, spec_draft=spec_draft,
                         spec_draft_nodes=spec_draft_nodes,
                         spec_adaptive=spec_adaptive,
                         spec_accept_floor=spec_accept_floor,
                         spec_adapt_window=spec_adapt_window,
                         spec_adapt_recovery=spec_adapt_recovery,
                         slo_gap_ms=slo_gap_ms, slo_queue_depth=slo_queue_depth,
                         slo_degrade=slo_degrade,
                         slo_recovery_ticks=slo_recovery_ticks, noise=noise,
                         device=mesh_device)
        self.mesh = mesh
        self.n_hosts = int(mesh.shape["data"])
        self.slots_per_host = slots_per_host
        self.n_slots = self.n_hosts * slots_per_host
        self.host = mesh.coord("data") if self.group is not None else None
        if self.group is None and prefix_cache is not None \
                and prefix_cache.n_shards != self.n_hosts:
            raise ValueError(f"prefix cache has {prefix_cache.n_shards} shards for "
                             f"{self.n_hosts} hosts")

    # -------------------------------------------- dispatch-op overrides
    # The tick body is ServeEngine's, slot splices and per-row node caps
    # included: host h's rows are the contiguous range h*K .. h*K + K - 1
    # of the one pool, so a global slot id is its owner's row, and every
    # target decode and verify dispatch takes a [H*K] caps row. The sharded engine
    # swaps in per-shard cache routing and least-loaded arrival routing.

    def _ops_lookup(self, prompt, h: int):
        if self.group is not None:       # the process form: the rank's own shard
            return super()._ops_lookup(prompt, h)
        if self.prefix_cache is None:
            return 0, None, None
        entry = self.prefix_cache.lookup(prompt, shard=h)
        if entry is None:
            return 0, None, None
        return entry.n_tokens, entry.state, entry.logits

    def _ops_cache_insert(self, prompt, n, state, logits, h: int):
        if self.group is not None:
            return super()._ops_cache_insert(prompt, n, state, logits, h)
        if self.prefix_cache is not None and n > 0:
            self.prefix_cache.insert(prompt[:n], state, logits, shard=h)

    def _route_arrivals(self, run: _ServeRun):
        """Deal every arrived request to the least-loaded host's queue
        (queued + live + pending; the lowest host id wins ties)."""
        while run.queue and run.queue[0][0] <= run.tick:
            load = [len(h.queue) + int(h.sched.live.sum()) + int(h.sched.pending.sum())
                    for h in run.hosts]
            self._enqueue(run, int(np.argmin(load)), *run.queue.pop(0))

    # -------------------------------------------------------------- serve
    @torch.no_grad()
    def serve(self, requests: list, arrivals=None, rng_seed: int = 0,
              return_stats: bool = False, prompt_len: Optional[int] = None):
        """Serve a request list across the sharded slot pool. Returns
        ``{request_id: tokens}`` (plus per-request stats, each with the
        ``host`` that served it, when ``return_stats``). Each tick: route
        arrivals, admit per host into its own rows, at most one
        ``[n_slots, chunk]`` masked prefill dispatch, one ``[n_slots]``
        decode step (or, with ``spec_k``, one draft-verify round). In the
        process form every rank of the mesh calls it with the same
        requests and arrivals and gets every host's streams and stats;
        each rank's ``serve_stats`` count its own dispatches."""
        if self.group is not None:
            return self._serve_ranks(requests, arrivals, rng_seed, return_stats, prompt_len)
        hosts = [_Host(self.slots_per_host) for _ in range(self.n_hosts)]
        return self._serve_ticks(hosts, requests, prompt_len, arrivals, rng_seed,
                                 return_stats, self.prefill_chunk, coalesce=True)

    def _serve_ranks(self, requests, arrivals, rng_seed, return_stats, prompt_len):
        """The process form's tick loop: this rank's host runs the tick body
        on its K rows; ``loads`` [H, 3] (each host's queued, live and
        pending rows at the tick's start) comes from the tick's one
        all-gather, taken after the decode phase with each host's advance
        flag (a live or pending row after admission: the tick counts)."""
        run = self._serve_start([_Host(self.slots_per_host)], requests, prompt_len, arrivals,
                                rng_seed, self.prefill_chunk, coalesce=True)
        loads = np.zeros((self.n_hosts, 3), np.int64)
        ticks = 0
        while run.queue or loads.any():
            tick_was = run.tick
            if not loads.any() and run.queue[0][0] > run.tick:
                run.tick = run.queue[0][0]  # idle everywhere: fast-forward
                self._cache_tick(run.tick - tick_was)
                tick_was = run.tick
            self._route_ranks(run, loads.sum(1))
            self._tick_admission(run)
            advance = run.any_live() or run.any_pending()
            self._tick_decode(run)
            host = run.host
            mine = torch.tensor([int(advance), len(host.queue), int(host.sched.live.sum()),
                                 int(host.sched.pending.sum())], device=self.device)
            every = comm.all_gather(mine[None], 0, self.group).cpu().numpy()
            ticks += 1
            run.tick = tick_was + int(every[:, 0].any())
            loads = every[:, 1:]
            if self.slo_degrade:
                self._slo_update(run.hosts, None, qdepth=int(loads[:, 0].sum()))
            self._cache_tick(run.tick - tick_was)
        self.serve_stats["exchanges"] = ticks
        out, stats = self._serve_finish(run, True)
        for st in stats.values():
            st["host"] = self.host
        parts = [None] * self.n_hosts
        dist.all_gather_object(parts, (out, stats), group=self.group)
        out = {rid: toks for o, _ in parts for rid, toks in o.items()}
        stats = {rid: st for _, s in parts for rid, st in s.items()}
        return (out, stats) if return_stats else out

    def _route_ranks(self, run: _ServeRun, load: np.ndarray):
        """The one-process engine's least-loaded route on every rank from the
        same loads: each arrived request goes to the least-loaded host (the
        lowest id on ties) and adds to its load; this rank queues its own."""
        while run.queue and run.queue[0][0] <= run.tick:
            h = int(np.argmin(load))
            load[h] += 1
            arrival, req = run.queue.pop(0)
            if h == self.host:
                self._enqueue(run, 0, arrival, req)
