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

A mesh is a list of devices, one per host. In this port every host of a
mesh sits on ONE device (the CPU, or one GPU): its hosts' row ranges are
ranges of one pool on that device, and the engine is one process, as the
JAX engine is. A mesh over distinct devices is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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


def make_serve_mesh(n_hosts: int, device=None) -> ServeMesh:
    """The serving mesh: 1-D ``("data",)`` over ``n_hosts`` hosts, every one
    on ``device`` (CUDA unless the caller names another)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1 (got {n_hosts})")
    return ServeMesh(devices=(resolve_device(device),) * n_hosts)


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
        if isinstance(prefix_cache, PrefixCache):
            raise TypeError(
                "ShardedServeEngine routes cache traffic per shard: pass a "
                "ReplicatedPrefixCache (or None), not a bare PrefixCache")
        if mesh is None:
            mesh = make_serve_mesh(n_hosts if n_hosts is not None else 1, device)
        devices = {torch.device(d) for d in mesh.devices}
        if len(devices) > 1:
            raise NotImplementedError(
                f"a serve mesh over {len(devices)} distinct devices is not ported "
                "yet: every host of the mesh must sit on one device")
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
        if prefix_cache is not None and prefix_cache.n_shards != self.n_hosts:
            raise ValueError(f"prefix cache has {prefix_cache.n_shards} shards for "
                             f"{self.n_hosts} hosts")

    # -------------------------------------------- dispatch-op overrides
    # The tick body is ServeEngine's, slot splices and per-row node caps
    # included: host h's rows are the contiguous range h*K .. h*K + K - 1
    # of the one pool, so a global slot id is its owner's row, and every
    # target decode and verify dispatch takes a [H*K] caps row. The sharded engine
    # swaps in per-shard cache routing and least-loaded arrival routing.

    def _ops_lookup(self, prompt, h: int):
        if self.prefix_cache is None:
            return 0, None, None
        entry = self.prefix_cache.lookup(prompt, shard=h)
        if entry is None:
            return 0, None, None
        return entry.n_tokens, entry.state, entry.logits

    def _ops_cache_insert(self, prompt, n, state, logits, h: int):
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
        decode step (or, with ``spec_k``, one draft-verify round)."""
        hosts = [_Host(self.slots_per_host) for _ in range(self.n_hosts)]
        return self._serve_ticks(hosts, requests, prompt_len, arrivals, rng_seed,
                                 return_stats, self.prefill_chunk, coalesce=True)
