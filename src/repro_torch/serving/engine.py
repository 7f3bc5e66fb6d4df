"""Slot-level continuous-batching serve engine, the port of the JAX
package's ``serving/engine.py`` on one device.

The engine owns a pool of ``slots`` decode rows whose states (O(S*d) for
an STLT block, a KV cache of ``max_len`` slots for an attention block)
live in ONE batched decode state (``transformer.init_decode_state(cfg,
batch=slots)``); every per-sequence position is a [slots] vector, so
co-resident rows sit at different depths. Three operations drive it:
``transformer.insert_slot`` (splice a prefilled batch-1 state into a free
row), ``reset_slot`` (return a released row to the pristine state) and
``decode_step`` (one batched token step for the WHOLE pool). The host-side
:class:`Scheduler` tracks which row holds which request; a finished
request's row is refilled from the queue while the others keep decoding.

Admission runs K1 (the Hopper STLT scan) once per STLT layer per dispatch
(an attention layer runs plain torch), by one of three routes:

* monolithic (``prefill_chunk=0``): ``transformer.prefill`` of the whole
  prompt (``prefill_chunk`` from a cached prefix's state);
* coalesced (default): prompts are folded ``prefill_chunk`` tokens per tick
  through ``transformer.prefill_chunk`` with a carried state and a per-row
  ``valid_len``, every co-pending admission in ONE masked dispatch, at two
  shapes only: ``[1, chunk]`` for a lone pending row (also ``warm_prefix``'s
  shape) and ``[slots, chunk]`` over a second slot pool, the prefill pool,
  when several are pending. The prefill pool is dropped once it drains;
* one request per tick (``coalesce=False``): batch-1 chunks, the tail at
  its natural length.

A :class:`PrefixCache` snapshots the streaming state at chunk boundaries and
at full prompts, keyed by prompt-prefix hash, so requests sharing a system
prompt skip its prefill; ``warm_prefix`` pre-populates it.

``serve(mode="wave")`` keeps the admission-wave baseline (a whole wave
drains before the next is admitted). Time is counted in ticks: one batched
decode step is one tick, the unit of ``arrivals`` and of the latency stats.
Sampled requests draw Gumbel noise per ``(rng_seed, request id, token
index)`` (``sampler.GumbelStreams``), so a request's stream is the same in
both modes.

Speculative decoding (``spec_k``, greedy only): each decode tick drafts k
tokens per live row (``serving/speculative.py``: the n-gram draft or the
node-subset draft) and scores them in ONE ``transformer.spec_verify``
dispatch (one K1 call per layer); the stream is the plain greedy stream.
The SLO ladder (``slo_degrade``) steps every live row's node budget down
on a breach and back up after ``slo_recovery_ticks`` healthy ticks.
``serve_stats`` counts every dispatch by kind; ``spec_stats`` and
``node_stats`` describe the last serve's drafts and ladder.

The tick body works over a list of hosts (``_Host``: a queue, a Scheduler
over K rows and its pending prefills) on one pool of B = hosts x K rows,
global row g = h * K + local; ``serve`` is the one-host case. The
disaggregated controller (``serving/disagg``) drives a prefill fleet and a
decode fleet through the same phases (``_tick_admission``,
``_tick_decode``) with four hooks: ``_now`` (the fleet's clock),
``_handoff_promote`` (ship a finished prefill instead of decoding it),
``_ready_state`` (admit a state prefilled elsewhere) and
``_evacuate_host`` (a lost host's work, for requeueing). The sharded
engine (``serving/multihost.py``) serves over H hosts of K rows through the
same body, with its own routing and per-shard prefix cache.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving import speculative
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import (GumbelStreams, advance_slots, gumbel,
                                         sample_slot_tokens)
from repro_torch.utils import default_generator, resolve_device, tree_map


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # [L] int32
    max_new_tokens: int
    id: int = 0
    temperature: Optional[float] = None  # None -> engine default
    # per-request STLT node budget for decode (None -> engine default ->
    # full S); mixed budgets ride ONE dispatch (the cap is a [B] argument)
    serve_nodes: Optional[int] = None


class Scheduler:
    """Host-side slot bookkeeping: which request occupies which row, how
    many tokens it has emitted, and when it arrived / was admitted.

    A row is free, ``pending`` (mid chunked prefill, not decoding yet) or
    ``live`` (decoding). Per-request stats record ``prompt_tokens``, the
    ``prefilled_tokens`` actually computed, the ``cached_tokens`` skipped by
    a prefix-cache hit, the ticks of ``arrival``, ``admit``, ``live`` (the
    first token) and ``finish``, and the wall-clock stamp of every token."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.req = [None] * n_slots          # row -> Request | None
        self.live = np.zeros(n_slots, bool)
        self.pending = np.zeros(n_slots, bool)
        self.emitted = np.zeros(n_slots, np.int64)
        self.budgets = np.zeros(n_slots, np.int64)
        self.stats: dict[int, dict] = {}

    def free_slots(self):
        return [s for s in range(self.n_slots)
                if not (self.live[s] or self.pending[s])]

    def hold(self, slot: int, req: Request, arrival: int, tick: int,
             prompt_tokens: int = 0, cached_tokens: int = 0):
        """Assign the row for chunked prefill (occupied but not decoding)."""
        self.req[slot] = req
        self.pending[slot] = True
        self.emitted[slot] = 0
        self.budgets[slot] = req.max_new_tokens
        self.stats[req.id] = {
            "arrival": arrival, "admit": tick, "live": None, "finish": None,
            "n_tokens": 0, "prompt_tokens": prompt_tokens,
            "prefilled_tokens": prompt_tokens - cached_tokens,
            "cached_tokens": cached_tokens,
            # inter-token gaps show decode stalls that ticks cannot (a
            # monolithic prefill spends any wall time inside one tick)
            "token_walls": [],
        }

    def activate(self, slot: int, tick: int):
        """Prefill finished: the row starts decoding."""
        self.pending[slot] = False
        self.live[slot] = True
        self.stats[self.req[slot].id]["live"] = tick

    def bind(self, slot: int, req: Request, arrival: int, tick: int,
             prompt_tokens: int = 0, cached_tokens: int = 0):
        """Single-shot admission: prefill completed within this tick."""
        self.hold(slot, req, arrival, tick, prompt_tokens, cached_tokens)
        self.activate(slot, tick)

    def release(self, slot: int, tick: int):
        req = self.req[slot]
        self.stats[req.id]["finish"] = tick
        self.stats[req.id]["n_tokens"] = int(self.emitted[slot])
        self.req[slot] = None
        self.live[slot] = False
        self.pending[slot] = False


class _Host:
    """One host's serving state: its admission queue, its Scheduler over
    its K rows and its in-flight chunked prefills. The tick body works over
    a list of these; a single-device serve is the one-element case."""

    def __init__(self, n_slots: int):
        self.sched = Scheduler(n_slots)
        self.queue: list = []                # (arrival, Request), FIFO
        self.pending: dict[int, dict] = {}   # local row -> in-flight prefill


class _ServeRun:
    """Mutable state of one continuous serve run, threaded through the tick
    phases (``_serve_start`` -> ``_serve_tick``* -> ``_serve_finish``), so
    the disaggregated controller can drive a fleet's admission and decode
    phases from outside, between its transport's messages."""

    def __init__(self, hosts, queue, chunk_size, coalesce, prompt_len,
                 draws, temperature: float):
        self.hosts = hosts
        self.K = hosts[0].sched.n_slots
        self.B = len(hosts) * self.K
        self.queue = queue               # (arrival, Request), arrival-sorted
        self.results: dict[int, list[int]] = {}
        # the decode pool is built at the first promote (a prefill fleet
        # never builds it), the prefill pool at the first coalesced
        # admission (and dropped when it drains)
        self.pool = None
        self.prefill_pool = None
        self.spec = None          # the draft (speculative serving)
        self.spec_adapt = None    # its AdaptiveK (spec_adaptive)
        self.tok = np.zeros(self.B, np.int32)
        self.temps = np.full(self.B, temperature, np.float32)
        self.draws = draws
        self.tick = 0
        self.chunk_size = chunk_size
        self.coalesce = coalesce
        self.prompt_len = prompt_len
        # request id -> the clock (``_now``) when it reached a host queue
        self.arrival_walls: dict[int, float] = {}
        # a standalone run fast-forwards idle gaps to the next arrival; the
        # disaggregated controller owns the clock and turns this off
        self.fast_forward = True

    @property
    def host(self) -> _Host:
        """The first host: the whole pool of a single-host run."""
        return self.hosts[0]

    def any_live(self) -> bool:
        return any(h.sched.live.any() for h in self.hosts)

    def any_pending(self) -> bool:
        return any(h.pending for h in self.hosts)

    def any_queued(self) -> bool:
        return any(h.queue for h in self.hosts)

    def active(self) -> bool:
        return (bool(self.queue) or self.any_queued() or self.any_pending()
                or self.any_live())


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, max_len: int = 4096,
                 temperature: float = 0.0, eos_id: int = -1, top_k: int = 0,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 serve_nodes: Optional[int] = None, spec_k: int = 0,
                 spec_draft: str = "ngram", spec_draft_nodes: int = 4,
                 spec_adaptive: bool = False, spec_accept_floor: float = 0.4,
                 spec_adapt_window: int = 8, spec_adapt_recovery: int = 4,
                 slo_gap_ms: float = 0.0, slo_queue_depth: int = 0,
                 slo_degrade: tuple = (), slo_recovery_ticks: int = 8,
                 noise: Optional[Callable] = None, device=None):
        """``params`` from ``transformer.init_lm`` or
        ``convert.from_jax_params``; they are moved to ``device`` (CUDA
        unless the caller names another).

        ``prefill_chunk``: admit prompts this many tokens per tick,
        interleaved with decode (None/0 -> monolithic admission).
        ``prefix_cache``: reuse post-prefix states across requests sharing a
        prompt prefix (full-prompt states are stored after every prefill,
        chunk-boundary states where they extend a cached prefix).
        ``serve_nodes``: default STLT node budget of decode steps (None ->
        full S); a :class:`Request` may override it. Prefill always runs at
        full S. ``noise(rng_seed)`` returns the sampled rows' Gumbel draws,
        ``draws(request_id, token_index) -> [vocab]`` (default
        ``sampler.GumbelStreams`` on ``device``).

        ``spec_k`` >= 1: speculative decoding in continuous serve (greedy
        only; refused on adaptive-mask configs, whose verify would pool one
        mask per window where decode pools one per token). ``spec_draft``
        "ngram" (prompt lookup, no dispatches) or "nodes" (the model with
        each head's readout cut to its top ``spec_draft_nodes`` nodes).
        ``spec_adaptive``: a slot whose accept rate over the last
        ``spec_adapt_window`` drafted tokens falls below
        ``spec_accept_floor`` halves its verified window, and doubles it
        back after ``spec_adapt_recovery`` healthy rounds.

        ``slo_degrade``: a descending ladder of node budgets, e.g.
        ``(16, 8, 4)``; a decode tick whose wall gap exceeds ``slo_gap_ms``
        (when > 0) or after whose admission ``slo_queue_depth`` or more
        requests still queue (when > 0) steps one level down, and
        ``slo_recovery_ticks`` healthy ticks step one level up.

        ``serve_nodes``, ``slo_degrade`` and the node draft act on STLT
        blocks: on a model with none (native attention) they are refused.
        With an ``attn`` block the KV cache holds ``max_len`` positions, so
        a request whose prompt and budget exceed it is refused up front
        (``_check_fits``)."""
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (got {spec_k})")
        if spec_draft not in ("ngram", "nodes"):
            raise ValueError(f"unknown spec_draft {spec_draft!r} "
                             "(expected 'ngram' or 'nodes')")
        if spec_adaptive and spec_k < 2:
            raise ValueError(
                "spec_adaptive needs spec_k >= 2 (a 1-token window has no "
                f"room to shrink; got spec_k={spec_k})")
        if not 0.0 < spec_accept_floor <= 1.0:
            raise ValueError(
                f"spec_accept_floor must be in (0, 1] (got {spec_accept_floor})")
        if spec_adapt_window < 1 or spec_adapt_recovery < 1:
            raise ValueError(
                "spec_adapt_window and spec_adapt_recovery must be >= 1 "
                f"(got {spec_adapt_window}, {spec_adapt_recovery})")
        self._has_stlt = any(bt in ("stlt", "stlt_rel") for bt in cfg.block_types())
        # only unbounded causal attention allocates a length-bounded cache;
        # a local window is a ring and STLT states are O(1) in N
        self._length_bounded = "attn" in cfg.block_types()
        if spec_k and spec_draft == "nodes" and not self._has_stlt:
            raise ValueError("spec_draft='nodes' requires an STLT mixer")
        if spec_k and self._has_stlt and cfg.stlt_adaptive:
            raise ValueError(
                "speculative decoding is incompatible with adaptive node "
                "masks (stlt_adaptive=True): verify pools one mask per "
                "window, decode pools one per token")
        self.spec_k = spec_k
        self.spec_draft = spec_draft
        self.spec_draft_nodes = spec_draft_nodes
        self.spec_adaptive = spec_adaptive
        self.spec_accept_floor = spec_accept_floor
        self.spec_adapt_window = spec_adapt_window
        self.spec_adapt_recovery = spec_adapt_recovery
        S = cfg.stlt_nodes
        slo_degrade = tuple(int(m) for m in (slo_degrade or ()))
        if slo_degrade:
            if not self._has_stlt:
                raise ValueError("slo_degrade requires an STLT mixer")
            if not (slo_gap_ms > 0 or slo_queue_depth > 0):
                raise ValueError(
                    "slo_degrade needs a trigger: set slo_gap_ms and/or "
                    "slo_queue_depth")
            for m in slo_degrade:
                if not 1 <= m <= S:
                    raise ValueError(
                        f"slo_degrade levels must be in [1, {S}] "
                        f"(got {slo_degrade})")
        if slo_recovery_ticks < 1:
            raise ValueError(
                f"slo_recovery_ticks must be >= 1 (got {slo_recovery_ticks})")
        self.slo_gap_ms = slo_gap_ms
        self.slo_queue_depth = slo_queue_depth
        self.slo_degrade = slo_degrade
        self.slo_recovery_ticks = slo_recovery_ticks
        # the ladder's state: _slo_level indexes slo_degrade (-1: full S)
        self._slo_level = -1
        self._slo_streak = 0
        self._slo_last_wall: Optional[float] = None
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.top_k = top_k
        self.prefill_chunk = prefill_chunk or 0
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (got {prefill_chunk})")
        if serve_nodes is not None:
            if not self._has_stlt:
                raise ValueError("serve_nodes requires an STLT mixer")
            if not 1 <= serve_nodes <= S:
                raise ValueError(f"serve_nodes must be in [1, {S}] (got {serve_nodes})")
        self.serve_nodes = serve_nodes
        self.prefix_cache = prefix_cache
        self.noise = noise or (lambda seed: GumbelStreams(seed, cfg.vocab, self.device))
        self.params = tree_map(lambda t: t.to(self.device), params)
        self._fresh1 = None   # pristine batch-1 state (``_fresh_template``)
        # dispatch counts, draft/accept counts and the node ladder's
        # trajectory of the last serve call (reset at its start)
        self.serve_stats: dict = {}
        self.spec_stats: dict = {}
        self.node_stats: dict = {}

    # take the [1, chunk] dispatch for a lone pending row (the sharded engine
    # turns it off: its trace stays [B, chunk] plus warm_prefix's [1, chunk])
    _fast_single_prefill = True

    # ------------------------------------------------------------------ simple
    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 serve_nodes: Optional[int] = None) -> np.ndarray:
        """prompts [B, L] -> generated tokens [B, max_new_tokens] (numpy).

        Sampling (temperature > 0) draws from ``generator`` (seed 0 when
        None). ``serve_nodes`` caps decode steps' node budget for this call;
        the prefill always runs at full S."""
        level = serve_nodes if serve_nodes is not None else self.serve_nodes
        S = self.cfg.stlt_nodes
        if level is not None and not 1 <= level <= S:
            raise ValueError(f"serve_nodes must be in [1, {S}] (got {level})")
        if generator is None:
            generator = default_generator(self.device)
        tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
        B = tokens.shape[0]
        caps = torch.full((B,), level if level is not None else S,
                          dtype=torch.int32, device=self.device)
        temps = torch.full((B,), self.temperature, device=self.device)

        def sample(logits):
            noise = (gumbel(logits.shape, generator, self.device)
                     if self.temperature > 0 else None)
            return sample_slot_tokens(logits, noise, temps, self.top_k)

        logits, state = T.prefill(self.params, self.cfg, tokens, self.max_len)
        tok = sample(logits)
        outs = [tok]
        for _ in range(max_new_tokens - 1):
            logits, state = T.decode_step(self.params, self.cfg, tok, state,
                                          node_cap=caps)
            tok = sample(logits)
            outs.append(tok)
        return torch.stack(outs, dim=1).cpu().numpy()

    # ------------------------------------------------------- continuous batching
    @torch.no_grad()
    def serve(self, requests: list, slots: int = 4,
              prompt_len: Optional[int] = None, mode: str = "continuous",
              arrivals=None, rng_seed: int = 0, return_stats: bool = False,
              coalesce: bool = True):
        """Serve a request list. Returns {request_id: np.ndarray tokens}
        (plus a per-request stats dict when ``return_stats``).

        Admission follows the engine's ``prefill_chunk`` (0: monolithic).
        ``coalesce=False`` admits one request
        per tick per pending row (batch-1 chunks, natural-length tails).
        mode="continuous": per-row admission; mode="wave": admit up to
        ``slots`` requests, drain them all, then admit the next wave.
        ``arrivals`` (ticks, aligned with ``requests``) gates admission;
        requests are admitted in arrival order. With ``prompt_len`` prompts
        are left-padded to that length (the padding enters the state);
        without it each is prefilled at its natural length. Sampled
        requests draw from per-request streams (``noise``), identical
        across modes."""
        if slots < 1:
            raise ValueError(f"slots must be >= 1 (got {slots})")
        if mode == "wave":
            return self._serve_wave(requests, slots, prompt_len, arrivals,
                                    rng_seed, return_stats)
        if mode != "continuous":
            raise ValueError(f"unknown serve mode {mode!r}")
        return self._serve_continuous(requests, slots, prompt_len, arrivals,
                                      rng_seed, return_stats, coalesce)

    def _padded(self, prompt: np.ndarray, prompt_len: Optional[int]):
        prompt = np.asarray(prompt, np.int32)
        if prompt_len is None or len(prompt) == prompt_len:
            return prompt
        if len(prompt) > prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds prompt_len={prompt_len}")
        out = np.zeros(prompt_len, np.int32)
        out[prompt_len - len(prompt):] = prompt  # left-pad
        return out

    def _check_fits(self, req: Request, prompt_tokens: int):
        """A model with an ``attn`` block caches ``max_len`` positions: its
        request's prompt and budget must fit in them."""
        if self._length_bounded and prompt_tokens + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.id}: {prompt_tokens} prompt tokens + "
                f"{req.max_new_tokens} new tokens exceeds max_len={self.max_len}")

    def _queue(self, requests, arrivals, prompt_len=None):
        """Validate the whole request set up front (ids, budgets, node caps,
        lengths against ``max_len`` where a KV cache bounds them, arrivals),
        so a bad request fails before any device work, then return
        (arrival, request) pairs in arrival order."""
        ids = [r.id for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError(
                "duplicate request ids (results/stats are keyed by id and "
                f"noise streams are derived from it): {sorted(ids)}")
        S = self.cfg.stlt_nodes
        for r in requests:
            if r.max_new_tokens < 1:
                raise ValueError(
                    f"request {r.id}: max_new_tokens must be >= 1 "
                    f"(got {r.max_new_tokens})")
            if r.serve_nodes is not None:
                if not self._has_stlt:
                    raise ValueError(
                        f"request {r.id}: serve_nodes requires an STLT mixer")
                if not 1 <= r.serve_nodes <= S:
                    raise ValueError(
                        f"request {r.id}: serve_nodes must be in [1, {S}] "
                        f"(got {r.serve_nodes})")
            n_prompt = len(np.asarray(r.prompt))
            if prompt_len is not None and n_prompt > prompt_len:
                raise ValueError(
                    f"request {r.id}: prompt of {n_prompt} tokens exceeds "
                    f"prompt_len={prompt_len}")
            self._check_fits(r, prompt_len if prompt_len is not None else n_prompt)
        arrivals = [0] * len(requests) if arrivals is None else list(arrivals)
        if len(arrivals) != len(requests):
            raise ValueError(
                f"arrivals has {len(arrivals)} entries for {len(requests)} requests")
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        return [(int(arrivals[i]), requests[i]) for i in order]

    # ----------------------------------------------------------- prefix cache
    def _lookup_prefix(self, prompt: np.ndarray):
        """(resume offset, state-or-None, logits-or-None) for ``prompt``."""
        if self.prefix_cache is None:
            return 0, None, None
        entry = self.prefix_cache.lookup(prompt)
        if entry is None:
            return 0, None, None
        return entry.n_tokens, entry.state, entry.logits

    def _cache_insert(self, prompt: np.ndarray, n: int, state, logits,
                      pinned: bool = False):
        if self.prefix_cache is not None and n > 0:
            self.prefix_cache.insert(prompt[:n], state, logits, pinned=pinned)

    @torch.no_grad()
    def warm_prefix(self, prompt, chunk: Optional[int] = None):
        """Prefill ``prompt`` (e.g. a shared system prompt) into the prefix
        cache without serving a request: snapshots the state at every chunk
        boundary and at the full length, PINNED against eviction. The tail
        is masked-prefilled at the padded [1, chunk] shape, so the EXACT
        length is always registered. Returns the number of tokens prefilled
        (0 on a full cache hit)."""
        if self.prefix_cache is None:
            raise ValueError("warm_prefix requires a prefix_cache")
        prompt = np.asarray(prompt, np.int32)
        chunk = chunk or self.prefill_chunk or len(prompt)
        if chunk < 1:
            raise ValueError(f"warm_prefix needs a non-empty prompt (chunk={chunk})")
        offset, state, logits = self._lookup_prefix(prompt)
        if offset == len(prompt):
            return 0
        if state is None:
            state = self._fresh_template()
        done = offset
        while done < len(prompt):
            n = min(chunk, len(prompt) - done)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :n] = prompt[done:done + n]
            logits, state = self._run_prefill_chunk(buf, state, [n])
            done += n
            self._cache_insert(prompt, done, state, logits, pinned=True)
        return len(prompt) - offset

    # ---------------------------------------------------------- dispatches
    def _fresh_template(self):
        """Pristine batch-1 decode state, shared and never written: seeds
        fresh prefills and resets rows."""
        if self._fresh1 is None:
            self._fresh1 = T.init_decode_state(self.cfg, 1, self.max_len,
                                               device=self.device)
        return self._fresh1

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int32), device=self.device)

    def _count(self, key: str):
        self.serve_stats[key] = self.serve_stats.get(key, 0) + 1

    def _run_prefill(self, toks):
        """Monolithic admission dispatch: one K1 call per layer."""
        self._count("admission_dispatches")
        return T.prefill(self.params, self.cfg, self._tokens(toks), self.max_len)

    def _run_prefill_chunk(self, toks, state, valid=None, params=None,
                           key: str = "admission_dispatches"):
        """Chunk admission dispatch ([1 or slots, chunk], per-row ``valid``;
        or a batch-1 natural-length chunk): one K1 call per layer. The node
        draft passes its own ``params`` and counts under its own ``key``."""
        self._count(key)
        return T.prefill_chunk(
            self.params if params is None else params, self.cfg,
            self._tokens(toks), state,
            valid_len=None if valid is None else self._tokens(valid))

    def _run_decode(self, tok, pool, caps=None, params=None,
                    key: str = "decode_dispatches"):
        """One decode step over the pool (no K1 call)."""
        self._count(key)
        if caps is not None:
            caps = self._tokens(caps)
        return T.decode_step(self.params if params is None else params, self.cfg,
                             self._tokens(tok), pool, node_cap=caps)

    def _run_verify(self, toks, valid, pool, caps):
        """ONE spec_verify dispatch over the pool ([slots, k + 1]): one K1
        call per layer. Returns (greedy, commit) as numpy and the new pool."""
        self._count("verify_dispatches")
        greedy, commit, pool = T.spec_verify(
            self.params, self.cfg, self._tokens(toks), pool, self._tokens(valid),
            node_cap=self._tokens(caps))
        return greedy.cpu().numpy(), commit.cpu().numpy(), pool

    def _sample(self, draws, logits, rows, temps) -> np.ndarray:
        """Tokens [B] (numpy) from logits [B, V] (a tensor, or numpy off the
        wire): greedy rows by argmax, sampled rows by argmax(logits / T +
        their Gumbel draw). ``rows[b]`` is (request id, token index) of a
        live row, None for the others."""
        logits = torch.as_tensor(logits, device=self.device)
        temps = np.asarray(temps, np.float32)
        hot = [b for b, r in enumerate(rows) if r is not None and temps[b] > 0]
        noise = None
        if hot:
            noise = torch.zeros(logits.shape, dtype=torch.float32, device=self.device)
            for b in hot:
                noise[b] = torch.as_tensor(draws(*rows[b]), dtype=torch.float32,
                                           device=self.device)
        tok = sample_slot_tokens(logits, noise,
                                 torch.as_tensor(temps, device=self.device),
                                 self.top_k)
        return tok.cpu().numpy()

    # The tick body calls the slot-pool and prefix-cache operations through
    # these primitives (with ``_run_prefill_chunk``, ``_run_decode`` and
    # ``_run_verify``, the JAX package's ``_ops_prefill_pool``,
    # ``_ops_decode`` and ``_ops_verify``); the disaggregated prefill
    # engine swaps in a prefix cache per host.

    def _ops_insert(self, pool, st1, g: int):
        return T.insert_slot(pool, st1, g, self.cfg)

    def _ops_extract(self, pool, g: int):
        return T.extract_slot(pool, g, self.cfg)

    def _ops_reset(self, pool, g: int):
        return T.reset_slot(pool, g, self.cfg, self.max_len,
                            template=self._fresh_template())

    def _ops_lookup(self, prompt, h: int):
        return self._lookup_prefix(prompt)

    def _ops_cache_insert(self, prompt, n, state, logits, h: int):
        self._cache_insert(prompt, n, state, logits)

    def _enqueue(self, run: _ServeRun, h: int, arrival: int, req: Request):
        """Put a request in host ``h``'s queue, stamping its arrival on the
        engine's clock (the TTFT's start)."""
        run.arrival_walls[req.id] = self._now()
        run.hosts[h].queue.append((arrival, req))

    def _route_arrivals(self, run: _ServeRun):
        """Move every arrived request into a host queue (one host: FIFO)."""
        while run.queue and run.queue[0][0] <= run.tick:
            self._enqueue(run, 0, *run.queue.pop(0))

    def _row_caps(self, hosts, K: int) -> np.ndarray:
        """Per-row node budgets [B] of a decode tick: request override ->
        engine default -> full S, clamped by the SLO ladder's current level.
        Free and pending rows get full S."""
        S = self.cfg.stlt_nodes
        caps = np.full(len(hosts) * K, S, np.int32)
        ladder_cap = self.slo_degrade[self._slo_level] if self._slo_level >= 0 else S
        for h, host in enumerate(hosts):
            sched = host.sched
            for local in np.flatnonzero(sched.live):
                req = sched.req[local]
                base = req.serve_nodes if req.serve_nodes is not None else self.serve_nodes
                base = S if base is None else base
                caps[h * K + local] = max(1, min(base, ladder_cap, S))
        return caps

    def _slo_update(self, hosts, gap_ms: Optional[float], qdepth: Optional[int] = None):
        """One step of the degrade/restore ladder after a tick: a breach
        (the decode tick's wall gap, or the queue depth after admission:
        ``hosts``' queues, or ``qdepth`` where the caller counts them)
        steps one level down and resets the healthy streak;
        ``slo_recovery_ticks`` healthy ticks in a row step one level up."""
        if not self.slo_degrade:
            return
        ns = self.node_stats
        if qdepth is None:
            qdepth = sum(len(h.queue) for h in hosts)
        gap_breach = bool(self.slo_gap_ms > 0 and gap_ms is not None
                          and gap_ms > self.slo_gap_ms)
        queue_breach = bool(self.slo_queue_depth > 0 and qdepth >= self.slo_queue_depth)
        if gap_breach:
            ns["gap_breaches"] += 1
        if queue_breach:
            ns["queue_breaches"] += 1
        if gap_breach or queue_breach:
            if self._slo_level < len(self.slo_degrade) - 1:
                self._slo_level += 1
                ns["degrade_steps"] += 1
            self._slo_streak = 0
        else:
            self._slo_streak += 1
            if self._slo_level >= 0 and self._slo_streak >= self.slo_recovery_ticks:
                self._slo_level -= 1
                ns["restore_steps"] += 1
                self._slo_streak = 0
        if self._slo_level >= 0:
            ns["ticks_degraded"] += 1
            ns["min_nodes"] = min(ns["min_nodes"],
                                  int(self.slo_degrade[self._slo_level]))

    def _make_draft(self, n_slots: int):
        if not self.spec_k:
            return None
        if self.spec_draft == "nodes":
            return speculative.NodeDraft(self, self.spec_k, n_slots,
                                         self.spec_draft_nodes)
        return speculative.NGramDraft(self.spec_k, n_slots)

    def _cache_tick(self, n: int):
        """Advance the prefix cache's TTL clock by ``n`` scheduler ticks."""
        if self.prefix_cache is not None and n > 0:
            self.prefix_cache.tick(n)

    # ------------------------------------------------------- disagg hooks
    def _now(self) -> float:
        """The clock of token walls, arrival walls and SLO gaps. A
        disaggregated role engine reads its fleet's own clock instead."""
        return time.perf_counter()

    def _handoff_promote(self, run: _ServeRun, h: int, local: int, ent: dict,
                         logits1, st1) -> bool:
        """Return True to take a finished prefill (its state and first-token
        logits) away instead of decoding it here: the row is then released.
        The disaggregated prefill engine ships the state here."""
        return False

    def _ready_state(self, req: Request):
        """(state, logits) of a request prefilled elsewhere (a shipped
        state on a disaggregated decode host), or None for the normal
        admission path. A hit admits like a full-prompt cache hit."""
        return None

    def _evacuate_host(self, run: _ServeRun, h: int) -> list:
        """Host ``h`` is lost: forget its rows and queue and return what was
        in flight as ``(kind, arrival, request, progress)``, kind "queued",
        "pending" (progress: the prefilled tokens lost) or "live" (the
        caller owns ``run.results``). Rows are cleared without release (the
        requests did not finish) and reset in the pool, so a reused row
        never sees the lost host's state. A requeued request gives the same
        tokens: its stream depends on (rng_seed, request id, step) only."""
        host = run.hosts[h]
        sched = host.sched
        lost = [("queued", arrival, req, 0) for arrival, req in host.queue]
        host.queue = []
        for ent in host.pending.values():
            req = ent["req"]
            st = sched.stats.get(req.id, {})
            lost.append(("pending", st.get("arrival", run.tick), req,
                         max(0, ent["done"] - st.get("cached_tokens", 0))))
        host.pending = {}
        for local in range(sched.n_slots):
            req = sched.req[local]
            if req is not None:
                if sched.live[local]:
                    lost.append(("live", sched.stats.get(req.id, {}).get("arrival", run.tick),
                                 req, 0))
                sched.stats.pop(req.id, None)
            sched.req[local] = None
            sched.live[local] = False
            sched.pending[local] = False
            sched.emitted[local] = 0
            if run.pool is not None:
                run.pool = self._ops_reset(run.pool, h * run.K + local)
        return lost

    # ------------------------------------------------------------- continuous
    def _serve_continuous(self, requests, slots, prompt_len, arrivals,
                          rng_seed, return_stats, coalesce=True):
        return self._serve_ticks([_Host(slots)], requests, prompt_len, arrivals,
                                 rng_seed, return_stats, self.prefill_chunk, coalesce)

    def _serve_ticks(self, hosts, requests, prompt_len, arrivals, rng_seed,
                     return_stats, chunk_size, coalesce=True):
        """The serve tick body over ``hosts``: per tick, in order, route
        arrivals -> admission -> at most one masked prefill dispatch -> one
        decode step -> release/reset finished rows."""
        run = self._serve_start(hosts, requests, prompt_len, arrivals, rng_seed,
                                chunk_size, coalesce)
        while run.active():
            self._serve_tick(run)
        return self._serve_finish(run, return_stats)

    def _serve_start(self, hosts, requests, prompt_len, arrivals, rng_seed,
                     chunk_size, coalesce=True) -> _ServeRun:
        """Validate the requests and build a run's state. ``requests`` may be
        empty: the disaggregated controller feeds its fleets' host queues."""
        queue = self._queue(requests, arrivals, prompt_len)
        if self.spec_k:
            if self.temperature and self.temperature > 0:
                raise ValueError(
                    "speculative decoding is greedy-only: the accept rule "
                    f"compares argmax tokens (temperature={self.temperature})")
            for _, r in queue:
                if r.temperature:
                    raise ValueError(
                        f"request {r.id}: speculative decoding is greedy-only "
                        f"(temperature={r.temperature})")
        run = _ServeRun(hosts, queue, chunk_size, coalesce, prompt_len,
                        self.noise(rng_seed), self.temperature)
        self.serve_stats = {"admission_dispatches": 0, "decode_dispatches": 0}
        run.spec = self._make_draft(run.B)
        if run.spec is not None:
            self.serve_stats["verify_dispatches"] = 0
            if self.spec_draft == "nodes":
                self.serve_stats.update(draft_prefill_dispatches=0,
                                        draft_decode_dispatches=0)
            if self.spec_adaptive:
                run.spec_adapt = speculative.AdaptiveK(
                    self.spec_k, run.B, floor=self.spec_accept_floor,
                    window=self.spec_adapt_window,
                    recovery=self.spec_adapt_recovery)
        self.spec_stats = {"verify_calls": 0, "drafted": 0, "accepted": 0,
                           "emitted": 0, "k": self.spec_k}
        self._slo_level = -1
        self._slo_streak = 0
        self._slo_last_wall = None
        self.node_stats = {"degrade_steps": 0, "restore_steps": 0,
                           "ticks_degraded": 0, "gap_breaches": 0,
                           "queue_breaches": 0,
                           "min_nodes": int(self.cfg.stlt_nodes),
                           "ladder": list(self.slo_degrade)}
        return run

    def _ensure_pool(self, run: _ServeRun):
        if run.pool is None:
            run.pool = T.init_decode_state(self.cfg, run.B, self.max_len,
                                           device=self.device)
        return run.pool

    def _promote(self, run: _ServeRun, h: int, local: int, ent: dict, logits1, st1):
        """Prefill complete on host h: sample the first token, splice the
        state into the decode pool and go live (or finish, for a one-token
        request), unless ``_handoff_promote`` takes the state away."""
        sched = run.hosts[h].sched
        req = ent["req"]
        if self._handoff_promote(run, h, local, ent, logits1, st1):
            sched.release(local, run.tick)   # shipped: free the row
            return
        g = h * run.K + local
        temp = self.temperature if req.temperature is None else req.temperature
        t0 = int(self._sample(run.draws, logits1, [(req.id, 0)], [temp])[0])
        run.pool = self._ops_insert(self._ensure_pool(run), st1, g)
        run.tok[g] = t0
        run.temps[g] = temp
        sched.activate(local, run.tick)
        run.results[req.id] = [t0]
        sched.stats[req.id]["token_walls"].append(self._now())
        sched.emitted[local] = 1
        if sched.emitted[local] >= sched.budgets[local] or t0 == self.eos_id:
            sched.release(local, run.tick)   # prefill-only request
            run.pool = self._ops_reset(run.pool, g)
        elif run.spec is not None:
            run.spec.on_promote(g, ent["prompt"], t0)
            if run.spec_adapt is not None:
                run.spec_adapt.reset(g)

    def _tick_admission(self, run: _ServeRun):
        """Admission phase of one tick: fill free rows from the host queues,
        then advance every pending chunked prefill with at most one masked
        dispatch. Completed prefills promote (or hand off) within the same
        tick."""
        cfg = self.cfg
        hosts, K, B = run.hosts, run.K, run.B
        chunk_size, coalesce = run.chunk_size, run.coalesce
        for h, host in enumerate(hosts):
            sched = host.sched
            for local in sched.free_slots():
                if not host.queue:
                    break
                arrival, req = host.queue.pop(0)
                prompt = self._padded(req.prompt, run.prompt_len)
                ready = self._ready_state(req)
                if ready is not None:
                    # prefilled elsewhere (a disaggregated handoff): splice
                    # and promote with no local prefill, the whole prompt
                    # counted as cached, as a full-prompt hit is
                    st1, logits1 = ready
                    ent = {"req": req, "prompt": prompt, "done": len(prompt),
                           "resumed": False}
                    sched.hold(local, req, arrival, run.tick, prompt_tokens=len(prompt),
                               cached_tokens=len(prompt))
                    sched.stats[req.id].update(host=h,
                                               arrival_wall=run.arrival_walls.get(req.id))
                    self._promote(run, h, local, ent, logits1, st1)
                    continue
                g = h * K + local
                offset, pstate, plogits = self._ops_lookup(prompt, h)
                # per-request boundary snapshots are cached only where they
                # EXTEND a cached prefix (a unique prompt's boundaries would
                # churn the LRU); warm_prefix covers first-contact prompts
                ent = {"req": req, "prompt": prompt, "done": offset,
                       "resumed": offset > 0}
                sched.hold(local, req, arrival, run.tick,
                           prompt_tokens=len(prompt), cached_tokens=offset)
                sched.stats[req.id].update(host=h,
                                           arrival_wall=run.arrival_walls.get(req.id))
                if offset == len(prompt):
                    # full-prompt hit: the stored last-token logits stand in
                    # for the skipped prefill
                    self._promote(run, h, local, ent, plogits, pstate)
                elif chunk_size and coalesce:
                    if run.prefill_pool is None:
                        run.prefill_pool = T.init_decode_state(cfg, B, self.max_len,
                                                               device=self.device)
                    self._ops_insert(run.prefill_pool,
                                     self._fresh_template() if pstate is None else pstate,
                                     g)
                    host.pending[local] = ent
                elif chunk_size:
                    ent["state"] = self._fresh_template() if pstate is None else pstate
                    host.pending[local] = ent
                else:  # monolithic
                    if pstate is None:
                        logits1, st1 = self._run_prefill(prompt[None])
                    else:
                        logits1, st1 = self._run_prefill_chunk(prompt[None, offset:], pstate)
                    self._ops_cache_insert(prompt, len(prompt), st1, logits1, h)
                    self._promote(run, h, local, ent, logits1, st1)

        # mixed step: ONE masked chunk dispatch advances every pending
        # admission, at [1, chunk] for a lone pending row, else [B, chunk]
        n_pending = sum(len(host.pending) for host in hosts)
        if n_pending == 1 and coalesce and B > 1 and self._fast_single_prefill:
            h, host = next((h, host) for h, host in enumerate(hosts) if host.pending)
            (local, ent), = host.pending.items()
            g = h * K + local
            n = min(chunk_size, len(ent["prompt"]) - ent["done"])
            buf = np.zeros((1, chunk_size), np.int32)
            buf[0, :n] = ent["prompt"][ent["done"]:ent["done"] + n]
            st1 = self._ops_extract(run.prefill_pool, g)
            logits1, st1 = self._run_prefill_chunk(buf, st1, [n])
            ent["done"] += n
            finished = ent["done"] == len(ent["prompt"])
            if ent["resumed"] or finished:
                self._ops_cache_insert(ent["prompt"], ent["done"], st1, logits1, h)
            if finished:
                del host.pending[local]
                self._promote(run, h, local, ent, logits1, st1)
            else:
                self._ops_insert(run.prefill_pool, st1, g)
        elif n_pending and coalesce:
            chunk_tok = np.zeros((B, chunk_size), np.int32)
            valid = np.zeros((B,), np.int32)
            for h, host in enumerate(hosts):
                for local, ent in host.pending.items():
                    g = h * K + local
                    n = min(chunk_size, len(ent["prompt"]) - ent["done"])
                    chunk_tok[g, :n] = ent["prompt"][ent["done"]:ent["done"] + n]
                    valid[g] = n
            logits_all, run.prefill_pool = self._run_prefill_chunk(
                chunk_tok, run.prefill_pool, valid)
            for h, host in enumerate(hosts):
                for local in list(host.pending):
                    ent = host.pending[local]
                    g = h * K + local
                    ent["done"] += int(valid[g])
                    finished = ent["done"] == len(ent["prompt"])
                    if ent["resumed"] or finished:
                        st1 = self._ops_extract(run.prefill_pool, g)
                        logits1 = logits_all[g:g + 1].clone()
                        self._ops_cache_insert(ent["prompt"], ent["done"], st1, logits1, h)
                    if finished:
                        del host.pending[local]
                        self._promote(run, h, local, ent, logits1, st1)
        elif n_pending:  # one batch-1 chunk per pending row (one host)
            host = hosts[0]
            for local in list(host.pending):
                ent = host.pending[local]
                n = min(chunk_size, len(ent["prompt"]) - ent["done"])
                logits1, ent["state"] = self._run_prefill_chunk(
                    ent["prompt"][None, ent["done"]:ent["done"] + n], ent["state"])
                ent["done"] += n
                finished = ent["done"] == len(ent["prompt"])
                if ent["resumed"] or finished:
                    self._ops_cache_insert(ent["prompt"], ent["done"], ent["state"],
                                           logits1, 0)
                if finished:
                    del host.pending[local]
                    self._promote(run, 0, local, ent, logits1, ent["state"])

        # drop the prefill pool once every admission has drained; the next
        # chunked admission rebuilds it
        if run.prefill_pool is not None and not run.any_pending():
            run.prefill_pool = None

    def _tick_decode(self, run: _ServeRun) -> bool:
        """Decode phase of one tick: one batched decode step over the pool
        (or, with ``spec_k``, one draft-verify round), one host sync for the
        tokens, then release/reset finished rows. Returns whether a decode
        dispatch ran."""
        hosts, K = run.hosts, run.K
        decoded = run.any_live()
        if decoded and run.spec is not None:
            self._spec_tick(run, self._row_caps(hosts, K))
        elif decoded:
            logits, run.pool = self._run_decode(run.tok, run.pool, self._row_caps(hosts, K))
            rows = [None] * run.B
            for h, host in enumerate(hosts):
                sched = host.sched
                for local in np.flatnonzero(sched.live):
                    rows[h * K + local] = (sched.req[local].id, int(sched.emitted[local]))
            nxt = self._sample(run.draws, logits, rows, run.temps)
            run.tick += 1
            now = self._now()
            for h, host in enumerate(hosts):
                sched = host.sched
                row = nxt[h * K:(h + 1) * K]
                new_live, new_emitted = advance_slots(
                    row, sched.live, sched.emitted, sched.budgets, self.eos_id)
                for local in np.flatnonzero(sched.live):
                    rid = sched.req[local].id
                    run.results[rid].append(int(row[local]))
                    sched.stats[rid]["token_walls"].append(now)
                sched.emitted = new_emitted
                for local in np.flatnonzero(sched.live & ~new_live):
                    sched.release(local, run.tick)
                    run.pool = self._ops_reset(run.pool, h * K + local)
            run.tok = nxt
        elif run.any_pending():
            run.tick += 1  # prefill-only tick (nothing decoding yet)
        return decoded

    def _spec_tick(self, run: _ServeRun, caps: np.ndarray):
        """One draft-verify-accept round: draft k tokens per live row, score
        the window in ONE ``spec_verify`` dispatch, emit every accepted
        token plus the model's bonus token, and keep each row's state at
        exactly its committed length. A row's verified window is capped by
        its remaining budget and, with ``spec_adaptive``, by 1 + its
        current k (data, not shape: the dispatch is always [B, k + 1])."""
        hosts, K = run.hosts, run.K
        spec, adapt = run.spec, run.spec_adapt
        L = self.spec_k + 1
        live = np.concatenate([host.sched.live for host in hosts])
        inputs = np.zeros((run.B, L), np.int32)
        inputs[:, 0] = run.tok
        inputs[:, 1:] = spec.propose(run.tok, live)
        valid = np.zeros(run.B, np.int32)
        for h, host in enumerate(hosts):
            sched = host.sched
            for local in np.flatnonzero(sched.live):
                g = h * K + local
                remaining = int(sched.budgets[local] - sched.emitted[local])
                win = L if adapt is None else min(L, 1 + adapt.k_for(g))
                valid[g] = min(win, remaining)
        greedy, commit, run.pool = self._run_verify(inputs, valid, run.pool, caps)
        run.tick += 1
        now = self._now()
        ss = self.spec_stats
        ss["verify_calls"] += 1
        for h, host in enumerate(hosts):
            sched = host.sched
            for local in np.flatnonzero(sched.live):
                g = h * K + local
                rid = sched.req[local].id
                ss["drafted"] += int(valid[g]) - 1
                ss["accepted"] += int(commit[g]) - 1
                if adapt is not None and valid[g] > 1:
                    adapt.observe(g, int(valid[g]) - 1, int(commit[g]) - 1)
                emitted_now = []
                for t in greedy[g, :commit[g]]:
                    emitted_now.append(int(t))
                    if int(t) == self.eos_id:
                        break   # tokens past EOS are never emitted
                run.results[rid].extend(emitted_now)
                sched.stats[rid]["token_walls"].extend([now] * len(emitted_now))
                sched.emitted[local] += len(emitted_now)
                ss["emitted"] += len(emitted_now)
                if (sched.emitted[local] >= sched.budgets[local]
                        or emitted_now[-1] == self.eos_id):
                    sched.release(local, run.tick)
                    run.pool = self._ops_reset(run.pool, g)
                else:
                    run.tok[g] = emitted_now[-1]
                    spec.on_emit(g, emitted_now)
        # the node draft rolls its pool forward by the committed tokens
        spec.commit(inputs, commit)

    def _serve_tick(self, run: _ServeRun):
        """One scheduler tick: idle fast-forward -> route arrivals ->
        admission -> decode -> SLO ladder -> cache TTL clock."""
        tick_was = run.tick
        if (run.fast_forward and not run.any_live() and not run.any_pending()
                and not run.any_queued() and run.queue and run.queue[0][0] > run.tick):
            run.tick = run.queue[0][0]  # idle: fast-forward to the next arrival
            # sweep the TTL clock across the jump BEFORE this tick's lookups
            self._cache_tick(run.tick - tick_was)
            tick_was = run.tick
        self._route_arrivals(run)
        self._tick_admission(run)
        decoded = self._tick_decode(run)
        if self.slo_degrade:
            gap_ms = None
            if decoded:
                now_slo = self._now()
                if self._slo_last_wall is not None:
                    gap_ms = (now_slo - self._slo_last_wall) * 1e3
                self._slo_last_wall = now_slo
            self._slo_update(run.hosts, gap_ms)
        self._cache_tick(run.tick - tick_was)

    def _serve_finish(self, run: _ServeRun, return_stats):
        out = {rid: np.array(toks, np.int32) for rid, toks in run.results.items()}
        if run.spec_adapt is not None:
            self.spec_stats.update(run.spec_adapt.stats())
        if not return_stats:
            return out
        stats: dict[int, dict] = {}
        for host in run.hosts:
            stats.update(host.sched.stats)
        return out, stats

    # ------------------------------------------------------------- wave
    @torch.no_grad()
    def _serve_wave(self, requests, slots, prompt_len, arrivals, rng_seed,
                    return_stats):
        """Admission-wave baseline: a whole wave drains before any queued
        request is admitted. Waves are rectangular: prompts are left-padded
        to the wave's longest (or ``prompt_len``) and prefilled in one
        monolithic dispatch; decode runs every row at full S. With a KV cache
        of ``max_len`` positions, a request that would push a row of the wave
        past it waits for the next wave (FIFO). Sampling draws
        from the same per-request streams as continuous mode."""
        results: dict[int, list[int]] = {}
        stats: dict[int, dict] = {}
        queue = self._queue(requests, arrivals, prompt_len)
        self.serve_stats = {"admission_dispatches": 0, "decode_dispatches": 0}
        draws = self.noise(rng_seed)
        tick = 0
        while queue:
            if queue[0][0] > tick:
                tick = queue[0][0]
            wave = []
            while queue and queue[0][0] <= tick and len(wave) < slots:
                # the padding to the wave's longest prompt counts against
                # every row's max_len; a request alone always fits (_queue)
                trial = wave + [queue[0]]
                plen_trial = prompt_len or max(len(r.prompt) for _, r in trial)
                if wave and self._length_bounded and any(
                        plen_trial + r.max_new_tokens > self.max_len for _, r in trial):
                    break
                wave.append(queue.pop(0))
            sched = Scheduler(len(wave))
            plen = prompt_len or max(len(r.prompt) for _, r in wave)
            prompts = np.stack([self._padded(r.prompt, plen) for _, r in wave])
            temps = np.array([self.temperature if r.temperature is None
                              else r.temperature for _, r in wave], np.float32)
            logits, state = self._run_prefill(prompts)
            tok = self._sample(draws, logits, [(r.id, 0) for _, r in wave], temps)
            for i, (arrival, r) in enumerate(wave):
                sched.bind(i, r, arrival, tick, prompt_tokens=len(r.prompt))
                results[r.id] = []
            while sched.live.any():
                new_live, new_emitted = advance_slots(
                    tok, sched.live, sched.emitted, sched.budgets, self.eos_id)
                now = self._now()
                for i in np.flatnonzero(sched.live):
                    results[sched.req[i].id].append(int(tok[i]))
                    sched.stats[sched.req[i].id]["token_walls"].append(now)
                sched.emitted = new_emitted
                for i in np.flatnonzero(sched.live & ~new_live):
                    sched.release(i, tick)
                if not sched.live.any():
                    break
                logits, state = self._run_decode(tok, state)
                rows = [(sched.req[i].id, int(sched.emitted[i])) if sched.live[i]
                        else None for i in range(len(wave))]
                tok = self._sample(draws, logits, rows, temps)
                tick += 1
            stats.update(sched.stats)
        out = {rid: np.array(toks, np.int32) for rid, toks in results.items()}
        return (out, stats) if return_stats else out
