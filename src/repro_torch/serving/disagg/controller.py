"""Disaggregated prefill/decode controller: the JAX package's
``serving/disagg/controller.py`` on the port's engine.

``DisaggController`` splits the fleet into a prefill role (admission and
chunked prefill ONLY: its decode pool is never built) and a decode role
(decode and spec-verify ONLY: it prefills only stolen work), two
:class:`~repro_torch.serving.engine.ServeEngine` specializations driven
through the same tick phases. At promote time the prefill engine takes the
finished state in ``_handoff_promote``, packs it with :mod:`wire` (O(S*d),
flat in prompt length for STLT mixers) and ships it to the least-loaded
decode host; the decode engine admits it through ``_ready_state`` exactly
like a full-prompt prefix-cache hit. Every admission dispatch of the prefill
fleet runs K1 once per STLT layer; the decode fleet runs none.

Token exactness: chunked masked prefill equals monolithic, the first token's
noise is a function of ``(rng_seed, request.id)`` and decode streams depend
only on how many steps a row has taken, never on its host or tick. So the
shipped-state path emits token for token what the colocated engine emits,
at f32 wire storage, for any arrival schedule.

Failure model: at-least-once delivery with receiver-side idempotence on top
of the transports; dead peers are detected by heartbeat deadline, retry
exhaustion or a transport ``peer_down`` event, whichever fires first.
Detection fences the peer (a suspected-dead host is killed at the
transport, so a false suspicion becomes true rather than split-brain),
reroutes its unacked outbox entries and requeues its in-flight requests,
re-spliced from the controller-kept handoff blob when there is one and
re-prefilled otherwise. Every recovered request re-derives the same tokens;
the dedupe keys (``(src, msg_id)`` per message, ``req.id`` per splice) keep
at-least-once delivery from ever splicing twice. Losing the whole decode
fleet degrades to colocated mode: the prefill engine decodes locally.

Clocks: each role engine's ``_now()`` reads its fleet's own clock, which
advances by that fleet's own tick time only, measured after a device
synchronize (``torch.cuda.synchronize`` on the card): on one card this is
the model of role-isolated hardware, where a long admission burns the
prefill fleet's clock and decode gaps never see it. Unlike the JAX
package's, the clock also runs inside a tick (the time since the tick
began is added), so a token's stamp falls after its own dispatch. A
request's time to first token on these clocks is its prefill-fleet span
(``prefill_s`` in the merged stats: admit queue to handoff) plus its
decode-fleet span (first token's wall minus its ``arrival_wall``, both on
the decode clock).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serving.disagg.failover import FaultSchedule, Outbox
from repro_torch.serving.disagg.transport import LoopbackTransport, Message
from repro_torch.serving.disagg.wire import pack_state, unpack_state
from repro_torch.serving.engine import ServeEngine, _Host
from repro_torch.serving.prefix_cache import PrefixCache


def _host_logits(logits) -> np.ndarray:
    """First-token logits as float32 numpy, the form that crosses the wire
    (a tensor would be pickled onto the sender's device; widening a bf16
    logit is exact, so sampling from it picks the same token)."""
    return torch.as_tensor(logits).detach().float().cpu().numpy()


class _RoleEngine(ServeEngine):
    """A ServeEngine on its fleet's own clock, which can splice a state
    prefilled elsewhere (``_ready``): the decode role admits shipped
    handoffs this way, and the prefill role in degraded colocated mode
    resumes requests recovered from a dead decode fleet without prefilling
    them again."""

    role = "role"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.clock = 0.0
        self._tick_t0: Optional[float] = None
        self._ready: dict[int, tuple] = {}  # req.id -> (state, logits)

    def tick_start(self):
        self._tick_t0 = time.perf_counter()

    def tick_end(self):
        """Wait for the fleet's device work, then bill the tick to its clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.clock += time.perf_counter() - self._tick_t0
        self._tick_t0 = None

    def _now(self) -> float:
        if self._tick_t0 is None:
            return self.clock
        return self.clock + (time.perf_counter() - self._tick_t0)

    def _ready_state(self, req):
        return self._ready.pop(req.id, None)


class PrefillEngine(_RoleEngine):
    """Prefill-role engine: admission and chunked prefill; every promote is
    taken and handed off, so no decode pool, no sampling and no live rows,
    unless ``_handoff_fn`` is None (degraded colocated mode after the whole
    decode fleet is lost), when promotes go live here. One instance spans
    the whole prefill fleet (one prefill pool over all its hosts), with a
    prefix cache per host so gossip has something to replicate into."""

    role = "prefill"

    def __init__(self, params, cfg, *, n_hosts: int = 1, caches=None,
                 wire_store: str = "f32", wire_compress: Optional[str] = None,
                 **kwargs):
        super().__init__(params, cfg, **kwargs)
        self.n_hosts = n_hosts
        self.caches: list[Optional[PrefixCache]] = (
            list(caches) if caches is not None else [None] * n_hosts)
        if len(self.caches) != n_hosts:
            raise ValueError(f"need one cache slot per host "
                             f"({n_hosts} hosts, {len(self.caches)} caches)")
        # warm_prefix and the single-host helpers go through prefix_cache:
        # point them at host 0's cache; gossip replicates to the rest
        self.prefix_cache = self.caches[0]
        self.wire_store = wire_store
        self.wire_compress = wire_compress
        self.handoff_bytes: dict[int, int] = {}
        # set per serve by the controller: fn(h, req, ent, blob, logits);
        # None -> degraded colocated mode, promotes stay local
        self._handoff_fn: Optional[Callable] = None

    def _handoff_promote(self, run, h, local, ent, logits1, st1) -> bool:
        if self._handoff_fn is None:
            return False
        req = ent["req"]
        blob = pack_state(st1, store=self.wire_store, compress=self.wire_compress,
                          meta={"req_id": req.id, "prefill_host": h,
                                "n_prompt": len(ent["prompt"])})
        self.handoff_bytes[req.id] = len(blob)
        run.hosts[h].sched.stats[req.id]["handoff_wall"] = self._now()
        self._handoff_fn(h, req, ent, blob, _host_logits(logits1))
        return True

    def _ops_lookup(self, prompt, h: int):
        cache = self.caches[h]
        if cache is None:
            return 0, None, None
        entry = cache.lookup(prompt)
        if entry is None:
            return 0, None, None
        return entry.n_tokens, entry.state, entry.logits

    def _ops_cache_insert(self, prompt, n, state, logits, h: int):
        if self.caches[h] is not None and n > 0:
            self.caches[h].insert(np.asarray(prompt)[:n], state, logits)

    def _cache_tick(self, n: int):
        if n > 0:
            for cache in self.caches:
                if cache is not None:
                    cache.tick(n)


class DecodeEngine(_RoleEngine):
    """Decode-role engine: decode and spec-verify over shipped states. A
    request whose state arrived over the wire admits through
    ``_ready_state`` with no local prefill; stolen requests take the normal
    admission path and prefill here."""

    role = "decode"


def _new_fault_stat_counters() -> dict:
    return {"detected_failures": 0, "recovered_requests": 0,
            "requeued_tokens": 0, "corrupt_blobs_rejected": 0,
            "double_splices_prevented": 0, "dup_msgs_ignored": 0,
            "heartbeats_sent": 0, "rerouted_msgs": 0,
            "degraded_colocated": False}


class DisaggController:
    """Drives a prefill fleet and a decode fleet through the tick phases,
    every cross-role interaction a counted transport message (see the
    module docstring for the protocol).

    ``steal_threshold`` > 0 turns on work stealing: when the prefill
    fleet's unadmitted backlog (queued minus free prefill rows) reaches it
    and a decode host is idle, the youngest queued request moves to that
    decode host (steal + steal_reply messages) and is admitted there as a
    normal local prefill, token-exact all the same.

    ``remote_prefill`` names socket-connected prefill workers
    (:mod:`repro_torch.serving.disagg.worker`) used INSTEAD of the local
    prefill fleet; admits and handoffs then cross processes, and stealing
    is refused (the controller cannot see a remote queue).

    ``faults`` installs a seeded :class:`FaultSchedule` into the transport
    (the chaos harness). Reliable kinds (admit, handoff, steal_reply) ride
    an :class:`Outbox` with per-message acks and exponential-backoff retry;
    heartbeats every ``heartbeat_every`` ticks declare a peer down after
    ``heartbeat_deadline`` unanswered ticks (``heartbeat_deadline_s``
    seconds of wall clock for remote workers: keep it above a worker's
    longest healthy stall). The remaining keyword arguments (``spec_*``,
    ``slo_*``, ``serve_nodes``, ``device``, ...) reach both engines: in
    degraded colocated mode the prefill engine is the decode fleet.
    """

    def __init__(self, params, cfg, *, n_prefill: int = 1, n_decode: int = 1,
                 slots: int = 2, max_len: int = 4096,
                 temperature: float = 0.0, eos_id: int = -1, top_k: int = 0,
                 prefill_chunk: Optional[int] = 64,
                 transport=None, steal_threshold: int = 0,
                 wire_store: str = "f32", wire_compress: Optional[str] = None,
                 prefix_cache_factory: Optional[Callable] = None,
                 decode_prefix_cache: Optional[PrefixCache] = None,
                 remote_prefill: Optional[list] = None,
                 faults: Optional[FaultSchedule] = None,
                 heartbeat_every: int = 1, heartbeat_deadline: int = 8,
                 heartbeat_deadline_s: float = 30.0,
                 heartbeat_wall_every_s: float = 0.2,
                 retry_ticks: float = 2.0, retry_max_attempts: int = 8,
                 max_ticks: int = 100_000,
                 **decode_kwargs):
        if n_prefill < 1 or n_decode < 1 or slots < 1:
            raise ValueError("n_prefill, n_decode and slots must be >= 1")
        self.n_prefill = n_prefill
        self.n_decode = n_decode
        self.slots = slots
        self.steal_threshold = steal_threshold
        self.wire_store = wire_store
        self.wire_compress = wire_compress
        self.transport = transport if transport is not None else LoopbackTransport()
        self.faults = faults
        if faults is not None:
            self.transport.install_faults(faults)
        self.heartbeat_every = max(1, int(heartbeat_every))
        self.heartbeat_deadline = int(heartbeat_deadline)
        self.heartbeat_deadline_s = float(heartbeat_deadline_s)
        self.heartbeat_wall_every_s = float(heartbeat_wall_every_s)
        self.retry_ticks = float(retry_ticks)
        self.retry_max_attempts = int(retry_max_attempts)
        self.max_ticks = int(max_ticks)
        self.remote_prefill = list(remote_prefill or [])
        if self.remote_prefill and steal_threshold:
            raise ValueError("work stealing needs in-process prefill hosts "
                             "(the controller cannot see a remote queue)")
        caches = ([prefix_cache_factory() for _ in range(n_prefill)]
                  if prefix_cache_factory is not None else None)
        self.prefill = None
        if not self.remote_prefill:
            self.prefill = PrefillEngine(
                params, cfg, n_hosts=n_prefill, caches=caches,
                wire_store=wire_store, wire_compress=wire_compress,
                max_len=max_len, temperature=temperature, eos_id=eos_id,
                top_k=top_k, prefill_chunk=prefill_chunk, **decode_kwargs)
        self.decode = DecodeEngine(
            params, cfg, max_len=max_len, temperature=temperature,
            eos_id=eos_id, top_k=top_k, prefill_chunk=prefill_chunk,
            prefix_cache=decode_prefix_cache, **decode_kwargs)
        self.transport.register("controller")
        for h in range(n_prefill):
            if not self.remote_prefill:
                self.transport.register(f"prefill/{h}")
        for j in range(n_decode):
            self.transport.register(f"decode/{j}")
        self.steal_count = 0
        self.gossip_sent = 0
        self.handoff_bytes: dict[int, int] = {}
        self._pstats_remote: dict[int, dict] = {}
        self._admit_inflight = [0] * n_prefill
        self._serve_ctx: Optional[dict] = None
        self._reset_failure_state()

    def _reset_failure_state(self):
        """The failure layer's state, reset at every serve."""
        self.fault_stats_counters = _new_fault_stat_counters()
        self.fault_log: list[dict] = []
        self._outbox = Outbox(self.retry_ticks, self.retry_max_attempts)
        self._msg_seq = 0
        self._seen: set[tuple] = set()       # (src, msg_id) receiver dedupe
        self._spliced: set[int] = set()      # req.id splice dedupe
        self._handoff_keep: dict[int, tuple] = {}   # rid -> (blob, logits)
        self._limbo: dict[str, list] = {}    # dead ep -> evacuated work
        self._down: set[str] = set()         # endpoints declared down
        self._killed_seen: set[str] = set()  # sim-kills already evacuated
        self._last_hb: dict[str, int] = {}   # ep -> tick of last hb ack
        self._hb_wall: dict[str, float] = {}
        self._hb_wall_sent = 0.0
        self._hb_last_tick = -(1 << 30)
        self._hb_active = False
        self._degraded = False
        self._remote_inflight: dict[str, dict] = {}
        self._t = 0

    # ------------------------------------------------------------ warm prefix
    @torch.no_grad()
    def warm_prefix(self, prompt, chunk: Optional[int] = None) -> int:
        """Warm host 0's prefill cache (pinned boundary snapshots), then
        gossip every boundary entry to the other prefill hosts as wire
        blobs. Returns the tokens prefilled (0 on a full hit)."""
        if self.remote_prefill:
            raise ValueError("warm_prefix with remote prefill workers is "
                             "not supported yet")
        pe = self.prefill
        if pe.prefix_cache is None:
            raise ValueError("warm_prefix requires prefix_cache_factory")
        n_done = pe.warm_prefix(prompt, chunk)
        prompt = np.asarray(prompt, np.int32)
        chunk = chunk or pe.prefill_chunk or len(prompt)
        bounds = sorted({*range(chunk, len(prompt) + 1, chunk), len(prompt)})
        for b in bounds:
            entry = pe.caches[0].lookup(prompt[:b])
            if entry is None or entry.n_tokens != b:
                continue
            blob = pack_state(entry.state, store=self.wire_store,
                              compress=self.wire_compress, meta={"n_tokens": b})
            for h in range(1, self.n_prefill):
                self.transport.send(Message(
                    "gossip", "controller", f"prefill/{h}",
                    {"tokens": prompt[:b].copy(), "blob": blob,
                     "logits": _host_logits(entry.logits)}))
                self.gossip_sent += 1
        self._drain_prefill_inboxes([], 0)  # apply gossip before any serve
        return n_done

    def gossip_hit_rate(self) -> Optional[float]:
        """Hit rate of the gossip-fed caches (prefill hosts 1..n-1), whose
        only entries are gossiped: the direct measure of replication's
        value. None with one prefill host or no caches."""
        if self.remote_prefill or self.prefill is None:
            return None
        tried = hits = 0
        for cache in self.prefill.caches[1:]:
            if cache is None:
                continue
            st = cache.stats()
            tried += st["hits"] + st["misses"]
            hits += st["hits"]
        return (hits / tried) if tried else None

    # ------------------------------------------------------ reliable delivery
    def _send_reliable(self, msg: Message, wall: bool = False):
        """Stamp a msg_id, park the message in the retry outbox, send. Acks
        and nacks route back to the controller (the outbox's owner), never
        to ``msg.src``, which may be a fleet endpoint that dies while its
        message is in flight."""
        mid = self._msg_seq
        self._msg_seq += 1
        msg.payload["msg_id"] = mid
        msg.payload["ack_to"] = "controller"
        now = time.monotonic() if wall else self._t
        self._outbox.add(mid, msg, now, wall=wall)
        self.transport.send(msg)

    def _reliable_fresh(self, msg: Message, receiver: str) -> bool:
        """Receiver half of at-least-once: ALWAYS ack (even a duplicate:
        the sender's first ack may have been lost), process only fresh
        ``(src, msg_id)`` pairs."""
        mid = msg.payload.get("msg_id")
        if mid is None:
            return True
        self.transport.send(Message("ack", receiver, msg.payload.get("ack_to", msg.src),
                                    {"msg_id": mid}))
        key = (msg.src, mid)
        if key in self._seen:
            self.fault_stats_counters["dup_msgs_ignored"] += 1
            return False
        self._seen.add(key)
        return True

    def _handle_ack(self, msg: Message):
        p = msg.payload
        if "msg_id" in p:
            self._outbox.ack(p["msg_id"])
        if "hb" in p:
            if msg.src in self._remote_inflight:
                self._hb_wall[msg.src] = time.monotonic()
            else:
                self._last_hb[msg.src] = self._t

    # --------------------------------------------------------------- routing
    def _alive_prefill(self) -> list:
        return [h for h in range(self.n_prefill) if f"prefill/{h}" not in self._down]

    def _alive_decode(self) -> list:
        return [j for j in range(self.n_decode) if f"decode/{j}" not in self._down]

    def _pick_decode(self, d_hosts) -> int:
        return min(self._alive_decode(),
                   key=lambda i: (len(d_hosts[i].queue) + int(d_hosts[i].sched.live.sum())
                                  + int(d_hosts[i].sched.pending.sum()), i))

    def _route_admit(self, arrival, req):
        """Send a request to the least-loaded surviving host: remote workers
        first, then local prefill, then (both fleets gone, or a degraded
        colocated splice pending) straight to a decode host, which prefills
        it as it prefills stolen work."""
        ctx = self._serve_ctx
        if self.remote_prefill:
            alive = [n for n in self.remote_prefill if n not in self._down]
            if alive:
                name = min(alive, key=lambda n: ctx["outstanding"][n])
                ctx["outstanding"][name] += 1
                self._remote_inflight[name][req.id] = (arrival, req)
                self._send_reliable(Message("admit", "controller", name,
                                            {"req": req, "arrival": arrival}), wall=True)
                return
        elif self.prefill is not None:
            alive = self._alive_prefill()
            if alive:
                p_hosts = ctx["p_hosts"]
                h = min(alive, key=lambda i: (len(p_hosts[i].queue)
                                              + int(p_hosts[i].sched.pending.sum())
                                              + self._admit_inflight[i], i))
                self._admit_inflight[h] += 1
                self._send_reliable(Message("admit", "controller", f"prefill/{h}",
                                            {"req": req, "arrival": arrival}))
                return
        if not self._alive_decode():
            raise RuntimeError(f"no surviving hosts to serve request {req.id}")
        j = self._pick_decode(ctx["d_hosts"])
        self._send_reliable(Message("admit", "controller", f"decode/{j}",
                                    {"req": req, "arrival": arrival}))

    # ------------------------------------------------------------------ serve
    @torch.no_grad()
    def serve(self, requests, prompt_len: Optional[int] = None, arrivals=None,
              rng_seed: int = 0, return_stats: bool = False):
        """Serve a request list through the two fleets. Returns {request id:
        tokens} (plus merged per-request stats with ``return_stats``: the
        decode host's, with the prefill host's arrival, admission and
        prefill accounting, ``prefill_s`` on the prefill clock, the
        request's ``handoff_bytes`` and whether it was ``stolen``)."""
        de = self.decode
        pe = self.prefill
        queue = de._queue(requests, arrivals, prompt_len)
        d_hosts = [_Host(self.slots) for _ in range(self.n_decode)]
        d_run = de._serve_start(d_hosts, [], prompt_len, None, rng_seed,
                                de.prefill_chunk, True)
        d_run.fast_forward = False
        p_hosts = []
        p_run = None
        if pe is not None:
            pe.handoff_bytes = {}
            p_hosts = [_Host(self.slots) for _ in range(self.n_prefill)]
            p_run = pe._serve_start(p_hosts, [], prompt_len, None, rng_seed,
                                    pe.prefill_chunk, True)
            p_run.fast_forward = False
            pe._handoff_fn = self._make_handoff_fn(d_hosts)
            pe._ready = {}
        self.handoff_bytes = {}
        self._pstats_remote = {}
        de._ready = {}
        outstanding = {name: 0 for name in self.remote_prefill}
        self._reset_failure_state()
        self._remote_inflight = {name: {} for name in self.remote_prefill}
        self._admit_inflight = [0] * self.n_prefill
        self._serve_ctx = dict(queue=queue, p_hosts=p_hosts, p_run=p_run,
                               d_hosts=d_hosts, d_run=d_run, outstanding=outstanding)

        t = 0
        while queue or not self._all_idle():
            if t > self.max_ticks:
                raise RuntimeError(
                    f"serve did not converge within {self.max_ticks} ticks "
                    f"(outbox={len(self._outbox)}, limbo={len(self._limbo)}, "
                    f"down={sorted(self._down)})")
            self._t = t
            # chaos clock: scheduled kills land, delayed frames come due
            if hasattr(self.transport, "advance"):
                self.transport.advance(t)
            # a sim-killed host's work STOPS now (the process died)...
            self._observe_kills()
            # ...but the controller learns of it only by detection: transport
            # events (socket EOF/OSError), heartbeat deadline or retry
            # exhaustion, never by reading the kill schedule
            for ev in self.transport.events():
                for name in ev.get("peers", []):
                    if name != "<unidentified>":
                        self._declare_down(name, f"peer_down: {ev.get('reason')}")
            if queue and queue[0][0] > t and self._all_idle():
                dt = queue[0][0] - t
                t = queue[0][0]
                self._t = t
                if pe is not None:
                    pe._cache_tick(dt)
                de._cache_tick(dt)
                # nobody was probed across the jump: restart the liveness
                # window rather than expire every idle host
                for ep in list(self._last_hb):
                    self._last_hb[ep] = t

            self._heartbeat_tick(t)

            # 1. route arrived requests to the least-loaded surviving host
            while queue and queue[0][0] <= t:
                arrival, req = queue.pop(0)
                self._route_admit(arrival, req)

            # 2. prefill fleet: drain its inboxes, one admission phase on its
            # own clock (handoffs fire inside _tick_admission); in degraded
            # colocated mode the same engine also decodes
            if pe is not None:
                self._drain_prefill_inboxes(p_hosts, t)
                pe.tick_start()
                p_run.tick = t
                pe._tick_admission(p_run)
                if self._degraded:
                    decoded = pe._tick_decode(p_run)
                    self._slo_tick(pe, p_hosts, decoded)
                pe._cache_tick(1)
                # the device runs asynchronously: without the barrier in
                # tick_end the prefill work would land in the decode phase
                # and bill the decode fleet's clock
                pe.tick_end()

            # 3. steal: a deep unadmitted prefill backlog and an idle decode
            # host move the youngest queued request across roles
            if self.steal_threshold > 0 and pe is not None and not self._degraded:
                self._maybe_steal(p_hosts, d_hosts, d_run, t)

            # 4. decode fleet: drain its inboxes (handoffs -> ready states),
            # one admission and decode phase on its own clock
            self._drain_decode_inboxes(d_hosts, d_run, outstanding, t)
            de.tick_start()
            d_run.tick = t
            de._tick_admission(d_run)
            decoded = de._tick_decode(d_run)
            self._slo_tick(de, d_hosts, decoded)
            de._cache_tick(1)
            de.tick_end()

            # 5. retries in both time bases; exhaustion is the fallback
            # liveness signal
            self._outbox.tick(t, False, self.transport.send,
                              lambda dst: self._declare_down(dst, "retry exhaustion"))
            if self.remote_prefill:
                self._outbox.tick(time.monotonic(), True, self.transport.send,
                                  lambda dst: self._declare_down(dst, "retry exhaustion"))
            self._gc_handoff_keep()

            if (self.remote_prefill and not queue and not de._ready
                    and not d_run.any_live() and not d_run.any_pending()
                    and not any(h.queue for h in d_hosts) and not self._limbo):
                # everything outstanding is on a remote worker: poll the
                # socket instead of burning ticks
                time.sleep(0.001)
            else:
                t += 1

        if pe is not None:
            self.handoff_bytes.update(pe.handoff_bytes)
        out = de._serve_finish(d_run, return_stats)
        pres = {}
        if pe is not None and p_run.results:
            pout = pe._serve_finish(p_run, return_stats)
            pres = pout[0] if return_stats else pout
        if not return_stats:
            out.update(pres)   # degraded-mode completions override any
            return out         # partial stream from a dead decode host
        results, dstats = out
        results.update(pres)
        return results, self._merge_stats(dstats, p_hosts, pres)

    @staticmethod
    def _slo_tick(engine, hosts, decoded: bool):
        """The SLO ladder of one fleet (the colocated ``_serve_tick``'s
        block): under failover the surviving fleet takes the dead one's
        load, and the ladder sheds node budget instead of latency."""
        if not engine.slo_degrade:
            return
        gap_ms = None
        if decoded:
            now_slo = engine._now()
            if engine._slo_last_wall is not None:
                gap_ms = (now_slo - engine._slo_last_wall) * 1e3
            engine._slo_last_wall = now_slo
        engine._slo_update(hosts, gap_ms)

    # ------------------------------------------------------- failure handling
    def _work_outstanding(self) -> bool:
        """In-flight work only: future arrivals and heartbeat/ack traffic do
        not count, or the liveness machinery would keep itself alive probing
        an idle fleet."""
        ctx = self._serve_ctx
        d_run, p_run = ctx["d_run"], ctx["p_run"]
        if d_run.any_queued() or d_run.any_pending() or d_run.any_live():
            return True
        if p_run is not None and (p_run.any_queued() or p_run.any_pending()
                                  or p_run.any_live()):
            return True
        if self.decode._ready or (self.prefill is not None and self.prefill._ready):
            return True
        if self._limbo or len(self._outbox):
            return True
        return any(n > 0 for n in ctx["outstanding"].values())

    def _all_idle(self) -> bool:
        return not self._work_outstanding() and self.transport.pending() == 0

    def _observe_kills(self):
        """Sim-killed endpoints stop working at once (their local state died
        with the process): evacuate it to limbo. Recovery waits for the
        detection; routing keeps treating the host as alive until then."""
        dead = getattr(self.transport, "dead", None)
        if not dead:
            return
        ctx = self._serve_ctx
        for ep in sorted(dead):
            if ep in self._killed_seen:
                continue
            self._killed_seen.add(ep)
            lost = []
            if ep.startswith("prefill/") and self.prefill is not None:
                h = int(ep.split("/")[1])
                lost = self.prefill._evacuate_host(ctx["p_run"], h)
                if self.prefill.caches[h] is not None:
                    # the host's memory died with it; gossiped replicas on
                    # the survivors are the warm recovery path
                    self.prefill.caches[h].clear()
            elif ep.startswith("decode/"):
                j = int(ep.split("/")[1])
                lost = self.decode._evacuate_host(ctx["d_run"], j)
                for _kind, _arrival, req, _prog in lost:
                    # the shipped state lived in that process; recovery
                    # unpacks the controller-kept blob again
                    self.decode._ready.pop(req.id, None)
            if lost:
                self._limbo[ep] = lost

    def _heartbeat_tick(self, t: int):
        """Probe every endpoint not yet down while work is in flight, and
        declare down the peers whose acks go stale past the deadline."""
        fs = self.fault_stats_counters
        if not self._work_outstanding():
            self._hb_active = False
            return
        eps = []
        if self.prefill is not None:
            eps += [f"prefill/{h}" for h in self._alive_prefill()]
        eps += [f"decode/{j}" for j in self._alive_decode()]
        if not self._hb_active:
            # idle -> busy: restart every liveness window
            self._hb_active = True
            for ep in eps:
                self._last_hb[ep] = t
        if t - self._hb_last_tick >= self.heartbeat_every:
            self._hb_last_tick = t
            for ep in eps:
                self.transport.send(Message("heartbeat", "controller", ep, {"t": t}))
                fs["heartbeats_sent"] += 1
        for ep in eps:
            if t - self._last_hb.get(ep, t) > self.heartbeat_deadline:
                self._declare_down(ep, "heartbeat deadline")
        if self.remote_prefill:
            now = time.monotonic()
            alive = [n for n in self.remote_prefill if n not in self._down]
            if now - self._hb_wall_sent >= self.heartbeat_wall_every_s:
                self._hb_wall_sent = now
                for name in alive:
                    self.transport.send(Message("heartbeat", "controller", name, {"t": t}))
                    fs["heartbeats_sent"] += 1
            for name in alive:
                last = self._hb_wall.setdefault(name, now)
                if now - last > self.heartbeat_deadline_s:
                    self._declare_down(name, "heartbeat deadline")

    def _declare_down(self, ep: str, reason: str):
        """Failure detection: fence, reroute unacked messages, requeue
        in-flight work. Idempotent per endpoint, and safe on a false
        positive: fencing kills the suspected peer at the transport, so the
        declaration makes itself true, and requeued work re-derives the
        same tokens either way."""
        if self._serve_ctx is None or ep in self._down:
            return
        known = (ep in self._remote_inflight
                 or any(ep == f"prefill/{h}" for h in range(self.n_prefill))
                 or any(ep == f"decode/{j}" for j in range(self.n_decode)))
        if not known:
            return
        fs = self.fault_stats_counters
        self._down.add(ep)
        fs["detected_failures"] += 1
        self.fault_log.append({"endpoint": ep, "reason": reason, "tick": self._t})
        if hasattr(self.transport, "kill") and ep not in getattr(self.transport, "dead", ()):
            self.transport.kill(ep)
        self._observe_kills()  # a false positive: evacuate now (post-fence)
        if ep.startswith("prefill/") and ep not in self._remote_inflight:
            self._admit_inflight[int(ep.split("/")[1])] = 0
        # losing the LAST decode host turns colocated mode on BEFORE any
        # recovery below, so requeued work routes to the prefill engine
        if ep.startswith("decode/") and not self._alive_decode():
            if self.prefill is None:
                raise RuntimeError("decode fleet lost with remote-only prefill: "
                                   "no surviving engine")
            self._degraded = True
            fs["degraded_colocated"] = True
            self.prefill._handoff_fn = None
        for ent in self._outbox.drop_for(ep):
            self._reroute(ent.msg)
        for kind, arrival, req, prog in self._limbo.pop(ep, []):
            fs["recovered_requests"] += 1
            if ep.startswith("decode/"):
                emitted = (len(self._serve_ctx["d_run"].results.get(req.id, []))
                           if kind == "live" else 0)
                fs["requeued_tokens"] += emitted + prog
                self._requeue_decode(arrival, req)
            else:
                fs["requeued_tokens"] += prog
                self._route_admit(arrival, req)
        inflight = self._remote_inflight.get(ep)
        if inflight:
            self._remote_inflight[ep] = {}
            self._serve_ctx["outstanding"][ep] = 0
            for rid, (arrival, req) in inflight.items():
                if rid in self._spliced:
                    continue  # its handoff landed before the worker died
                fs["recovered_requests"] += 1
                self._route_admit(arrival, req)

    def _requeue_decode(self, arrival, req):
        """Recover a request lost with a decode host: splice it again from
        the kept handoff blob when there is one (no prefill work), else
        prefill it again. The same tokens either way."""
        rid = req.id
        de = self.decode
        ctx = self._serve_ctx
        alive_d = self._alive_decode()
        kept = self._handoff_keep.get(rid)
        if alive_d and (rid in de._ready or kept is not None):
            if rid not in de._ready:
                state, _digest, _meta = unpack_state(kept[0], device=de.device)
                de._ready[rid] = (state, kept[1])
            de._enqueue(ctx["d_run"], self._pick_decode(ctx["d_hosts"]), arrival, req)
            return
        if not alive_d and self.prefill is not None and kept is not None:
            # degraded colocated: splice on the prefill engine, the blob
            # sparing even the prefill
            state, _digest, _meta = unpack_state(kept[0], device=self.prefill.device)
            self.prefill._ready[rid] = (state, kept[1])
            self._route_admit(arrival, req)
            return
        # no kept state (stolen or directly admitted): prefill again; the
        # request must splice again when its fresh handoff arrives
        self._spliced.discard(rid)
        self._handoff_keep.pop(rid, None)
        self._route_admit(arrival, req)

    def _reroute(self, msg: Message):
        """An unacked message's peer died: issue the work elsewhere."""
        self.fault_stats_counters["rerouted_msgs"] += 1
        p = msg.payload
        if msg.kind in ("admit", "steal_reply"):
            self._route_admit(p["arrival"], p["req"])
        elif msg.kind == "handoff":
            req = p["req"]
            if req.id in self._spliced:
                return  # it DID land; only the ack was lost
            if self._alive_decode():
                self._send_reliable(Message(
                    "handoff", "controller",
                    f"decode/{self._pick_decode(self._serve_ctx['d_hosts'])}",
                    {"req": req, "blob": p["blob"], "logits": p["logits"],
                     "prefill_host": p.get("prefill_host")}))
            elif self.prefill is not None:
                state, _digest, _meta = unpack_state(p["blob"], device=self.prefill.device)
                self.prefill._ready[req.id] = (state, p["logits"])
                self._route_admit(self._t, req)
            else:
                raise RuntimeError("handoff unroutable: no surviving hosts")

    def _gc_handoff_keep(self):
        """Drop kept handoff blobs once their request has finished
        everywhere (at-least-once retention ends at completion)."""
        if not self._handoff_keep:
            return
        ctx = self._serve_ctx
        busy = set(self.decode._ready)
        if self.prefill is not None:
            busy |= set(self.prefill._ready)
        runs = [ctx["d_run"]] + ([ctx["p_run"]] if ctx["p_run"] is not None else [])
        for run in runs:
            for host in run.hosts:
                busy |= {req.id for _a, req in host.queue}
                busy |= {req.id for req in host.sched.req if req is not None}
        # limbo'd work has partial results but is NOT done: its kept blob is
        # what recovery splices again
        for entries in self._limbo.values():
            busy |= {req.id for _k, _a, req, _p in entries}
        for inflight in self._remote_inflight.values():
            busy |= set(inflight)
        done = ctx["d_run"].results
        pdone = ctx["p_run"].results if ctx["p_run"] is not None else {}
        for rid in list(self._handoff_keep):
            if rid not in busy and (rid in done or rid in pdone):
                del self._handoff_keep[rid]

    # ------------------------------------------------------------ serve parts
    def _make_handoff_fn(self, d_hosts):
        def handoff(h, req, ent, blob, logits):
            j = self._pick_decode(d_hosts)
            self._send_reliable(Message(
                "handoff", f"prefill/{h}", f"decode/{j}",
                {"req": req, "blob": blob, "logits": logits, "prefill_host": h}))
        return handoff

    def _drain_prefill_inboxes(self, p_hosts, t):
        pe = self.prefill
        fs = self.fault_stats_counters
        for h in range(self.n_prefill):
            ep = f"prefill/{h}"
            for msg in self.transport.recv(ep):
                if msg.kind == "admit":
                    if not self._reliable_fresh(msg, ep):
                        continue
                    pe._enqueue(self._serve_ctx["p_run"], h, msg.payload["arrival"],
                                msg.payload["req"])
                    self._admit_inflight[h] = max(0, self._admit_inflight[h] - 1)
                elif msg.kind == "gossip":
                    if pe.caches[h] is None:
                        continue
                    try:  # gossip is best-effort: a corrupt replica is
                        # dropped, never spliced and never retried
                        state, digest, _meta = unpack_state(msg.payload["blob"],
                                                            device=pe.device)
                    except ValueError:
                        fs["corrupt_blobs_rejected"] += 1
                        continue
                    pe.caches[h].insert(msg.payload["tokens"], state, msg.payload["logits"],
                                        pinned=True, digest=digest)
                elif msg.kind == "steal":
                    # reply with the youngest queued request (a tail steal
                    # keeps the FIFO order of everything already queued)
                    if p_hosts[h].queue:
                        arrival, req = p_hosts[h].queue.pop()
                        self._send_reliable(Message("steal_reply", ep, msg.src,
                                                    {"req": req, "arrival": arrival}))
                elif msg.kind == "heartbeat":
                    self.transport.send(Message("ack", ep, "controller",
                                                {"hb": msg.payload["t"]}))
                elif msg.kind == "ack":
                    self._handle_ack(msg)
                elif msg.kind == "nack":
                    self._outbox.nack(msg.payload["msg_id"])

    def _drain_decode_inboxes(self, d_hosts, d_run, outstanding, t):
        # remote workers address the controller; forward to a decode host
        for msg in self.transport.recv("controller"):
            if msg.kind == "handoff":
                src = msg.src
                rid = msg.payload["req"].id
                status = self._accept_handoff(
                    msg, self._pick_decode(d_hosts) if self._alive_decode() else None,
                    d_run, receiver="controller")
                if status == "corrupt":
                    continue  # the worker re-sends on the nack
                if src in self._remote_inflight:
                    if self._remote_inflight[src].pop(rid, None) is not None:
                        outstanding[src] -= 1
                if status == "spliced" and "pstats" in msg.payload:
                    self._pstats_remote[rid] = msg.payload["pstats"]
            elif msg.kind == "ack":
                self._handle_ack(msg)
            elif msg.kind == "nack":
                self._outbox.nack(msg.payload["msg_id"])
        for j in range(self.n_decode):
            ep = f"decode/{j}"
            for msg in self.transport.recv(ep):
                if msg.kind == "handoff":
                    self._accept_handoff(msg, j, d_run, receiver=ep)
                elif msg.kind in ("steal_reply", "admit"):
                    if self._reliable_fresh(msg, ep):
                        self.decode._enqueue(d_run, j, msg.payload["arrival"],
                                             msg.payload["req"])
                elif msg.kind == "heartbeat":
                    self.transport.send(Message("ack", ep, "controller",
                                                {"hb": msg.payload["t"]}))
                elif msg.kind == "ack":
                    self._handle_ack(msg)
                elif msg.kind == "nack":
                    self._outbox.nack(msg.payload["msg_id"])

    def _accept_handoff(self, msg, j: Optional[int], d_run, receiver: str) -> str:
        """Idempotent splice of a shipped state onto decode host ``j``.
        Returns "spliced", "dup" or "corrupt". A corrupt blob is NACKed (the
        sender re-sends, with a fresh fault decision); a duplicate is acked
        again but never spliced again."""
        de = self.decode
        fs = self.fault_stats_counters
        req = msg.payload["req"]
        rid = req.id
        mid = msg.payload.get("msg_id")
        ack_to = msg.payload.get("ack_to", msg.src)
        if mid is not None and (msg.src, mid) in self._seen:
            fs["dup_msgs_ignored"] += 1
            self.transport.send(Message("ack", receiver, ack_to, {"msg_id": mid}))
            return "dup"
        if j is None:
            # no surviving decode host to splice into: refuse, so the
            # sender's retry (or the recovery path) issues the work again
            if mid is not None:
                self.transport.send(Message("nack", receiver, ack_to, {"msg_id": mid}))
            return "corrupt"
        try:
            state, digest, _meta = unpack_state(msg.payload["blob"], device=de.device)
        except ValueError:
            fs["corrupt_blobs_rejected"] += 1
            if mid is not None:
                self.transport.send(Message("nack", receiver, ack_to, {"msg_id": mid}))
            return "corrupt"
        if mid is not None:
            self._seen.add((msg.src, mid))
            self.transport.send(Message("ack", receiver, ack_to, {"msg_id": mid}))
        if rid in self._spliced:
            # a re-sent handoff whose first copy landed (its ack was lost),
            # or a reroute raced by the original: NEVER splice twice
            fs["double_splices_prevented"] += 1
            return "dup"
        self._spliced.add(rid)
        # keep the blob until the request completes: the recovery source if
        # the decode host holding its live row dies
        self._handoff_keep[rid] = (msg.payload["blob"], msg.payload["logits"])
        de._ready[rid] = (state, msg.payload["logits"])
        self.handoff_bytes[rid] = len(msg.payload["blob"])
        if de.prefix_cache is not None:
            # a shipped full-prompt state slots into the decode fleet's
            # prefix cache under its wire digest: dedup against an earlier
            # ship of the same prefix is free
            de.prefix_cache.insert(np.asarray(req.prompt, np.int32), state,
                                   msg.payload["logits"], digest=digest)
        de._enqueue(d_run, j, d_run.tick, req)
        return "spliced"

    def _maybe_steal(self, p_hosts, d_hosts, d_run, t):
        alive_p = self._alive_prefill()
        free_prefill = sum(len(p_hosts[h].sched.free_slots()) for h in alive_p)
        backlog = sum(len(p_hosts[h].queue) for h in alive_p) - max(0, free_prefill)
        if backlog < self.steal_threshold:
            return
        for j in self._alive_decode():
            d_host = d_hosts[j]
            if d_host.queue or d_host.sched.live.any() or d_host.sched.pending.any():
                continue
            deepest = max(alive_p, key=lambda i: len(p_hosts[i].queue))
            if not p_hosts[deepest].queue:
                return
            self.transport.send(Message("steal", f"decode/{j}", f"prefill/{deepest}", {}))
            self._drain_prefill_inboxes(p_hosts, t)  # serve the steal now
            self.steal_count += 1
            backlog -= 1
            if backlog < self.steal_threshold:
                return

    def _merge_stats(self, dstats, p_hosts, pres):
        pstats = dict(self._pstats_remote)
        for host in p_hosts:
            pstats.update(host.sched.stats)
        merged = {}
        for rid, st in dstats.items():
            st = dict(st)
            st["decode_host"] = st.pop("host", None)
            if rid in pstats:
                ps = pstats[rid]
                # the prefill side's admission and prefill accounting (the
                # decode host saw the whole prompt as cached)
                st["arrival"] = ps["arrival"]
                st["admit"] = ps["admit"]
                st["prefilled_tokens"] = ps["prefilled_tokens"]
                st["cached_tokens"] = ps["cached_tokens"]
                st["prefill_host"] = ps.get("host")
                st["handoff_bytes"] = self.handoff_bytes.get(rid)
                if ps.get("arrival_wall") is not None and "handoff_wall" in ps:
                    st["prefill_s"] = ps["handoff_wall"] - ps["arrival_wall"]
                st["stolen"] = False
            else:
                st["stolen"] = True  # prefilled on the decode host itself
            merged[rid] = st
        # degraded colocated completions: the request finished ON the prefill
        # engine (the decode fleet was lost mid-serve)
        for rid, ps in pstats.items():
            if rid in merged or rid not in pres:
                continue
            st = dict(ps)
            st["decode_host"] = None
            st["prefill_host"] = st.pop("host", None)
            st["handoff_bytes"] = None
            st["stolen"] = False
            st["degraded"] = True
            merged[rid] = st
        return merged

    # ----------------------------------------------------------------- report
    def fault_stats(self) -> dict:
        """Failure-layer accounting: every injected fault in ``injected``
        (the transport's count) and every consequence (detections, retries,
        requeues, rejected blobs) in the controller's counters."""
        fs = dict(self.fault_stats_counters)
        fs["failures"] = list(self.fault_log)
        fs["retries"] = self._outbox.retries
        fs["max_backoff"] = self._outbox.max_backoff
        fs["outbox_unacked"] = len(self._outbox)
        fs["injected"] = dict(self.transport.stats().get("faults", {}))
        return fs

    def report(self) -> dict:
        hb = list(self.handoff_bytes.values())
        return {
            "n_prefill": self.n_prefill, "n_decode": self.n_decode,
            "wire_store": self.wire_store,
            "wire_compress": self.wire_compress,
            "handoff_requests": len(hb),
            "handoff_bytes_min": min(hb) if hb else 0,
            "handoff_bytes_max": max(hb) if hb else 0,
            "steal_count": self.steal_count,
            "gossip_sent": self.gossip_sent,
            "gossip_hit_rate": self.gossip_hit_rate(),
            "transport": self.transport.stats(),
            "fault_stats": self.fault_stats(),
            "prefill_clock_s": None if self.prefill is None else self.prefill.clock,
            "decode_clock_s": self.decode.clock,
        }
