"""Failure detection and chaos-injection primitives of the disaggregated
fleet: the JAX package's ``serving/disagg/failover.py``, pure Python.

Two pieces live here, both deterministic:

* :class:`FaultSchedule` — a seeded fault injector the transports consult
  on every send. Message-level faults (drop / duplicate / delay /
  corrupt) are decided by hashing ``(seed, frame bytes, attempt#)``: the
  SAME bytes re-sent get a FRESH decision on every attempt, so a retried
  message is not doomed to the fate of its first send, yet the whole
  fault sequence is a pure function of the seed and the message sequence
  — a chaos run replays bit-for-bit. Timed faults (endpoint kills,
  partitions) are keyed on the transport's simulated tick.

* :class:`Outbox` — at-least-once delivery bookkeeping for reliable
  message kinds (admit / handoff / steal_reply): each entry waits for a
  message-level ``ack``, is re-sent past its deadline with exponential
  backoff, and is handed to an ``on_dead`` recovery callback when its
  peer exhausts ``max_attempts`` (retry exhaustion doubles as a liveness
  signal alongside the heartbeat deadline). Deduplication lives on the
  RECEIVER (seen ``(src, msg_id)`` pairs + the handoff digest), so
  at-least-once delivery never double-processes.

Exactness under all of this is the sampler's contract: token streams are
pure functions of ``(rng_seed, request.id)`` and the number of steps a
row has taken — never of which host, tick, or attempt
carried the work — so requeue/retry/reorder can only ever re-derive the
identical tokens.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Callable, Optional

# faults never touch the process-level handshake: a corrupted `config`
# would fail the run before the recovery machinery even starts, which
# tests nothing
FAULTABLE_KINDS = ("admit", "handoff", "gossip", "steal", "steal_reply",
                   "heartbeat", "ack", "nack")

#: corruption variants cycled by hash — each exercises a distinct
#: reject path in ``wire.unpack_state`` (magic / version / truncation /
#: payload bit-flip -> digest mismatch)
_CORRUPTIONS = ("magic", "version", "truncate", "bitflip")


def corrupt_blob(blob: bytes, variant: str) -> bytes:
    """Return a corrupted copy of a wire blob (never mutates input)."""
    b = bytearray(blob)
    if variant == "magic":
        b[:4] = b"XXXX"
    elif variant == "version":
        # the <HHII fixed header starts right after the 8-byte magic
        struct.pack_into("<H", b, 8, 0x7FFF)
    elif variant == "truncate":
        del b[max(len(b) // 2, 24):]
    elif variant == "bitflip":
        b[-16] ^= 0xFF  # payload tail: header JSON parses, digest won't
    else:  # pragma: no cover
        raise ValueError(f"unknown corruption variant {variant!r}")
    return bytes(b)


class FaultSchedule:
    """Deterministic seeded fault plan for a chaos run.

    ``drop``/``dup``/``delay``/``corrupt`` are per-send probabilities
    (decided by hash, not an RNG stream — concurrent senders cannot
    perturb each other's draws). ``kills`` maps a tick to endpoint names
    that die at that tick (their inboxes are cleared and every later
    message to them is discarded). ``partitions`` is a list of
    ``(t0, t1, endpoint)`` windows during which messages to OR from the
    endpoint are dropped — the endpoint itself stays alive.

    ``corrupt`` only applies to messages carrying a wire blob
    (``payload["blob"]``); for other kinds a corrupt decision degrades
    to a drop (there is nothing to corrupt).
    """

    def __init__(self, seed: int = 0, *, drop: float = 0.0, dup: float = 0.0,
                 delay: float = 0.0, corrupt: float = 0.0, max_delay: int = 3,
                 kills: Optional[dict] = None, partitions: Optional[list] = None,
                 kinds: tuple = FAULTABLE_KINDS):
        for name, p in (("drop", drop), ("dup", dup), ("delay", delay),
                        ("corrupt", corrupt)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1] (got {p})")
        if drop + dup + delay + corrupt > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")
        self.seed = seed
        self.drop, self.dup = drop, dup
        self.delay, self.corrupt = delay, corrupt
        self.max_delay = max(1, int(max_delay))
        self.kills = {int(t): tuple(eps if isinstance(eps, (list, tuple))
                                    else (eps,))
                      for t, eps in (kills or {}).items()}
        self.partitions = [(int(a), int(b), ep)
                           for a, b, ep in (partitions or [])]
        self.kinds = tuple(kinds)
        self._attempts: dict[bytes, int] = {}

    def killed_at(self, tick: int) -> list:
        """Endpoints whose kill time is exactly ``tick``."""
        return list(self.kills.get(int(tick), ()))

    def partitioned(self, endpoint: str, tick: int) -> bool:
        return any(a <= tick < b and ep == endpoint
                   for a, b, ep in self.partitions)

    def _hash01(self, key: bytes, attempt: int) -> tuple[float, int]:
        h = hashlib.sha1(struct.pack("<qI", self.seed, attempt) + key).digest()
        u = int.from_bytes(h[:8], "little") / 2.0 ** 64
        return u, h[8]

    def action(self, kind: str, frame: bytes,
               has_blob: bool) -> tuple[Optional[str], int]:
        """Fault decision for one send of ``frame``.

        Returns ``(action, aux)`` where action is one of None / "drop" /
        "dup" / "delay" / "corrupt" and aux is the delay tick count or
        the corruption-variant index. Re-sends of the same bytes advance
        an attempt counter, so retries draw fresh decisions.
        """
        if kind not in self.kinds:
            return None, 0
        key = hashlib.sha1(frame).digest()
        attempt = self._attempts.get(key, 0)
        self._attempts[key] = attempt + 1
        u, aux = self._hash01(key, attempt)
        if u < self.drop:
            return "drop", 0
        u -= self.drop
        if u < self.dup:
            return "dup", 0
        u -= self.dup
        if u < self.delay:
            return "delay", 1 + aux % self.max_delay
        u -= self.delay
        if u < self.corrupt:
            if not has_blob:
                return "drop", 0
            return "corrupt", aux % len(_CORRUPTIONS)
        return None, 0

    @staticmethod
    def corruption_variant(idx: int) -> str:
        return _CORRUPTIONS[idx % len(_CORRUPTIONS)]


@dataclass
class _OutEntry:
    msg_id: int
    msg: object                 # the Message (re-sent verbatim)
    due: float                  # tick (loopback) or wall seconds (socket)
    attempts: int = 0
    wall: bool = False          # which time base `due` lives in


@dataclass
class Outbox:
    """At-least-once sender bookkeeping: unacked reliable messages with
    exponential-backoff retry. The owner drives it with ``tick()`` and
    feeds it ``ack``/``nack`` payloads; ``on_dead`` fires when a peer
    exhausts ``max_attempts`` (the retry-side liveness signal)."""

    retry_ticks: float = 2.0
    max_attempts: int = 8
    entries: dict = field(default_factory=dict)   # msg_id -> _OutEntry
    retries: int = 0
    max_backoff: float = 0.0

    def add(self, msg_id: int, msg, now: float, wall: bool = False):
        self.entries[msg_id] = _OutEntry(
            msg_id, msg, now + self.retry_ticks, wall=wall)

    def ack(self, msg_id: int) -> bool:
        return self.entries.pop(msg_id, None) is not None

    def nack(self, msg_id: int):
        """Make the entry due immediately (receiver rejected the bytes)."""
        ent = self.entries.get(msg_id)
        if ent is not None:
            ent.due = -1.0

    def pending_for(self, dst: str) -> list:
        return [e for e in self.entries.values() if e.msg.dst == dst]

    def drop_for(self, dst: str) -> list:
        """Remove and return every entry addressed to ``dst`` (peer
        declared dead: the owner re-routes or requeues them)."""
        out = [e for e in self.entries.values() if e.msg.dst == dst]
        for e in out:
            del self.entries[e.msg_id]
        return out

    def tick(self, now: float, wall: bool, send: Callable,
             on_dead: Callable):
        """Re-send every overdue entry in the matching time base; report
        peers that exhausted their attempts to ``on_dead(dst)``."""
        exhausted = set()
        for ent in list(self.entries.values()):
            if ent.wall != wall or ent.due > now:
                continue
            if ent.attempts + 1 >= self.max_attempts:
                exhausted.add(ent.msg.dst)
                continue
            ent.attempts += 1
            backoff = self.retry_ticks * (2.0 ** ent.attempts)
            self.max_backoff = max(self.max_backoff, backoff)
            ent.due = now + backoff
            self.retries += 1
            send(ent.msg)
        for dst in exhausted:
            on_dead(dst)

    def __len__(self):
        return len(self.entries)
