"""Transports for the disaggregated fleet: the JAX package's
``serving/disagg/transport.py``, pure Python.

Every control-plane interaction is a :class:`Message` with one of a small
set of kinds:

* ``admit`` — controller -> prefill host: a routed arrival (the admission
  RPC; the request rides the message, prefill work stays host-local).
* ``handoff`` — prefill host -> decode host: the promote-time state ship —
  one :mod:`wire` blob (O(S*d), flat in prompt length) + the first-token
  logits + the prefill-side stats to merge.
* ``gossip`` — controller -> prefill hosts: a pinned warm-prefix cache
  entry (wire blob + boundary logits) replicated so every prefill host
  resumes shared system prompts without recomputing them.
* ``steal`` / ``steal_reply`` — decode host -> prefill host: an idle
  decode host requests queued-but-unadmitted work when prefill backlog
  crosses the steal threshold; the reply carries the stolen request, which
  the decode host then admits as a normal full local admission.
* ``hello`` / ``config`` / ``bye`` — multi-process handshake: a worker
  announces itself, the controller replies with the model config + seed so
  both sides build identical params, ``bye`` shuts the worker down.
* ``heartbeat`` — controller -> worker liveness probe (the worker answers
  with an ``ack``); a peer whose heartbeat acks stop for longer than the
  detection deadline is declared down and its in-flight work requeued.
* ``ack`` / ``nack`` — message-level delivery receipts for the reliable
  kinds (admit / handoff / steal_reply): ``ack`` clears the sender's
  retry outbox, ``nack`` reports a corrupted/unparseable blob and
  triggers an immediate re-send (reject-and-requeue, never a controller
  crash).

All transports serialize messages the same way (length-prefixed pickle),
so byte counters are identical across loopback and socket runs — the
flat-bytes acceptance numbers measured in-process hold verbatim for the
multi-process deployment.

Failure surfaces: both transports expose ``events()`` (drained
peer-down notifications — the socket transport converts EOF/``OSError``
into these instead of silently dropping the peer) and
``fault_counters`` (injected + observed fault accounting). The loopback
transport additionally accepts a seeded
:class:`~repro_torch.serving.disagg.failover.FaultSchedule` via
``install_faults`` and a simulated clock via ``advance(tick)`` — the
deterministic chaos harness.
"""
from __future__ import annotations

import copy
import pickle
import select
import socket
import struct
from collections import deque
from dataclasses import dataclass, field

from repro_torch.serving.disagg.failover import FaultSchedule, corrupt_blob

KINDS = ("admit", "handoff", "gossip", "steal", "steal_reply",
         "hello", "config", "bye", "heartbeat", "ack", "nack")


def _new_fault_counters() -> dict:
    return {"dropped": 0, "duplicated": 0, "delayed": 0, "corrupted": 0,
            "sends_to_dead": 0, "partition_drops": 0, "peer_down_events": 0,
            "recv_errors": 0, "send_errors": 0}


@dataclass
class Message:
    kind: str
    src: str
    dst: str
    payload: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown message kind {self.kind!r}")


def _frame(msg: Message) -> bytes:
    return pickle.dumps(msg, protocol=4)


class _Counters:
    def __init__(self):
        self.msgs: dict[str, int] = {k: 0 for k in KINDS}
        self.bytes: dict[str, int] = {k: 0 for k in KINDS}

    def count(self, kind: str, n: int):
        self.msgs[kind] += 1
        self.bytes[kind] += n

    def stats(self) -> dict:
        return {"msgs": dict(self.msgs), "bytes": dict(self.bytes),
                "total_bytes": sum(self.bytes.values()),
                "total_msgs": sum(self.msgs.values())}


class LoopbackTransport:
    """In-process deterministic transport: per-endpoint FIFO inboxes of
    SERIALIZED frames. Messages are pickled on send and unpickled on recv
    even though both ends share an address space — the wire protocol is
    exercised for real (no object aliasing) and the per-kind byte counters
    equal what the socket transport would put on the network.

    Chaos hook: ``install_faults(FaultSchedule)`` makes every send
    consult the seeded schedule — drop / duplicate / delay (delivered at
    a later simulated tick via ``advance``) / corrupt (the payload's
    wire blob is mangled; the message still parses, the blob does not) —
    and ``advance(tick)`` applies scheduled endpoint kills. A dead
    endpoint's inbox is cleared and every later send to it is discarded
    (``sends_to_dead``): exactly what a crashed process looks like from
    the wire. Detection stays the CONTROLLER's job (heartbeat deadlines,
    retry exhaustion) — the transport never announces a loopback kill."""

    def __init__(self, faults: FaultSchedule | None = None):
        self._inbox: dict[str, deque] = {}
        self.counters = _Counters()
        self.faults = faults
        self.fault_counters = _new_fault_counters()
        self.tick = 0
        self.dead: set[str] = set()
        self._delayed: list = []   # (due_tick, dst, frame)

    def install_faults(self, faults: FaultSchedule):
        self.faults = faults

    def register(self, name: str):
        self._inbox.setdefault(name, deque())

    def kill(self, name: str):
        """Endpoint dies NOW: inbox lost, all future sends discarded."""
        self.dead.add(name)
        self._inbox.get(name, deque()).clear()
        self._delayed = [(d, dst, f) for d, dst, f in self._delayed
                         if dst != name]

    def advance(self, tick: int):
        """Move the simulated clock: apply scheduled kills, deliver
        delayed frames that have come due. Kills are applied for EVERY
        schedule entry at or before ``tick`` (idempotent) — an idle
        fast-forward jump over the kill time must not resurrect the
        host."""
        self.tick = tick
        if self.faults is not None:
            for kt in sorted(self.faults.kills):
                if kt <= tick:
                    for ep in self.faults.kills[kt]:
                        if ep not in self.dead:
                            self.kill(ep)
        if self._delayed:
            still = []
            for due, dst, frame in self._delayed:
                if due <= tick:
                    if dst in self.dead:
                        self.fault_counters["sends_to_dead"] += 1
                    else:
                        self._inbox[dst].append(frame)
                else:
                    still.append((due, dst, frame))
            self._delayed = still

    def _deliver(self, dst: str, frame: bytes):
        if dst in self.dead:
            self.fault_counters["sends_to_dead"] += 1
            return
        self._inbox[dst].append(frame)

    def send(self, msg: Message) -> bool:
        if msg.dst not in self._inbox:
            raise KeyError(f"unknown endpoint {msg.dst!r} "
                           f"(registered: {sorted(self._inbox)})")
        fc = self.fault_counters
        if self.faults is not None and (
                self.faults.partitioned(msg.src, self.tick)
                or self.faults.partitioned(msg.dst, self.tick)):
            # the frame "went on the wire" (counted) but never arrives
            raw = _frame(msg)
            self.counters.count(msg.kind, len(raw))
            fc["partition_drops"] += 1
            return True
        action, aux = (None, 0)
        if self.faults is not None:
            probe = _frame(msg)
            action, aux = self.faults.action(
                msg.kind, probe, has_blob="blob" in msg.payload)
        if action == "corrupt":
            msg = copy.copy(msg)
            msg.payload = dict(msg.payload)
            msg.payload["blob"] = corrupt_blob(
                msg.payload["blob"], FaultSchedule.corruption_variant(aux))
            fc["corrupted"] += 1
        raw = _frame(msg)
        self.counters.count(msg.kind, len(raw))
        if msg.dst in self.dead:
            fc["sends_to_dead"] += 1
            return True
        if action == "drop":
            fc["dropped"] += 1
        elif action == "dup":
            fc["duplicated"] += 1
            self._deliver(msg.dst, raw)
            self._deliver(msg.dst, raw)
        elif action == "delay":
            fc["delayed"] += 1
            self._delayed.append((self.tick + aux, msg.dst, raw))
        else:
            self._deliver(msg.dst, raw)
        return True

    def recv(self, name: str) -> list[Message]:
        """Drain endpoint ``name``'s inbox (FIFO), possibly empty. A dead
        endpoint receives nothing (there is no process left to read)."""
        if name in self.dead:
            return []
        box = self._inbox[name]
        out = []
        while box:
            out.append(pickle.loads(box.popleft()))
        return out

    def events(self) -> list[dict]:
        """Loopback kills are schedule-driven and deliberately silent —
        liveness must come from heartbeat deadlines / retry exhaustion."""
        return []

    def pending(self) -> int:
        return (sum(len(b) for b in self._inbox.values())
                + len(self._delayed))

    def stats(self) -> dict:
        return {**self.counters.stats(), "faults": dict(self.fault_counters)}

    def close(self):
        self._inbox.clear()
        self._delayed.clear()


class SocketTransport:
    """Multi-process transport over TCP: 4-byte length-prefixed pickle
    frames, one long-lived connection per remote worker.

    Controller side (``listen=addr``): accepts workers, who identify
    themselves with a ``hello`` message; thereafter ``send`` routes by
    ``msg.dst`` over the matching connection. Worker side
    (``connect=addr``): a single connection to the controller; every send
    goes up that pipe regardless of ``dst`` (the controller forwards).
    ``recv`` never blocks — it drains whatever frames have arrived.

    Failure surfacing: a recv EOF, a recv ``OSError`` or a send
    ``OSError`` NEVER silently drops a peer — each one increments a
    fault counter and appends a ``peer_down`` event that ``events()``
    hands to the controller (which requeues the peer's in-flight work).
    ``install_faults`` enables the chaos schedule on the send path
    (drop / dup / corrupt; a "delay" decision degrades to a drop — a
    dropped frame is an unbounded delay, recovered by the retry layer).
    """

    def __init__(self, name: str, listen: tuple | None = None,
                 connect: tuple | None = None,
                 faults: FaultSchedule | None = None):
        if (listen is None) == (connect is None):
            raise ValueError("exactly one of listen=/connect= is required")
        self.name = name
        self.counters = _Counters()
        self.faults = faults
        self.fault_counters = _new_fault_counters()
        self._events: list[dict] = []
        self._peers: dict[str, socket.socket] = {}
        self._bufs: dict[socket.socket, bytearray] = {}
        self._queue: dict[str, deque] = {}
        self._server = None
        if listen is not None:
            self._server = socket.create_server(listen)
            self._server.setblocking(False)
        else:
            sock = socket.create_connection(connect)
            sock.setblocking(False)
            self._peers["controller"] = sock
            self._bufs[sock] = bytearray()
            self.send(Message("hello", src=name, dst="controller"))

    def install_faults(self, faults: FaultSchedule):
        self.faults = faults

    def register(self, name: str):
        self._queue.setdefault(name, deque())

    # --- wire helpers ----------------------------------------------------
    def _send_raw(self, sock: socket.socket, raw: bytes):
        sock.sendall(struct.pack("<I", len(raw)) + raw)

    def _pump(self, timeout: float = 0.0):
        """Accept new connections and drain readable sockets into frames."""
        if self._server is not None:
            try:
                while True:
                    conn, _ = self._server.accept()
                    conn.setblocking(False)
                    self._bufs[conn] = bytearray()
            except (BlockingIOError, OSError):
                pass
        socks = [s for s in self._bufs]
        if not socks:
            return
        readable, _, _ = select.select(socks, [], [], timeout)
        for sock in readable:
            try:
                data = sock.recv(1 << 20)
            except BlockingIOError:
                continue
            except OSError as e:
                self.fault_counters["recv_errors"] += 1
                self._drop(sock, reason=f"recv: {e!r}")
                continue
            if not data:
                self._drop(sock, reason="eof")
                continue
            buf = self._bufs[sock]
            buf.extend(data)
            while len(buf) >= 4:
                (n,) = struct.unpack("<I", buf[:4])
                if len(buf) < 4 + n:
                    break
                raw = bytes(buf[4:4 + n])
                del buf[:4 + n]
                msg: Message = pickle.loads(raw)
                if msg.kind == "hello" and self._server is not None:
                    self._peers[msg.src] = sock
                self._queue.setdefault(msg.dst, deque()).append(msg)

    def _drop(self, sock, reason: str = "closed", quiet: bool = False):
        """Close a peer socket. Unless ``quiet`` (our own deliberate
        ``close()``), the drop is ALWAYS counted and surfaced as a
        ``peer_down`` event naming the endpoints that vanished (a partial
        frame left in its buffer is reported too: a mid-frame death is a
        truncation the controller must know about)."""
        buf = self._bufs.pop(sock, None)
        names = [k for k, s in self._peers.items() if s is sock]
        for k in names:
            del self._peers[k]
        if not quiet:
            self.fault_counters["peer_down_events"] += 1
            self._events.append(
                {"event": "peer_down",
                 "peers": names or ["<unidentified>"],
                 "reason": reason,
                 "partial_frame_bytes": len(buf) if buf else 0})
        try:
            sock.close()
        except OSError:
            pass

    # --- Transport API ---------------------------------------------------
    def send(self, msg: Message) -> bool:
        action, aux = (None, 0)
        if self.faults is not None:
            probe = _frame(msg)
            action, aux = self.faults.action(
                msg.kind, probe, has_blob="blob" in msg.payload)
        if action == "corrupt":
            msg = copy.copy(msg)
            msg.payload = dict(msg.payload)
            msg.payload["blob"] = corrupt_blob(
                msg.payload["blob"], FaultSchedule.corruption_variant(aux))
            self.fault_counters["corrupted"] += 1
        raw = _frame(msg)
        self.counters.count(msg.kind, len(raw))
        if action in ("drop", "delay"):
            self.fault_counters["dropped" if action == "drop"
                                else "delayed"] += 1
            return True
        if self._server is None:
            sock = self._peers.get("controller")
            if sock is None:
                self.fault_counters["sends_to_dead"] += 1
                return False
        else:
            # route by destination endpoint owner: "prefill/2" -> worker
            # that said hello as "prefill/2" (or local queue if unknown)
            sock = self._peers.get(msg.dst)
            if sock is None:
                self._queue.setdefault(msg.dst, deque()).append(msg)
                return True
        n_sends = 2 if action == "dup" else 1
        if action == "dup":
            self.fault_counters["duplicated"] += 1
        sock.setblocking(True)
        try:
            for _ in range(n_sends):
                self._send_raw(sock, raw)
        except OSError as e:
            self.fault_counters["send_errors"] += 1
            self._drop(sock, reason=f"send: {e!r}")
            return False
        finally:
            try:
                sock.setblocking(False)
            except OSError:
                pass
        return True

    def recv(self, name: str, timeout: float = 0.0) -> list[Message]:
        self._pump(timeout)
        box = self._queue.setdefault(name, deque())
        out = []
        while box:
            out.append(box.popleft())
        return out

    def events(self) -> list[dict]:
        """Drain peer-down notifications accumulated since the last call
        (the controller turns these into requeue + re-route actions)."""
        self._pump()
        out, self._events = self._events, []
        return out

    def pending(self) -> int:
        self._pump()
        return sum(len(b) for b in self._queue.values())

    def stats(self) -> dict:
        return {**self.counters.stats(), "faults": dict(self.fault_counters)}

    def close(self):
        for sock in list(self._bufs):
            self._drop(sock, reason="close", quiet=True)
        self._events.clear()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
