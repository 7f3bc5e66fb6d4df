"""Multi-process prefill worker: ``python -m repro_torch.serving.disagg.worker
--connect HOST:PORT [--name prefill/0] [--device cpu]``.

Connects to a listening :class:`DisaggController` (or any driver speaking
the transport protocol), announces itself with ``hello``, and waits for a
``config`` message carrying the model config and the init seed: both sides
build the same params from the seed (``transformer.init_lm`` with a
generator on the device, then the serve CLI's ``cast_params_for_compute``),
so no weights cross the wire. Then it loops: ``admit`` messages queue
requests, each tick runs one admission phase of the engine's tick body
(K1 once per STLT layer per dispatch), and every finished prefill ships back
to the controller as a ``handoff`` wire blob (O(S*d), flat in prompt
length) with its first-token logits as float32 numpy. ``bye`` ends it,
after one JSON line on stderr: the worker's name, its dispatch counts and
the K1 launches of its process (``k1_launches``), so that a driver can hold
the worker's path to its kernel.

Fault tolerance: admits are deduplicated by ``(src, msg_id)`` and ALWAYS
acked (the controller retries unacked admits: at-least-once delivery,
exactly-once admission); handoffs ride the worker's own wall-clock retry
:class:`Outbox` until the controller acks them, and a ``nack`` (a blob
corrupt on arrival) re-sends at once. Heartbeats are answered with an
``ack`` carrying the probe's stamp. Losing the controller's connection
(surfaced by ``SocketTransport.events``) ends the worker cleanly: its
in-flight work is the controller's to requeue.

Work stealing does not cross processes (the controller cannot see a remote
queue): a remote worker only prefills. The worker runs on CUDA unless
``--device`` names another device; there is no fallback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import stlt_scan
from repro_torch.models import transformer as T
from repro_torch.serving.disagg.controller import PrefillEngine
from repro_torch.serving.disagg.failover import Outbox
from repro_torch.serving.disagg.transport import Message, SocketTransport
from repro_torch.serving.engine import _Host
from repro_torch.utils import cast_params_for_compute, resolve_device


def cfg_to_wire(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def cfg_from_wire(d: dict) -> ModelConfig:
    # a pickle round trip keeps tuples, a JSON one turns them into lists
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def build_params(cfg: ModelConfig, seed: int, device):
    """The serve CLI's params: ``init_lm`` from ``seed`` with a generator on
    ``device``, the matrices cast to the activation dtype."""
    device = resolve_device(device)
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    return cast_params_for_compute(params, cfg.act_dtype)


@torch.no_grad()
def run_worker(name: str, connect: tuple, poll_s: float = 0.01, max_idle_s: float = 60.0,
               device=None):
    device = resolve_device(device)
    tr = SocketTransport(name, connect=connect)
    tr.register(name)
    cfg = None
    deadline = time.monotonic() + max_idle_s
    while cfg is None:
        for msg in tr.recv(name, timeout=poll_s):
            if msg.kind == "config":
                cfg = msg
        if time.monotonic() > deadline:
            tr.close()
            raise TimeoutError("no config message from controller")
    p = cfg.payload
    model_cfg = cfg_from_wire(p["cfg"])
    engine = PrefillEngine(
        build_params(model_cfg, p["seed"], device), model_cfg, n_hosts=1,
        wire_store=p.get("wire_store", "f32"), wire_compress=p.get("wire_compress"),
        max_len=p.get("max_len", 4096), prefill_chunk=p.get("prefill_chunk", 64),
        device=device)
    hosts = [_Host(p.get("slots", 2))]
    run = engine._serve_start(hosts, [], p.get("prompt_len"), None, p.get("seed", 0),
                              engine.prefill_chunk, True)
    run.fast_forward = False

    outbox = Outbox(retry_ticks=p.get("retry_s", 0.5),
                    max_attempts=p.get("retry_max_attempts", 8))
    seen: set[tuple] = set()
    seq = {"n": 0}

    def handoff(h, req, ent, blob, logits):
        pstats = dict(hosts[0].sched.stats[req.id])
        pstats.pop("token_walls", None)
        mid = seq["n"]
        seq["n"] += 1
        msg = Message("handoff", name, "controller",
                      {"req": req, "blob": blob, "logits": logits,
                       "pstats": pstats, "msg_id": mid, "ack_to": name})
        outbox.add(mid, msg, time.monotonic(), wall=True)
        tr.send(msg)

    engine._handoff_fn = handoff
    deadline = time.monotonic() + max_idle_s
    while True:
        busy = bool(hosts[0].queue) or run.any_pending()
        for msg in tr.recv(name, timeout=0.0 if busy else poll_s):
            if msg.kind == "admit":
                mid = msg.payload.get("msg_id")
                if mid is not None:
                    tr.send(Message("ack", name, msg.payload.get("ack_to", msg.src),
                                    {"msg_id": mid}))
                    if (msg.src, mid) in seen:
                        continue  # the controller's retry of a landed admit
                    seen.add((msg.src, mid))
                engine._enqueue(run, 0, msg.payload.get("arrival", run.tick),
                                msg.payload["req"])
            elif msg.kind == "heartbeat":
                tr.send(Message("ack", name, "controller", {"hb": msg.payload.get("t")}))
            elif msg.kind == "ack":
                if "msg_id" in msg.payload:
                    outbox.ack(msg.payload["msg_id"])
            elif msg.kind == "nack":
                outbox.nack(msg.payload["msg_id"])
            elif msg.kind == "bye":
                tr.close()
                print(json.dumps({"worker": name, **engine.serve_stats,
                                  "k1_launches": stlt_scan.stlt_scan_kernel.launches}),
                      file=sys.stderr, flush=True)
                return
        # the controller's loss is surfaced, never silent: end cleanly, the
        # controller (or its successor) owns requeueing our in-flight work
        for ev in tr.events():
            if "controller" in ev.get("peers", ()):
                tr.close()
                return
        # on exhaustion stop retrying into a void (the idle timeout then
        # ends the worker if the controller never comes back)
        outbox.tick(time.monotonic(), True, tr.send, lambda dst: outbox.drop_for(dst))
        if hosts[0].queue or run.any_pending():
            run.tick += 1
            engine.tick_start()
            engine._tick_admission(run)
            engine._cache_tick(1)
            engine.tick_end()
            deadline = time.monotonic() + max_idle_s
        elif len(outbox):
            deadline = time.monotonic() + max_idle_s  # unacked handoffs
        elif time.monotonic() > deadline:
            tr.close()
            raise TimeoutError("idle past max_idle_s with no bye")


def main(argv=None):
    ap = argparse.ArgumentParser(description="disaggregated prefill worker")
    ap.add_argument("--connect", required=True, help="controller address host:port")
    ap.add_argument("--name", default="prefill/0")
    ap.add_argument("--max-idle-s", type=float, default=60.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    run_worker(args.name, (host, int(port)), max_idle_s=args.max_idle_s,
               device=args.device)


if __name__ == "__main__":
    main()
