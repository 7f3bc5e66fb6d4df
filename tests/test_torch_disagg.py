"""The port's disaggregated prefill/decode serving
(``repro_torch.serving.disagg``) on the CPU: token for token against the
port's colocated ``serve`` (greedy at four fleet shapes, sampled, n-gram
spec, adaptive node masks, adaptive spec k, work stealing, gossip), flat
handoff bytes, the JAX package's ``DisaggController`` on the same weights
and trace (greedy streams, per-request handoff bytes, steal and gossip
counts), a socket prefill worker in a subprocess, and the CLI's report.

Weights come from the JAX package's ``init_lm`` at ``small_cfg`` sizes with
its ``STLT_KW`` (2 layers, d_model 32, S = 4, ``scan_layers=False``),
carried over by ``convert.from_jax_params``; the trace is
``tests/test_disagg.py``'s ``_trace``. The JAX controller runs are shared
by a module fixture.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import small_cfg  # noqa: E402
from test_disagg import _trace  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import DisaggController as JDisaggController  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import serve as t_serve_cli  # noqa: E402
from repro_torch.serving import (DisaggController, LoopbackTransport, PrefixCache,  # noqa: E402
                                 Request, ServeEngine)
from repro_torch.serving.disagg import worker as t_worker  # noqa: E402
from repro_torch.serving.disagg.transport import Message, SocketTransport  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

STLT_KW = dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8)
SMALL = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
             blockwise_threshold=10_000)
MAX_LEN, CHUNK = 160, 16
SRC = str(Path(__file__).resolve().parents[1] / "src")
WAIT_S = 60   # every wait on a worker process is bounded by this


def _model(**kw):
    kw = kw or STLT_KW
    jcfg, tcfg = small_cfg(**kw), TModelConfig(**{**SMALL, **kw})
    jparams = JT.init_lm(jax.random.key(0), jcfg)
    tparams = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _model()


def _port_requests(jreqs):
    return [Request(np.asarray(r.prompt), r.max_new_tokens, id=r.id,
                    temperature=r.temperature) for r in jreqs]


def _trace_port(cfg, **kw):
    jreqs, arrivals = _trace(cfg, **kw)
    return _port_requests(jreqs), arrivals, jreqs


def _colocated(tcfg, tparams, reqs, arrivals, seed=7, **kw):
    return ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu",
                       **kw).serve(reqs, slots=4, arrivals=arrivals, rng_seed=seed)


def _ctl(tcfg, tparams, n_p, n_d, slots, **kw):
    return DisaggController(tparams, tcfg, n_prefill=n_p, n_decode=n_d, slots=slots,
                            max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu", **kw)


def _same(base, out, reqs, ctx=""):
    assert sorted(out) == sorted(r.id for r in reqs), ctx
    for r in reqs:
        np.testing.assert_array_equal(base[r.id], out[r.id],
                                      err_msg=f"{ctx}: request {r.id} diverged")


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------


def test_loopback_transport_fifo_and_counters():
    tr = LoopbackTransport()
    tr.register("a")
    tr.register("b")
    for i in range(3):
        tr.send(Message("admit", "a", "b", {"i": i}))
    tr.send(Message("steal", "b", "a", {}))
    assert tr.pending() == 4
    assert [m.payload["i"] for m in tr.recv("b")] == [0, 1, 2]   # FIFO
    assert tr.recv("b") == []
    st = tr.stats()
    assert st["msgs"]["admit"] == 3 and st["msgs"]["steal"] == 1 and st["bytes"]["admit"] > 0
    with pytest.raises(KeyError):
        tr.send(Message("admit", "a", "nope", {}))
    with pytest.raises(ValueError):
        Message("bogus_kind", "a", "b")


# ---------------------------------------------------------------------------
# token for token against the port's colocated serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fleet", [(1, 1, 4), (2, 1, 2), (1, 2, 2), (2, 2, 2)])
def test_greedy_equals_colocated(model, fleet):
    _, tcfg, _, tparams = model
    reqs, arrivals, _ = _trace_port(tcfg)
    base = _colocated(tcfg, tparams, reqs, arrivals)
    ctl = _ctl(tcfg, tparams, *fleet)
    out, stats = ctl.serve(reqs, arrivals=arrivals, rng_seed=7, return_stats=True)
    _same(base, out, reqs, f"fleet={fleet}")
    assert set(ctl.handoff_bytes) == {r.id for r in reqs}
    assert not any(st["stolen"] for st in stats.values())
    assert ctl.transport.stats()["msgs"]["handoff"] == len(reqs)
    # the decode fleet prefills nothing; every request's prefill is billed
    # to the prefill fleet's clock
    assert ctl.decode.serve_stats["admission_dispatches"] == 0
    assert ctl.prefill.serve_stats["admission_dispatches"] > 0
    assert all(st["prefill_s"] > 0 and st["arrival_wall"] is not None
               for st in stats.values())
    assert ctl.prefill.clock > 0 and ctl.decode.clock > 0


def test_sampled_equals_colocated(model):
    _, tcfg, _, tparams = model
    reqs, arrivals, _ = _trace_port(tcfg, temps=[0.0, 0.8, 0.7, 0.0, 1.0, 0.5])
    base = _colocated(tcfg, tparams, reqs, arrivals, seed=11)
    out = _ctl(tcfg, tparams, 2, 1, 3).serve(reqs, arrivals=arrivals, rng_seed=11)
    _same(base, out, reqs, "sampled")
    greedy = _colocated(tcfg, tparams, _trace_port(tcfg)[0], arrivals, seed=11)
    assert any(not np.array_equal(out[i], greedy[i]) for i in (1, 2, 4, 5))


def test_ngram_spec_equals_colocated(model):
    _, tcfg, _, tparams = model
    reqs, arrivals, _ = _trace_port(tcfg, budget=lambda i: 8 + i % 5)
    base = _colocated(tcfg, tparams, reqs, arrivals, spec_k=3)
    ctl = _ctl(tcfg, tparams, 1, 2, 2, spec_k=3)
    _same(base, ctl.serve(reqs, arrivals=arrivals, rng_seed=7), reqs, "spec")
    assert ctl.decode.spec_stats["verify_calls"] > 0
    assert ctl.decode.serve_stats["decode_dispatches"] == 0


def test_adaptive_masks_equal_colocated():
    """The adaptive summaries ``asum``/``acnt`` ride the shipped state: the
    decode fleet recomputes the same masks."""
    _, tcfg, _, tparams = _model(**STLT_KW, stlt_adaptive=True)
    reqs, arrivals, _ = _trace_port(tcfg)
    base = _colocated(tcfg, tparams, reqs, arrivals)
    out = _ctl(tcfg, tparams, 2, 2, 2).serve(reqs, arrivals=arrivals, rng_seed=7)
    _same(base, out, reqs, "adaptive masks")


def test_adaptive_spec_k_equals_colocated(model):
    _, tcfg, _, tparams = model
    reqs, arrivals, _ = _trace_port(tcfg, budget=lambda i: 10 + i % 4)
    base = _colocated(tcfg, tparams, reqs, arrivals)
    kw = dict(spec_k=4, spec_adaptive=True, spec_accept_floor=0.9, spec_adapt_window=4,
              spec_adapt_recovery=2)
    ctl = _ctl(tcfg, tparams, 1, 1, 4, **kw)
    _same(base, ctl.serve(reqs, arrivals=arrivals, rng_seed=7), reqs, "adaptive k")
    assert ctl.decode.spec_stats["adapt_shrinks"] > 0


def test_steal_equals_colocated(model):
    _, tcfg, _, tparams = model
    reqs, _, _ = _trace_port(tcfg)
    arrivals = [0] * len(reqs)   # a burst: the 1-row prefill host drowns
    base = _colocated(tcfg, tparams, reqs, arrivals)
    ctl = _ctl(tcfg, tparams, 1, 1, 1, steal_threshold=1)
    out, stats = ctl.serve(reqs, arrivals=arrivals, rng_seed=7, return_stats=True)
    _same(base, out, reqs, "steal")
    assert ctl.steal_count > 0
    stolen = {rid for rid, st in stats.items() if st["stolen"]}
    assert stolen and stolen.isdisjoint(ctl.handoff_bytes)
    tst = ctl.transport.stats()["msgs"]
    assert tst["steal"] == tst["steal_reply"] >= ctl.steal_count
    assert ctl.decode.serve_stats["admission_dispatches"] > 0   # it prefilled its steals


def _gossip_requests(cfg, request):
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(3, cfg.vocab, 32).astype(np.int32)
    reqs = [request(np.concatenate([sys_prompt, rng.integers(3, cfg.vocab, 6).astype(np.int32)]),
                    4, id=i) for i in range(6)]
    return sys_prompt, reqs


def test_gossip_equals_colocated(model):
    _, tcfg, _, tparams = model
    sys_prompt, reqs = _gossip_requests(tcfg, Request)
    ctl = _ctl(tcfg, tparams, 3, 1, 2,
               prefix_cache_factory=lambda: PrefixCache(max_bytes=1 << 26))
    ctl.warm_prefix(sys_prompt)
    assert ctl.gossip_sent > 0 and ctl.transport.stats()["bytes"]["gossip"] > 0
    lens = [len(c) for c in ctl.prefill.caches]
    assert lens[0] > 0 and lens == [lens[0]] * 3
    out = ctl.serve(reqs, arrivals=[0] * 6, rng_seed=3)
    assert ctl.gossip_hit_rate() > 0
    base = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK,
                       device="cpu").serve(reqs, slots=6, rng_seed=3)
    _same(base, out, reqs, "gossip")


def test_handoff_bytes_flat_and_bf16_wire(model):
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(3, tcfg.vocab, n).astype(np.int32), 4, id=i)
            for i, n in enumerate((8, 128))]
    ctl = _ctl(tcfg, tparams, 1, 1, 2)
    out32 = ctl.serve(reqs, arrivals=[0, 0])
    assert ctl.handoff_bytes[0] == ctl.handoff_bytes[1]
    ctl16 = _ctl(tcfg, tparams, 1, 1, 2, wire_store="bf16")
    out16 = ctl16.serve(reqs, arrivals=[0, 0])
    assert ctl16.handoff_bytes[0] == ctl16.handoff_bytes[1]
    assert ctl16.handoff_bytes[0] / ctl.handoff_bytes[0] < 0.75
    assert all(len(out16[r.id]) == len(out32[r.id]) == 4 for r in reqs)


# ---------------------------------------------------------------------------
# against the JAX package's DisaggController
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX controller's greedy (2, 2) run, its steal run and its gossip
    run (streams, per-request handoff bytes, steal and gossip counts)."""
    jcfg, _, jparams, _ = model
    jreqs, arrivals = _trace(jcfg)
    greedy = JDisaggController(jparams, jcfg, n_prefill=2, n_decode=2, slots=2,
                               max_len=MAX_LEN, prefill_chunk=CHUNK)
    out = {"greedy": (greedy.serve(jreqs, arrivals=arrivals, rng_seed=7),
                      dict(greedy.handoff_bytes))}
    steal = JDisaggController(jparams, jcfg, n_prefill=1, n_decode=1, slots=1,
                              max_len=MAX_LEN, prefill_chunk=CHUNK, steal_threshold=1)
    out["steal"] = (steal.serve(jreqs, arrivals=[0] * len(jreqs), rng_seed=7),
                    steal.steal_count)
    from repro.serving.engine import Request as JRequest
    sys_prompt, greqs = _gossip_requests(jcfg, JRequest)
    gossip = JDisaggController(jparams, jcfg, n_prefill=3, n_decode=1, slots=2,
                               max_len=MAX_LEN, prefill_chunk=CHUNK,
                               prefix_cache_factory=lambda: JPrefixCache(max_bytes=1 << 26))
    gossip.warm_prefix(sys_prompt)
    out["gossip"] = (gossip.serve(greqs, arrivals=[0] * 6, rng_seed=3), gossip.gossip_sent,
                     gossip.gossip_hit_rate())
    return out


def test_greedy_streams_and_handoff_bytes_equal_jax(model, jax_runs):
    _, tcfg, _, tparams = model
    reqs, arrivals, _ = _trace_port(tcfg)
    ctl = _ctl(tcfg, tparams, 2, 2, 2)
    out = ctl.serve(reqs, arrivals=arrivals, rng_seed=7)
    jout, jbytes = jax_runs["greedy"]
    _same(jout, out, reqs, "vs JAX")
    assert ctl.handoff_bytes == jbytes


def test_steal_count_equals_jax(model, jax_runs):
    _, tcfg, _, tparams = model
    reqs, _, _ = _trace_port(tcfg)
    ctl = _ctl(tcfg, tparams, 1, 1, 1, steal_threshold=1)
    out = ctl.serve(reqs, arrivals=[0] * len(reqs), rng_seed=7)
    jout, jsteals = jax_runs["steal"]
    _same(jout, out, reqs, "steal vs JAX")
    assert ctl.steal_count == jsteals > 0


def test_gossip_counts_equal_jax(model, jax_runs):
    _, tcfg, _, tparams = model
    sys_prompt, reqs = _gossip_requests(tcfg, Request)
    ctl = _ctl(tcfg, tparams, 3, 1, 2,
               prefix_cache_factory=lambda: PrefixCache(max_bytes=1 << 26))
    ctl.warm_prefix(sys_prompt)
    out = ctl.serve(reqs, arrivals=[0] * 6, rng_seed=3)
    jout, jsent, jrate = jax_runs["gossip"]
    _same(jout, out, reqs, "gossip vs JAX")
    assert ctl.gossip_sent == jsent > 0
    assert ctl.gossip_hit_rate() == jrate


# ---------------------------------------------------------------------------
# the socket prefill worker
# ---------------------------------------------------------------------------


def _spawn_worker(port: int, name: str):
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving.disagg.worker", "--connect",
         f"127.0.0.1:{port}", "--name", name, "--device", "cpu", "--max-idle-s", str(WAIT_S)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _connect(tr, names, tcfg):
    deadline = time.monotonic() + WAIT_S
    hello = set()
    while hello != set(names) and time.monotonic() < deadline:
        hello |= {m.src for m in tr.recv("controller", timeout=0.2) if m.kind == "hello"}
    assert hello == set(names), f"workers never connected: {hello}"
    payload = {"cfg": t_worker.cfg_to_wire(tcfg), "seed": 0, "max_len": MAX_LEN,
               "prefill_chunk": CHUNK, "slots": 2, "prompt_len": None, "wire_store": "f32"}
    for n in names:
        tr.send(Message("config", "controller", n, payload))


def _watchdog(procs):
    """Kills the workers after WAIT_S: a hang ends as a failed test."""
    timer = threading.Timer(WAIT_S, lambda: [p.kill() for p in procs if p.poll() is None])
    timer.daemon = True
    timer.start()
    return timer


def test_socket_worker_equals_loopback():
    """One port worker process prefills over a socket: its streams are the
    in-process loopback run's, and it exits 0 after ``bye`` with its report
    line (its admission dispatches; no K1 launch on the CPU, where the
    wrapper runs the plain version)."""
    tcfg = TModelConfig(**{**SMALL, **STLT_KW})
    params = t_worker.build_params(tcfg, 0, "cpu")   # the worker's params
    reqs, arrivals, _ = _trace_port(tcfg)
    base = _ctl(tcfg, params, 1, 2, 2).serve(reqs, arrivals=arrivals, rng_seed=7)
    tr = SocketTransport("controller", listen=("127.0.0.1", 0))
    proc = _spawn_worker(tr._server.getsockname()[1], "prefill/0")
    timer = _watchdog([proc])
    try:
        _connect(tr, ["prefill/0"], tcfg)
        ctl = _ctl(tcfg, params, 1, 2, 2, transport=tr, remote_prefill=["prefill/0"],
                   heartbeat_deadline_s=WAIT_S / 2)
        out, stats = ctl.serve(reqs, arrivals=arrivals, rng_seed=7, return_stats=True)
        _same(base, out, reqs, "socket")
        assert ctl.fault_stats()["detected_failures"] == 0
        assert set(ctl.handoff_bytes) == {r.id for r in reqs}
        assert all(st["prefill_host"] == 0 and not st["stolen"] for st in stats.values())
        tr.send(Message("bye", "controller", "prefill/0", {}))
        err = proc.communicate(timeout=WAIT_S)[1].decode()
        assert proc.returncode == 0, err[-2000:]
        report = json.loads(err.strip().splitlines()[-1])
        assert report["worker"] == "prefill/0" and report["k1_launches"] == 0
        assert report["admission_dispatches"] > 0
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        tr.close()


@pytest.mark.slow
def test_socket_failover_sigkill_mid_trace():
    """Two workers, one SIGKILLed while it holds admits: the controller
    detects it (peer-down or the wall heartbeat deadline), routes its work
    to the survivor, and the trace completes token-identical to the
    in-process run."""
    tcfg = TModelConfig(**{**SMALL, **STLT_KW})
    params = t_worker.build_params(tcfg, 0, "cpu")
    reqs, arrivals, _ = _trace_port(tcfg, n=8)
    base = _ctl(tcfg, params, 2, 2, 2).serve(reqs, arrivals=arrivals, rng_seed=7)
    tr = SocketTransport("controller", listen=("127.0.0.1", 0))
    names = ["prefill/0", "prefill/1"]
    procs = [_spawn_worker(tr._server.getsockname()[1], n) for n in names]
    timer = _watchdog(procs)
    try:
        _connect(tr, names, tcfg)
        ctl = _ctl(tcfg, params, 1, 2, 2, transport=tr, remote_prefill=names,
                   heartbeat_deadline_s=3.0)

        def kill_when_loaded():
            stop = time.monotonic() + WAIT_S
            while time.monotonic() < stop:
                if ctl._remote_inflight.get(names[1]):
                    os.kill(procs[1].pid, signal.SIGKILL)
                    return
                time.sleep(0.02)

        killer = threading.Thread(target=kill_when_loaded, daemon=True)
        killer.start()
        out = ctl.serve(reqs, arrivals=arrivals, rng_seed=7)
        killer.join(timeout=5)
        assert procs[1].poll() is not None, "the victim was never killed"
        _same(base, out, reqs, "sigkill failover")
        f = ctl.fault_stats()
        assert f["detected_failures"] >= 1 and f["recovered_requests"] >= 1
        assert any(e["endpoint"] == names[1] for e in f["failures"])
        assert f["outbox_unacked"] == 0
        tr.send(Message("bye", "controller", names[0], {}))
        procs[0].wait(timeout=WAIT_S)
        assert procs[0].returncode == 0, procs[0].stderr.read().decode()[-2000:]
    finally:
        timer.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
        tr.close()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_role_disagg_reports(capsys):
    t_serve_cli.main(["--arch", "stlt-base", "--reduced", "--device", "cpu", "--role",
                      "disagg", "--prefill-hosts", "2", "--decode-hosts", "2", "--slots", "2",
                      "--requests", "5", "--max-new", "6", "--prefill-chunk", "16",
                      "--system-prompt-len", "24", "--wire-store", "bf16",
                      "--chaos-seed", "1"])
    out = capsys.readouterr().out
    assert "[serve] disagg: 2 prefill x 2 decode hosts (2 slots each), wire=bf16" in out
    assert "[serve] disagg role=disagg: 5 handoffs" in out
    assert "(flat in prompt length)" in out and "[serve] fleet clocks: prefill=" in out
    assert "[serve] faults: injected=" in out and "[serve] prefix cache:" in out
    with pytest.raises(SystemExit):
        t_serve_cli.main(["--reduced", "--device", "cpu", "--role", "disagg",
                          "--mode", "wave"])
