"""The port's fault-tolerant disaggregated serving on the CPU: the chaos
harness of ``tests/test_chaos.py`` run on ``repro_torch.serving.disagg``.

``FaultSchedule`` and ``Outbox`` decide exactly as the JAX package's do for
the same seed, frames and calls. The scenarios run on ``test_chaos.py``'s
``chaos_env`` trace (8 requests of 4-70 prompt tokens, bursty arrivals,
small_cfg sizes with ``STLT_KW``, the JAX package's weights carried over):
seeded message faults with a prefill-host kill, a decode-host kill re-spliced
from the kept blob, the whole decode fleet lost (colocated mode), short and
long partitions, corrupt handoffs nacked and re-sent, duplicates that never
splice twice, speculative decoding and adaptive masks under chaos. Every
stream must equal the fault-free port run's, and under a timed schedule
(kills, partitions: no decision hashes a frame, whose bytes differ between
the packages) ``fault_stats()`` must equal the JAX controller's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import small_cfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import DisaggController as JDisaggController  # noqa: E402
from repro.serving import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.serving import LoopbackTransport as JLoopbackTransport  # noqa: E402
from repro.serving import Outbox as JOutbox  # noqa: E402
from repro.serving.disagg.transport import Message as JMessage  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.serving import (DisaggController, FaultSchedule,  # noqa: E402
                                 LoopbackTransport, Outbox, Request)
from repro_torch.serving.disagg.transport import Message  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

STLT_KW = dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8)
SMALL = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
             blockwise_threshold=10_000)
MAX_LEN = 160
LENS = [4, 40, 9, 70, 25, 6, 50, 12]       # test_chaos.py's chaos_env
ARRIVALS = [0, 0, 1, 4, 4, 9, 9, 12]


# ---------------------------------------------------------------------------
# FaultSchedule and Outbox decide as the JAX package's do
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(drop=0.2, dup=0.2, delay=0.2, corrupt=0.2),
                                dict(drop=0.5), dict(corrupt=1.0, max_delay=5)])
def test_fault_schedule_decides_as_jax(kw):
    frames = [(kind, f"frame-{i % 11}".encode(), i % 3 == 0)
              for i, kind in enumerate(["admit", "handoff", "gossip", "ack", "config"] * 20)]
    for seed in (0, 7):
        ours, theirs = FaultSchedule(seed, **kw), JFaultSchedule(seed, **kw)
        got = [ours.action(k, f, b) for k, f, b in frames]
        assert got == [theirs.action(k, f, b) for k, f, b in frames]
        assert {a for a, _ in got} - {None}   # something was decided
    timed = dict(kills={5: "decode/0", 9: ("prefill/1", "decode/1")},
                 partitions=[(3, 7, "prefill/1")])
    ours, theirs = FaultSchedule(0, **timed), JFaultSchedule(0, **timed)
    for t in range(12):
        assert ours.killed_at(t) == theirs.killed_at(t)
        assert ours.partitioned("prefill/1", t) == theirs.partitioned("prefill/1", t)
    with pytest.raises(ValueError, match="sum"):
        FaultSchedule(0, drop=0.6, corrupt=0.6)


def test_outbox_backs_off_and_gives_up_as_jax():
    def drive(outbox_cls, message_cls):
        ob = outbox_cls(retry_ticks=2.0, max_attempts=4)
        sent, dead = [], []
        for mid, dst in enumerate(("prefill/0", "decode/1", "prefill/0")):
            ob.add(mid, message_cls("admit", "controller", dst, {"msg_id": mid}), now=0.0)
        log = []
        for now in (1.0, 3.0, 3.0, 8.0, 20.0, 50.0, 1e9):
            if now == 8.0:
                ob.nack(1)
                ob.ack(2)
            ob.tick(now, False, lambda m: sent.append((m.dst, m.payload["msg_id"])),
                    dead.append)
            log.append((len(ob), ob.retries, ob.max_backoff, list(sent), list(dead)))
        ob.add(9, message_cls("admit", "controller", "decode/0", {"msg_id": 9}), 0.0, wall=True)
        ob.tick(5.0, False, sent.append, dead.append)
        log.append((len(ob), [e.msg_id for e in ob.drop_for("decode/0")], len(ob)))
        return log

    assert drive(Outbox, Message) == drive(JOutbox, JMessage)


# ---------------------------------------------------------------------------
# the chaos scenarios
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_env():
    jcfg, tcfg = small_cfg(**STLT_KW), TModelConfig(**{**SMALL, **STLT_KW})
    jparams = JT.init_lm(jax.random.key(0), jcfg)
    tparams = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                      device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, jcfg.vocab, n).astype(np.int32) for n in LENS]
    reqs = [Request(p, 5 + i % 6, id=i) for i, p in enumerate(prompts)]
    jreqs = [JRequest(p, 5 + i % 6, id=i) for i, p in enumerate(prompts)]
    return tcfg, tparams, reqs, jcfg, jparams, jreqs


def _run(env, faults=None, **kw):
    tcfg, tparams, reqs = env[:3]
    ctl = DisaggController(tparams, tcfg, n_prefill=2, n_decode=2, slots=2,
                           max_len=MAX_LEN, prefill_chunk=16, transport=LoopbackTransport(),
                           faults=faults, device="cpu", **kw)
    return ctl, ctl.serve(reqs, arrivals=ARRIVALS, rng_seed=7)


@pytest.fixture(scope="module")
def baseline(chaos_env):
    return _run(chaos_env)[1]


def _assert_parity(base, out, ctx):
    assert set(out) == set(base)
    for rid in base:
        np.testing.assert_array_equal(base[rid], out[rid],
                                      err_msg=f"{ctx}: request {rid} diverged")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_message_faults_and_prefill_kill(chaos_env, baseline, seed):
    fs = FaultSchedule(seed, drop=0.1, dup=0.05, delay=0.1, corrupt=0.1,
                       kills={6: ("prefill/1",)})
    ctl, out = _run(chaos_env, faults=fs)
    _assert_parity(baseline, out, f"seed={seed}")
    f = ctl.fault_stats()
    assert f["detected_failures"] >= 1
    assert any(e["endpoint"] == "prefill/1" for e in f["failures"])
    assert sum(f["injected"].values()) > 0 and f["heartbeats_sent"] > 0
    assert f["outbox_unacked"] == 0


@pytest.mark.parametrize("timed", [dict(kills={8: ("decode/0",)}),
                                   dict(partitions=[(5, 60, "decode/1")])])
def test_timed_faults_equal_jax_fault_stats(chaos_env, baseline, timed):
    """A decode-host kill (its live rows re-spliced from the kept blobs) and
    a partition past the heartbeat deadline: the port's streams are the
    fault-free run's, and its fault accounting is the JAX controller's."""
    ctl, out = _run(chaos_env, faults=FaultSchedule(0, **timed))
    _assert_parity(baseline, out, f"timed {timed}")
    f = ctl.fault_stats()
    assert f["detected_failures"] >= 1
    if "kills" in timed:
        assert f["recovered_requests"] >= 1 and f["requeued_tokens"] > 0
        assert not f["degraded_colocated"]
    else:
        assert f["injected"]["partition_drops"] > 0
        assert any(e["endpoint"] == "decode/1" for e in f["failures"])
    _, _, _, jcfg, jparams, jreqs = chaos_env
    jctl = JDisaggController(jparams, jcfg, n_prefill=2, n_decode=2, slots=2,
                             max_len=MAX_LEN, prefill_chunk=16,
                             transport=JLoopbackTransport(), faults=JFaultSchedule(0, **timed))
    jout = jctl.serve(jreqs, arrivals=ARRIVALS, rng_seed=7)
    _assert_parity(jout, out, "vs JAX")
    assert f == jctl.fault_stats()


def test_full_decode_loss_degrades_colocated(chaos_env, baseline):
    ctl, out = _run(chaos_env, faults=FaultSchedule(0, kills={8: ("decode/0", "decode/1")}))
    _assert_parity(baseline, out, "degraded")
    f = ctl.fault_stats()
    assert f["degraded_colocated"] and f["detected_failures"] >= 2
    assert ctl.prefill.serve_stats["decode_dispatches"] > 0   # it decoded


def test_short_partition_heals_silently(chaos_env, baseline):
    ctl, out = _run(chaos_env, faults=FaultSchedule(0, partitions=[(5, 9, "decode/1")]))
    _assert_parity(baseline, out, "short partition")
    assert ctl.fault_stats()["detected_failures"] == 0


def test_corrupt_handoffs_nacked_and_resent(chaos_env, baseline):
    ctl, out = _run(chaos_env, faults=FaultSchedule(1, corrupt=0.6, kinds=("handoff",)))
    _assert_parity(baseline, out, "corrupt handoffs")
    f = ctl.fault_stats()
    assert f["corrupt_blobs_rejected"] > 0
    assert f["corrupt_blobs_rejected"] == f["injected"]["corrupted"]
    assert f["detected_failures"] == 0


def test_duplicates_never_double_splice(chaos_env, baseline):
    ctl, out = _run(chaos_env, faults=FaultSchedule(2, dup=0.4))
    _assert_parity(baseline, out, "duplicates")
    f = ctl.fault_stats()
    assert f["injected"]["duplicated"] > 0 and f["dup_msgs_ignored"] > 0
    ctl2, out2 = _run(chaos_env, faults=FaultSchedule(1, dup=0.3, drop=0.1,
                                                      kills={8: ("decode/0",)}))
    _assert_parity(baseline, out2, "dup+drop+kill")


def test_spec_decode_under_chaos(chaos_env):
    _, base = _run(chaos_env, spec_k=3)
    fs = FaultSchedule(0, drop=0.1, dup=0.1, delay=0.1, kills={7: ("decode/0",)})
    ctl, out = _run(chaos_env, faults=fs, spec_k=3)
    _assert_parity(base, out, "spec chaos")
    assert ctl.decode.spec_stats["verify_calls"] > 0


def test_adaptive_masks_under_chaos():
    kw = {**STLT_KW, "stlt_adaptive": True}
    jcfg, tcfg = small_cfg(**kw), TModelConfig(**{**SMALL, **kw})
    tparams = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg)), tcfg,
        device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(3, tcfg.vocab, n).astype(np.int32), 6, id=i)
            for i, n in enumerate([9, 40, 25, 50, 12, 6])]
    env = (tcfg, tparams, reqs)

    def run(faults=None):
        ctl = DisaggController(tparams, tcfg, n_prefill=2, n_decode=2, slots=2,
                               max_len=MAX_LEN, prefill_chunk=16, faults=faults, device="cpu")
        return ctl.serve(env[2], arrivals=[0, 0, 1, 4, 4, 9], rng_seed=7)

    _assert_parity(run(), run(FaultSchedule(1, drop=0.1, corrupt=0.1,
                                            kills={7: ("decode/1",)})), "adaptive chaos")


def test_report_surfaces_fault_stats(chaos_env):
    ctl, _ = _run(chaos_env, faults=FaultSchedule(0, drop=0.2))
    rep = ctl.report()
    assert rep["fault_stats"]["injected"]["dropped"] > 0
    assert "detected_failures" in rep["fault_stats"]
    assert rep["prefill_clock_s"] > 0 and rep["decode_clock_s"] > 0
