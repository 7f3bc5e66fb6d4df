"""The port's fault tolerance against the JAX package's four
tests/test_fault_tolerance.py cases: crash-restart reproduces the clean run
bit for bit, the loop gives up after ``max_failures``, the straggler
detector flags the same steps as the JAX package's on the same step times,
and the data pipeline replays exactly. The loop's stats equal the JAX
loop's on the same injector, with one fake clock feeding both (a wall
clock's step times differ between runs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.data import lm_batch_stream as j_lm_batch_stream  # noqa: E402
from repro.distributed import fault_tolerance as j_ft  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import lm_batch_stream  # noqa: E402
from repro_torch.distributed import fault_tolerance as t_ft  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)


def _step(state, step):
    """Deterministic toy train step: state = {w, seen}."""
    g = torch.sin(torch.arange(4.0) + step)   # step-indexed "data"
    return {"w": state["w"] - 0.01 * g, "seen": state["seen"] + step}


def _init():
    return {"w": torch.zeros(4), "seen": torch.zeros((), dtype=torch.int32)}


def _injector(crashes):
    crashes = set(crashes)

    def inject(step):
        if step in crashes:
            crashes.remove(step)
            raise t_ft.SimulatedHardwareFailure(f"chip lost at step {step}")
    return inject


def test_crash_restart_bitwise_matches_clean_run(tmp_path):
    state = _init()
    for s in range(40):
        state = _step(state, s)
    mgr = CheckpointManager(str(tmp_path), async_saves=False)
    stats = t_ft.run_resilient_loop(step_fn=_step, init_fn=_init, ckpt=mgr, total_steps=40,
                                    save_every=5, fail_injector=_injector({13, 27}))
    assert stats["restarts"] == 2 and stats["completed"]
    final, step = mgr.restore_or_init(_init)
    assert step == 39
    assert torch.equal(final["w"], state["w"]) and torch.equal(final["seen"], state["seen"])


def test_gives_up_after_max_failures(tmp_path):
    def always_fail(step):
        raise t_ft.SimulatedHardwareFailure("flaky host")

    mgr = CheckpointManager(str(tmp_path), async_saves=False)
    with pytest.raises(t_ft.SimulatedHardwareFailure):
        t_ft.run_resilient_loop(step_fn=_step, init_fn=_init, ckpt=mgr, total_steps=10,
                                max_failures=2, fail_injector=always_fail)


@pytest.mark.parametrize("times,threshold,warmup", [
    ([0.1] * 10 + [0.5] + [0.1] * 5, 2.0, 3),
    ([0.1, 0.3, 0.1, 0.9, 0.2, 0.2, 1.5, 0.1, 0.1, 0.7, 0.1, 2.0], 2.5, 5),
    (list(np.random.default_rng(0).exponential(0.1, 64)), 2.5, 5),
])
def test_straggler_detector_flags_what_jax_flags(times, threshold, warmup):
    jd = j_ft.StragglerDetector(threshold=threshold, warmup=warmup)
    td = t_ft.StragglerDetector(threshold=threshold, warmup=warmup)
    got = [i for i, t in enumerate(times) if td.observe(i, t)]
    want = [i for i, t in enumerate(times) if jd.observe(i, t)]
    assert got == want and td.flags == jd.flags and td.ewma == jd.ewma
    if threshold == 2.0:
        assert got == [10]


class _Clock:
    """time.time() stand-in: each reading advances by the next step time."""

    def __init__(self, dts):
        self.t, self.dts, self.i = 0.0, dts, 0

    def time(self):
        self.t += self.dts[self.i // 2 % len(self.dts)]
        self.i += 1
        return self.t


def test_loop_stats_equal_jax_on_the_same_injector(tmp_path, monkeypatch):
    """Crashes at steps 7 and 19 and a slow step every 9th reading: the
    port's loop and the JAX package's report the same stats."""
    dts = [0.1] * 8 + [0.9]

    @jax.jit
    def j_step(state, step):
        g = jnp.sin(jnp.arange(4.0) + step)
        return {"w": state["w"] - 0.01 * g, "seen": state["seen"] + step}

    def j_init():
        return {"w": jnp.zeros((4,)), "seen": jnp.zeros((), jnp.int32)}

    def j_injector(crashes):
        crashes = set(crashes)

        def inject(step):
            if step in crashes:
                crashes.remove(step)
                raise j_ft.SimulatedHardwareFailure(f"chip lost at step {step}")
        return inject

    monkeypatch.setattr(j_ft, "time", _Clock(dts))
    want = j_ft.run_resilient_loop(
        step_fn=j_step, init_fn=j_init, ckpt=JCheckpointManager(str(tmp_path / "j"),
                                                                  async_saves=False),
        total_steps=30, save_every=4, fail_injector=j_injector({7, 19}))
    monkeypatch.setattr(t_ft, "time", _Clock(dts))
    got = t_ft.run_resilient_loop(
        step_fn=_step, init_fn=_init, ckpt=CheckpointManager(str(tmp_path / "t"),
                                                             async_saves=False),
        total_steps=30, save_every=4, fail_injector=_injector({7, 19}))
    assert got == want and got["restarts"] == 2 and got["straggler_flags"] > 0


def test_data_pipeline_replay_is_exact():
    a = lm_batch_stream(0, 17, 4, 32, 100)
    b = lm_batch_stream(0, 17, 4, 32, 100)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    np.testing.assert_array_equal(a["inputs"], j_lm_batch_stream(0, 17, 4, 32, 100)["inputs"])
    c = lm_batch_stream(0, 18, 4, 32, 100)
    assert not np.array_equal(a["inputs"], c["inputs"])
