"""Fault tolerance: checkpoint-restart supervision, elastic re-meshing and
straggler detection, the port of the JAX package's
``distributed/fault_tolerance.py``.

A hardware failure (a card down, a host dropped) is simulated at the step
function's boundary: any exception from a step, an injected
``SimulatedHardwareFailure`` included, takes the recovery path a real job
takes:

  1. abandon in-flight device state,
  2. (elastic) build a fresh mesh from the surviving ranks (``remesh``),
  3. restore params and optimizer state from the last checkpoint,
  4. fast-forward the deterministic data pipeline to the restored step,
  5. resume.

In a job of several ranks each rank supervises its own shards with its own
checkpoint directory; a failure raised at the same step on every rank (as
an injector keyed on the step is) restarts them together.

Straggler mitigation: a per-step wall-time EWMA with an outlier threshold
(the same alpha, threshold and warm-up as the JAX package's); flagged
steps go to ``on_straggler``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import sharding as sh


class SimulatedHardwareFailure(RuntimeError):
    """Injected by tests to exercise the recovery path."""


class StragglerDetector:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.5, warmup: int = 5):
        self.alpha, self.threshold, self.warmup = alpha, threshold, warmup
        self.ewma: Optional[float] = None
        self.count = 0
        self.flags: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = self.count > self.warmup and dt > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flags.append(step)
        return slow


def run_resilient_loop(
    *,
    step_fn: Callable,              # (state, step) -> state
    init_fn: Callable[[], Any],     # builds a fresh state
    ckpt: CheckpointManager,
    total_steps: int,
    save_every: int = 50,
    max_failures: int = 3,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
    on_straggler: Optional[Callable[[int], None]] = None,
    fail_injector: Optional[Callable[[int], None]] = None,
) -> dict:
    """Checkpoint-restart training supervisor. Returns run stats."""
    failures = 0
    detector = StragglerDetector()
    state, restored_step = ckpt.restore_or_init(init_fn)
    step = restored_step + 1
    stats = {"restarts": 0, "straggler_flags": 0, "completed": False}
    while step < total_steps:
        try:
            if fail_injector is not None:
                fail_injector(step)
            t0 = time.time()
            state = step_fn(state, step)
            dt = time.time() - t0
            if detector.observe(step, dt):
                stats["straggler_flags"] += 1
                if on_straggler:
                    on_straggler(step)
            if step % save_every == 0:
                ckpt.save(step, state)
            step += 1
        except Exception as e:  # noqa: BLE001 - supervisor boundary
            failures += 1
            stats["restarts"] += 1
            if on_failure:
                on_failure(step, e)
            if failures > max_failures:
                raise
            # recovery: restore from the checkpoint, replay data from there
            ckpt.wait()
            state, restored_step = ckpt.restore_or_init(init_fn)
            step = restored_step + 1
    ckpt.wait()
    ckpt.save(total_steps - 1, state)
    ckpt.wait()
    stats["completed"] = True
    stats["final_step"] = total_steps - 1
    return stats


def remesh(tree: Any, specs: Any, mesh, new_specs: Any, new_mesh) -> Any:
    """Elastic re-scale: re-place this rank's shards of ``tree`` (laid out by
    ``specs`` over ``mesh``) on ``new_mesh`` by ``new_specs`` (say 2 x 2 ->
    1 x 2 after a data rank is lost). Gathers every leaf over the old mesh
    (a collective of its ranks), then takes the new slices; a rank outside
    the new mesh gets None."""
    full = sh.gather_full(tree, specs, mesh)
    if not new_mesh.member:
        return None
    return sh.local_slices(full, new_specs, new_mesh)
