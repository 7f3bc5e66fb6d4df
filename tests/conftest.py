"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see exactly
one device (the dry-run forces 512 in its own process).

Markers: ``slow`` tags long-running kernel/scale tests. They are skipped by
default (the tier-1 suite stays fast) and run with ``--runslow`` — CI splits
them into their own job (.github/workflows/ci.yml).
"""
import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (the CI slow-kernel job)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running kernel/scale tests; skipped unless --runslow")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (the PyTorch port's kernels); "
        "skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def jit_trace_log(monkeypatch):
    """Counting jit hook: patches the transformer prefill entry points with
    ``repro.utils.trace_probe`` BEFORE they are jitted, so every jit trace
    (= XLA compilation) of a prefill program appends ``(name, inputs.shape)``
    to the returned list. Engines must be constructed inside the test (after
    the patch) for their ``jax.jit`` wrappers to pick up the probe — used by
    the two-shape compile-count regression in test_masked_prefill.py."""
    from repro.models import transformer as T
    from repro.utils import trace_probe

    log: list = []
    for name in ("prefill", "prefill_chunk", "spec_verify"):
        monkeypatch.setattr(T, name, trace_probe(getattr(T, name), log, name))
    return log


def small_cfg(**kw):
    from repro.configs.base import ModelConfig

    base = dict(
        name="t", family="lm", vocab=64, num_layers=2, d_model=32,
        num_heads=4, num_kv_heads=2, d_ff=64, dtype="float32",
        scan_layers=False, remat=False, blockwise_threshold=10_000,
    )
    base.update(kw)
    return ModelConfig(**base)
