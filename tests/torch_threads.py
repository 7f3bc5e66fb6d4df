"""An autouse fixture that sets a port test module's CPU settings.

The port's CPU tests run many small tensor ops, which gain little from
torch's intra-op threads, and the suite runs several worker processes on
the machine's cores, where more threads only contend for them: a module
runs on one torch intra-op thread.

Their JAX references are small programs that XLA compiles once and runs a
few times, so most of their time is XLA's optimization passes: a module
compiles them with ``jax_disable_most_optimizations`` on (XLA's backend at
optimization level 0, its expensive LLVM passes off; the same HLO, the
results within fp32 rounding of the optimized build). The JAX package's own
tests keep the default: when the module's tests end the flag is restored
and JAX's caches are cleared, so no later module reuses an executable
compiled this way. A module whose references need the optimized build
sets ``XLA_OPTIMIZED = True`` (``test_torch_relevance.py``: the relevance
LM's grads through the unoptimized build move by 0.8 of that test's gate).

A module imports ``cpu_test_settings`` to take both.
"""
import pytest

# the subprocesses' environment for the same setting
JAX_ENV = {"JAX_DISABLE_MOST_OPTIMIZATIONS": "1"}


@pytest.fixture(autouse=True, scope="module")
def cpu_test_settings(request):
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        import jax
    except ImportError:
        jax = None
    if getattr(request.module, "XLA_OPTIMIZED", False):
        jax = None
    if jax is not None:
        was = jax.config.read("jax_disable_most_optimizations")
        jax.config.update("jax_disable_most_optimizations", True)
    yield
    torch.set_num_threads(n)
    if jax is not None:
        jax.config.update("jax_disable_most_optimizations", was)
        jax.clear_caches()
