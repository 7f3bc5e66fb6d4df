"""K1's chunk-parallel design, on the CPU: the kernel's own order of work.

``csrc/stlt_scan.cu`` runs the scan in three product launches, after one
that packs the operators for the tensor cores: (1) per chunk, the
carry contribution U_c = [Pre; Pim] X_c; (2) across chunks, the complex
recurrence h_c+1 = dec * h_c + U_c in fp32; (3) per chunk, z_c =
[M | A | B] [X_c; h_re,c; h_im,c] as one product, and in the chunk where
the gate fires the snapshot [Spre; Spim] X_c + sdec * h_c. Its products are
3xTF32 on the tensor cores: each operand split hi/lo as K2 splits it, and
each k-step of 8 products added to the fp32 accumulator and truncated toward
zero, as the tensor cores sum (``chip_smoke.py`` phase 2c reads that on the
card). This file runs the same steps in plain torch, with the split and the
truncating sums of ``tests/test_torch_k2_precision.py``, and holds the
result against the JAX package's ``ops.stlt_scan`` (its jnp path, as
``tests/test_torch_scan_ops.py`` runs it) and against the port's plain
version run in float64, within ``chip_smoke.K1_TOL`` of (1 + max |ref|):
at the main path's shape (4 rows, N = 1000, d = 64, S = 64, C = 128, h0 != 0,
valid in {0, 1, 128, 1000}) and for one row at N = 8192. The same steps in
fp32 matmuls match the JAX package within 3e-6 of the scale, so the
decomposition is exact algebra; with one TF32 product per pair they miss
``K1_TOL``. It also holds ``chip_smoke.k1_bound``, the least time K1's work
could take on the card, to the products the operators need.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import stlt_scan as t_k1  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

_TESTS = Path(__file__).resolve().parent


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _module("chip_smoke", _TESTS.parent / "chip_smoke.py")
k2_precision = _module("k2_precision", _TESTS / "test_torch_k2_precision.py")

S, D, C = 64, 64, 128


def _inputs(seed, BH, N, valid):
    r = np.random.default_rng(seed)
    f = np.float32
    x = r.normal(size=(BH, N, D)).astype(f)
    lm = (-r.uniform(0.002, 0.5, size=(BH, S))).astype(f)
    th = r.uniform(-np.pi / 4, np.pi / 4, size=(BH, S)).astype(f)
    ur, ui = ((r.normal(size=(BH, S)) / S).astype(f) for _ in range(2))
    h0r, h0i = (r.normal(size=(BH, S, D)).astype(f) for _ in range(2))
    return x, lm, th, ur, ui, h0r, h0i, np.asarray(valid, np.int32)


def _operators(x, lm, th, ur, ui, h0r, h0i, valid, dtype=torch.float32):
    """K1's arguments as ``ops.stlt_scan`` builds them, in ``dtype``."""
    t = [torch.from_numpy(a).to(dtype) for a in (x, lm, th, ur, ui, h0r, h0i)]
    x, lm, th, ur, ui, h0r, h0i = t
    g, A, B, pre, pim, dec = t_ops._filter_ops(lm, th, ur, ui, C)
    nc = -(-x.shape[1] // C)
    spre, spim, sdec, gate = t_ops._snapshot_ops(lm, th, torch.from_numpy(valid),
                                                 x.shape[1], C, nc)
    return [gate, x, t_ops._toeplitz(g), A, B, pre, pim, dec, h0r, h0i, spre, spim,
            sdec]


def _fp32(w, b):
    return w @ b


def _3xtf32(w, b):
    """w @ b as the kernel's mma sums it: 3xTF32, truncating k-steps of 8."""
    return k2_precision._mm3_truncating(w, b.transpose(-1, -2))


def _design(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec, mm):
    """K1's three product launches in plain torch, every product through
    ``mm``."""
    BH, N, d = x.shape
    nc = gate.shape[1]
    xc = F.pad(x, (0, 0, 0, nc * C - N)).view(BH, nc, C, d)
    # 1. carry_in: every chunk's U_c at once
    u = mm(torch.cat([pre, pim], 1)[:, None], xc)                # [BH, nc, 2S, d]
    # 2. carry_scan: the chunk-start carries, in fp32
    dr, di = dec[:, 0, :, None], dec[:, 1, :, None]
    hr, hi, starts = h0_re, h0_im, []
    for c in range(nc):
        starts.append((hr, hi))
        hr, hi = (u[:, c, :S] + dr * hr - di * hi, u[:, c, S:] + dr * hi + di * hr)
    h_re = torch.stack([h[0] for h in starts], 1)                # [BH, nc, S, d]
    h_im = torch.stack([h[1] for h in starts], 1)
    # 3. readout: one K = C + 2S product per chunk, and the gated snapshot
    z = mm(torch.cat([m, a, b], -1)[:, None], torch.cat([xc, h_re, h_im], 2))
    rows = torch.arange(BH)
    cg = (gate > 0).int().argmax(1)                              # the gated chunk
    snap = mm(torch.cat([spre, spim], 1), xc[rows, cg])          # [BH, 2S, d]
    sr, si = sdec[:, 0, :, None], sdec[:, 1, :, None]
    gr, gi = h_re[rows, cg], h_im[rows, cg]
    fires = (gate > 0).any(1)[:, None, None]
    out_re = torch.where(fires, snap[:, :S] + sr * gr - si * gi, h0_re)
    out_im = torch.where(fires, snap[:, S:] + sr * gi + si * gr, h0_im)
    return z.reshape(BH, nc * C, d)[:, :N], out_re, out_im


def _jax(x, lm, th, ur, ui, h0r, h0i, valid):
    fn = jax.jit(functools.partial(j_ops.stlt_scan, chunk=C, return_state=True,
                                   use_kernel=False))
    z, (hr, hi) = fn(*(jnp.asarray(a) for a in (x, lm, th, ur, ui)),
                     h0_re=jnp.asarray(h0r), h0_im=jnp.asarray(h0i),
                     valid=jnp.asarray(valid))
    return [np.asarray(t) for t in (z, hr, hi)]


CASES = {"main": (0, 4, 1000, [0, 1, 128, 1000]), "long": (1, 1, 8192, [5000])}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Inputs, the JAX package's outputs and the float64 plain version's."""
    inputs = _inputs(*CASES[request.param])
    exact = t_k1.stlt_scan_reference(*_operators(*inputs, dtype=torch.float64), chunk=C)
    return inputs, _jax(*inputs), [t.numpy() for t in exact]


def _within(got, want, tol):
    for g, w in zip(got, want):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * (1.0 + float(np.abs(w).max())), (err, tol)


def test_design_in_fp32_matches_jax(case):
    """The three steps with fp32 matmuls: the decomposition is the scan."""
    inputs, want, _ = case
    _within(_design(*_operators(*inputs), mm=_fp32), want, 3e-6)


def test_design_in_3xtf32_within_k1_tol(case):
    """The three steps as the kernel sums them, against JAX and float64; and
    valid == 0 rows hand back h0 bit for bit."""
    inputs, want, exact = case
    got = _design(*_operators(*inputs), mm=_3xtf32)
    _within(got, want, chip_smoke.K1_TOL)
    _within(got, exact, chip_smoke.K1_TOL)
    idle = inputs[-1] == 0
    np.testing.assert_array_equal(got[1].numpy()[idle], inputs[5][idle])
    np.testing.assert_array_equal(got[2].numpy()[idle], inputs[6][idle])


def test_design_in_1xtf32_misses_k1_tol(case):
    """One TF32 product per pair (round to nearest) errs by ~2e-4 of the
    outputs' scale: plain TF32 is not enough for K1."""
    inputs, want, _ = case
    tf32 = k2_precision._tf32
    got = _design(*_operators(*inputs), mm=lambda w, b: tf32(w) @ tf32(b))
    with pytest.raises(AssertionError):
        _within(got, want, chip_smoke.K1_TOL)


# chip_smoke.K1_SHAPES at phase 2's valid pattern: (3xTF32 tensor-core bound,
# fp32 bound) in ms as PERF.md quotes them, and what bounds the first
BOUNDS = {(32, 1000): (0.0080, 0.0193, "bytes"), (8, 1000): (0.0020, 0.0048, "bytes"),
          (8, 131072): (0.2647, 0.6459, "operations")}


@pytest.mark.parametrize("BH,N", sorted(BOUNDS))
def test_k1_bound_is_the_tensor_core_bound(BH, N):
    """K1 runs its products as 3xTF32 on the tensor cores, so its bound is
    theirs: below the fp32 bound, named by what bounds it."""
    valid = np.array([(0, 1, C, N)[i % 4] for i in range(BH)], np.int32)
    bound, fp32, by, flops, nbytes = chip_smoke.k1_bound(BH, N, D, C, S, valid)
    tc_want, fp32_want, by_want = BOUNDS[(BH, N)]
    assert (round(bound, 4), round(fp32, 4), by) == (tc_want, fp32_want, by_want)
    assert bound < fp32
    t_bytes = 1e3 * nbytes / chip_smoke.PEAK_BYTES_PER_S
    assert (bound == t_bytes) == (by == "bytes")
    assert fp32 == max(1e3 * flops / chip_smoke.PEAK_FP32_FLOPS, t_bytes)


@pytest.mark.parametrize("N", [37, 64])
def test_k1_bound_counts_the_operators_nonzero_products(N):
    """``k1_bound``'s flops are the products with an operator entry that is
    not structurally zero, counted on the operators ``ops.py`` builds: the
    readout's [M | A | B] rows of live tokens, [Pre; Pim] into every chunk
    but the first, [Spre; Spim] in the gated chunk, and 8 flops per node
    and column for each carry decay. The support is read off the real parts
    (Re lambda^k != 0); an imaginary part shares it but vanishes at
    lambda^0."""
    BH, c, s, d = 4, 8, 4, 3
    valid = np.array([0, 1, c, N], np.int32)
    r = np.random.default_rng(N)
    lm = torch.from_numpy(-r.uniform(0.002, 0.5, size=(BH, s)).astype(np.float32))
    th = torch.from_numpy(r.uniform(-np.pi / 4, np.pi / 4, size=(BH, s)).astype(np.float32))
    ur, ui = (torch.from_numpy(r.normal(size=(BH, s)).astype(np.float32)) for _ in range(2))
    g, A, B, pre, _, _ = t_ops._filter_ops(lm, th, ur, ui, c)
    nc = -(-N // c)
    spre, _, _, gate = t_ops._snapshot_ops(lm, th, torch.from_numpy(valid), N, c, nc)
    nz = lambda t: int((t != 0).sum())  # noqa: E731
    readout = sum(nz(torch.cat([t_ops._toeplitz(g), A, B], -1)[:, n % c]) for n in range(N))
    carry_in = (nc - 1) * 2 * nz(pre)
    fires = (gate > 0).any(1)
    snapshot = 2 * nz(spre[fires])
    decays = BH * (nc - 1) + int(fires.sum())
    want = 2 * d * (readout + carry_in + snapshot) + 8 * s * d * decays
    assert chip_smoke.k1_bound(BH, N, d, c, s, valid)[3] == want
