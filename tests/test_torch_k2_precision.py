"""K2's precision choice, on the CPU: 3xTF32 score and P.v products.

K2 contracts its scores on the tensor cores in TF32 (a 10-bit mantissa),
split three ways: each fp32 operand a is hi = tf32(a) (round to nearest)
plus lo = a - hi, which the tensor cores read truncated to TF32, and the
kernel sums hi.hi + hi.lo + lo.hi in fp32. This file emulates that
arithmetic on the path's own coefficients (stlt-base poles, S = 64,
dh = 64, built by the port's ``_flash_ops``/``_reconstruct``) and shows:

* summed in IEEE fp32, the 3xTF32 score error against fp64 is within 2x
  plain fp32's, while one TF32 product's is at least 10x fp32's, and z from
  one TF32 product misses ``K2_UNIT_TOL`` at the mid scale (so plain TF32
  is not enough);
* z with 3xTF32 scores and P.v stays within the tolerances ``chip_smoke.py``
  holds the kernel to (``K2_TOL`` at the real scale, ``K2_UNIT_TOL`` where x
  is scaled so the largest score is 1, 10 or 30), both summed in IEEE fp32
  and summed as the tensor cores sum: each k-step of 8 products added to
  the fp32 accumulator with truncation toward zero, the rounding that
  ``chip_smoke.py`` phase 2c reads on the card (the scores' magnitudes
  shrink), and which makes the tensor cores' 3xTF32 scores 25-31x less
  accurate than fp32's there;
* the float64 plain version, ``chip_smoke.py``'s yardstick, is the exact
  readout;
* the host's tile carries at the kernel's stride (``KERNEL_CARRY`` = 32
  rows, where its recurrence segments start) equal the JAX package's
  ``_flash_ops`` carries at that tile, up to 256 tiles.

TF32 rounding is emulated on the fp32 bits (round to nearest, ties away
from zero, as the kernel's add-and-mask; truncation for lo); products of
two TF32 values are exact in fp32, so an fp32 matmul of TF32-valued operands sums them as the tensor
cores' fp32 accumulator does, up to the order of the sum.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.scan import _chunk_powers  # noqa: E402
from repro_torch.kernels import relevance_flash as t_rf  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

N, DH, S, TILE = 256, 64, 64, 128


def _tf32(a):
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(a):
    """fp32 -> TF32 by dropping the low 13 bits, as the tensor cores read it."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _trunc(a - hi)


def _mm3(a, b):
    """a @ b.T as K2 forms it: 3xTF32 into one fp32 accumulator."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return torch.cat([al, ah, ah], -1) @ torch.cat([bh, bl, bh], -1).T


def _trunc64(t):
    """float64 -> the fp32 value toward zero, kept in float64: clear the 29
    mantissa bits that fp32 lacks."""
    return (t.view(torch.int64) & -(1 << 29)).view(torch.float64)


def _mm3_truncating(a, b):
    """a @ b.T as the tensor cores sum K2's 3xTF32 products: exact products,
    each k-step of 8 (lo.hi, hi.lo, hi.hi in turn) added to the fp32
    accumulator and the sum truncated toward zero. Batched over leading
    dimensions (a [..., M, K], b [..., N, K])."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    K = a.shape[-1]

    def steps(t):          # [..., R, K] -> [K/8, ..., R, 8], one k-step each
        return torch.stack(t.double().split(8, -1))

    pairs = [(steps(x), steps(y).transpose(-1, -2)) for x, y in ((al, bh), (ah, bl), (ah, bh))]
    acc = 0.0
    for k in range(K // 8):
        for x, y in pairs:
            acc = _trunc64(acc + x[k] @ y[k])
    return acc.float()


def _inputs(seed=0):
    """One row at stlt-base's poles (sigma log-spaced over [1e-3, 1] plus the
    1/32 window, omega in [-pi/4, 0]), soft node masks, unit-variance x, v."""
    r = np.random.default_rng(seed)
    f = np.float32
    x = r.normal(size=(1, N, DH)).astype(f)
    v = r.normal(size=(1, N, DH)).astype(f)
    sig = np.logspace(-3, 0, S)
    lm = (-(sig + 1 / 32) * (1 + 0.01 * r.normal(size=(1, S)))).astype(f)
    th = (-(np.pi / 4) * r.uniform(size=(1, S))).astype(f)
    mk = (0.2 + 0.8 * r.uniform(size=(1, S))).astype(f)
    return [torch.from_numpy(a) for a in (x, v, lm, th, mk)]


def _operands(x, lm, th, mk):
    """The contraction's operands: q = mk L and k = L, [N, S * 2 * dh] fp32
    (re | im per node), so that R = q k^T / sqrt(S)."""
    ops = t_rf._flash_ops(x, lm, th, TILE, bidirectional=False)
    zero = torch.zeros_like(ops["hc_re"][:, 0])
    tiles = [t_rf._reconstruct(x[:, c * TILE:(c + 1) * TILE], ops, ops["hc_re"][:, c],
                               ops["hc_im"][:, c], zero, zero, False)
             for c in range(N // TILE)]
    l_re = torch.cat([t[0] for t in tiles], 1)[0]          # [N, S, dh]
    l_im = torch.cat([t[1] for t in tiles], 1)[0]
    k = torch.cat([l_re, l_im], -1).reshape(N, -1)
    q = (mk[0][:, None] * torch.cat([l_re, l_im], -1)).reshape(N, -1)
    return q, k


def _readout(r, v, mm=_mm3):
    """Causal softmax of the scores r [N, N], then P.v in 3xTF32."""
    causal = torch.tril(torch.ones(N, N, dtype=torch.bool))
    p = torch.softmax(torch.where(causal, r, t_rf.NEG), -1)
    return mm(p, v[0].T.contiguous())


def test_3xtf32_scores_are_as_accurate_as_fp32():
    """Summed in IEEE fp32 (the tensor cores truncate instead: see
    ``_mm3_truncating``)."""
    x, _, lm, th, mk = _inputs()
    q, k = _operands(x, lm, th, mk)
    exact = q.double() @ k.double().T
    err = {name: float((r.double() - exact).abs().max()) for name, r in (
        ("fp32", q @ k.T), ("1xtf32", _tf32(q) @ _tf32(k).T), ("3xtf32", _mm3(q, k)))}
    top = float(exact.diagonal().max()) / math.sqrt(S)
    assert 1000 < top < 10000, top       # the real scale: scores in the thousands
    assert err["3xtf32"] <= 2 * err["fp32"], err
    assert err["1xtf32"] >= 10 * err["fp32"], err


def _check_readout(max_score, mm):
    """z from scores and P.v by ``mm`` against the plain version (fp32), at
    the real scale (None: unit-variance x) or with x scaled so the largest
    score is ``max_score``, held to ``chip_smoke.py``'s tolerance."""
    x, v, lm, th, mk = _inputs(seed=1)
    q, k = _operands(x, lm, th, mk)
    top = float((q.double() * k.double()).sum(-1).max()) / math.sqrt(S)
    if max_score is not None:      # scores are quadratic in x
        x = x * math.sqrt(max_score / top)
        q, k = _operands(x, lm, th, mk)
    got = _readout(mm(q, k) / math.sqrt(S), v, mm)
    want = t_rf.relevance_flash_reference(x, v, lm, th, mk, None, tile=TILE,
                                          causal=True)[0]
    err = (got - want).abs()
    if max_score is None:
        assert float((err - chip_smoke.K2_TOL * want.abs()).max()) <= chip_smoke.K2_TOL
    else:
        assert float(err.max()) <= chip_smoke.K2_UNIT_TOL * (1 + float(want.abs().max()))


@pytest.mark.parametrize("max_score", [1.0, 10.0, 30.0, None])
def test_3xtf32_readout_within_the_kernel_tolerance(max_score):
    """z from 3xTF32 scores and P.v summed in IEEE fp32, at the real scale
    and at largest scores 1, 10 and 30, where the softmax is neither one-hot
    nor flat."""
    _check_readout(max_score, _mm3)


@pytest.mark.parametrize("max_score", [1.0, 10.0, 30.0, None])
def test_3xtf32_readout_within_the_kernel_tolerance_with_truncating_sums(max_score):
    """The same with every k-step's sum truncated toward zero, as the tensor
    cores sum K2's products."""
    _check_readout(max_score, _mm3_truncating)


def _mm1(a, b):
    """a @ b.T from one TF32 product of each pair (round to nearest)."""
    return _tf32(a) @ _tf32(b).T


def test_1xtf32_readout_fails_the_mid_scale_gate():
    """Where x is scaled so the largest score is 30, z from one TF32 product
    per pair (scores and P.v) misses ``K2_UNIT_TOL``: plain TF32 is not
    enough for K2, even where the softmax is neither one-hot nor flat."""
    x, v, lm, th, mk = _inputs(seed=1)
    q, k = _operands(x, lm, th, mk)
    top = float((q.double() * k.double()).sum(-1).max()) / math.sqrt(S)
    x = x * math.sqrt(30.0 / top)
    q, k = _operands(x, lm, th, mk)
    causal = torch.tril(torch.ones(N, N, dtype=torch.bool))
    p = torch.softmax(torch.where(causal, _mm1(q, k) / math.sqrt(S), t_rf.NEG), -1)
    got = _mm1(p, v[0].T.contiguous())
    want = t_rf.relevance_flash_reference(x, v, lm, th, mk, None, tile=TILE,
                                          causal=True)[0]
    gate = chip_smoke.K2_UNIT_TOL * (1 + float(want.abs().max()))
    assert float((got - want).abs().max()) > gate


@pytest.mark.parametrize("causal", [True, False])
def test_float64_plain_version_matches_the_exact_readout(causal):
    """The plain version run in float64 (``chip_smoke.py``'s yardstick for
    the fp32 versions' rounding) against the readout materialized in float64
    from the same coefficients, at the mid scale."""
    x, v, lm, th, mk = (t.double() for t in _inputs(seed=3))
    q, k = _operands(x, lm, th, mk)
    x = x * math.sqrt(30.0 / float((q * k).sum(-1).max() / math.sqrt(S)))
    ops = t_rf._flash_ops(x, lm, th, TILE, bidirectional=not causal)
    tiles = [t_rf._reconstruct(x[:, c * TILE:(c + 1) * TILE], ops, ops["hc_re"][:, c],
                               ops["hc_im"][:, c],
                               *((ops["gc_re"][:, c], ops["gc_im"][:, c]) if not causal
                                 else (None, None)), not causal)
             for c in range(N // TILE)]
    l = torch.cat([torch.cat([t[0] for t in tiles], 1), torch.cat([t[1] for t in tiles], 1)],
                  -1)[0]                                   # [N, S, 2 dh]
    r = (mk[0][:, None] * l).flatten(1) @ l.flatten(1).T / math.sqrt(S)
    if causal:
        r = torch.where(torch.tril(torch.ones(N, N, dtype=torch.bool)), r, -math.inf)
    want = torch.softmax(r, -1) @ v[0]
    got = t_rf.relevance_flash_reference(x, v, lm, th, mk, None, tile=TILE, causal=causal,
                                         dtype=torch.float64)[0]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_tile_carries_at_the_kernel_stride_match_jax(bidirectional):
    """The wrapper's carries (x masked and padded to the kernel's block, one
    operator step per 32-row segment) against the JAX package's at that
    tile."""
    jax = pytest.importorskip("jax")
    from repro.kernels import relevance_flash as j_rf

    T = t_rf.KERNEL_CARRY
    assert (T, t_rf.KERNEL_BLOCK) == (32, 64)
    r = np.random.default_rng(2)
    n = 150                                               # 2 blocks + 22 rows
    x = r.normal(size=(3, n, 20)).astype(np.float32)
    lm = (-r.uniform(0.005, 1.0, (3, 5))).astype(np.float32)
    th = (-r.uniform(0.0, 1.5, (3, 5))).astype(np.float32)
    km = (np.arange(n)[None] < np.array([n, 100, 0])[:, None]).astype(np.float32)
    xp = np.pad(x * km[:, :, None], ((0, 0), (0, -n % t_rf.KERNEL_BLOCK), (0, 0)))
    pw_re, pw_im = _chunk_powers(torch.from_numpy(lm), torch.from_numpy(th), T)
    hc, gc = t_rf._tile_carries(torch.from_numpy(xp), pw_re, pw_im, T, bidirectional)
    want = j_rf._flash_ops(jax.numpy.asarray(xp), jax.numpy.asarray(lm),
                           jax.numpy.asarray(th), T, bidirectional=bidirectional)
    got = {"hc_re": hc[0], "hc_im": hc[1]}
    if bidirectional:
        got.update(gc_re=gc[0], gc_im=gc[1])
    else:
        assert gc is None
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[name]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("n", [1000, 8192])
def test_tile_carries_at_the_path_tile_count_match_jax(n, bidirectional):
    """The wrapper's doubling scan over tiles against the JAX package's
    sequential ``_flash_ops`` scan at the kernel's stride, at the path's
    length (N = 1000: 32 tiles) and at 256 tiles (N = 8192), on stlt-base's
    poles with S = 64, dh = 64, one row's tail masked."""
    jax = pytest.importorskip("jax")
    from repro.kernels import relevance_flash as j_rf

    T = t_rf.KERNEL_CARRY
    r = np.random.default_rng(4)
    x = r.normal(size=(2, n, DH)).astype(np.float32)
    sig = np.logspace(-3, 0, S)
    lm = (-(sig + 1 / 32) * (1 + 0.01 * r.normal(size=(2, S)))).astype(np.float32)
    th = (-(np.pi / 4) * r.uniform(size=(2, S))).astype(np.float32)
    km = (np.arange(n)[None] < np.array([n, n - 37])[:, None]).astype(np.float32)
    xp = np.pad(x * km[:, :, None], ((0, 0), (0, -n % t_rf.KERNEL_BLOCK), (0, 0)))
    pw_re, pw_im = _chunk_powers(torch.from_numpy(lm), torch.from_numpy(th), T)
    hc, gc = t_rf._tile_carries(torch.from_numpy(xp), pw_re, pw_im, T, bidirectional)
    want = j_rf._flash_ops(jax.numpy.asarray(xp), jax.numpy.asarray(lm),
                           jax.numpy.asarray(th), T, bidirectional=bidirectional)
    got = {"hc_re": hc[0], "hc_im": hc[1]}
    if bidirectional:
        got.update(gc_re=gc[0], gc_im=gc[1])
    for name, t in got.items():
        assert t.shape == (2, xp.shape[1] // T, S, DH)
        np.testing.assert_allclose(t.numpy(), np.asarray(want[name]), atol=1e-5, rtol=0)
