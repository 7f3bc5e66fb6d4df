"""K1 on the card: the Hopper kernel against its plain PyTorch version.

These tests need a CUDA device and ``nvcc`` (they build the kernel from
``src/repro_torch/kernels/csrc``); elsewhere they skip. Run them on an H100
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.

Tolerance: the kernel and the plain version both accumulate in fp32 (TF32
off) but sum in different orders, over up to C + 2S = 256 terms per output
and nc chunk steps of the carry; 2e-4 relative to the output's scale bounds
that rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import stlt_scan as k1  # noqa: E402

pytestmark = pytest.mark.cuda
RTOL_SCALE = 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(dev, BH, N, d, S, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(BH, N, d, generator=g)
    lm = -(0.01 + 0.5 * torch.rand(BH, S, generator=g))
    th = 1.6 * torch.rand(BH, S, generator=g) - 0.8
    ur, ui = (torch.randn(BH, S, generator=g) / S for _ in range(2))
    h0r, h0i = (torch.randn(BH, S, d, generator=g) for _ in range(2))
    valid = torch.tensor([[0, 1, C, N][i % 4] for i in range(BH)], dtype=torch.int32)
    valid = valid.clamp(max=N)
    return [t.to(dev) for t in (x, lm, th, ur, ui, h0r, h0i, valid)]


def _k1_args(x, lm, th, ur, ui, h0r, h0i, valid, C):
    g, A, B, pre, pim, dec = ops._filter_ops(lm, th, ur, ui, C)
    nc = -(-x.shape[1] // C)
    spre, spim, sdec, gate = ops._snapshot_ops(lm, th, valid, x.shape[1], C, nc)
    return [gate] + [t.contiguous() for t in (x, ops._toeplitz(g), A, B, pre, pim,
                                              dec, h0r, h0i, spre, spim, sdec)]


def _assert_close(got, want):
    scale = float(want.abs().max()) + 1.0
    err = float((got - want).abs().max())
    assert err <= RTOL_SCALE * scale, (err, scale)


@pytest.mark.parametrize("BH,N,d,S,C", [
    (4, 37, 8, 8, 16),       # odd N, one partial d-slice
    (5, 45, 20, 12, 16),     # ragged d (20 = 16 + 4), S % 8 != 0
    (8, 256, 64, 64, 128),   # stlt-base rows at batch 1, exact chunks
    (32, 1000, 64, 64, 128),  # stlt-base at batch 4, N not a multiple of C
])
def test_kernel_matches_plain_version(dev, BH, N, d, S, C):
    args = _k1_args(*_operands(dev, BH, N, d, S, C), C)
    got = k1.stlt_scan_kernel(*args, chunk=C)
    want = k1.stlt_scan_reference(*args, chunk=C)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _assert_close(a, b)
    # valid == 0 rows return h0 bit for bit
    torch.testing.assert_close(got[1][0], args[8][0], rtol=0, atol=0)


def test_ops_dispatch_launches_the_kernel_once(dev):
    x, lm, th, ur, ui, h0r, h0i, valid = _operands(dev, 8, 300, 64, 64, 128)
    before = k1.stlt_scan_kernel.launches
    z, (h_re, _) = ops.stlt_scan(x, lm, th, ur, ui, chunk=128, h0_re=h0r,
                                 h0_im=h0i, valid=valid, return_state=True)
    assert k1.stlt_scan_kernel.launches == before + 1
    zc, (hc, _) = ops.stlt_scan(*(t.cpu() for t in (x, lm, th, ur, ui)), chunk=128,
                                h0_re=h0r.cpu(), h0_im=h0i.cpu(), valid=valid.cpu(),
                                return_state=True)
    _assert_close(z.cpu(), zc)
    _assert_close(h_re.cpu(), hc)


def test_kernel_wrapper_checks_its_inputs(dev):
    args = _k1_args(*_operands(dev, 2, 40, 16, 8, 16), 16)
    bad = list(args)
    bad[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)  # strided x
    with pytest.raises(ValueError, match="contiguous"):
        k1.stlt_scan_kernel(*bad, chunk=16)
    bad = list(args)
    bad[2] = args[2].double()
    with pytest.raises(ValueError, match="dtype"):
        k1.stlt_scan_kernel(*bad, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        k1.stlt_scan_kernel(*args, chunk=8)
    assert np.isfinite(k1.stlt_scan_kernel(*args, chunk=16)[0].cpu().numpy()).all()
