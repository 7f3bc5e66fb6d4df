"""K1 and K2 on the card: the Hopper kernels against their plain PyTorch
versions, and the scan's VJP (K1 forward and anti-causal) against float64
autograd through the plain version.

These tests need a CUDA device and ``nvcc`` (they build the kernel from
``src/repro_torch/kernels/csrc``); elsewhere they skip. Run them on an H100
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.

Tolerances. K1: the kernel's products are 3xTF32 on the tensor cores
(about fp32's rounding, but truncated as the tensor cores sum), the plain
version's fp32 (TF32 off), summed in different orders over up to
C + 2S = 256 terms per output and nc chunk steps of the carry; 2e-4
relative to the output's scale bounds that rounding. K2: the kernel builds
the pole powers by repeated multiplication and the plain version in closed
form, so the scores differ by ~1e-7 of their size; with scores in the
thousands (|lambda| near e^(-1/32)) the softmax is near one-hot and that
moves z by up to ~1e-3 x |v|, so K2 is held elementwise within
2e-3 + 2e-3 |z|, the JAX package's own tiled-vs-materialized tolerance;
gradients within 2e-3 of the largest entry, for the same reason.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import stlt as stlt_lib  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import relevance_flash as k2  # noqa: E402
from repro_torch.kernels import stlt_scan as k1  # noqa: E402

pytestmark = pytest.mark.cuda
RTOL_SCALE = 2e-4

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


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
    (8, 1000, 64, 64, 128),   # stlt-base at batch 1
    (8, 131072, 64, 64, 128),  # a 131,072-token prompt at batch 1
    (3, 70, 72, 8, 16),      # d past one 64-column block
    (3, 50, 7, 4, 8),        # odd d, the smallest chunk and node count
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


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("BH,N,d,S,C", [
    (4, 37, 16, 8, 16),      # odd N
    (32, 1000, 64, 64, 128),  # stlt-base at batch 4
    (8, 1037, 64, 64, 128),   # a partial last chunk
])
def test_scan_vjp_on_the_card_matches_float64_autograd(dev, BH, N, d, S, C, reverse):
    """``ops._StltScan`` on the card (K1 forward, K1 anti-causal for dx,
    analytic pole/mixer grads) against torch autograd through the plain
    version in float64, every input's grad within K1's 2e-4 of the scale;
    two K1 launches per forward + backward."""
    x, lm, th, ur, ui, _, _, _ = _operands(dev, BH, N, d, S, C, seed=3)
    dz = torch.randn(BH, N, d, generator=torch.Generator().manual_seed(4)).to(dev)
    ins = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    before = k1.stlt_scan_kernel.launches
    z = ops.stlt_scan(*ins, chunk=C, reverse=reverse)
    got = torch.autograd.grad(z, ins, dz)
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches == before + 2
    ref = [t.double().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    z64 = ops._pass(ref[0], ops._operators(*ref[1:], C), C, reverse,
                    k1.stlt_scan_reference)[0]
    want = torch.autograd.grad(z64, ref, dz.double())
    _assert_close(z.detach().double(), z64.detach())
    for a, b in zip(got, want):
        _assert_close(a.double(), b)


def test_factorized_lm_loss_gives_every_leaf_a_grad_on_the_card(dev):
    """Every parameter of a small factorized model gets a finite, non-zero
    grad from ``lm_loss`` on the card (the scan's output was once filled
    through ctypes with no autograd history, and w_v, the nodes and the
    adaptive gate got none)."""
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_flatten_with_paths

    cfg = CONFIG.reduced(num_layers=2)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev)
    before = k1.stlt_scan_kernel.launches
    _, _, grads = train.loss_and_grads(params, cfg, {"inputs": toks,
                                                     "labels": toks.roll(-1, 1)}, tau=0.5)
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches == before + 2 * cfg.num_layers
    for path, g in tree_flatten_with_paths(grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, path


# ---------------------------------------------------------------------------
# K2, the flash relevance readout
# ---------------------------------------------------------------------------


def _k2_inputs(dev, BH, N, d, S, seed=0):
    """stlt-base-like poles (|lambda| <= e^(-1/32)), node masks with zeros,
    a padded key tail on row 1 and an all-masked row 2 (when BH > 2)."""
    g = torch.Generator().manual_seed(seed)
    x, v = (torch.randn(BH, N, d, generator=g) for _ in range(2))
    sig = torch.logspace(-3, 0, S)
    lm = -(sig + 1 / 32) * (1 + 0.01 * torch.randn(BH, S, generator=g))
    th = -0.785 * torch.rand(BH, S, generator=g)
    mk = torch.rand(BH, S, generator=g)
    mk[:, ::3] = 0.0
    km = torch.ones(BH, N)
    if BH > 1:
        km[1, N - N // 3:] = 0.0
    if BH > 2:
        km[2] = 0.0
    return [t.to(dev) for t in (x, v, lm, th, mk, km)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,N,d,S", [
    (3, 40, 16, 8),          # one partial block
    (3, 129, 20, 5),         # d not a multiple of 16, N one past a block
    (4, 300, 7, 3),          # odd d, ragged last block
    (32, 1000, 64, 64),      # stlt-base at batch 4
    (8, 1000, 64, 64),       # stlt-base at batch 1
    (2, 4099, 64, 64),       # long, ragged past every block size
])
def test_k2_matches_plain_version(dev, causal, BH, N, d, S):
    args = _k2_inputs(dev, BH, N, d, S)
    got = k2.relevance_flash_kernel(*args, causal=causal)
    want = k2.relevance_flash_reference(*args, tile=128, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    if BH > 2:
        assert torch.equal(got[2], torch.zeros_like(got[2]))   # all keys masked


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("max_score", [1.0, 30.0])
def test_k2_matches_plain_version_where_the_softmax_is_smooth(dev, causal, max_score):
    """x scaled so the largest score is 1 or 30: the softmax is neither
    one-hot nor flat, so z shows the scores' rounding (chip_smoke.py's
    K2_UNIT_TOL of (1 + max |z|))."""
    args = _k2_inputs(dev, 8, 1000, 64, 64)
    top = chip_smoke.k2_max_score(k2, args[0], args[2], args[3], args[4], args[5],
                                  causal)
    args[0] = args[0] * (max_score / top) ** 0.5
    got = k2.relevance_flash_kernel(*args, causal=causal)
    want = k2.relevance_flash_reference(*args, tile=128, causal=causal)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= chip_smoke.K2_UNIT_TOL * (1 + float(want.abs().max())), err


def test_k2_dispatch_launches_the_kernel_once(dev):
    args = _k2_inputs(dev, 8, 200, 64, 16)
    before = k2.relevance_flash_kernel.launches
    z = k2.relevance_flash(*args[:4], masks=args[4], kmask=args[5])
    assert k2.relevance_flash_kernel.launches == before + 1
    zc = k2.relevance_flash(*(t.cpu() for t in args[:4]), masks=args[4].cpu(),
                            kmask=args[5].cpu())
    torch.testing.assert_close(z.cpu(), zc, rtol=2e-3, atol=2e-3)
    cfg = stlt_lib.STLTConfig(d_model=64, num_heads=4, num_nodes=8, chunk=16,
                              mode="relevance")
    params = stlt_lib.init_stlt(torch.Generator(device=dev).manual_seed(0), cfg,
                                device=dev)
    before = k2.relevance_flash_kernel.launches
    y, _ = stlt_lib.apply_stlt(params, cfg, torch.randn(2, 50, 64, device=dev))
    assert k2.relevance_flash_kernel.launches == before + 1
    assert torch.isfinite(y).all()


def test_k2_wrapper_checks_its_inputs(dev):
    args = _k2_inputs(dev, 2, 40, 16, 4)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)  # strided x
    with pytest.raises(ValueError, match="contiguous"):
        k2.relevance_flash_kernel(*bad, causal=True)
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(ValueError, match="dtype"):
        k2.relevance_flash_kernel(*bad, causal=True)
    bad = list(args)
    bad[4] = args[4][:, :3].contiguous()
    with pytest.raises(ValueError, match="shape"):
        k2.relevance_flash_kernel(*bad, causal=True)
    wide = _k2_inputs(dev, 2, 40, 72, 4)
    with pytest.raises(ValueError, match="dh"):
        k2.relevance_flash_kernel(*wide, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        k2.relevance_flash_kernel(*(t.cpu() for t in args), causal=True)


@pytest.mark.parametrize("causal", [True, False])
def test_k2_autograd_grads_on_the_card_match_the_cpu(dev, causal):
    """The autograd Function on the card (forward: K2) and on the CPU
    (forward: the plain version); both backwards recompute through the plain
    version."""
    args = _k2_inputs(dev, 3, 150, 16, 8, seed=1)
    dz = torch.randn(3, 150, 16, generator=torch.Generator().manual_seed(2))
    grads = []
    for where in (dev, torch.device("cpu")):
        ins = [t.to(where).clone().requires_grad_(True) for t in args[:5]]
        z = k2.relevance_flash(*ins[:4], masks=ins[4], kmask=args[5].to(where),
                               causal=causal, tile=64)
        grads.append(torch.autograd.grad(z, ins, dz.to(where)))
    for a, b in zip(*grads):
        scale = float(b.abs().max()) + 1e-12
        torch.testing.assert_close(a.cpu() / scale, b / scale, rtol=0, atol=2e-3)
