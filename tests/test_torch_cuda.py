"""K1 and K2 on the card: the Hopper kernels against their plain PyTorch
versions (K1 at head dims up to 256), the scan's VJP (K1 forward and
anti-causal) against float64 autograd through the plain version, and
continuous serve on the card against the same serve on the CPU (stlt-base,
each arch added with the untied head and the hybrid family, and the xLSTM
and MoE archs, whose train step is also held to the CPU's; the MoE
combine gives the same output on two calls, bit for bit, and the
expert-parallel form on one rank is the gather path bit for bit), the
disaggregated fleets' and the sharded engine's serves against the
colocated single-host card serve, the hann window's forward and decode step
on the card against the CPU, and ``param_grads="recompute"`` against the
analytic grads through K1.

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
import dataclasses
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
    (32, 512, 64, 64, 128),   # serve's [slots, chunk] admission, 4 slots
    (32, 5, 64, 64, 128),     # ... the n-gram draft's verify window [4, k + 1]
    (3, 70, 72, 8, 16),      # d past one 64-column block
    (3, 50, 7, 4, 8),        # odd d, the smallest chunk and node count
    (15, 512, 64, 32, 128),  # SmolLM-360M-stlt (15 heads, S = 32): [1, 512]
    (60, 512, 64, 32, 128),  # ... [4, 512] admission
    (60, 5, 64, 32, 128),    # ... the node draft's commit at [4, k + 1]
    (64, 512, 256, 32, 128),  # recurrentgemma-9b-stlt (16 heads, dh 256): [4, 512]
    (16, 512, 256, 32, 128),  # ... [1, 512] admission
    (64, 5, 256, 32, 128),    # ... the verify window [4, k + 1]
    (32, 1024, 256, 32, 128),  # ... the 2 x 1024 training step
    (64, 512, 128, 32, 128),  # chatglm3-6b-stlt (32 heads, dh 128): 2 x 512
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


@pytest.mark.parametrize("with_valid", [False, True], ids=["verify", "commit"])
def test_scan_at_the_spec_shapes_matches_the_cpu(dev, with_valid):
    """``ops.stlt_scan`` at SmolLM-360M-stlt's speculative shapes, 4 slots x
    15 heads = 60 rows of k + 1 = 5 tokens (less than one 128-token chunk)
    resumed from h0: the verify window (every row's carry at N) and the
    node draft's commit (per-row valid, 0 included); one launch, and the
    card agrees with the plain version on the CPU."""
    x, lm, th, ur, ui, h0r, h0i, valid = _operands(dev, 60, 5, 64, 32, 128)
    valid = valid if with_valid else None
    before = k1.stlt_scan_kernel.launches
    z, (h_re, h_im) = ops.stlt_scan(x, lm, th, ur, ui, chunk=128, h0_re=h0r, h0_im=h0i,
                                    valid=valid, return_state=True)
    assert k1.stlt_scan_kernel.launches == before + 1
    cpu = [t.cpu() for t in (x, lm, th, ur, ui, h0r, h0i)]
    zc, (hrc, hic) = ops.stlt_scan(*cpu[:5], chunk=128, h0_re=cpu[5], h0_im=cpu[6],
                                   valid=None if valid is None else valid.cpu(),
                                   return_state=True)
    for a, b in ((z, zc), (h_re, hrc), (h_im, hic)):
        _assert_close(a.cpu(), b)
    if with_valid:   # valid == 0 rows return h0 bit for bit
        idle = (valid == 0).nonzero()[:, 0]
        assert torch.equal(h_re[idle], h0r[idle]) and torch.equal(h_im[idle], h0i[idle])


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


@pytest.mark.parametrize("BH,N,d,S,C", [
    (4, 37, 16, 8, 16),        # odd N: the end state is a mid-chunk snapshot
    (8, 1037, 64, 64, 128),    # stlt-base rows, a partial last chunk
    (8, 4096, 64, 64, 128),    # a context-parallel shard, whole chunks
])
def test_stateful_scan_vjp_on_the_card_matches_float64_autograd(dev, BH, N, d, S, C):
    """``ops._StltScanState`` on the card (K1's stateful forward, K1
    anti-causal over dz plus the end state's term for dx, the analytic
    grads seeded with the end state's cotangent) against torch autograd
    through the plain version with its snapshot at N in float64: z, both
    carries and every input's grad within K1's 2e-4 of the scale; two K1
    launches per forward + backward."""
    x, lm, th, ur, ui, _, _, _ = _operands(dev, BH, N, d, S, C, seed=5)
    g = torch.Generator().manual_seed(6)
    dz = torch.randn(BH, N, d, generator=g).to(dev)
    dh = [torch.randn(BH, S, d, generator=g).to(dev) for _ in range(2)]
    ins = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    before = k1.stlt_scan_kernel.launches
    z, (h_re, h_im) = ops.stlt_scan(*ins, chunk=C, return_state=True)
    got = torch.autograd.grad((z * dz).sum() + (h_re * dh[0]).sum() + (h_im * dh[1]).sum(),
                              ins)
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches == before + 2
    ref = [t.double().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    nc = -(-N // C)
    z64, hr64, hi64 = ops._pass(ref[0], ops._operators(*ref[1:], C), C, False,
                                k1.stlt_scan_reference,
                                snapshot=ops._snapshot_ops(ref[1], ref[2], None, N, C, nc))
    want = torch.autograd.grad((z64 * dz.double()).sum() + (hr64 * dh[0].double()).sum()
                               + (hi64 * dh[1].double()).sum(), ref)
    for a, b in ((z, z64), (h_re, hr64), (h_im, hi64), *zip(got, want)):
        _assert_close(a.detach().double(), b.detach())


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


def test_reverse_scan_returns_its_carry_on_the_card(dev):
    """``reverse=True, return_state=True``: z and the anti-causal carry
    after all N tokens, K1 on the card against the plain version on the
    CPU, one launch."""
    x, lm, th, ur, ui, _, _, _ = _operands(dev, 8, 300, 64, 64, 128, seed=5)
    before = k1.stlt_scan_kernel.launches
    z, (h_re, h_im) = ops.stlt_scan(x, lm, th, ur, ui, chunk=128, reverse=True,
                                    return_state=True)
    assert k1.stlt_scan_kernel.launches == before + 1
    zc, (hrc, hic) = ops.stlt_scan(*(t.cpu() for t in (x, lm, th, ur, ui)), chunk=128,
                                   reverse=True, return_state=True)
    for a, b in ((z, zc), (h_re, hrc), (h_im, hic)):
        _assert_close(a.cpu(), b)


def test_serve_on_the_card_matches_the_cpu(dev):
    """Continuous serve of a reduced stlt-base (staggered arrivals, mixed
    node budgets, coalesced chunked admission, a warmed prefix): the same
    streams on the card as on the CPU from the same weights, and K1 launched
    once per layer per admission dispatch, as phase S of chip_smoke.py."""
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.models import transformer as T
    from repro_torch.serving import PrefixCache, Request, ServeEngine

    cfg = CONFIG.reduced(num_layers=2)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    reqs = [Request(np.concatenate([sys_prompt if i % 2 else sys_prompt[:0],
                                    rng.integers(0, cfg.vocab, n).astype(np.int32)]),
                    m, id=i, serve_nodes=c)
            for i, (n, m, c) in enumerate([(40, 5, None), (9, 1, None), (21, 6, 3),
                                           (50, 4, None), (16, 7, 5)])]
    results = []
    for where in ("cpu", dev):
        eng = ServeEngine(params, cfg, prefill_chunk=16, prefix_cache=PrefixCache(),
                          device=where)
        eng.warm_prefix(sys_prompt)
        before = k1.stlt_scan_kernel.launches
        results.append(eng.serve(reqs, slots=3, arrivals=[0, 0, 1, 4, 4]))
        torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches - before == (
        cfg.num_layers * eng.serve_stats["admission_dispatches"]) > 0
    for r in reqs:
        np.testing.assert_array_equal(results[1][r.id], results[0][r.id])
        assert len(results[1][r.id]) == r.max_new_tokens


@pytest.mark.parametrize("bidirectional", [False, True], ids=["causal", "bilateral"])
def test_hann_forward_and_step_on_the_card_match_the_cpu(dev, bidirectional):
    """The hann window (W = 128, an FFT convolution: no kernel of the port)
    on the card against the CPU at stlt-base's layer widths and adaptive
    masks: ``apply_stlt`` at 2 x 300 in either direction; causally also a
    prefill, a padded resumed chunk (valid 0 keeps its ring bit for bit)
    and 4 decode steps. No K1 launch; within RTOL_SCALE of the scale."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.utils import tree_map

    cfg = stlt_lib.STLTConfig(d_model=512, num_heads=8, num_nodes=64, chunk=128,
                              window="hann", bidirectional=bidirectional,
                              adaptive=AdaptiveConfig(enabled=True))
    params = stlt_lib.init_stlt(torch.Generator().manual_seed(0), cfg)
    cuda = tree_map(lambda t: t.to(dev), params)
    x = torch.randn(2, 300, 512, generator=torch.Generator().manual_seed(1))
    before = k1.stlt_scan_kernel.launches
    y, _ = stlt_lib.apply_stlt(cuda, cfg, x.to(dev))
    _assert_close(y.cpu(), stlt_lib.apply_stlt(params, cfg, x)[0])
    if not bidirectional:
        outs = {}
        for where, p in ((torch.device("cpu"), params), (dev, cuda)):
            _, st = stlt_lib.stlt_prefill(p, cfg, x[:, :200].to(where))
            valid = torch.tensor([100, 0], dtype=torch.int32, device=where)
            y2, st2 = stlt_lib.stlt_prefill(p, cfg, x[:, 200:].to(where), state=st,
                                            valid=valid)
            assert torch.equal(st2["buf"][1], st["buf"][1])
            steps = []
            for t in range(4):
                yt, st2 = stlt_lib.apply_stlt_step(p, cfg, x[:, 296 + t].to(where), st2)
                steps.append(yt)
            outs[where.type] = (y2[0, :100], torch.stack(steps), st2["buf"], st2["pos"])
        for a, b in zip(outs[dev.type], outs["cpu"]):
            if a.dtype == torch.int32:
                assert torch.equal(a.cpu(), b)
            else:
                _assert_close(a.cpu(), b)
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches == before


def test_sharded_serve_on_the_card_matches_single_host(dev):
    """``ShardedServeEngine`` (2 hosts x 2 slots, a replicated warmed
    prefix) on the card against the single-host engine on 4 slots, same
    weights: the same streams, both hosts serving, the warmed prefix hit on
    every request, and K1 once per layer per [4, chunk] admission dispatch."""
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.models import transformer as T
    from repro_torch.serving import (PrefixCache, ReplicatedPrefixCache, Request,
                                     ServeEngine, ShardedServeEngine)

    cfg = CONFIG.reduced(num_layers=2)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    reqs = [Request(np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
                    m, id=i) for i, (n, m) in enumerate([(40, 5), (9, 1), (21, 6), (50, 4),
                                                         (16, 7), (33, 3)])]
    arrivals = [0, 0, 1, 4, 4, 6]
    single = ServeEngine(params, cfg, prefill_chunk=16, prefix_cache=PrefixCache(), device=dev)
    single.warm_prefix(sys_prompt)
    want = single.serve(reqs, slots=4, arrivals=arrivals)
    cache = ReplicatedPrefixCache(2)
    eng = ShardedServeEngine(params, cfg, n_hosts=2, slots_per_host=2, prefill_chunk=16,
                             prefix_cache=cache, device=dev)
    eng.warm_prefix(sys_prompt)
    before = k1.stlt_scan_kernel.launches
    got, stats = eng.serve(reqs, arrivals=arrivals, return_stats=True)
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches - before == (
        cfg.num_layers * eng.serve_stats["admission_dispatches"]) > 0
    for r in reqs:
        np.testing.assert_array_equal(got[r.id], want[r.id])
        assert stats[r.id]["cached_tokens"] == len(sys_prompt)
    assert {s["host"] for s in stats.values()} == {0, 1}
    assert cache.stats()["replication_ok"]


@pytest.mark.parametrize("reverse", [False, True])
def test_recompute_param_grads_through_k1_match_analytic(dev, reverse):
    """``param_grads="recompute"`` on the card (K1 forward and dx, the pole
    and mixer grads by autograd through the plain version) against the
    analytic grads at stlt-base's batch-4 shape: dx bit for bit (the same
    K1 pass), the rest within RTOL_SCALE of the scale; 2 K1 launches each."""
    x, lm, th, ur, ui, _, _, _ = _operands(dev, 32, 1000, 64, 64, 128, seed=6)
    dz = torch.randn(32, 1000, 64, generator=torch.Generator().manual_seed(7)).to(dev)
    grads = {}
    for mode in ("analytic", "recompute"):
        ins = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
        before = k1.stlt_scan_kernel.launches
        z = ops.stlt_scan(*ins, chunk=128, reverse=reverse, param_grads=mode)
        grads[mode] = torch.autograd.grad(z, ins, dz)
        torch.cuda.synchronize()
        assert k1.stlt_scan_kernel.launches == before + 2
    assert torch.equal(grads["recompute"][0], grads["analytic"][0])
    for a, b in zip(grads["recompute"][1:], grads["analytic"][1:]):
        _assert_close(a.double(), b.double())


def test_disagg_serve_on_the_card_matches_colocated(dev):
    """A reduced stlt-base served by the disaggregated fleets on the card (2
    prefill hosts, 2 decode hosts x 2 rows, loopback transport, f32 wire):
    the streams of the colocated card serve; K1 launched once per layer per
    prefill-fleet admission dispatch and never by the decode fleet; a
    shipped blob unpacks bit for bit to the state the prefill engine
    packed."""
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.models import transformer as T
    from repro_torch.serving import DisaggController, Request, ServeEngine
    from repro_torch.serving.disagg import wire
    from repro_torch.utils import tree_flatten_with_paths

    cfg = CONFIG.reduced(num_layers=2)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m, id=i)
            for i, (n, m) in enumerate([(40, 5), (9, 3), (21, 6), (50, 4), (16, 7)])]
    arrivals = [0, 0, 1, 4, 4]
    base = ServeEngine(params, cfg, prefill_chunk=16, device=dev).serve(
        reqs, slots=4, arrivals=arrivals)
    ctl = DisaggController(params, cfg, n_prefill=2, n_decode=2, slots=2, prefill_chunk=16,
                           device=dev)
    packed, blobs = {}, {}
    real_promote, real_accept = ctl.prefill._handoff_promote, ctl._accept_handoff

    def capture_state(run, h, local, ent, logits1, st1):
        packed[ent["req"].id] = [(k, t.clone()) for k, t in tree_flatten_with_paths(st1)]
        return real_promote(run, h, local, ent, logits1, st1)

    def capture_blob(msg, j, d_run, receiver):
        blobs.setdefault(msg.payload["req"].id, msg.payload["blob"])
        return real_accept(msg, j, d_run, receiver)
    ctl.prefill._handoff_promote, ctl._accept_handoff = capture_state, capture_blob
    before = k1.stlt_scan_kernel.launches
    out = ctl.serve(reqs, arrivals=arrivals)
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches - before == (
        cfg.num_layers * ctl.prefill.serve_stats["admission_dispatches"]) > 0
    assert ctl.decode.serve_stats["admission_dispatches"] == 0
    for r in reqs:
        np.testing.assert_array_equal(out[r.id], base[r.id])
    assert sorted(blobs) == sorted(packed) == [r.id for r in reqs]
    for rid, leaves in packed.items():
        got = dict(tree_flatten_with_paths(wire.unpack_state(blobs[rid], device=dev)[0]))
        for k, t in leaves:
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), (rid, k)


def test_full_width_spec_verify_on_the_card_matches_the_cpu(dev):
    """One ``spec_verify`` of full-width SmolLM-360M-stlt (32 layers, d_model
    960, S = 32) over 4 slots with k = 4, from a prefilled state, with
    drafts that follow the model's greedy continuation fully, for one
    token, not at all, and an idle row: the card (K1, one launch per layer)
    against the same call on the CPU. In fp32 activations, so that the two
    differ only by summation order and greedy and commit are exact; bf16's
    rounding flips are phase P's near-tie rule in chip_smoke.py."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(get_config("smollm-360m", "stlt"), dtype="float32")
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
    _, state = T.prefill(params, cfg, prompts, 0)
    L = 5
    inputs = torch.from_numpy(rng.integers(0, cfg.vocab, (4, L))).to(torch.int32)
    inputs[:, 0] = prompts[:, -1].to(torch.int32)
    full = torch.full((4,), L, dtype=torch.int32)
    for _ in range(L - 1):   # drafts = the greedy continuation
        greedy, _, _ = T.spec_verify(params, cfg, inputs, state, full)
        inputs[:, 1:] = greedy[:, :-1]
    inputs[1, 2:] = (inputs[1, 2:] + 1) % cfg.vocab
    inputs[2, 1:] = (inputs[2, 1:] + 1) % cfg.vocab
    valid = torch.tensor([L, L, L, 0], dtype=torch.int32)
    want = T.spec_verify(params, cfg, inputs, state, valid)
    before = k1.stlt_scan_kernel.launches
    got = T.spec_verify(tree_map(lambda t: t.to(dev), params), cfg, inputs.to(dev),
                        tree_map(lambda t: t.to(dev), state), valid.to(dev))
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches - before == cfg.num_layers
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert want[1].tolist() == [L, 2, 1, 0]
    assert torch.equal(got[2]["pos"].cpu(), want[2]["pos"])
    for lg, lw in zip(got[2]["layers"], want[2]["layers"]):
        for k in lw:
            _assert_close(lg[k].cpu(), lw[k])


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


def test_bf16_train_steps_on_the_card_match_the_cpu(dev):
    """Reduced SmolLM-360M-stlt in bf16 (remat on; the cast takes the
    embedding and FFN matrices and leaves w_v fp32), two ``make_step`` steps
    from the same weights on the card and on the CPU: 3 K1 launches a layer
    a step (forward, recompute, dx), loss and grad norm within 1e-2 relative
    (bf16 products summed in other orders), every moment leaf within 0.1 of
    its norm, the params within 2 lr of a moving step (Adam's sign)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch_stream
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_flatten_with_paths, tree_map

    cfg = get_config("smollm-360m", "stlt").reduced(
        num_layers=2, d_model=256, d_ff=512, vocab=512, dtype="bfloat16", remat=True)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for where in (dev, torch.device("cpu")):
        opt, step_fn = train.make_step(cfg, tcfg)
        p = tree_map(lambda t, w=where: t.to(w), params)
        state, metrics = opt.init(p), []
        k1.stlt_scan_kernel.launches = 0
        for step in range(2):
            batch = {k: torch.from_numpy(v).to(where)
                     for k, v in lm_batch_stream(0, step, 2, 64, cfg.vocab).items()}
            p, state, m = step_fn(p, state, batch, step)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        out[where.type] = (p, state, metrics, k1.stlt_scan_kernel.launches)
    (pc, sc, mc, launches), (pp, sp, mp, _) = out["cuda"], out["cpu"]
    assert launches == 2 * 3 * cfg.num_layers
    for a, b in zip(mc, mp):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-2 * abs(b[k]), (k, a[k], b[k])
    for name in ("mu", "nu"):
        for (path, a), (_, b) in zip(tree_flatten_with_paths(sc[name]),
                                     tree_flatten_with_paths(sp[name])):
            rel = float(torch.linalg.vector_norm((a.cpu() - b).double())
                        / torch.linalg.vector_norm(b.double()))
            assert rel <= 0.1, (name, path, rel)
    for (path, a), (_, b) in zip(tree_flatten_with_paths(pc), tree_flatten_with_paths(pp)):
        assert a.dtype == torch.float32
        assert float((a.cpu() - b).abs().max()) <= 2 * tcfg.learning_rate + 1e-6, path


# ---------------------------------------------------------------------------
# the encoder-decoder family (whisper-base-stlt)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_bidirectional_apply_stlt_on_the_card_matches_the_cpu(dev, adaptive):
    """The bilateral STLT layer (K1 causal and anti-causal, minus the
    centre Re(sum_k u_k) v over the masked mixers) on the card against its
    plain version on the CPU at N = 300 (a padded tail in both directions),
    2 K1 launches, within RTOL_SCALE of the output's scale."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.utils import tree_map

    cfg = stlt_lib.STLTConfig(d_model=128, num_heads=2, num_nodes=32, chunk=128,
                              bidirectional=True,
                              adaptive=AdaptiveConfig(enabled=adaptive))
    params = stlt_lib.init_stlt(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(3, 300, 128, generator=torch.Generator().manual_seed(1))
    before = k1.stlt_scan_kernel.launches
    y, _ = stlt_lib.apply_stlt(tree_map(lambda t: t.to(dev), params), cfg, x.to(dev))
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches == before + 2
    want, _ = stlt_lib.apply_stlt(params, cfg, x)
    _assert_close(y.cpu(), want)


def test_encdec_on_the_card_matches_the_cpu(dev):
    """A reduced whisper-base-stlt (4 + 2 layers, stacked as the JAX package
    stacks them, remat on) on the card and on the CPU from the same weights:
    the encode makes 2 K1 calls a layer and the decode steps none; one
    train step's forward + backward makes 4 x 6 + 2 x 3 = 30 (remat
    recomputes each layer: encoder 2 forward, 2 recompute, 2 dx; decoder
    1 + 1 + 1); the teacher-forced logits, 5 decode steps' logits (the
    card's greedy tokens fed to both) and the loss within RTOL_SCALE of the
    scale, every grad leaf within 1e-2 of its norm (the cross-STLT's sharp
    softmax amplifies rounding), non-zero but for the cross-STLT's unread
    node mixers."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import whisper as W
    from repro_torch.utils import tree_flatten_with_paths, tree_map

    cfg = get_config("whisper-base", "stlt").reduced(scan_layers=True, remat=True)
    params = W.init_encdec(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    frames = torch.randn(2, 150, cfg.d_model, generator=g)
    toks = torch.randint(0, cfg.vocab, (2, 25), generator=g)
    batch = {"enc_inputs": frames, "dec_inputs": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for where in (dev, torch.device("cpu")):
        p = tree_map(lambda t, w=where: t.to(w), params)
        b = {k: v.to(where) for k, v in batch.items()}
        with torch.no_grad():
            before = k1.stlt_scan_kernel.launches
            st = steps.prefill_fn(cfg, 8)(p, b["enc_inputs"])
            torch.cuda.synchronize()
            enc = k1.stlt_scan_kernel.launches - before
            tok, rows, fed = torch.ones(2, dtype=torch.int64, device=where), [], []
            for i in range(5):
                lg, st = steps.decode_fn(cfg)(p, tok, st)
                rows.append(lg.cpu())
                tok = (out["cuda"]["fed"][i] if where.type == "cpu" else lg.argmax(-1)).to(where)
                fed.append(tok.cpu())
            torch.cuda.synchronize()
            dec = k1.stlt_scan_kernel.launches - before - enc
            teacher = W.apply_encdec(p, cfg, b["enc_inputs"], b["dec_inputs"]).cpu()
        before = k1.stlt_scan_kernel.launches
        loss, _, grads = train.loss_and_grads(p, cfg, b, tau=1.0)
        torch.cuda.synchronize()
        out[where.type] = {"enc": enc, "dec": dec, "rows": torch.stack(rows, 1), "fed": fed,
                           "teacher": teacher, "loss": float(loss),
                           "train": k1.stlt_scan_kernel.launches - before,
                           "grads": tree_map(torch.Tensor.cpu, grads)}
    card, cpu = out["cuda"], out["cpu"]
    assert (card["enc"], card["dec"], card["train"]) == (8, 0, 30)
    _assert_close(card["teacher"], cpu["teacher"])
    _assert_close(card["rows"], cpu["rows"])
    assert abs(card["loss"] - cpu["loss"]) <= RTOL_SCALE * abs(cpu["loss"])
    for (path, a), (_, b) in zip(tree_flatten_with_paths(card["grads"]),
                                 tree_flatten_with_paths(cpu["grads"])):
        if "/cross/nodes/u_" in path:
            assert not a.any() and not b.any(), path
            continue
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0, path
        rel = float(torch.linalg.vector_norm((a - b).double())
                    / torch.linalg.vector_norm(b.double()))
        assert rel <= 1e-2, (path, rel)


def _attention_lm(layer_types=()):
    """Reduced native SmolLM-360M (4 layers, d_model 64, 4 heads, 2 KV
    heads, RoPE; or local_attn blocks over a 16-token window), fp32, random
    weights from seed 0, on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm-360m").reduced(layer_types=layer_types,
                                            local_window=16 if layer_types else 0)
    return cfg, T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("layer_types", [(), ("local_attn",) * 4], ids=["attn", "local_attn"])
def test_attention_chunked_prefill_on_the_card_matches_monolithic(dev, layer_types):
    """Native attention on the card, fp32: a 100-token prompt folded 24
    tokens a chunk (the last 4 tokens a masked tail of a 24-wide chunk)
    through ``prefill_chunk`` against the monolithic ``prefill`` (which
    takes the blockwise path: N >= the reduced threshold of 64), then 4
    decode steps from each; last logits and every step within RTOL_SCALE
    of the scale; the card's monolithic logits against the CPU's too. No
    K1 launch: attention never reaches the STLT scan."""
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_map

    cfg, params = _attention_lm(layer_types)
    toks = torch.randint(0, cfg.vocab, (2, 104), generator=torch.Generator().manual_seed(1))
    before = k1.stlt_scan_kernel.launches
    with torch.no_grad():
        cpu_logits, _ = T.prefill(params, cfg, toks[:, :100], 128)
        p = tree_map(lambda t: t.to(dev), params)
        t = toks.to(dev)
        mono, sm = T.prefill(p, cfg, t[:, :100], 128)
        sc = T.init_decode_state(cfg, 2, 128, device=dev)
        for a in range(0, 100, 24):
            chunk = torch.zeros(2, 24, dtype=t.dtype, device=dev)
            n = min(24, 100 - a)
            chunk[:, :n] = t[:, a:a + n]
            chunked, sc = T.prefill_chunk(p, cfg, chunk, sc,
                                          valid_len=torch.full((2,), n, device=dev))
        _assert_close(chunked.cpu(), mono.cpu())
        _assert_close(mono.cpu(), cpu_logits)
        for i in range(100, 104):
            la, sm = T.decode_step(p, cfg, t[:, i], sm)
            lb, sc = T.decode_step(p, cfg, t[:, i], sc)
            _assert_close(lb.cpu(), la.cpu())
    torch.cuda.synchronize()
    assert k1.stlt_scan_kernel.launches == before


# bf16 activations and bf16 matrices (every matrix cast, not only those past
# the serving cast's 65,536 elements, so scores, softmax inputs and the PV
# product all run at bf16) against fp32, from the same weights: at these
# widths the CPU reads a logit gap of 0.009-0.013 at a logit scale of ~0.6
# over three seeds, both block kinds (2^-8 relative rounding per op through
# 4 layers); the bound is 5e-2 of (1 + scale), ~3x that.
ATTN_BF16_TOL = 5e-2


@pytest.mark.parametrize("layer_types", [(), ("local_attn",) * 4], ids=["attn", "local_attn"])
def test_attention_bf16_on_the_card_is_near_fp32(dev, layer_types):
    """The reduced native model's logits over 100 tokens on the card in
    bf16 (activations and matrices) against fp32, within ATTN_BF16_TOL of
    (1 + the fp32 scale), finite; the fp32 logits against the CPU's."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.utils import cast_params_for_compute, tree_map

    cfg, params = _attention_lm(layer_types)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        cpu, _ = T.apply_lm(params, cfg, toks)
        p = tree_map(lambda t: t.to(dev), params)
        ref, _ = T.apply_lm(p, cfg, toks.to(dev))
        low, _ = T.apply_lm(cast_params_for_compute(p, torch.bfloat16, min_size=0),
                            dataclasses.replace(cfg, dtype="bfloat16"), toks.to(dev))
    _assert_close(ref.cpu(), cpu)
    assert low.dtype == torch.bfloat16 and bool(torch.isfinite(low).all())
    gap = float((low.float() - ref).abs().max())
    assert gap <= ATTN_BF16_TOL * (1 + float(ref.abs().max())), gap


NEW_ARCHS = [("recurrentgemma-9b", "native"), ("recurrentgemma-9b", "stlt"),
             ("chatglm3-6b", "native"), ("chatglm3-6b", "stlt"),
             ("granite-20b", "native"), ("granite-20b", "stlt"),
             ("internvl2-76b", "native"), ("internvl2-76b", "stlt"),
             ("xlstm-350m", "native"), ("qwen3-moe-235b-a22b", "native"),
             ("qwen3-moe-235b-a22b", "stlt"), ("arctic-480b", "native"),
             ("arctic-480b", "stlt")]
XLSTM_MOE = NEW_ARCHS[-5:]


@pytest.mark.parametrize("arch,variant", NEW_ARCHS, ids=[f"{a}-{v}" for a, v in NEW_ARCHS])
def test_new_archs_on_the_card_match_the_cpu(dev, arch, variant):
    """Each new arch at ``reduced()`` widths (fp32; the untied head; the
    hybrid's rg-LRU blocks; xLSTM cells; experts): ``apply_lm`` logits over
    2 x 40 tokens on the card against the CPU within RTOL_SCALE of the
    scale, and a continuous serve (coalesced chunked admission, staggered
    arrivals) with the same streams on both, K1 launched once per STLT
    layer per admission dispatch and never by a native model."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.utils import tree_map

    cfg = get_config(arch, variant).reduced()
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cpu, _ = T.apply_lm(params, cfg, toks)
        card, _ = T.apply_lm(tree_map(lambda t: t.to(dev), params), cfg, toks.to(dev))
    _assert_close(card.cpu(), cpu)
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m, id=i)
            for i, (n, m) in enumerate([(30, 5), (9, 3), (21, 6), (2, 4)])]
    results = []
    for where in ("cpu", dev):
        eng = ServeEngine(params, cfg, max_len=64, prefill_chunk=16, device=where)
        before = k1.stlt_scan_kernel.launches
        results.append(eng.serve(reqs, slots=3, arrivals=[0, 0, 1, 4]))
        torch.cuda.synchronize()
    n_stlt = sum(bt == "stlt" for bt in cfg.block_types())
    assert k1.stlt_scan_kernel.launches - before == (
        n_stlt * eng.serve_stats["admission_dispatches"])
    for r in reqs:
        np.testing.assert_array_equal(results[1][r.id], results[0][r.id])


@pytest.mark.parametrize("arch,variant", XLSTM_MOE, ids=[f"{a}-{v}" for a, v in XLSTM_MOE])
def test_xlstm_and_moe_train_step_on_the_card_matches_the_cpu(dev, arch, variant):
    """One ``make_step`` (the config's optimizer: AdamW for xLSTM,
    adafactor for the MoE archs) at ``reduced()`` widths in fp32 on 2 x 32
    tokens, card against CPU: loss, ce, aux_loss, router_z and grad_norm
    within 1e-5 relative, the updated params within 1e-5; with the MoE's
    dropped choices counted the same on both."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch_stream
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_flatten_with_paths, tree_map

    cfg = get_config(arch, variant).reduced()
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = lm_batch_stream(0, 0, 2, 32, cfg.vocab)
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where), params)
        opt, step = train.make_step(cfg, tcfg)
        moe.DROPS.reset()
        p, _, m = step(p, opt.init(p), {k: torch.from_numpy(v).to(where)
                                        for k, v in batch.items()}, 0)
        out[str(where)] = (tree_map(lambda t: t.cpu(), p), {k: float(v) for k, v in m.items()},
                           moe.DROPS.read()["dropped"])
    (pc, mc, dc), (pg, mg, dg) = out["cpu"], out[str(dev)]
    assert dc == dg
    for k in ("loss", "ce", "aux_loss", "router_z", "grad_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-5 * abs(mc[k]) + 1e-12, (k, mg[k], mc[k])
    for (path, a), (_, b) in zip(tree_flatten_with_paths(pg), tree_flatten_with_paths(pc)):
        assert float((a - b).abs().max()) <= 1e-5, path


def test_moe_combine_is_deterministic_on_the_card(dev):
    """apply_moe at reduced qwen3-moe widths (capacity factor 0.5) in bf16
    on 4 x 64 tokens, a dispatch that drops: two calls on the card give the same output bit
    for bit (the K contributions of a token are summed in slot order, not
    by atomics); in fp32 the card's output is the CPU's within RTOL_SCALE
    of the scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced().moe_config(),
                              capacity_factor=0.5)     # capacity 64 for a mean load of 128
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pb = {k: v.to(dev, torch.bfloat16) for k, v in p.items()}
    moe.DROPS.reset()
    y1, _ = moe.apply_moe(pb, cfg, x.to(dev, torch.bfloat16))
    y2, _ = moe.apply_moe(pb, cfg, x.to(dev, torch.bfloat16))
    assert moe.DROPS.read()["dropped"] > 0
    assert torch.equal(y1, y2)
    y, _ = moe.apply_moe(p, cfg, x)
    y_card, _ = moe.apply_moe({k: v.to(dev) for k, v in p.items()}, cfg, x.to(dev))
    _assert_close(y_card.cpu(), y)


@pytest.mark.parametrize("dispatch", ["gather", "shard_map"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_apply_moe_ep_on_one_rank_equals_apply_moe_on_the_card(dev, arch, dtype, dispatch):
    """The expert-parallel MoE with no group (every expert on the rank, one
    batch shard) is the gather path on the card bit for bit, in either
    dispatch (one shard's capacity is the global one): y, aux_loss,
    router_z, and the dropped choices it counts, at reduced widths
    (capacity factor 0.5, arctic with its dense branch) on 4 x 64 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tp_lib
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch).reduced().moe_config(), capacity_factor=0.5)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    p = {k: ({n: t.to(dev, dtype) for n, t in v.items()} if isinstance(v, dict)
             else v.to(dev, dtype)) for k, v in p.items()}
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    moe.DROPS.reset()
    y, aux = moe.apply_moe(p, cfg, x)
    drops = moe.DROPS.read()["dropped"]
    moe.DROPS.reset()
    y_ep, aux_ep = tp_lib.apply_moe_ep(p, dataclasses.replace(cfg, dispatch=dispatch), x)
    assert drops > 0 and moe.DROPS.read()["dropped"] == drops
    assert torch.equal(y_ep, y)
    for k in ("aux_loss", "router_z"):
        assert torch.equal(aux_ep[k], aux[k]), k


def test_context_parallel_matches_serial_k1_on_the_card(dev, tmp_path):
    """``stlt_context_parallel`` on 4 gloo ranks sharing the card (K1's
    stateful call on each rank's 4 x 1024 tokens, one exchange of end
    states) against K1 over all 4096 tokens: within K1's gate, one K1
    launch per rank."""
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen([sys.executable, str(root / "tests" / "torch_dist_worker.py"),
                               str(tmp_path), str(r), "4", "cuda-cp"], env=env,
                              stderr=subprocess.PIPE) for r in range(4)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-3000:]
    for r in range(4):
        res = torch.load(tmp_path / f"cp{r}.pt")
        assert res["launches"] == 1
        assert res["err"] <= RTOL_SCALE * res["scale"], (r, res)


def test_sharded_serving_on_the_card(dev, tmp_path):
    """Phase DS at reduced width (2 layers), 4 gloo ranks sharing the card:
    DS1's 2 x 2 prefill cell (a K1 launch per layer per rank) and decode
    cell (none) against the single-device functions on the card (logits
    within 1e-3, each rank's state slice within K1's gate, streams under
    the near-tie rule); DS2's process-form engine on 2 host ranks against
    the one-process engine (hosts and ticks equal, K1 = layers x each
    rank's admission dispatches)."""
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen([sys.executable, str(root / "tests" / "torch_dist_worker.py"),
                               str(tmp_path), str(r), "4", "cuda-serve"], env=env,
                              stderr=subprocess.PIPE) for r in range(4)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-3000:]
    res = [torch.load(tmp_path / f"serve{r}.pt", weights_only=False) for r in range(4)]
    for r in res:
        d = r["DS1"]
        assert d["prefill_k1"] == r["layers"] and set(d["decode_k1"]) == {0}, d
        assert d["logit_gap"] <= 1e-3 and d["prefill_state_gap_over_tol"] <= 1.0, d
        assert d["final_state_gap_over_tol"] is None or d["final_state_gap_over_tol"] <= 1.0
        h = r["DS2"]
        if h["member"]:
            assert h["k1"] == r["layers"] * h["dispatches"]["admission_dispatches"] > 0, h
    assert res[0]["DS2"]["ticks_equal"] and set(res[0]["DS2"]["hosts"].values()) == {0, 1}
    assert [r["DS2"]["member"] for r in res] == [True, True, False, False]
