"""Parity of the PyTorch port's scan algebra and K1 host side with the JAX
package, on the CPU (the port's plain version of K1).

Inputs are made with numpy from a seed and fed to both packages. The JAX
reference runs both its jnp path (``use_kernel=False``) and its Pallas
kernel in interpret mode (``interpret=True, block_d=8``), as
tests/test_kernels.py runs it; the JAX scan calls are jitted so each
compiles once. Tolerance: atol 3e-5 on fp32 scan outputs, the same bound
tests/test_kernels.py holds the Pallas kernel to.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.core import nodes as j_nodes  # noqa: E402
from repro.core import scan as j_scan  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.core import nodes as t_nodes  # noqa: E402
from repro_torch.core import scan as t_scan  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import stlt_scan as t_k1  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

ATOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _scan_inputs(seed, BH, N, d, S):
    r = np.random.default_rng(seed)
    x = r.normal(size=(BH, N, d)).astype(np.float32)
    lm = -r.uniform(0.01, 0.5, size=(BH, S)).astype(np.float32)
    th = r.uniform(-0.8, 0.8, size=(BH, S)).astype(np.float32)
    ur = (r.normal(size=(BH, S)) / S).astype(np.float32)
    ui = (r.normal(size=(BH, S)) / S).astype(np.float32)
    h0r = r.normal(size=(BH, S, d)).astype(np.float32)
    h0i = r.normal(size=(BH, S, d)).astype(np.float32)
    return x, lm, th, ur, ui, h0r, h0i


# ---------------------------------------------------------------------------
# (a) ops.stlt_scan: carry in, per-row valid snapshot out
# ---------------------------------------------------------------------------

JAX_PATHS = {"jnp": dict(use_kernel=False),
             "pallas_interpret": dict(interpret=True, block_d=8)}


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
@pytest.mark.parametrize("N,chunk", [(37, 16), (48, 16), (5, 8), (129, 32)])
def test_stlt_scan_carry_valid_matches_jax(path, N, chunk):
    """Odd and exact splits, h0 != 0, per-row valid in {0, 1, C, N} (clipped
    to N) and per-row mixers u: z and the snapshot carry."""
    BH, d, S = 4, 8, 8
    x, lm, th, ur, ui, h0r, h0i = _scan_inputs(N + chunk, BH, N, d, S)
    valid = np.array([0, 1, min(chunk, N), N], np.int32)
    j_scan_fn = jax.jit(functools.partial(j_ops.stlt_scan, chunk=chunk,
                                          return_state=True, **JAX_PATHS[path]))
    zj, (hrj, hij) = j_scan_fn(
        jnp.asarray(x), jnp.asarray(lm), jnp.asarray(th), jnp.asarray(ur),
        jnp.asarray(ui), h0_re=jnp.asarray(h0r), h0_im=jnp.asarray(h0i),
        valid=jnp.asarray(valid))
    zt, (hrt, hit) = t_ops.stlt_scan(
        _t(x), _t(lm), _t(th), _t(ur), _t(ui), chunk=chunk, h0_re=_t(h0r),
        h0_im=_t(h0i), valid=_t(valid), return_state=True)
    _close(zt, zj)
    _close(hrt, hrj)
    _close(hit, hij)
    # valid == 0 rows hand back h0 exactly
    np.testing.assert_array_equal(_np(hrt)[0], h0r[0])
    np.testing.assert_array_equal(_np(hit)[0], h0i[0])


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
def test_stlt_scan_fresh_matches_jax(path):
    """No carry in, final state at N (the fresh prefill) and z-only calls."""
    BH, N, d, S, C = 3, 45, 8, 8, 16
    x, lm, th, ur, ui, _, _ = _scan_inputs(7, BH, N, d, S)
    args_j = [jnp.asarray(a) for a in (x, lm, th, ur, ui)]
    args_t = [_t(a) for a in (x, lm, th, ur, ui)]
    zj, (hrj, hij) = jax.jit(functools.partial(
        j_ops.stlt_scan, chunk=C, return_state=True, **JAX_PATHS[path]))(*args_j)
    zt, (hrt, hit) = t_ops.stlt_scan(*args_t, chunk=C, return_state=True)
    _close(zt, zj)
    _close(hrt, hrj)
    _close(hit, hij)
    _close(t_ops.stlt_scan(*args_t, chunk=C), zj)


def test_stlt_scan_reference_is_one_pass_of_the_kernel_algebra():
    """``stlt_scan_reference`` on the operators ``ops`` builds equals the
    JAX Pallas kernel (interpret mode) on the same operators."""
    from repro.kernels.stlt_scan import stlt_scan_kernel as j_kernel

    BH, N, d, S, C = 2, 32, 8, 8, 16
    x, lm, th, ur, ui, h0r, h0i = _scan_inputs(3, BH, N, d, S)
    g, A, B, pre, pim, dec = t_ops._filter_ops(_t(lm), _t(th), _t(ur), _t(ui), C)
    spre, spim, sdec, gate = t_ops._snapshot_ops(_t(lm), _t(th), _t(np.array([9, 32])),
                                                 N, C, N // C)
    ops = [gate, _t(x), t_ops._toeplitz(g), A, B, pre, pim, dec, _t(h0r),
           _t(h0i), spre, spim, sdec]
    out_t = t_k1.stlt_scan_reference(*ops, chunk=C)
    out_j = j_kernel(*[jnp.asarray(_np(o)) for o in ops], chunk=C, block_d=8,
                     interpret=True)
    for a, b in zip(out_t, out_j):
        _close(a, b)


# ---------------------------------------------------------------------------
# host-side operators
# ---------------------------------------------------------------------------


def test_filter_toeplitz_snapshot_ops_match_jax():
    BH, S, C, nc = 4, 8, 16, 3
    _, lm, th, ur, ui, _, _ = _scan_inputs(11, BH, 1, 1, S)
    for a, b in zip(t_ops._filter_ops(_t(lm), _t(th), _t(ur), _t(ui), C),
                    j_ops._filter_ops(jnp.asarray(lm), jnp.asarray(th),
                                      jnp.asarray(ur), jnp.asarray(ui), C)):
        _close(a, b, atol=1e-6)
    g = _t(_scan_inputs(12, BH, 1, C, 1)[0][:, 0])
    _close(t_ops._toeplitz(g), j_ops._toeplitz(jnp.asarray(_np(g))), atol=0)
    valid = np.array([0, 1, 16, 40], np.int32)
    for a, b in zip(t_ops._snapshot_ops(_t(lm), _t(th), _t(valid), 40, C, nc),
                    j_ops._snapshot_ops(jnp.asarray(lm), jnp.asarray(th),
                                        jnp.asarray(valid), 40, C, nc)):
        _close(a, b, atol=1e-6)


@pytest.mark.parametrize("q", [[0, 1, 16, 17], [5, 32, 31, 2]])
def test_snapshot_operators_and_carry_snapshot_match_jax(q):
    """c* = max(q-1, 0)//C (q = 0 lands in chunk 0 with r = 0)."""
    B, S, C, d = 4, 8, 16, 8
    _, lm, th, _, _, h0r, h0i = _scan_inputs(13, B, 1, d, S)
    q = np.asarray(q, np.int32)
    out_t = t_scan.stlt_snapshot_operators(_t(lm), _t(th), _t(q), C)
    out_j = j_scan.stlt_snapshot_operators(jnp.asarray(lm), jnp.asarray(th),
                                           jnp.asarray(q), C)
    np.testing.assert_array_equal(_np(out_t[0]), np.asarray(out_j[0]))
    for a, b in zip(out_t[1:], out_j[1:]):
        _close(a, b, atol=1e-6)
    xs = np.random.default_rng(1).normal(size=(B, C, d)).astype(np.float32)
    for a, b in zip(
            t_scan.stlt_carry_snapshot(_t(xs), _t(h0r), _t(h0i), _t(lm), _t(th),
                                       _t(q), C),
            j_scan.stlt_carry_snapshot(jnp.asarray(xs), jnp.asarray(h0r),
                                       jnp.asarray(h0i), jnp.asarray(lm),
                                       jnp.asarray(th), jnp.asarray(q), C)):
        _close(a, b)


def test_chunk_powers_and_decode_step_match_jax():
    B, H, S, d = 2, 3, 8, 8
    r = np.random.default_rng(5)
    lm = -r.uniform(0.01, 0.5, size=(S,)).astype(np.float32)
    th = r.uniform(-0.8, 0.8, size=(S,)).astype(np.float32)
    for a, b in zip(t_scan._chunk_powers(_t(lm), _t(th), 16),
                    j_scan._chunk_powers(jnp.asarray(lm), jnp.asarray(th), 16)):
        _close(a, b, atol=1e-6)
    x = r.normal(size=(B, H, d)).astype(np.float32)
    hr, hi = (r.normal(size=(B, H, S, d)).astype(np.float32) for _ in range(2))
    lmh = np.broadcast_to(lm, (H, S)).copy()
    thh = np.broadcast_to(th, (H, S)).copy()
    ur, ui = (r.normal(size=(B, H, S)).astype(np.float32) for _ in range(2))
    out_t = t_scan.stlt_decode_step(_t(x), _t(hr), _t(hi), _t(lmh), _t(thh),
                                    _t(ur), _t(ui))
    out_j = j_scan.stlt_decode_step(*(jnp.asarray(a) for a in
                                      (x, hr, hi, lmh, thh, ur, ui)))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-5)


# ---------------------------------------------------------------------------
# nodes and adaptive masks
# ---------------------------------------------------------------------------


def test_node_poles_match_jax():
    p = j_nodes.init_nodes(jax.random.key(3), 4, 8)
    pt = {k: _t(v) for k, v in p.items()}
    for a, b in zip(t_nodes.node_poles(pt), j_nodes.node_poles(p)):
        _close(a, b, atol=1e-6)
    for a, b in zip(t_nodes.node_poles(pt, fold_window=False, delta=0.5),
                    j_nodes.node_poles(p, fold_window=False, delta=0.5)):
        _close(a, b, atol=1e-6)


def test_half_lives_match_jax():
    """The interpretability readout ln2/sigma on nodes converted from the
    JAX package's ``init_nodes``, and after the nodes move: within 1e-6
    relative (sigma down to 1e-3 gives half-lives up to ~690 tokens)."""
    p = j_nodes.init_nodes(jax.random.key(5), 4, 16)
    p = {**p, "sigma_hat": p["sigma_hat"] + 0.3 * jax.random.normal(jax.random.key(6), (4, 16))}
    got = t_nodes.half_lives({k: _t(v) for k, v in p.items()})
    want = j_nodes.half_lives(p)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=0)
    from repro_torch.core import half_lives
    assert half_lives is t_nodes.half_lives


def test_exponential_window_matches_jax():
    """exp(-|t|/T) on both sides of 0, T per head and a T below the 1e-6
    clamp."""
    t = np.arange(-40, 41, dtype=np.float32)[:, None]
    T = np.array([1e-8, 0.5, 3.0, 32.0, 700.0], np.float32)[None, :]
    got = t_nodes.exponential_window(_t(t), _t(T))
    want = j_nodes.exponential_window(jnp.asarray(t), jnp.asarray(T))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=0)


def test_init_nodes_layout_and_range():
    gen = torch.Generator().manual_seed(0)
    p = t_nodes.init_nodes(gen, 4, 8)
    pj = j_nodes.init_nodes(jax.random.key(0), 4, 8)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in pj.items()}
    log_mag, _, sigma, T = t_nodes.node_poles(p)
    assert bool((log_mag < 0).all()) and bool((sigma > 0).all())
    np.testing.assert_allclose(_np(T), 32.0, rtol=1e-5)


@pytest.mark.parametrize("hard_eval", [False, True])
def test_masks_and_node_masks_match_jax(hard_eval):
    B, N, d, H, S = 3, 10, 16, 4, 8
    p = j_adaptive.init_adaptive(jax.random.key(1), d, H, S)
    p = {"w_alpha": p["w_alpha"] * 50.0, "b_alpha": p["b_alpha"] - 2.0}
    pt = {k: _t(v) for k, v in p.items()}
    cfg_j = j_adaptive.AdaptiveConfig(enabled=True, hard_eval=hard_eval, tau=0.7)
    cfg_t = t_adaptive.AdaptiveConfig(enabled=True, hard_eval=hard_eval, tau=0.7)
    x = np.random.default_rng(2).normal(size=(B, N, d)).astype(np.float32)
    pad = (np.arange(N)[None] < np.array([[10], [4], [1]])).astype(np.float32)
    for pm in (None, pad):
        mj, sj = j_adaptive.node_masks(p, jnp.asarray(x), cfg_j,
                                       pad_mask=None if pm is None else jnp.asarray(pm))
        mt, st = t_adaptive.node_masks(pt, _t(x), cfg_t,
                                       pad_mask=None if pm is None else _t(pm))
        _close(mt, mj, atol=1e-6)
        _close(st, sj, atol=1e-5)
    # the stochastic path with no noise source is the plain relaxed sigmoid
    mj, _ = j_adaptive.node_masks(p, jnp.asarray(x), cfg_j, deterministic=False)
    mt, _ = t_adaptive.node_masks(pt, _t(x), cfg_t, deterministic=False)
    _close(mt, mj, atol=1e-6)


def test_node_rank_cap_mask_importance_regularization_match_jax():
    r = np.random.default_rng(4)
    H, S, B = 3, 8, 4
    imp = r.integers(0, 3, size=(H, S)).astype(np.float32)  # many ties
    np.testing.assert_array_equal(_np(t_adaptive.node_rank(_t(imp))),
                                  np.asarray(j_adaptive.node_rank(jnp.asarray(imp))))
    cap = np.array([1, 3, 8, 0], np.int32)
    np.testing.assert_array_equal(
        _np(t_adaptive.node_cap_mask(_t(imp), _t(cap))),
        np.asarray(j_adaptive.node_cap_mask(jnp.asarray(imp), jnp.asarray(cap))))
    ur, ui = r.normal(size=(2, H, S)).astype(np.float32)
    lm = -r.uniform(0.01, 0.5, size=(H, S)).astype(np.float32)
    _close(t_adaptive.node_importance(_t(ur), _t(ui), _t(lm)),
           j_adaptive.node_importance(*(jnp.asarray(a) for a in (ur, ui, lm))),
           atol=1e-4)
    sigma = r.uniform(0.01, 1.0, size=(H, S)).astype(np.float32)
    sigma[0, 3] = sigma[0, 5]  # a tie in the sort
    omega = r.normal(size=(H, S)).astype(np.float32)
    masks = r.uniform(size=(B, H, S)).astype(np.float32)
    cfg = t_adaptive.AdaptiveConfig(enabled=True, lambda_sigma=0.3)
    cfg_j = j_adaptive.AdaptiveConfig(enabled=True, lambda_sigma=0.3)
    for m in (None, masks):
        _close(t_adaptive.regularization(_t(sigma), _t(omega),
                                         None if m is None else _t(m), cfg),
               j_adaptive.regularization(jnp.asarray(sigma), jnp.asarray(omega),
                                         None if m is None else jnp.asarray(m),
                                         cfg_j), atol=1e-6)


# ---------------------------------------------------------------------------
# dispatch: a CPU tensor takes the plain version; the kernel wrapper takes
# nothing but CUDA tensors
# ---------------------------------------------------------------------------


def test_cpu_dispatch_counts_no_kernel_launch():
    x, lm, th, ur, ui, _, _ = _scan_inputs(0, 2, 20, 8, 8)
    before = t_k1.stlt_scan_kernel.launches
    t_ops.stlt_scan(*(_t(a) for a in (x, lm, th, ur, ui)), chunk=8)
    assert t_k1.stlt_scan_kernel.launches == before


def test_kernel_wrapper_rejects_cpu_tensors_and_other_devices():
    """K1's wrapper refuses CPU tensors; the scan refuses a device other
    than cuda and cpu (fake tensors on ``lazy``, a device this build has no
    kernels for), but for ``meta`` (the dry-run), which takes the kernel's
    op in its shape-only form."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, lm, th, ur, ui, _, _ = _scan_inputs(0, 2, 20, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        t_k1.stlt_scan_kernel(*(torch.zeros(1) for _ in range(13)), chunk=8)
    with FakeTensorMode(), pytest.raises(ValueError, match="cuda or cpu"):
        t_ops.stlt_scan(*(torch.empty(a.shape, device="lazy") for a in (x, lm, th, ur, ui)),
                        chunk=8)
    z = t_ops.stlt_scan(*(_t(a).to("meta") for a in (x, lm, th, ur, ui)), chunk=8)
    assert z.shape == x.shape and z.device.type == "meta"


# ---------------------------------------------------------------------------
# param_grads="recompute": the legacy backward, the analytic grads' baseline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_recompute_param_grads_match_analytic_and_jax(reverse):
    """The scan's VJP with ``param_grads="recompute"`` (autograd through the
    plain version on the detached x) against ``"analytic"`` and against the
    JAX package's grads on the CPU, where ``stlt_scan`` runs its plain jnp
    chunked scan and autodiff through it is the recompute path), N = 37
    over chunk 16, per-row poles. dx is the same anti-causal pass in both
    modes, so it agrees bit for bit; the pole and mixer grads within 1e-5 of
    each leaf's scale (sums over 37 x 8 products of O(1) terms)."""
    BH, N, d, S, C = 4, 37, 8, 8, 16
    x, lm, th, ur, ui, _, _ = _scan_inputs(21, BH, N, d, S)
    dz = np.random.default_rng(22).normal(size=(BH, N, d)).astype(np.float32)
    grads = {}
    for mode in ("analytic", "recompute"):
        ins = [_t(a).requires_grad_(True) for a in (x, lm, th, ur, ui)]
        z = t_ops.stlt_scan(*ins, chunk=C, reverse=reverse, param_grads=mode)
        grads[mode] = torch.autograd.grad(z, ins, _t(dz))
    j_fn = functools.partial(j_ops.stlt_scan, chunk=C, reverse=reverse, use_kernel=False,
                             param_grads="recompute")
    _, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (x, lm, th, ur, ui)))
    jgrads = vjp(jnp.asarray(dz))
    assert torch.equal(grads["recompute"][0], grads["analytic"][0])
    for a, r, j in zip(grads["analytic"], grads["recompute"], jgrads):
        tol = 1e-5 * (1.0 + float(np.abs(np.asarray(j)).max()))
        _close(r, a, atol=tol)
        _close(r, j, atol=tol)
    with pytest.raises(ValueError, match="param_grads"):
        t_ops.stlt_scan(*(_t(a) for a in (x, lm, th, ur, ui)), chunk=C, param_grads="nope")
