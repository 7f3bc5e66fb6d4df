"""Parity of the PyTorch port's training path with the JAX package, on the
CPU: the anti-causal scan, the scan's VJP (dx by the same pass run
anti-causally, analytic pole/mixer grads), the stochastic node masks with
the JAX package's own draws fed in, AdamW (fp32 and bf16 moments),
adafactor, gradient compression, clipping, schedules, data and the data
pipeline, remat, whole train steps of ``stlt-base`` ``.reduced()`` and
bf16 train steps of SmolLM-360M-stlt at reduced widths, and the CLI.

Inputs are made with numpy from a seed and fed to both packages. The JAX
scan runs through its chunked reference, and at one tiny shape through its
custom VJP with the Pallas kernel in interpret mode (``use_kernel=True,
interpret=True``), as tests/test_kernels.py runs it. Tolerances are stated
beside each test: fp32 results within a few 1e-7 of their scale (summation
order only), float64 ones within 1e-9, and equal where both packages do the
same float32 arithmetic.
"""
import dataclasses
import functools
import importlib
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.stlt_base import CONFIG as J_CONFIG  # noqa: E402
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.data import text as j_text  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import clip as j_clip  # noqa: E402
from repro.optim import schedules as j_schedules  # noqa: E402
from repro.utils import fold_key  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.stlt_base import CONFIG as T_CONFIG  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.data import synthetic as t_synthetic  # noqa: E402
from repro_torch.data import text as t_text  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import (cast_params_for_compute, tree_flatten_with_paths,  # noqa: E402
                               tree_leaves, tree_unflatten)
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

# the modules (``repro.optim`` re-exports their functions under the same names)
j_adamw = importlib.import_module("repro.optim.adamw")
j_adafactor = importlib.import_module("repro.optim.adafactor")
j_compression = importlib.import_module("repro.optim.compression")
j_optim = importlib.import_module("repro.optim")
t_adafactor = importlib.import_module("repro_torch.optim.adafactor")
ROOT = Path(__file__).resolve().parents[1]
# fp32 scan outputs and grads, port vs JAX: max abs err / max |ref|
REL_F32 = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_err(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scan_inputs(seed, BH, N, d, S, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.normal(size=(BH, N, d))
    lm = -r.uniform(0.01, 0.5, size=(BH, S))
    th = r.uniform(-0.8, 0.8, size=(BH, S))
    ur = r.normal(size=(BH, S)) / S
    ui = r.normal(size=(BH, S)) / S
    dz = r.normal(size=(BH, N, d))
    return [a.astype(dtype) for a in (x, lm, th, ur, ui, dz)]


# ---------------------------------------------------------------------------
# the port's sources import nothing of JAX
# ---------------------------------------------------------------------------


def test_port_imports_no_jax_and_nothing_of_repro():
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources += [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
    sources += sorted((ROOT / "examples").glob("torch_*.py"))
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    found = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
             for p in sources
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if bad.match(line) or re.search(r"import_module\(\s*['\"](jax|repro)\b", line)]
    assert len(sources) > 20 and not found, found


# ---------------------------------------------------------------------------
# (1) the anti-causal scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,chunk", [(48, 16), (40, 8), (37, 16)])
def test_reverse_scan_matches_jax(N, chunk):
    """reverse=True against the JAX package's, at N a multiple of the chunk
    and not; S = 8, d = 16. Within 1e-5 of the output's scale (fp32)."""
    x, lm, th, ur, ui, _ = _scan_inputs(N, 3, N, 16, 8)
    zj = jax.jit(functools.partial(j_ops.stlt_scan, chunk=chunk, reverse=True,
                                   use_kernel=False))(*map(jnp.asarray, (x, lm, th, ur, ui)))
    zt = t_ops.stlt_scan(*map(torch.from_numpy, (x, lm, th, ur, ui)), chunk=chunk,
                         reverse=True)
    assert _rel_err(zt, zj) <= REL_F32
    # anti-causal: z[t] does not depend on x[:t]
    x2 = x.copy()
    x2[:, :N // 2] += 1.0
    zt2 = t_ops.stlt_scan(*map(torch.from_numpy, (x2, lm, th, ur, ui)), chunk=chunk,
                          reverse=True)
    torch.testing.assert_close(zt2[:, N // 2:], zt[:, N // 2:], rtol=0, atol=0)


def test_reverse_is_refused_with_carry_state():
    x, lm, th, ur, ui, _ = map(torch.from_numpy, _scan_inputs(0, 2, 16, 8, 8))
    for kw in (dict(valid=torch.tensor([3, 16])),
               dict(h0_re=torch.zeros(2, 8, 8), h0_im=torch.zeros(2, 8, 8))):
        with pytest.raises(ValueError, match="forward-only"):
            t_ops.stlt_scan(x, lm, th, ur, ui, chunk=8, reverse=True, **kw)


@pytest.mark.parametrize("N,chunk", [(48, 16), (37, 16)])
def test_reverse_return_state_matches_jax(N, chunk):
    """reverse=True with return_state: z and the anti-causal carry after all
    N tokens against the JAX package's, within 1e-5 of each output's scale
    (fp32)."""
    x, lm, th, ur, ui, _ = _scan_inputs(N + 1, 3, N, 16, 8)
    zj, (hrj, hij) = jax.jit(functools.partial(
        j_ops.stlt_scan, chunk=chunk, reverse=True, return_state=True,
        use_kernel=False))(*map(jnp.asarray, (x, lm, th, ur, ui)))
    zt, (hrt, hit) = t_ops.stlt_scan(*map(torch.from_numpy, (x, lm, th, ur, ui)),
                                     chunk=chunk, reverse=True, return_state=True)
    for got, want in ((zt, zj), (hrt, hrj), (hit, hij)):
        assert _rel_err(got, want) <= REL_F32
    # the carry folds every token, the first one included
    x2 = x.copy()
    x2[:, 0] += 1.0
    _, (hr2, _) = t_ops.stlt_scan(*map(torch.from_numpy, (x2, lm, th, ur, ui)),
                                  chunk=chunk, reverse=True, return_state=True)
    assert not torch.allclose(hr2, hrt)


# ---------------------------------------------------------------------------
# (2) the VJP against jax.grad, (3) the analytic param grads in float64
# ---------------------------------------------------------------------------

JAX_VJP_PATHS = {"chunked": dict(use_kernel=False),
                 "pallas_interpret": dict(use_kernel=True, interpret=True, block_d=8)}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("path,BH,N,d,S,chunk", [
    ("pallas_interpret", 2, 24, 8, 8, 8),
    ("chunked", 3, 48, 16, 8, 16),
    ("chunked", 3, 37, 16, 8, 16),
    ("chunked", 2, 5, 8, 4, 8),
])
def test_scan_vjp_matches_jax_grad(path, BH, N, d, S, chunk, reverse):
    """dx and the four pole/mixer grads of sum(z * dz), the port's
    ``_StltScan`` against ``jax.grad`` of the JAX package's ``stlt_scan``
    (its custom VJP with the interpreted kernel, or its chunked reference).
    Each within 1e-5 of its largest entry (fp32)."""
    x, lm, th, ur, ui, dz = _scan_inputs(N * 7 + chunk, BH, N, d, S)

    def j_loss(*args):
        z = j_ops.stlt_scan(*args, chunk=chunk, reverse=reverse, **JAX_VJP_PATHS[path])
        return jnp.sum(z * jnp.asarray(dz))

    want = jax.jit(jax.grad(j_loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, (x, lm, th, ur, ui)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, lm, th, ur, ui)]
    z = t_ops.stlt_scan(*ins, chunk=chunk, reverse=reverse)
    got = torch.autograd.grad(z, ins, torch.from_numpy(dz))
    for name, g, w in zip(("dx", "dlog_mag", "dtheta", "du_re", "du_im"), got, want):
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= REL_F32, (name, _rel_err(g, w))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,chunk", [(48, 16), (37, 16), (5, 8)])
def test_analytic_param_grads_match_autograd_float64(N, chunk, reverse):
    """``_analytic_param_grads`` against torch autograd through the plain
    pass, both in float64: within 1e-9 of each grad's largest entry."""
    x, lm, th, ur, ui, dz = map(torch.from_numpy,
                                _scan_inputs(N + 1, 3, N, 8, 8, np.float64))
    ins = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    z = t_ops._pass(ins[0], t_ops._operators(*ins[1:], chunk), chunk, reverse,
                    t_ops.stlt_scan_reference)[0]
    want = torch.autograd.grad(z, ins[1:], dz)
    got = t_ops._analytic_param_grads(x, dz, lm, th, ur, ui, chunk, reverse)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel_err(g, w) <= 1e-9


def test_training_call_goes_through_the_vjp_function():
    """The zero-carry call is ``_StltScan`` (on the card as on the CPU), and
    its z equals the stateful serving call's."""
    x, lm, th, ur, ui, _ = _scan_inputs(3, 2, 20, 8, 8)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, lm, th, ur, ui)]
    z = t_ops.stlt_scan(*ins, chunk=8)
    assert type(z.grad_fn).__name__ == "_StltScanBackward"
    with torch.no_grad():
        z2, _ = t_ops.stlt_scan(*ins, chunk=8, return_state=True)
    torch.testing.assert_close(z2, z.detach(), rtol=0, atol=1e-6)
    # dz as autograd hands it over from a sum (an expanded view, stride 0;
    # N a multiple of the chunk, so nothing pads it into a copy)
    for reverse in (False, True):
        z = t_ops.stlt_scan(*ins, chunk=4, reverse=reverse)
        got = torch.autograd.grad(z.sum(), ins, retain_graph=True)
        want = torch.autograd.grad(z, ins, torch.ones_like(z))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _state_loss_inputs(seed, BH, N, d, S, dtype):
    """The scan inputs, dz, and the end state's cotangents (dh_re, dh_im)."""
    x, lm, th, ur, ui, dz = map(torch.from_numpy, _scan_inputs(seed, BH, N, d, S, dtype))
    r = np.random.default_rng(seed + 1)
    dh = [torch.from_numpy(r.normal(size=(BH, S, d)).astype(dtype)) for _ in range(2)]
    return (x, lm, th, ur, ui), dz, dh


@pytest.mark.parametrize("N,chunk", [(48, 16), (37, 16), (5, 8)])
def test_stateful_grads_match_autograd_float64(N, chunk):
    """The stateful call's backward in float64: the anti-causal pass over dz
    plus ``_end_state_dx`` for dx, ``_analytic_param_grads`` seeded with the
    end state's cotangent for the poles and mixers, against torch autograd
    through the plain pass with its snapshot at N (z and both carries in the
    loss): within 1e-9 of each grad's largest entry, with N a multiple of
    the chunk and not."""
    ins, dz, dh = _state_loss_inputs(N + 2, 3, N, 8, 8, np.float64)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    nc = -(-N // chunk)
    z, h_re, h_im = t_ops._pass(leaves[0], t_ops._operators(*leaves[1:], chunk), chunk, False,
                                t_ops.stlt_scan_reference,
                                snapshot=t_ops._snapshot_ops(leaves[1], leaves[2], None, N,
                                                             chunk, nc))
    want = torch.autograd.grad((z * dz).sum() + (h_re * dh[0]).sum() + (h_im * dh[1]).sum(),
                               leaves)
    x, lm, th, ur, ui = ins
    dx = (t_ops._pass(dz, t_ops._operators(lm, th, ur, ui, chunk), chunk, True,
                      t_ops.stlt_scan_reference)[0]
          + t_ops._end_state_dx(lm, th, *dh, N))
    got = (dx, *t_ops._analytic_param_grads(x, dz, lm, th, ur, ui, chunk, False, dh=dh))
    for name, g, w in zip(("dx", "dlog_mag", "dtheta", "du_re", "du_im"), got, want):
        assert g.dtype == torch.float64
        assert _rel_err(g, w) <= 1e-9, (name, _rel_err(g, w))


def test_stateful_call_goes_through_its_vjp_function():
    """The causal call from a zero carry with ``return_state`` is
    ``_StltScanState`` on the CPU as on the card, not autograd through the
    plain version: z and both carries hang off its backward, which runs the
    scan's pass once (anti-causally, over dz: K1 on the card) after the one
    forward pass; its z and carries equal the forward-only call's, and its
    grads are within fp32 rounding (1e-5 of each grad's largest entry) of
    autograd through the plain version in float64."""
    ins, dz, dh = _state_loss_inputs(5, 2, 37, 8, 8, np.float32)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    runner, passes = t_ops._runner, []

    def counting(t):
        passes.append(t.requires_grad)
        return runner(t)

    t_ops._runner = counting
    try:
        z, (h_re, h_im) = t_ops.stlt_scan(*leaves, chunk=16, return_state=True)
        assert {type(t.grad_fn).__name__ for t in (z, h_re, h_im)} == {
            "_StltScanStateBackward"}
        assert len(passes) == 1
        got = torch.autograd.grad((z * dz).sum() + (h_re * dh[0]).sum()
                                  + (h_im * dh[1]).sum(), leaves)
        assert len(passes) == 2
    finally:
        t_ops._runner = runner
    with torch.no_grad():
        z2, (hr2, hi2) = t_ops.stlt_scan(*ins, chunk=16, h0_re=torch.zeros_like(dh[0]),
                                         h0_im=torch.zeros_like(dh[1]), return_state=True)
    for a, b in ((z, z2), (h_re, hr2), (h_im, hi2)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    ins64, dz64, dh64 = _state_loss_inputs(5, 2, 37, 8, 8, np.float64)
    leaves64 = [t.clone().requires_grad_(True) for t in ins64]
    z, h_re, h_im = t_ops._pass(leaves64[0], t_ops._operators(*leaves64[1:], 16), 16, False,
                                t_ops.stlt_scan_reference,
                                snapshot=t_ops._snapshot_ops(leaves64[1], leaves64[2], None,
                                                             37, 16, 3))
    want = torch.autograd.grad((z * dz64).sum() + (h_re * dh64[0]).sum()
                               + (h_im * dh64[1]).sum(), leaves64)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= REL_F32


# ---------------------------------------------------------------------------
# (4) stochastic masks with the JAX package's draws, anneal_tau, top_m_mask
# ---------------------------------------------------------------------------


def _adaptive_params(seed, d, H, S):
    r = np.random.default_rng(seed)
    return {"w_alpha": (3.0 * r.normal(size=(d, H, S))).astype(np.float32),
            "b_alpha": r.normal(size=(H, S)).astype(np.float32)}


def _uniform(key, shape):
    """The JAX package's draw in ``node_masks``."""
    return jax.random.uniform(key, shape, minval=1e-6, maxval=1.0 - 1e-6)


@pytest.mark.parametrize("tau", [1.0, 0.37])
def test_stochastic_masks_match_jax_with_fed_draws(tau):
    """The port's masks with ``jax.random.uniform``'s bits fed in against
    ``repro.core.adaptive.node_masks(rng=...)``. The draws enter bit for
    bit, but not bit-equal masks: the noise's log rounds differently in the
    last bit in 1 of 8 entries, and the pooled logits' einsum sums in
    another order (both 1 ulp), so the masks are held within 1e-6, as the
    deterministic masks are in tests/test_torch_stlt.py."""
    B, N, d, H, S = 3, 12, 16, 4, 8
    p = _adaptive_params(1, d, H, S)
    x = np.random.default_rng(2).normal(size=(B, N, d)).astype(np.float32)
    cfg_j = j_adaptive.AdaptiveConfig(enabled=True, tau=tau)
    cfg_t = t_adaptive.AdaptiveConfig(enabled=True, tau=tau)
    key = jax.random.fold_in(jax.random.key(7), 3)
    mj, sj = j_adaptive.node_masks(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), cfg_j, rng=key, deterministic=False)
    u = torch.from_numpy(np.array(_uniform(key, (B, H, S))))
    mt, st = t_adaptive.node_masks({k: torch.from_numpy(v) for k, v in p.items()},
                                   torch.from_numpy(x), cfg_t, deterministic=False,
                                   draws=u)
    np.testing.assert_allclose(_np(mt), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=1e-6)
    # the noise is not zero: the draws moved the masks
    m0, _ = t_adaptive.node_masks({k: torch.from_numpy(v) for k, v in p.items()},
                                  torch.from_numpy(x), cfg_t, deterministic=False)
    assert float((m0 - mt).abs().max()) > 0.1


def test_anneal_tau_matches_jax_exactly():
    for total in (10, 1000, 3):
        for step in (0, 1, 2, 3, 7, 150, 399, 400, 401, 999):
            want = float(j_adaptive.anneal_tau(jnp.int32(step), total))
            assert t_adaptive.anneal_tau(step, total) == want, (step, total)


def test_top_m_mask_matches_jax():
    r = np.random.default_rng(4)
    imp = r.normal(size=(5, 8)).astype(np.float32)
    imp[1] = 1.0                      # full ties: index breaks them
    imp[2, :4] = imp[2, 4:]
    for m in (0, 1, 3, 8):
        want = np.asarray(j_adaptive.top_m_mask(jnp.asarray(imp), m))
        got = _np(t_adaptive.top_m_mask(torch.from_numpy(imp), m))
        np.testing.assert_array_equal(got, want)
        assert (got.sum(-1) == m).all()


# ---------------------------------------------------------------------------
# (5) AdamW, default_wd_mask, clip_by_global_norm, make_schedule
# ---------------------------------------------------------------------------


def _tree(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    return {"embed": {"embed": f(16, 8)},
            "layers": [{"stlt": {"nodes": {"sigma_hat": f(2, 4), "u_re": f(2, 4)},
                                 "w_v": f(8, 8),
                                 "adaptive": {"w_alpha": f(8, 2, 4), "b_alpha": f(2, 4)}},
                        "norm1": {"scale": f(8), "bias": f(8)},
                        "ffn": {"w1": f(8, 12), "b1": f(12)}}],
            "final_norm": {"scale": f(8)}}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_default_wd_mask_matches_jax():
    """On the port's layout (one dict per layer), leaf by leaf, and on the
    reduced model with unstacked layers: decay on matrices only; nodes,
    norms, biases and b_alpha excluded."""
    tcfg = _models(False)[1]
    for tree in (_tree(0), _models(False)[2]):
        want = jax.tree_util.tree_leaves(j_adamw.default_wd_mask(tree))
        got = t_optim.default_wd_mask(_to_torch(tree), tcfg)
        assert [m for _, m in tree_flatten_with_paths(got)] == want
    paths = dict(tree_flatten_with_paths(t_optim.default_wd_mask(_to_torch(_tree(0)),
                                                                 tcfg)))
    assert paths["layers/0/stlt/w_v"] == 1.0 and paths["layers/0/ffn/b1"] == 0.0
    assert paths["layers/0/stlt/adaptive/b_alpha"] == 0.0
    assert paths["layers/0/stlt/nodes/u_re"] == 0.0


def _stacked_as_port(jtree, tcfg):
    """A tree on the JAX package's stacked layout (scan_layers=True) ->
    the port's layout."""
    return _port_tree(jax.tree_util.tree_map(np.asarray, jtree), tcfg)


def test_default_wd_mask_matches_jax_on_stacked_layers():
    """scan_layers=True: the JAX package stacks the reduced model's two
    layers, so their FFN biases are 2-D there and decayed. The port's mask
    on its unstacked layers equals the JAX mask leaf by leaf, unstacked."""
    _, tcfg, tree = _models(True)
    jmask = j_adamw.default_wd_mask(tree)
    want = _stacked_as_port(jax.tree_util.tree_map(
        lambda m, a: np.full(a.shape, m, np.float32), jmask, tree), tcfg)
    got = t_optim.default_wd_mask(_stacked_as_port(tree, tcfg), tcfg)
    pairs = list(zip(tree_flatten_with_paths(got), tree_flatten_with_paths(want)))
    assert len(pairs) == 2 * 17 + 3
    for (path, m), (wpath, w) in pairs:
        assert path == wpath and bool((w == m).all()), path
    paths = dict(tree_flatten_with_paths(got))
    assert paths["layers/1/ffn/b1"] == paths["layers/0/ffn/b2"] == 1.0
    assert paths["layers/1/norm1/scale"] == paths["layers/1/stlt/adaptive/b_alpha"] == 0.0


def test_adamw_on_stacked_layers_matches_jax():
    """One AdamW update (lr 1e-2, weight decay 0.1) of the scanned reduced
    model, params and grads made from a seed (FFN biases non-zero, so their
    decay shows at 10% of the update), against the JAX package's on its
    stacked tree: every leaf within 1e-6 relative."""
    _, tcfg, tree = _models(True)
    r = np.random.default_rng(9)
    params, grads = (jax.tree_util.tree_map(
        lambda a: r.normal(size=a.shape).astype(np.float32), tree) for _ in range(2))
    jopt, topt = j_adamw.adamw(), t_optim.adamw()
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _stacked_as_port(params, tcfg)
    ju, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jopt.init(jp), jp, 1e-2)
    tu, _ = topt.update(_stacked_as_port(grads, tcfg), topt.init(tp), tp, 1e-2,
                        t_optim.default_wd_mask(tp, tcfg))
    for (path, u), (_, w) in zip(tree_flatten_with_paths(tu),
                                 tree_flatten_with_paths(_stacked_as_port(ju, tcfg))):
        np.testing.assert_allclose(_np(u), _np(w), rtol=1e-6, atol=1e-12, err_msg=path)


def test_adamw_matches_jax_on_identical_grads():
    """Three updates on the same grads (lr 0, then 1e-3 and 3e-3): updates
    and both moments within 1e-6 relative (the same float32 arithmetic;
    XLA's pow and sqrt may round the last bit differently)."""
    params, grads = _tree(1), [_tree(2), _tree(3), _tree(4)]
    jopt, topt = j_adamw.adamw(), t_optim.adamw()
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g, lr in zip(grads, (0.0, 1e-3, 3e-3)):
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tu, ts = topt.update(_to_torch(g), ts, tp, lr,
                             t_optim.default_wd_mask(tp, _models(False)[1]))
        jp, tp = j_adamw.apply_updates(jp, ju), t_optim.apply_updates(tp, tu)
        for a, b in ((tu, ju), (ts["mu"], js["mu"]), (ts["nu"], js["nu"]), (tp, jp)):
            for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, a)),
                            jax.tree_util.tree_leaves(b)):
                np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-12)
        assert ts["count"] == int(js["count"])
    # make_optimizer: adafactor takes only learning_rate and weight_decay,
    # as the JAX package's drops the rest
    jopt = j_optim.make_optimizer("adafactor", b1=0.5, weight_decay=0.01)
    topt = t_optim.make_optimizer("adafactor", b1=0.5, weight_decay=0.01)
    ju, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[0]),
                        jopt.init(jp), jp, 1e-3)
    tu, _ = topt.update(_to_torch(grads[0]), topt.init(tp), tp, 1e-3)
    for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, tu)),
                    jax.tree_util.tree_leaves(ju)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-12)


def _adafactor_tree(seed):
    """Leaves on both sides of ``_factored``: matrices with both trailing
    dims >= 8 (factored; one stacked 3-D), a [16, 4] matrix and vectors
    (full second moments); some grads scaled up so update clipping acts."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    return {"w": f(16, 8), "stacked": f(2, 12, 8), "thin": f(16, 4),
            "b": f(8), "layers": [{"scale": 30 * f(10), "m": 30 * f(9, 11)}]}


def test_adafactor_matches_jax():
    """Three updates (lr 1e-3, 2e-3, 5e-3; weight decay 0.01) from the same
    params and grads: updates, every second-moment leaf (factored vr/vc and
    full v) and the params within 1e-5 relative (float32 on both sides;
    XLA's pow, mean and sqrt may round the last bits differently)."""
    shapes = ((16, 8), (2, 12, 8), (16, 4), (8,))
    assert [j_adafactor._factored(s) for s in shapes] \
        == [t_adafactor._factored(s) for s in shapes] == [True, True, False, False]
    params = _adafactor_tree(0)
    jopt = j_adafactor.adafactor(weight_decay=0.01)
    topt = t_optim.adafactor(weight_decay=0.01)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert sorted(ts["v"]["w"]) == ["vc", "vr"] and sorted(ts["v"]["thin"]) == ["v"]
    for seed, lr in zip((1, 2, 3), (1e-3, 2e-3, 5e-3)):
        g = _adafactor_tree(seed)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tu, ts = topt.update(_to_torch(g), ts, tp, lr)
        jp, tp = j_adamw.apply_updates(jp, ju), t_optim.apply_updates(tp, tu)
        for a, b in ((tu, ju), (ts["v"], js["v"]), (tp, jp)):
            got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, a))
            want = jax.tree_util.tree_leaves(b)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-12)
        assert ts["count"] == int(js["count"])


def test_adamw_bf16_moments_match_jax():
    """``moment_dtype=bfloat16``: three updates; the moments are stored in
    bf16 and equal JAX's bit for bit (the same fp32 arithmetic, rounded to
    bf16); the updates within 1e-5 relative."""
    params, grads = _tree(1), [_tree(2), _tree(3), _tree(4)]
    jopt = j_adamw.adamw(moment_dtype=jnp.bfloat16)
    topt = t_optim.adamw(moment_dtype=torch.bfloat16)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    wd = t_optim.default_wd_mask(tp, _models(False)[1])
    for g, lr in zip(grads, (1e-3, 2e-3, 3e-3)):
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tu, ts = topt.update(_to_torch(g), ts, tp, lr, wd)
        jp, tp = j_adamw.apply_updates(jp, ju), t_optim.apply_updates(tp, tu)
        for name in ("mu", "nu"):
            assert all(t.dtype == torch.bfloat16 for t in tree_leaves(ts[name]))
            got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda t: t.float().numpy(), ts[name]))
            for x, y in zip(got, jax.tree_util.tree_leaves(js[name])):
                np.testing.assert_array_equal(x, np.asarray(y, np.float32))
        for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, tu)),
                        jax.tree_util.tree_leaves(ju)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("mode", ["none", "bf16", "bf16_ef"])
def test_compress_gradients_matches_jax(mode):
    """Four steps of compression on fresh grads: the compressed grads (bf16:
    a round to nearest even on both sides) and the error accumulator equal
    JAX's bit for bit; with error feedback the sum of what was sent plus the
    final residual is the sum of the grads."""
    tree = _tree(6)
    je = j_compression.init_error_state(jax.tree_util.tree_map(jnp.asarray, tree))
    te = t_optim.init_error_state(_to_torch(tree))
    sent = jax.tree_util.tree_map(np.zeros_like, tree)
    total = jax.tree_util.tree_map(np.zeros_like, tree)
    for step in range(4):
        g = jax.tree_util.tree_map(lambda a, k=step: a * (1 + 1e-3 * k), _tree(7 + step))
        jq, je2 = j_compression.compress_gradients(
            jax.tree_util.tree_map(jnp.asarray, g), mode, je if mode == "bf16_ef" else None)
        tq, te2 = t_optim.compress_gradients(_to_torch(g), mode,
                                             te if mode == "bf16_ef" else None)
        for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda t: t.float().numpy(), tq)), jax.tree_util.tree_leaves(jq)):
            np.testing.assert_array_equal(x, np.asarray(y, np.float32))
        if mode == "bf16_ef":
            je, te = je2, te2
            for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, te)),
                            jax.tree_util.tree_leaves(je)):
                np.testing.assert_array_equal(x, np.asarray(y))
            sent = jax.tree_util.tree_map(lambda a, q: a + np.asarray(q, np.float32),
                                          sent, jq)
            total = jax.tree_util.tree_map(np.add, total, g)
        else:
            assert te2 is None
        want_dtype = torch.float32 if mode == "none" else torch.bfloat16
        assert all(t.dtype == want_dtype for t in tree_leaves(tq))
    if mode == "bf16_ef":
        for s_, r, t in zip(*(jax.tree_util.tree_leaves(x) for x in (
                sent, jax.tree_util.tree_map(_np, te), total))):
            np.testing.assert_allclose(s_ + r, t, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_optim.compress_gradients(_to_torch(tree), "bf16_ef")


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(5)
    jg, jn = j_clip.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tg, tn = t_optim.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, tg)),
                    jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(kind):
    """Every step of a 50-step run with 7 of warmup, within 1e-6 relative
    (float32 on both sides; cos may round its last bit differently); lr is
    exactly 0 at step 0."""
    j_s = j_schedules.make_schedule(kind, 3e-4, 7, 50)
    t_s = t_optim.make_schedule(kind, 3e-4, 7, 50)
    for step in range(0, 55):
        np.testing.assert_allclose(t_s(step), float(j_s(step)), rtol=1e-6, atol=0)
    assert t_s(0) == 0.0


# ---------------------------------------------------------------------------
# (6) data
# ---------------------------------------------------------------------------


def test_lm_batch_stream_is_identical():
    for seed, step in ((0, 0), (0, 5), (3, 2)):
        want = j_synthetic.lm_batch_stream(seed, step, 3, 40, 300)
        got = t_synthetic.lm_batch_stream(seed, step, 3, 40, 300)
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_byte_corpus_batch_is_identical():
    assert t_text.repo_corpus(max_bytes=1 << 18) == j_text.repo_corpus(max_bytes=1 << 18)
    data = bytes(np.random.default_rng(0).integers(0, 256, 70000, dtype=np.uint8))
    jc, tc = j_text.ByteCorpus(data, seed=2), t_text.ByteCorpus(data, seed=2)
    for step, split in ((0, "train"), (4, "train"), (1, "eval")):
        want, got = jc.batch(step, 3, 32, split), tc.batch(step, 3, 32, split)
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_matches_jax_and_seeks():
    """``DataPipeline`` yields (step, batch) in step order from its start
    step, the same batches as the JAX package's pipeline (values; the JAX
    one holds them as jax arrays), as CPU tensors without a device; setting
    ``step`` forward (a resume seek) drops the batches made before it."""
    def batch_fn(step):
        return t_synthetic.lm_batch_stream(4, step, 2, 16, 300)

    jpipe = j_pipeline.DataPipeline(batch_fn, prefetch=2, start_step=3)
    tpipe = DataPipeline(batch_fn, prefetch=2, start_step=3)
    try:
        for want_step in (3, 4, 5):
            js_, jb = next(jpipe)
            ts_, tb = next(tpipe)
            assert js_ == ts_ == want_step
            for k in ("inputs", "labels"):
                assert tb[k].device.type == "cpu"
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        tpipe.step = 9                              # seek forward
        step, tb = next(tpipe)
        assert step == 9 and tpipe.step == 10
        np.testing.assert_array_equal(tb["inputs"].numpy(), batch_fn(9)["inputs"])
        assert [next(tpipe)[0] for _ in range(2)] == [10, 11]
    finally:
        jpipe.close()
        tpipe.close()
    assert not tpipe._thread.is_alive()


# ---------------------------------------------------------------------------
# (7) train steps of stlt-base .reduced() against repro.launch.train
# ---------------------------------------------------------------------------

B, N = 2, 64
TCFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
# loss and metrics, port vs JAX (fp32 through 2 blocks and a 256-way head)
METRIC_RTOL = 2e-5
# a grad leaf: ||g_port - g_jax|| / ||g_jax||
GRAD_REL = 1e-4


def _jax_draws(jcfg, seed, step):
    """Per-layer uniform draws as the JAX package derives them in
    ``launch/train.py`` and ``transformer.apply_lm``: rng =
    fold_in(key(seed), step), then fold_key(rng, li) for an unstacked layer
    and split(fold_key(rng, li), count) for a scanned run."""
    rng = jax.random.fold_in(jax.random.key(seed), step)
    shape = (B, jcfg.num_heads, jcfg.stlt_nodes)
    draws, li = [], 0
    for _, count in JT.execution_plan(jcfg):
        if count > 1:
            keys = jax.random.split(fold_key(rng, li), count)
            draws += [_uniform(keys[j], shape) for j in range(count)]
        else:
            draws.append(_uniform(fold_key(rng, li), shape))
        li += count
    return [torch.from_numpy(np.array(u)) for u in draws]


def _batch(step):
    return j_synthetic.lm_batch_stream(0, step, B, N, 256)


@functools.lru_cache(maxsize=None)
def _models(scan_layers: bool):
    jcfg = J_CONFIG.reduced(num_layers=2, scan_layers=scan_layers)
    tcfg = T_CONFIG.reduced(num_layers=2, scan_layers=scan_layers)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    return jcfg, tcfg, tree


@functools.lru_cache(maxsize=None)
def _j_make_step(scan_layers: bool):
    """The JAX package's (opt, jitted step_fn), shared so it compiles once."""
    return j_train.make_step(_models(scan_layers)[0], JTrainConfig(**TCFG))


def _port_tree(tree, tcfg):
    return convert.from_jax_params(tree, tcfg, device="cpu")


@pytest.mark.parametrize("scan_layers", [False, True])
def test_loss_and_every_grad_leaf_match_jax(scan_layers):
    """Step 0's loss, metrics and every grad leaf with stochastic masks
    (deterministic=False, the JAX draws fed in per layer in execution-plan
    order; scan_layers=True derives them by split, False by fold_in)."""
    jcfg, tcfg, tree = _models(scan_layers)
    assert len(JT.execution_plan(jcfg)) == (1 if scan_layers else 2)
    step = 0
    tau = float(j_adaptive.anneal_tau(jnp.int32(step), TCFG["total_steps"]))
    rng = jax.random.fold_in(jax.random.key(0), step)
    batch = _batch(step)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_loss(p):
        return JT.lm_loss(p, jcfg, jb, rng=rng, deterministic=False, tau=tau)

    (lj, mj), gj = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    lt, mt, gt = t_train.loss_and_grads(
        _port_tree(tree, tcfg), tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tau=t_adaptive.anneal_tau(step, TCFG["total_steps"]),
        draws=_jax_draws(jcfg, 0, step))
    np.testing.assert_allclose(float(lt), float(lj), rtol=METRIC_RTOL)
    assert sorted(mt) == sorted(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    want = tree_flatten_with_paths(_port_tree(jax.tree_util.tree_map(np.asarray, gj), tcfg))
    got = tree_flatten_with_paths(gt)
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == 2 * 17 + 3
    for (path, g), (_, w) in zip(got, want):
        rel = float(torch.linalg.vector_norm((g - w).double())
                    / torch.linalg.vector_norm(w.double()))
        assert rel <= GRAD_REL, (path, rel)


@pytest.mark.parametrize("scan_layers,steps", [(False, 1), (False, 3), (True, 1), (True, 3)],
                         ids=["1", "3", "scan_layers-1", "scan_layers-3"])
def test_train_steps_match_jax_make_step(scan_layers, steps):
    """``make_step``'s step_fn against ``repro.launch.train.make_step``'s
    over 1 and 3 steps (warmup 1, so lr is 0 at step 0 and the first step
    moves no weight; AdamW's moments then carry the grads): loss, ce, reg,
    s_eff, grad_norm within 2e-5, the moments within 1e-4 of their largest
    entry per leaf, and the params after the steps. Adam's first update
    moves a weight by about lr * sign(g), so a grad entry at rounding level
    can flip sign between the frameworks and move that weight by up to
    2 lr a step: the params are held within 2 lr per moving step, and all
    but 0.1% of their entries within 1e-6. Both layouts: unstacked, and
    stacked (``scan_layers=True``, stlt-base's own, whose FFN biases the
    JAX package's ``ndim`` test decays)."""
    jcfg, tcfg, tree = _models(scan_layers)
    jopt, jstep = _j_make_step(scan_layers)
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = _port_tree(tree, tcfg)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        batch = _batch(step)
        jp, js, mj = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()}, step)
        tp, ts, mt = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()},
                           step, draws=_jax_draws(jcfg, 0, step))
        for k in ("loss", "ce", "reg", "s_eff", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=METRIC_RTOL,
                                       err_msg=f"step {step} {k}")
    assert ts["count"] == int(js["count"]) == steps
    for name in ("mu", "nu"):
        want = _port_tree(jax.tree_util.tree_map(np.asarray, js[name]), tcfg)
        for (path, g), (_, w) in zip(tree_flatten_with_paths(ts[name]),
                                     tree_flatten_with_paths(want)):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * scale + 1e-30, (name, path)
    want = tree_flatten_with_paths(_port_tree(jax.tree_util.tree_map(np.asarray, jp), tcfg))
    moving = steps - 1                   # lr is 0 at step 0
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp), want):
        err = (p - w).abs()
        assert float(err.max()) <= 2 * TCFG["learning_rate"] * moving + 1e-6, path
        assert float((err > 1e-6).double().mean()) <= 1e-3, path
    if steps == 1:   # lr 0: no weight moved
        for (path, p), (_, w) in zip(tree_flatten_with_paths(tp),
                                     tree_flatten_with_paths(_port_tree(tree, tcfg))):
            torch.testing.assert_close(p, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (8) remat, bf16 train steps, resume, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_values(policy, monkeypatch):
    """Remat off against ``policy`` on the scanned reduced model: the loss,
    the metrics and every grad leaf are EQUAL (tolerance 0: the CPU
    recomputes the same ops in the same order). Remat recomputes each
    block's scan in backward: 3 passes a layer (forward, recompute, dx)
    against 2. ``dots`` keeps the un-batched products: its backward runs as
    many ``aten.mm`` as no remat, ``full`` runs them again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    passes = []
    plain = t_ops.stlt_scan_reference
    monkeypatch.setattr(t_ops, "stlt_scan_reference",
                        lambda *a, **k: passes.append(1) or plain(*a, **k))
    _, tcfg, tree = _models(True)
    assert tcfg.remat is False            # .reduced() turns it off, as in JAX
    params = _port_tree(tree, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    draws = _jax_draws(_models(True)[0], 0, 0)
    out = {}
    for name, cfg in (("off", tcfg),
                      (policy, dataclasses.replace(tcfg, remat=True, remat_policy=policy))):
        passes.clear()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = TT.lm_loss(tree_unflatten(params, leaves), cfg, batch,
                                   deterministic=False, tau=0.5, draws=draws)
        with CountMM() as count:
            grads = torch.autograd.grad(loss, leaves)
        out[name] = (loss, metrics, grads, len(passes), count.mm)
    (l0, m0, g0, p0, mm0), (l1, m1, g1, p1, mm1) = out["off"], out[policy]
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (p0, p1) == (2 * tcfg.num_layers, 3 * tcfg.num_layers)
    assert mm0 > 0 and (mm1 == mm0 if policy == "dots" else mm1 > mm0)
    with torch.no_grad():                  # no backward: nothing is wrapped
        passes.clear()
        TT.apply_lm(params, dataclasses.replace(tcfg, remat=True), batch["inputs"])
        assert len(passes) == tcfg.num_layers


# bf16: SmolLM-360M-stlt at widths where the cast (matrices of more than
# 65,536 elements) takes the embedding (512 x 256) and the FFN (256 x 512)
# and leaves w_v (256 x 256 = 65,536) in fp32; remat on, layers scanned.
BF16_KW = dict(num_layers=2, d_model=256, d_ff=512, vocab=512, dtype="bfloat16",
               remat=True, scan_layers=True)
# port vs JAX, bf16 compute (XLA keeps fused bf16 chains in fp32, torch
# rounds each op): loss, ce, grad_norm relative (measured <= 1.4e-4 over 3
# steps); the moments per leaf ||m_port - m_jax|| / ||m_jax|| (mu is the
# clipped grad, measured <= 0.027, T_hat's, at step 0)
BF16_METRIC_RTOL = 1e-3
BF16_MOMENT_REL = 0.1


@functools.lru_cache(maxsize=None)
def _bf16_models():
    jcfg = j_get_config("smollm-360m", "stlt").reduced(**BF16_KW)
    tcfg = t_configs.get_config("smollm-360m", "stlt").reduced(**BF16_KW)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    return jcfg, tcfg, tree, j_train.make_step(jcfg, JTrainConfig(**TCFG))


def _bf16_batch(step):
    return j_synthetic.lm_batch_stream(0, step, B, N, BF16_KW["vocab"])


@pytest.mark.parametrize("steps", [1, 3])
def test_bf16_train_steps_match_jax_make_step(steps):
    """Reduced SmolLM-360M-stlt in bf16 (remat, scanned layers), ``make_step``
    against ``repro.launch.train.make_step`` over 1 and 3 steps: both cast
    the matrices inside the loss, so fp32 masters get fp32 grads. Metrics
    within BF16_METRIC_RTOL, each moment leaf within BF16_MOMENT_REL (norm),
    the params within 2 lr per moving step (Adam's sign argument of the fp32
    test) and unmoved at step 0's lr of 0."""
    jcfg, tcfg, tree, (jopt, jstep) = _bf16_models()
    cast = dict(tree_flatten_with_paths(cast_params_for_compute(
        _port_tree(tree, tcfg), torch.bfloat16)))
    assert cast["embed/embed"].dtype == cast["layers/1/ffn/w1"].dtype == torch.bfloat16
    assert cast["layers/1/stlt/w_v"].dtype == torch.float32
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = _port_tree(tree, tcfg)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        batch = _bf16_batch(step)
        jp, js, mj = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()}, step)
        tp, ts, mt = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()},
                           step)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=BF16_METRIC_RTOL,
                                       err_msg=f"step {step} {k}")
    assert ts["count"] == int(js["count"]) == steps
    for name in ("mu", "nu"):
        want = _port_tree(jax.tree_util.tree_map(np.asarray, js[name]), tcfg)
        got = tree_flatten_with_paths(ts[name])
        assert len(got) == 2 * 12 + 2
        for (path, g), (_, w) in zip(got, tree_flatten_with_paths(want)):
            assert g.dtype == torch.float32, path
            rel = float(torch.linalg.vector_norm((g - w).double())
                        / torch.linalg.vector_norm(w.double()))
            assert rel <= BF16_MOMENT_REL, (name, path, rel)
    want = tree_flatten_with_paths(_port_tree(jax.tree_util.tree_map(np.asarray, jp), tcfg))
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp), want):
        assert p.dtype == torch.float32, path
        bound = 2 * TCFG["learning_rate"] * (steps - 1) + 1e-6
        assert float((p - w).abs().max()) <= bound, path


def test_resume_after_two_of_four_steps_is_bit_exact(tmp_path):
    """4 straight ``make_step`` steps == 2 steps, an async save, a restore
    into fresh state, 2 more: every param and moment and the count EQUAL
    (the CPU's arithmetic is deterministic and the checkpoint holds fp32
    exactly). The saved tree is a snapshot: changing the live tensors after
    ``save`` does not reach the file."""
    from repro_torch.checkpoint import CheckpointManager

    _, tcfg, tree = _models(True)
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))

    def fresh():
        params = _port_tree(tree, tcfg)
        return {"params": params, "opt": topt.init(params)}

    def run(state, start, stop):
        for step in range(start, stop):
            batch = {k: torch.from_numpy(v) for k, v in _batch(step).items()}
            p, o, _ = tstep(state["params"], state["opt"], batch, step)
            state = {"params": p, "opt": o}
        return state

    gold = run(fresh(), 0, 4)
    mgr = CheckpointManager(str(tmp_path), async_saves=True)
    half = run(fresh(), 0, 2)
    mgr.save(1, half)
    for t in tree_leaves(half["params"]):
        t.add_(1.0)                         # after save: must not reach the file
    mgr.wait()
    restored, step = mgr.restore_or_init(fresh)
    assert step == 1 and restored["opt"]["count"] == 2
    resumed = run(restored, 2, 4)
    assert resumed["opt"]["count"] == gold["opt"]["count"] == 4
    for (path, a), (_, b) in zip(tree_flatten_with_paths(resumed),
                                 tree_flatten_with_paths(gold)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package trains the scanned reduced model 2 steps and its
    ``CheckpointManager`` saves {"params", "opt"}; ``from_jax_checkpoint``
    reads it (numpy only): params and moments equal JAX's bit for bit,
    unstacked. The port's step 3 (step index 2) from there against JAX's
    step 3: metrics, moments and params within the fp32 train-step
    tolerances (one moving step)."""
    from repro.checkpoint import CheckpointManager as JCheckpointManager

    jcfg, tcfg, tree = _models(True)
    jopt, jstep = _j_make_step(True)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jopt.init(jp)
    for step in range(2):
        jb = {k: jnp.asarray(v) for k, v in _batch(step).items()}
        jp, js, _ = jstep(jp, js, jb, step)
    JCheckpointManager(str(tmp_path), async_saves=False).save(1, {"params": jp, "opt": js})
    state, step = convert.from_jax_checkpoint(str(tmp_path), tcfg, device="cpu")
    assert step == 1 and state["opt"]["count"] == 2
    for got, want in ((state["params"], jp), (state["opt"]["mu"], js["mu"]),
                      (state["opt"]["nu"], js["nu"])):
        want = dict(tree_flatten_with_paths(
            _port_tree(jax.tree_util.tree_map(np.asarray, want), tcfg)))
        got = dict(tree_flatten_with_paths(got))
        assert sorted(got) == sorted(want) and len(got) == 2 * 17 + 3
        for path, g in got.items():
            torch.testing.assert_close(g, want[path], rtol=0, atol=0, msg=path)
    _, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    batch = _batch(2)
    jp, js, mj = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    tp, ts, mt = tstep(state["params"], state["opt"],
                       {k: torch.from_numpy(v) for k, v in batch.items()}, 2,
                       draws=_jax_draws(jcfg, 0, 2))
    for k in ("loss", "ce", "reg", "s_eff", "grad_norm"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=METRIC_RTOL, err_msg=k)
    for name in ("mu", "nu"):
        want = dict(tree_flatten_with_paths(
            _port_tree(jax.tree_util.tree_map(np.asarray, js[name]), tcfg)))
        for path, g in tree_flatten_with_paths(ts[name]):
            w = want[path]
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-30, path
    want = dict(tree_flatten_with_paths(_port_tree(jax.tree_util.tree_map(np.asarray, jp),
                                                   tcfg)))
    for path, p in tree_flatten_with_paths(tp):
        err = (p - want[path]).abs()
        assert float(err.max()) <= 2 * TCFG["learning_rate"] + 1e-6, path
        assert float((err > 1e-6).double().mean()) <= 1e-3, path


def test_train_cli_runs_on_the_cpu(capsys):
    """The CLI on a reduced arch; and a bf16 config trains: ``make_step`` of
    reduced SmolLM-360M-stlt in bf16, step 0's loss against the JAX
    package's within BF16_METRIC_RTOL."""
    t_train.main(["--arch", "stlt-base", "--reduced", "--device", "cpu",
                  "--steps", "2", "--batch", "2", "--seq", "32", "--data", "synthetic",
                  "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "[train] done" in out
    jcfg, tcfg, tree, (jopt, jstep) = _bf16_models()
    topt, tstep = t_train.make_step(tcfg, TrainConfig())
    tp = _port_tree(tree, tcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = _bf16_batch(0)
    _, _, mj = jstep(jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}, 0)
    _, _, mt = tstep(tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=BF16_METRIC_RTOL)


def test_train_cli_paper_small_default_and_resume(tmp_path, capsys, monkeypatch):
    """No ``--arch``: the paper-small preset (4 layers, d_model 256, 32
    adaptive nodes, 3.0M params). With ``--ckpt-dir``: 4 steps straight
    equal the same command stopped right after its checkpoint of step 2 (a
    preemption) and run again, which resumes from step 2 for steps 3, bit
    for bit; the resume line names the step."""
    from repro_torch.checkpoint import CheckpointManager

    class Preempted(Exception):
        pass

    class PreemptedAfterStep2(CheckpointManager):
        def save(self, step, tree):
            super().save(step, tree)
            if step == 2:
                self.wait()
                raise Preempted

    argv = ["--device", "cpu", "--batch", "2", "--seq", "32", "--data", "synthetic",
            "--log-every", "1", "--save-every", "2", "--steps", "4"]
    cfg = t_train.paper_small()
    assert (cfg.name, cfg.num_layers, cfg.d_model, cfg.stlt_nodes, cfg.remat) == \
        ("stlt-paper-small", 4, 256, 32, False)
    gold = t_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "stlt-paper-small: 3.0M params on cpu, resume from step -1" in out
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000002", "step_00000003"]
    with monkeypatch.context() as m:
        m.setattr(t_train, "CheckpointManager", PreemptedAfterStep2)
        with pytest.raises(Preempted):
            t_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert os.listdir(tmp_path / "b") == ["step_00000002"]
    capsys.readouterr()
    resumed = t_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resume from step 2" in out and out.count("[train] step") == 1
    assert resumed["opt"]["count"] == gold["opt"]["count"] == 4
    for (path, a), (_, b) in zip(tree_flatten_with_paths(resumed),
                                 tree_flatten_with_paths(gold)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)
