"""Parity of the PyTorch port's training path with the JAX package, on the
CPU: the anti-causal scan, the scan's VJP (dx by the same pass run
anti-causally, analytic pole/mixer grads), the stochastic node masks with
the JAX package's own draws fed in, AdamW, clipping, schedules, data, and
whole train steps of ``stlt-base`` ``.reduced()``.

Inputs are made with numpy from a seed and fed to both packages. The JAX
scan runs through its chunked reference, and at one tiny shape through its
custom VJP with the Pallas kernel in interpret mode (``use_kernel=True,
interpret=True``), as tests/test_kernels.py runs it. Tolerances are stated
beside each test: fp32 results within a few 1e-7 of their scale (summation
order only), float64 ones within 1e-9, and equal where both packages do the
same float32 arithmetic.
"""
import functools
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.stlt_base import CONFIG as J_CONFIG  # noqa: E402
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.data import text as j_text  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import clip as j_clip  # noqa: E402
from repro.optim import schedules as j_schedules  # noqa: E402
from repro.utils import fold_key  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.stlt_base import CONFIG as T_CONFIG  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.data import synthetic as t_synthetic  # noqa: E402
from repro_torch.data import text as t_text  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

# the module (``repro.optim`` re-exports its function under the same name)
j_adamw = importlib.import_module("repro.optim.adamw")
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
    sources += [ROOT / "chip_smoke.py", ROOT / "tools" / "ab_port.py"]
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
    for kw in (dict(return_state=True), dict(valid=torch.tensor([3, 16])),
               dict(h0_re=torch.zeros(2, 8, 8), h0_im=torch.zeros(2, 8, 8))):
        with pytest.raises(ValueError, match="forward-only"):
            t_ops.stlt_scan(x, lm, th, ur, ui, chunk=8, reverse=True, **kw)


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
    with pytest.raises(NotImplementedError):
        t_optim.make_optimizer("adafactor")


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
def _j_make_step():
    """The JAX package's (opt, jitted step_fn), shared so it compiles once."""
    return j_train.make_step(_models(False)[0], JTrainConfig(**TCFG))


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


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_make_step(steps):
    """``make_step``'s step_fn against ``repro.launch.train.make_step``'s
    over 1 and 3 steps (warmup 1, so lr is 0 at step 0 and the first step
    moves no weight; AdamW's moments then carry the grads): loss, ce, reg,
    s_eff, grad_norm within 2e-5, the moments within 1e-4 of their largest
    entry per leaf, and the params after the steps. Adam's first update
    moves a weight by about lr * sign(g), so a grad entry at rounding level
    can flip sign between the frameworks and move that weight by up to
    2 lr a step: the params are held within 2 lr per moving step, and all
    but 0.1% of their entries within 1e-6."""
    jcfg, tcfg, tree = _models(False)
    jopt, jstep = _j_make_step()
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


def test_train_cli_runs_on_the_cpu(capsys):
    t_train.main(["--arch", "stlt-base", "--reduced", "--device", "cpu",
                  "--steps", "2", "--batch", "2", "--seq", "32", "--data", "synthetic",
                  "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "[train] done" in out
    with pytest.raises(NotImplementedError, match="mixed-precision"):
        t_train.make_step(T_CONFIG.reduced(dtype="bfloat16"), TrainConfig())
