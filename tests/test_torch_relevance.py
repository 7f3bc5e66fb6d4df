"""Parity of the port's relevance readout (``mode="relevance"``, K2's plain
version and its autograd Function, the layer and the LM) with the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs K2 as its own tests run it: the jnp tiled reference and the
Pallas kernel in interpret mode; at the layer level also its materialized
readout (JAX engine ``chunked``), an independent algorithm.

Tolerances: 1e-5 absolute where both sides run the same tiled algorithm in
fp32 on O(1) values (the port's plain version, its host operators and
carries); 2e-4 on layer and LM outputs, which sum the readout through W_o
and the FFN after a softmax whose scores reach the tens, and where the JAX
side may materialize [N, N] and sum in another order;
gradients within 1e-4 of the largest gradient entry, since a backward
through the online softmax and the pole powers sums over every tile.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.stlt_base import CONFIG as J_BASE  # noqa: E402
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.core import stlt as j_stlt  # noqa: E402
from repro.kernels import relevance_flash as j_rf  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.stlt_base import CONFIG as T_BASE  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.core import stlt as t_stlt  # noqa: E402
from repro_torch.kernels import relevance_flash as t_rf  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

ATOL = 1e-5          # same tiled algorithm on both sides
LAYER_ATOL = 2e-4    # against the JAX package's materialized readout
GRAD_RTOL = 1e-4     # relative to the largest gradient entry
# the JAX references compile with XLA's optimizations (tests/torch_threads.py):
# test_lm_relevance_loss_grads_match_jax's reference moves by 0.8 of
# GRAD_RTOL without them
XLA_OPTIMIZED = True
BH, N, DH, S, TILE = 3, 40, 5, 4, 16     # ragged: 40 = 2 * 16 + 8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _grad_close(a, b):
    b = _np(b)
    a = np.zeros_like(b) if a is None else _np(a)
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_RTOL, rtol=0)


def _inputs(seed=0, masked=True, padded=True):
    r = np.random.default_rng(seed)
    f = np.float32
    x, v = r.normal(size=(BH, N, DH)).astype(f), r.normal(size=(BH, N, DH)).astype(f)
    lm = -r.uniform(0.005, 1.0, (BH, S)).astype(f)
    th = -r.uniform(0.0, 1.5, (BH, S)).astype(f)
    mk = r.uniform(0.0, 1.0, (BH, S)).astype(f) if masked else np.ones((BH, S), f)
    if masked:
        mk[0, 1] = 0.0                                # a dropped node
    km = np.ones((BH, N), f)
    if padded:
        km = (np.arange(N)[None] < np.array([N, 29, 0])[:, None]).astype(f)
    return x, v, lm, th, mk, km


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K2's host side and plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ops_match_jax(causal):
    x, _, lm, th, _, km = _inputs(1)
    xp = np.pad(x * km[:, :, None], ((0, 0), (0, 8), (0, 0)))   # a tile multiple
    want = j_rf._flash_ops(*_j(xp, lm, th), TILE, bidirectional=not causal)
    got = t_rf._flash_ops(*_t(xp, lm, th), TILE, bidirectional=not causal)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked,padded", [(False, False), (True, False), (True, True)])
def test_reference_matches_jax(causal, masked, padded):
    """The plain version against the JAX jnp tiled reference and the Pallas
    kernel in interpret mode; with padding, one row's keys are all masked
    and it must come out exactly 0."""
    x, v, lm, th, mk, km = _inputs(2, masked, padded)
    got = t_rf.relevance_flash_reference(*_t(x, v, lm, th, mk, km), tile=TILE,
                                         causal=causal)
    want = j_rf.relevance_flash_reference(*_j(x, v, lm, th, mk, km), tile=TILE,
                                          causal=causal)
    _close(got, want)
    kern = j_rf.relevance_flash(*_j(x, v, lm, th), masks=jnp.asarray(mk),
                                kmask=jnp.asarray(km), causal=causal, tile=TILE,
                                interpret=True)
    _close(got, kern)
    if padded:
        assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.parametrize("causal", [True, False])
def test_relevance_flash_grads_match_jax_vjp(causal):
    """The autograd Function (forward: plain version on the CPU; backward:
    recompute through it) against jax.vjp of the JAX package's custom VJP,
    for x, v, log_mag, theta and mk, with a random cotangent."""
    x, v, lm, th, mk, km = _inputs(3)
    dz = np.random.default_rng(4).normal(size=(BH, N, DH)).astype(np.float32)
    ins = [t.requires_grad_(True) for t in _t(x, v, lm, th, mk)]
    z = t_rf.relevance_flash(*ins[:4], masks=ins[4], kmask=torch.from_numpy(km),
                             causal=causal, tile=TILE)
    got = torch.autograd.grad(z, ins, torch.from_numpy(dz))

    def f(x_, v_, lm_, th_, mk_):
        return j_rf.relevance_flash(x_, v_, lm_, th_, masks=mk_,
                                    kmask=jnp.asarray(km), causal=causal,
                                    tile=TILE, interpret=True)

    zj, vjp = jax.vjp(f, *_j(x, v, lm, th, mk))
    _close(z, zj)
    for a, b in zip(got, vjp(jnp.asarray(dz))):
        _grad_close(a, b)


def test_cpu_dispatch_runs_the_plain_version():
    """A CPU tensor never reaches the kernel; the kernel's wrapper refuses
    CPU tensors."""
    x, v, lm, th, mk, km = _t(*_inputs(5))
    before = t_rf.relevance_flash_kernel.launches
    z = t_rf.relevance_flash(x, v, lm, th, masks=mk, kmask=km, tile=TILE)
    assert t_rf.relevance_flash_kernel.launches == before
    _close(z, t_rf.relevance_flash_reference(x, v, lm, th, mk, km, tile=TILE,
                                             causal=True), atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        t_rf.relevance_flash_kernel(x, v, lm, th, mk, km, causal=True)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

LB, LN, D, H, LS, C = 3, 21, 32, 4, 8, 8


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layer_cfgs(bidirectional=False, adaptive=True, engine="chunked", **kw):
    j = j_stlt.STLTConfig(d_model=D, num_heads=H, num_nodes=LS, chunk=C,
                          mode="relevance", bidirectional=bidirectional,
                          engine=engine,
                          adaptive=j_adaptive.AdaptiveConfig(enabled=adaptive), **kw)
    t = t_stlt.STLTConfig(d_model=D, num_heads=H, num_nodes=LS, chunk=C,
                          mode="relevance", bidirectional=bidirectional,
                          engine=engine,
                          adaptive=t_adaptive.AdaptiveConfig(enabled=adaptive), **kw)
    return j, t


def _layer_params(cfg_j, seed=0):
    p = j_stlt.init_stlt(jax.random.key(seed), cfg_j)
    if "adaptive" in p:  # masks that differ per row
        p["adaptive"]["w_alpha"] = p["adaptive"]["w_alpha"] * 60.0
        p["adaptive"]["b_alpha"] = p["adaptive"]["b_alpha"] - 2.0
    return p, _tree(p, lambda a: torch.from_numpy(np.array(a)))


def _layer_x(seed=6):
    x = np.random.default_rng(seed).normal(size=(LB, LN, D)).astype(np.float32)
    pad = np.arange(LN)[None] < np.array([LN, 13, 5])[:, None]
    return x, pad


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX layer's pallas relevance engine through interpret
    mode, as tests/test_relevance_flash.py does."""
    monkeypatch.setattr(j_rf, "relevance_flash",
                        functools.partial(j_rf.relevance_flash, interpret=True))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("jax_engine", ["chunked", "pallas"])
def test_apply_stlt_relevance_matches_jax(pallas_interpret, bidirectional, jax_engine):
    """Adaptive masks and a pad_mask (rows of 21, 13 and 5 real tokens):
    outputs at real positions and the aux, against the JAX package's
    materialized readout (``chunked``) and its flash readout (``pallas``)."""
    cfg_j, cfg_t = _layer_cfgs(bidirectional, engine=jax_engine)
    pj, pt = _layer_params(cfg_j)
    x, pad = _layer_x()
    yj, auxj = j_stlt.apply_stlt(pj, cfg_j, jnp.asarray(x), pad_mask=jnp.asarray(pad))
    yt, auxt = t_stlt.apply_stlt(pt, cfg_t, torch.from_numpy(x),
                                 pad_mask=torch.from_numpy(pad))
    for b in range(LB):
        n = int(pad[b].sum())
        _close(yt[b, :n], np.asarray(yj)[b, :n], atol=LAYER_ATOL)
    for k in ("reg", "s_eff", "masks", "T", "sigma"):
        _close(auxt[k], auxj[k], atol=1e-6)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_port_materialized_oracle_matches_jax(bidirectional):
    """The port's own small-N oracle (plain complex scan, full [N, N])
    against the JAX package's materialized readout, and against the port's
    flash readout."""
    cfg_j, cfg_t = _layer_cfgs(bidirectional)
    pj, pt = _layer_params(cfg_j, seed=1)
    x, pad = _layer_x(7)
    lm_j, th_j, _, _ = j_stlt._poles(pj, cfg_j)
    v_j = j_stlt._split_heads(jnp.asarray(x) @ pj["w_v"], H)
    masks = np.random.default_rng(8).uniform(size=(LB, H, LS)).astype(np.float32)
    want = j_stlt._relevance_materialized(pj, cfg_j, jnp.asarray(x), v_j, lm_j, th_j,
                                          jnp.asarray(masks), jnp.asarray(pad))
    lm_t, th_t, _, _ = t_stlt._poles(pt, cfg_t)
    v_t = t_stlt._split_heads(torch.from_numpy(x) @ pt["w_v"], H)
    args = (cfg_t, torch.from_numpy(x), v_t, lm_t, th_t, torch.from_numpy(masks),
            torch.from_numpy(pad))
    got = t_stlt._relevance_materialized(*args)
    flash = t_stlt._relevance_readout(*args)
    for b in range(LB):
        n = int(pad[b].sum())
        _close(got[b, :, :n], np.asarray(want)[b, :, :n], atol=LAYER_ATOL)
        _close(flash[b, :, :n], got[b, :, :n], atol=LAYER_ATOL)


@pytest.mark.parametrize("frozen", ["sigma", "omega", "T"])
def test_frozen_node_parameters_get_no_gradient(frozen):
    """With one ``learnable_*`` switch off, that node parameter's gradient
    through the relevance layer's output is zero, and every node gradient
    matches jax.grad of the same loss. (The (Reg) loss reads omega
    directly in both packages, so it is left out.)"""
    cfg_j, cfg_t = _layer_cfgs(bidirectional=False,
                               **{f"learnable_{frozen}": False})
    pj, pt = _layer_params(cfg_j, seed=2)
    x, _ = _layer_x(9)

    def loss_j(nodes):
        y, _ = j_stlt.apply_stlt({**pj, "nodes": nodes}, cfg_j, jnp.asarray(x))
        return (y ** 2).sum()

    gj = jax.grad(loss_j)(pj["nodes"])
    nodes = {k: t.clone().requires_grad_(True) for k, t in pt["nodes"].items()}
    y, _ = t_stlt.apply_stlt({**pt, "nodes": nodes}, cfg_t, torch.from_numpy(x))
    names = list(nodes)
    gt = torch.autograd.grad((y ** 2).sum(), [nodes[k] for k in names],
                             allow_unused=True)
    gt = dict(zip(names, gt))
    leaf = {"sigma": "sigma_hat", "omega": "omega", "T": "T_hat"}[frozen]
    assert gt[leaf] is None or not gt[leaf].any()
    assert not np.asarray(gj[leaf]).any()
    for k in names:
        _grad_close(gt[k], gj[k])


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------


def _lm_cfgs(**kw):
    return (dataclasses.replace(J_BASE, mixer="stlt_relevance").reduced(**kw),
            dataclasses.replace(T_BASE, mixer="stlt_relevance").reduced(**kw))


@pytest.fixture(scope="module")
def lm_model():
    jcfg, tcfg = _lm_cfgs()
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    for layer in tree["layers"]:               # masks that differ per row
        layer["stlt"]["adaptive"]["w_alpha"] = layer["stlt"]["adaptive"]["w_alpha"] * 60.0
        layer["stlt"]["adaptive"]["b_alpha"] = layer["stlt"]["adaptive"]["b_alpha"] - 2.0
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree, tcfg, device="cpu")
    return jcfg, tcfg, tree, jparams, tparams


def _tokens(seed, b=2, n=37):
    return np.random.default_rng(seed).integers(0, 256, size=(b, n)).astype(np.int32)


def test_lm_relevance_forward_and_loss_match_jax(lm_model):
    """The reduced relevance LM (4 layers, d_model 64, 8 nodes, chunk 16):
    logits, aux and the loss against the JAX package (whose ``chunked``
    engine materializes the readout), with weights carried by the
    converter."""
    jcfg, tcfg, _, jparams, tparams = lm_model
    assert tcfg.block_types() == jcfg.block_types() == ("stlt_rel",) * 4
    toks = _tokens(10)
    lj, auxj = JT.apply_lm(jparams, jcfg, jnp.asarray(toks))
    lt, auxt = TT.apply_lm(tparams, tcfg, torch.from_numpy(toks))
    _close(lt, lj, atol=LAYER_ATOL)
    _close(auxt["reg"], auxj["reg"], atol=1e-6)
    _close(auxt["s_eff"], auxj["s_eff"], atol=1e-5)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1)}
    lossj, mj = JT.lm_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                           deterministic=True)
    losst, mt = TT.lm_loss(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                           deterministic=True)
    _close(losst, lossj, atol=LAYER_ATOL)
    _close(mt["ce"], mj["ce"], atol=LAYER_ATOL)


def test_lm_relevance_loss_grads_match_jax(lm_model, pallas_interpret):
    """One backward of lm_loss: every STLT parameter's gradient (through
    the relevance readout's autograd Function) against jax.grad through the
    JAX package's flash readout (engine ``pallas``, whose backward is also
    a recompute through the tiled reference). The node mixers u are unused
    by the relevance readout: zero in JAX, None here."""
    jcfg, tcfg, _, jparams, tparams = lm_model
    jcfg = dataclasses.replace(jcfg, stlt_engine="pallas")
    toks = _tokens(11, n=21)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1)}
    gj = jax.grad(lambda p: JT.lm_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                       deterministic=True)[0])(jparams)
    leaves = [(i, k, sub) for i, layer in enumerate(tparams["layers"])
              for k, sub in layer["stlt"].items() if k != "adaptive"]
    params = {**tparams, "layers": [dict(layer, stlt=dict(layer["stlt"]))
                                    for layer in tparams["layers"]]}
    flat = []
    for i, k, sub in leaves:
        if isinstance(sub, dict):
            sub = {n: t.clone().requires_grad_(True) for n, t in sub.items()}
            flat += [(i, k, n, t) for n, t in sub.items()]
        else:
            sub = sub.clone().requires_grad_(True)
            flat.append((i, k, None, sub))
        params["layers"][i]["stlt"][k] = sub
    loss, _ = TT.lm_loss(params, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                         deterministic=True)
    got = torch.autograd.grad(loss, [t for *_, t in flat], allow_unused=True)
    for (i, k, n, _), g in zip(flat, got):
        want = gj["layers"][i]["stlt"][k]
        _grad_close(g, want if n is None else want[n])


@pytest.mark.parametrize("scan_layers", [False, True])
def test_converter_takes_relevance_params(scan_layers):
    """A relevance model's params are the same pytree as a factorized
    model's; the converter unstacks them either way."""
    jcfg, tcfg = _lm_cfgs(scan_layers=scan_layers)
    jf = dataclasses.replace(jcfg, mixer="stlt")
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(1), jcfg))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(tree) == shapes(JT.init_lm(jax.random.key(1), jf))
    tp = convert.from_jax_params(tree, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers
    own = TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tshape = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert tshape(tp) == tshape(own)
    stacked = np.asarray(tree["layers"][0]["stlt"]["w_v"])
    first = stacked[0] if scan_layers else stacked
    np.testing.assert_array_equal(_np(tp["layers"][0]["stlt"]["w_v"]), first)


def test_lm_relevance_refuses_serving(lm_model):
    _, tcfg, _, _, tparams = lm_model
    toks = torch.from_numpy(_tokens(12, n=8))
    with pytest.raises(ValueError, match="streaming"):
        TT.init_decode_state(tcfg, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        TT.prefill(tparams, tcfg, toks, 64)
    fcfg = dataclasses.replace(tcfg, mixer="stlt")
    st = TT.init_decode_state(fcfg, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        TT.prefill_chunk(tparams, tcfg, toks, st)
    with pytest.raises(ValueError, match="streaming"):
        TT.decode_step(tparams, tcfg, toks[:, 0], st)
