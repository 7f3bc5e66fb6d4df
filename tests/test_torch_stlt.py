"""Parity of the PyTorch port's STLT layer and shared layers with the JAX
package, on the CPU.

The layer cases run a small adaptive config (d_model 32, 4 heads, 8 nodes,
chunk 16) with JAX-initialized weights carried across as numpy; the
adaptive gate's weights are scaled up so the node masks differ per row and
per chunk. Every JAX engine name that computes the causal exponential scan
(chunked, chunked_fused, pallas in interpret mode) is held to the port,
which runs all three through ``ops.stlt_scan``; the hann window (W = 16,
an FFT convolution in both packages) in both directions, its grads and its
ring through every streaming entry point. Tolerances: atol 1e-5 on layer
outputs and carries (fp32 sums of O(1) terms), 1e-6 on elementwise layers,
and the hann grads 1e-4 of each leaf's scale.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro.kernels.ops as j_kops  # noqa: E402
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.core import stlt as j_stlt  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.core import stlt as t_stlt  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

ATOL = 1e-5
B, N, D, H, S, C = 3, 40, 32, 4, 8, 16

# the JAX layer functions, jitted (config static) so each compiles once
j_apply_stlt = jax.jit(j_stlt.apply_stlt, static_argnums=1)
j_stlt_prefill = jax.jit(j_stlt.stlt_prefill, static_argnums=1)
j_apply_stlt_step = jax.jit(j_stlt.apply_stlt_step, static_argnums=1)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_torch(tree):
    return _tree(tree, lambda a: torch.from_numpy(np.array(a)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _cfgs(engine="chunked", adaptive=True, **kw):
    j = j_stlt.STLTConfig(d_model=D, num_heads=H, num_nodes=S, chunk=C,
                          engine=engine,
                          adaptive=j_adaptive.AdaptiveConfig(enabled=adaptive), **kw)
    t = t_stlt.STLTConfig(d_model=D, num_heads=H, num_nodes=S, chunk=C,
                          engine=engine,
                          adaptive=t_adaptive.AdaptiveConfig(enabled=adaptive), **kw)
    return j, t


def _params(cfg_j, seed=0):
    p = j_stlt.init_stlt(jax.random.key(seed), cfg_j)
    if "adaptive" in p:  # make the masks vary across rows and chunks
        p["adaptive"]["w_alpha"] = p["adaptive"]["w_alpha"] * 60.0
        p["adaptive"]["b_alpha"] = p["adaptive"]["b_alpha"] - 2.0
    return p, _to_torch(p)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX layer's pallas engine through interpret mode, as
    tests/test_kernels.py does."""
    monkeypatch.setattr(j_kops, "stlt_scan",
                        functools.partial(j_kops.stlt_scan, interpret=True,
                                          block_d=8))


ENGINES = ["chunked", "chunked_fused", "pallas"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("adaptive", [False, True])
def test_apply_stlt_matches_jax(pallas_interpret, engine, adaptive):
    cfg_j, cfg_t = _cfgs(engine, adaptive)
    pj, pt = _params(cfg_j)
    x = _x(1, B, N, D)
    yj, auxj = j_apply_stlt(pj, cfg_j, jnp.asarray(x))
    yt, auxt = t_stlt.apply_stlt(pt, cfg_t, torch.from_numpy(x))
    _close(yt, yj)
    for k in ("reg", "s_eff", "T", "sigma"):
        _close(auxt[k], auxj[k], atol=1e-6)
    if adaptive:
        _close(auxt["masks"], auxj["masks"], atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_stlt_prefill_state_and_valid_match_jax(pallas_interpret, engine):
    """A fresh prefill, then a resumed padded chunk with per-row valid
    lengths {N, 0, 7}: outputs at valid positions and every state leaf
    (carries and the asum/acnt pooled summary)."""
    cfg_j, cfg_t = _cfgs(engine)
    pj, pt = _params(cfg_j)
    x1, x2 = _x(2, B, N, D), _x(3, B, 24, D)
    yj, sj = j_stlt_prefill(pj, cfg_j, jnp.asarray(x1))
    yt, st = t_stlt.stlt_prefill(pt, cfg_t, torch.from_numpy(x1))
    _close(yt, yj)
    assert sorted(st) == sorted(sj) == ["acnt", "asum", "h_im", "h_re"]
    for k in sj:
        _close(st[k], sj[k], atol=1e-4 if k == "asum" else ATOL)
    valid = np.array([24, 0, 7], np.int32)
    yj, sj = j_stlt_prefill(pj, cfg_j, jnp.asarray(x2), state=sj,
                            valid=jnp.asarray(valid))
    yt, st = t_stlt.stlt_prefill(pt, cfg_t, torch.from_numpy(x2), state=st,
                                 valid=torch.from_numpy(valid))
    for b, v in enumerate(valid):
        _close(yt[b, :v], np.asarray(yj)[b, :v])
    for k in sj:
        _close(st[k], sj[k], atol=1e-4 if k == "asum" else ATOL)


def test_stlt_prefill_valid_from_empty_state_matches_jax():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=4)
    x = _x(5, B, 19, D)
    valid = np.array([19, 1, 0], np.int32)
    _, sj = j_stlt_prefill(pj, cfg_j, jnp.asarray(x), valid=jnp.asarray(valid))
    _, st = t_stlt.stlt_prefill(pt, cfg_t, torch.from_numpy(x),
                                valid=torch.from_numpy(valid))
    for k in sj:
        _close(st[k], sj[k])


@pytest.mark.parametrize("node_cap", [None, [8, 3, 1]])
def test_apply_stlt_step_matches_jax(node_cap):
    """Decode steps after a prefill, with and without per-row node caps."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=1)
    _, sj = j_stlt_prefill(pj, cfg_j, jnp.asarray(_x(6, B, 21, D)))
    _, st = t_stlt.stlt_prefill(pt, cfg_t, torch.from_numpy(_x(6, B, 21, D)))
    cap_j = None if node_cap is None else jnp.asarray(node_cap, jnp.int32)
    cap_t = None if node_cap is None else torch.tensor(node_cap, dtype=torch.int32)
    for i in range(4):
        xt = _x(10 + i, B, D)
        yj, sj = j_apply_stlt_step(pj, cfg_j, jnp.asarray(xt), sj, node_cap=cap_j)
        yt, st = t_stlt.apply_stlt_step(pt, cfg_t, torch.from_numpy(xt), st,
                                        node_cap=cap_t)
        _close(yt, yj)
        for k in sj:
            _close(st[k], sj[k], atol=1e-4 if k == "asum" else ATOL)


def test_init_stlt_layout_matches_jax():
    cfg_j, cfg_t = _cfgs(gate=True)
    pj = j_stlt.init_stlt(jax.random.key(0), cfg_j)
    pt = t_stlt.init_stlt(torch.Generator().manual_seed(0), cfg_t)
    shapes = lambda p: _tree(p, lambda a: tuple(a.shape))  # noqa: E731
    assert shapes(pt) == shapes(pj)
    st = t_stlt.init_stlt_state(cfg_t, 2)
    sj = j_stlt.init_stlt_state(cfg_j, 2)
    assert shapes(st) == shapes(sj)


# the hann window: its parity cases replace the refusal cases it had while
# unported (hann; bilateral; under the associative and sequential engine
# names, which the hann form ignores, as the JAX package's does), plus the
# adaptive form in both directions
HANN = {"causal": dict(adaptive=False),
        "bidirectional": dict(adaptive=False, bidirectional=True),
        "associative": dict(adaptive=False, engine="associative"),
        "sequential": dict(adaptive=False, engine="sequential"),
        "adaptive": dict(adaptive=True),
        "adaptive_bidirectional": dict(adaptive=True, bidirectional=True)}
# fp32 FFTs of length 64 (N + W = 40 + 16, rounded up to 5-smooth): torch's
# and jnp's transforms round differently, ~1e-6 of O(1) outputs
HANN_ATOL = 1e-5
# grads: relative to each leaf's largest entry (sums over 3 x 40 tokens)
HANN_GRAD_RTOL = 1e-4


def _hann_cfgs(**kw):
    return _cfgs(window="hann", hann_support=16, **kw)


def _grads_t(pt, cfg_t, x, w):
    """The port's grads of sum(apply_stlt(p, x) * w) w.r.t. every leaf and x."""
    leaves = {}

    def req(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = req(v, prefix + k + "/")
            else:
                out[k] = leaves.setdefault(prefix + k, v.clone().requires_grad_(True))
        return out
    p = req(pt)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_stlt.apply_stlt(p, cfg_t, xt)
    loss = (y * torch.from_numpy(w)).sum() + aux["reg"]
    names = sorted(leaves)
    g = torch.autograd.grad(loss, [leaves[n] for n in names] + [xt], allow_unused=True)
    return dict(zip(names + ["x"], g))


def _grads_j(pj, cfg_j, x, w):
    def loss(p, xx):
        y, aux = j_stlt.apply_stlt(p, cfg_j, xx)
        return (y * w).sum() + aux["reg"]
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(pj, jnp.asarray(x))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]}
    return {**flat, "x": gx}


@pytest.mark.parametrize("case", sorted(HANN))
def test_hann_apply_stlt_and_grads_match_jax(case):
    """``apply_stlt`` with the hann window (finite support W = 16 < N = 40,
    T = 32 > W, so the support truncates the taper) against the JAX package:
    outputs, aux, and the grads of a weighted sum (plus the Reg loss) w.r.t.
    every param leaf and x. The engine name is ignored by the hann form."""
    cfg_j, cfg_t = _hann_cfgs(**HANN[case])
    pj, pt = _params(cfg_j, seed=2)
    x, w = _x(1, B, N, D), _x(2, B, N, D)
    yj, auxj = j_apply_stlt(pj, cfg_j, jnp.asarray(x))
    yt, auxt = t_stlt.apply_stlt(pt, cfg_t, torch.from_numpy(x))
    _close(yt, yj, atol=HANN_ATOL)
    for k in ("reg", "s_eff", "T", "sigma"):
        _close(auxt[k], auxj[k], atol=1e-6)
    gt, gj = _grads_t(pt, cfg_t, x, w), _grads_j(pj, cfg_j, x, w)
    assert sorted(gt) == sorted(gj)
    for k, want in gj.items():
        want = np.asarray(want)
        got = np.zeros_like(want) if gt[k] is None else _np(gt[k])
        _close(got, want, atol=HANN_GRAD_RTOL * (1.0 + float(np.abs(want).max())))


@pytest.mark.parametrize("adaptive", [False, True])
def test_hann_streaming_matches_jax(adaptive):
    """The hann ring through every streaming entry point against the JAX
    package: a fresh prefill (the ring of the last W = 16 values), a resumed
    padded chunk with valid {24, 0, 7} (the valid == 0 row's ring back bit
    for bit), decode steps (roll, write slot 0, read out with g), and the
    spec rollback ``stlt_state_at`` at q {0, 3, 5} (q == 0 bit for bit)."""
    cfg_j, cfg_t = _hann_cfgs(adaptive=adaptive)
    pj, pt = _params(cfg_j, seed=3)
    st0 = t_stlt.init_stlt_state(cfg_t, B)
    sj0 = j_stlt.init_stlt_state(cfg_j, B)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in st0.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("float", "torch.float").replace(
            "int32", "torch.int32")) for k, v in sj0.items()}
    x1, x2 = _x(4, B, N, D), _x(5, B, 24, D)
    yj, sj = j_stlt_prefill(pj, cfg_j, jnp.asarray(x1))
    yt, st = t_stlt.stlt_prefill(pt, cfg_t, torch.from_numpy(x1))
    _close(yt, yj, atol=HANN_ATOL)
    assert sorted(st) == sorted(sj)
    for k in sj:
        _close(st[k], sj[k], atol=1e-4 if k == "asum" else ATOL)
    assert st["pos"].dtype == torch.int32 and st["buf"].dtype == torch.float32
    valid = np.array([24, 0, 7], np.int32)
    yj, sj = j_stlt_prefill(pj, cfg_j, jnp.asarray(x2), state=sj, valid=jnp.asarray(valid))
    yt, st2 = t_stlt.stlt_prefill(pt, cfg_t, torch.from_numpy(x2), state=st,
                                  valid=torch.from_numpy(valid))
    for b, v in enumerate(valid):
        _close(yt[b, :v], np.asarray(yj)[b, :v], atol=HANN_ATOL)
    for k in sj:
        _close(st2[k], sj[k], atol=1e-4 if k == "asum" else ATOL)
    assert torch.equal(st2["buf"][1], st["buf"][1]) and int(st2["pos"][1]) == N
    st = st2
    for i in range(3):
        xt = _x(20 + i, B, D)
        yj, sj = j_apply_stlt_step(pj, cfg_j, jnp.asarray(xt), sj)
        yt, st = t_stlt.apply_stlt_step(pt, cfg_t, torch.from_numpy(xt), st)
        _close(yt, yj)
        for k in sj:
            _close(st[k], sj[k], atol=1e-4 if k == "asum" else ATOL)
    q = np.array([0, 3, 5], np.int32)
    x3 = _x(6, B, 5, D)
    aj = j_stlt.stlt_state_at(pj, cfg_j, jnp.asarray(x3), sj, jnp.asarray(q))
    at = t_stlt.stlt_state_at(pt, cfg_t, torch.from_numpy(x3), st, torch.from_numpy(q))
    for k in aj:
        _close(at[k], aj[k], atol=1e-4 if k == "asum" else ATOL)
    assert torch.equal(at["buf"][0], st["buf"][0])
    np.testing.assert_array_equal(_np(at["pos"]), _np(st["pos"]) + q)


@pytest.mark.parametrize("entry", ["stlt_prefill", "init_stlt_state",
                                   "apply_stlt_step"])
def test_streaming_entry_points_refuse_relevance_mode(entry):
    """The relevance readout has no streaming state: prefill, state init
    and decode refuse it, as the JAX package asserts."""
    cfg_f = _cfgs()[1]
    cfg_r = dataclasses.replace(cfg_f, mode="relevance")
    pt = t_stlt.init_stlt(torch.Generator().manual_seed(0), cfg_r)
    x = torch.zeros(1, 4, D)
    calls = {"stlt_prefill": lambda: t_stlt.stlt_prefill(pt, cfg_r, x),
             "init_stlt_state": lambda: t_stlt.init_stlt_state(cfg_r, 1),
             "apply_stlt_step": lambda: t_stlt.apply_stlt_step(
                 pt, cfg_r, x[:, 0], t_stlt.init_stlt_state(cfg_f, 1))}
    with pytest.raises(ValueError, match="streaming"):
        calls[entry]()


# ---------------------------------------------------------------------------
# numerics that differ between the frameworks
# ---------------------------------------------------------------------------


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; torch's default is exact erf."""
    r = np.random.default_rng(0)
    pj = {"w1": r.normal(size=(16, 32)), "w2": r.normal(size=(32, 16)) / 4,
          "b1": r.normal(size=32), "b2": r.normal(size=16)}
    pj = {k: v.astype(np.float32) for k, v in pj.items()}
    x = _x(1, 5, 16)
    want = j_layers.ffn({k: jnp.asarray(v) for k, v in pj.items()}, jnp.asarray(x),
                        act="gelu")
    got = t_layers.ffn(_to_torch(pj), torch.from_numpy(x), act="gelu")
    _close(got, want, atol=1e-5)
    h = torch.from_numpy(x) @ _to_torch(pj)["w1"]
    assert float((F.gelu(h) - F.gelu(h, approximate="tanh")).abs().max()) > 1e-4


def test_swiglu_ffn_matches_jax():
    r = np.random.default_rng(1)
    pj = {k: r.normal(size=s).astype(np.float32) / 4
          for k, s in (("w1", (16, 24)), ("w3", (16, 24)), ("w2", (24, 16)))}
    x = _x(2, 3, 16)
    _close(t_layers.ffn(_to_torch(pj), torch.from_numpy(x)),
           j_layers.ffn({k: jnp.asarray(v) for k, v in pj.items()}, jnp.asarray(x)))


def test_layer_norm_uses_population_variance():
    r = np.random.default_rng(2)
    p = {"scale": r.normal(size=8).astype(np.float32),
         "bias": r.normal(size=8).astype(np.float32)}
    x = (3.0 * _x(3, 4, 8) + 1.0)
    want = j_layers.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = t_layers.layer_norm(_to_torch(p), torch.from_numpy(x))
    _close(got, want, atol=1e-5)
    xt = torch.from_numpy(x)
    biased = (xt - xt.mean(-1, keepdim=True)) * torch.rsqrt(
        xt.var(-1, keepdim=True, unbiased=True) + 1e-5)
    assert float((biased * _to_torch(p)["scale"] + _to_torch(p)["bias"]
                  - got).abs().max()) > 1e-2
    _close(t_layers.rms_norm({"scale": torch.from_numpy(p["scale"])}, xt),
           j_layers.rms_norm({"scale": jnp.asarray(p["scale"])}, jnp.asarray(x)))


@pytest.mark.parametrize("offset", [0, 17, [0, 5, 1000]])
def test_sinusoidal_pe_matches_jax(offset):
    """sin in even columns, cos in odd; a per-row offset [B] gives [B, n, d]
    as the JAX package's vmap over positions does."""
    n, d = 6, 16
    if isinstance(offset, list):
        want = jax.vmap(lambda p: j_layers.sinusoidal_pe(n, d, offset=p))(
            jnp.asarray(offset, jnp.int32))
    else:
        want = j_layers.sinusoidal_pe(n, d, offset=offset)
    got = t_layers.sinusoidal_pe(n, d, offset=torch.tensor(offset))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-4)
    np.testing.assert_allclose(_np(got)[..., 0, 0::2][..., :1],
                               np.sin(np.asarray(offset, np.float64)).reshape(-1, 1)
                               if isinstance(offset, list)
                               else [np.sin(offset)], atol=1e-4)


def test_cross_entropy_and_embeddings_match_jax():
    r = np.random.default_rng(3)
    logits = r.normal(size=(2, 5, 11)).astype(np.float32)
    labels = r.integers(0, 11, size=(2, 5))
    mask = (r.uniform(size=(2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        _close(t_layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if m is None else torch.from_numpy(m)),
               j_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                      None if m is None else jnp.asarray(m)), atol=1e-6)
    E = r.normal(size=(11, 4)).astype(np.float32)
    tok = labels
    _close(t_layers.embed({"embed": torch.from_numpy(E)}, torch.from_numpy(tok)),
           j_layers.embed({"embed": jnp.asarray(E)}, jnp.asarray(tok)), atol=0)
    h = _x(4, 3, 4)
    _close(t_layers.unembed({"embed": torch.from_numpy(E)}, torch.from_numpy(h)),
           j_layers.unembed({"embed": jnp.asarray(E)}, jnp.asarray(h)), atol=1e-6)
