"""The PyTorch port's mixture of experts and the MoE archs against the JAX
package on the CPU: ``apply_moe`` alone (a dispatch that fits, one that
drops, a row whose router probabilities tie, ``gelu`` experts, Arctic's
dense residual branch, the ``shard_map`` dispatch's one-device fallback;
outputs, ``aux_loss``, ``router_z`` and the dropped choices counted),
top-k's tie order, and reduced qwen3-moe-235b-a22b in both variants and
arctic-480b: logits, loss with ``aux_loss`` and ``router_z``, grads in both
``scan_layers`` layouts, train steps against ``repro.launch.train.make_step``
(adafactor, the configs' optimizer), chunked and masked prefill, decode,
the ``spec_verify`` rollback, and greedy ``generate``, continuous
``serve`` and n-gram spec streams against the unsharded JAX
``ServeEngine`` on the same request mix.

An expert's capacity depends on the token count of the whole call, so
padded tokens and idle rows route too, in both packages: chunked prefill
equals the monolithic one only where no call dropped (the test checks that
its calls dropped nothing), and a served stream is held to the JAX
engine's on the same mix, where every dispatch has the same shape.

Both packages get the same weights (``convert.from_jax_params``) and inputs
from numpy seeds, in fp32. Tolerances: ``apply_moe`` 1e-5 relative /
1e-6 absolute (fp32 summation order); logits rtol 2e-4 / atol 1e-5 (the
other LM tests'); each state leaf within 2e-5 of (1 + its largest entry);
the loss and the aux terms 2e-5 relative, grads 1e-3 of each leaf's largest
entry; token streams exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

RTOL, ATOL = 2e-4, 1e-5
STATE_TOL = 2e-5
MOE_RTOL, MOE_ATOL = 1e-5, 1e-6
MAX_LEN, CHUNK, SLOTS = 48, 8, 3
LAYOUTS = {"qwen3": ("qwen3-moe-235b-a22b", "native"),
           "qwen3_stlt": ("qwen3-moe-235b-a22b", "stlt"),
           "arctic": ("arctic-480b", "native")}

j_apply_lm = jax.jit(JT.apply_lm, static_argnums=1)
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)
j_spec_verify = jax.jit(JT.spec_verify, static_argnums=1)
j_apply_moe = jax.jit(JM.apply_moe, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def j_loss_and_grads(params, cfg, batch):
    return jax.value_and_grad(
        lambda p: JT.lm_loss(p, cfg, batch, deterministic=True), has_aux=True)(params)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _model(layout: str, scan_layers: bool = False):
    arch, variant = LAYOUTS[layout]
    jcfg = j_get_config(arch, variant).reduced(scan_layers=scan_layers)
    tcfg = t_get_config(arch, variant).reduced(scan_layers=scan_layers)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.from_jax_params(tree, tcfg, device="cpu"))


def _state(tree, tcfg):
    return convert.from_jax_state(jax.tree_util.tree_map(np.asarray, tree), tcfg,
                                  device="cpu")


def _same_state(got, want, what, tol=STATE_TOL):
    for li, (lg, lw) in enumerate(zip(got["layers"], want["layers"])):
        assert sorted(lg) == sorted(lw), (what, li, sorted(lg), sorted(lw))
        for k in lw:
            assert lg[k].dtype == lw[k].dtype and lg[k].shape == lw[k].shape, (what, li, k)
            scale = 1.0 + float(lw[k].float().abs().max())
            _close(lg[k], lw[k], f"{what} layer {li} {k}", 0, tol * scale)
    assert torch.equal(got["pos"], want["pos"]), what


def _toks(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _dropped(fn):
    """(fn's result, the (token, expert) choices its MoE calls dropped)."""
    TM.DROPS.reset()
    out = fn()
    return out, TM.DROPS.read()["dropped"]


# ---------------------------------------------------------------------------
# (1) apply_moe alone
# ---------------------------------------------------------------------------


def _moe_cfgs(**kw):
    """The reduced qwen3-moe's MoE (d_model 64, 4 experts of d_ff 128,
    top-2), with ``kw`` replaced, in both packages."""
    jc = dataclasses.replace(j_get_config("qwen3-moe-235b-a22b").reduced().moe_config(), **kw)
    tc = dataclasses.replace(t_get_config("qwen3-moe-235b-a22b").reduced().moe_config(), **kw)
    return jc, tc


def _expected_drops(jp, jc, x):
    """The choices JAX's routing drops, counted in numpy from its top-k."""
    T = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jp["router"], axis=-1)
    flat = np.asarray(jax.lax.top_k(probs, jc.top_k)[1]).reshape(-1)
    onehot = np.eye(jc.num_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat]
    return int((pos >= JM._capacity(T, jc)).sum())


# case: (MoEConfig overrides, tie the router's experts 1, 2 and 3?)
MOE_CASES = {"fits": ({}, False), "drops": ({"capacity_factor": 0.5}, False),
             "gelu": ({"act": "gelu"}, False),
             "dense": ({"dense_residual": True, "dense_ff": 64}, False),
             "shard_map": ({"dispatch": "shard_map"}, False),
             "tied_drops": ({"capacity_factor": 0.5}, True)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_jax(case):
    """apply_moe's output, aux_loss and router_z equal JAX's on 2 x 12
    tokens (capacity 16, or 8 at capacity factor 0.5, for a mean load of
    12 choices an expert), and DROPS counts the choices JAX's routing
    drops. With experts 1, 2 and 3 given one router column, each token's
    probabilities tie among them and the lower index wins, as in
    ``jax.lax.top_k``: with drops, another order gives other outputs. The
    init draws JAX's shapes; the port's combine gives the same output on a
    second call, bit for bit."""
    kw, tied = MOE_CASES[case]
    jc, tc = _moe_cfgs(**kw)
    jp = jax.tree_util.tree_map(np.asarray, JM.init_moe(jax.random.key(1), jc))
    port = TM.init_moe(torch.Generator().manual_seed(0), tc)
    assert sorted(port) == sorted(jp)
    for path, a in tree_flatten_with_paths(port):
        want = functools.reduce(lambda t, k: t[k], path.split("/"), jp)
        assert tuple(a.shape) == want.shape and a.dtype == torch.float32, path
    if tied:
        router = jp["router"].copy()
        router[:, 2] = router[:, 3] = router[:, 1]
        jp = {**jp, "router": router}
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    x = np.random.default_rng(2).normal(size=(2, 12, 64)).astype(np.float32)
    yj, aj = j_apply_moe(jax.tree_util.tree_map(jnp.asarray, jp), jc, jnp.asarray(x))
    (yt, at), dropped = _dropped(lambda: TM.apply_moe(tp, tc, torch.from_numpy(x)))
    _close(yt, yj, "y", MOE_RTOL, MOE_ATOL)
    for k in ("aux_loss", "router_z"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=2e-5, err_msg=k)
    assert dropped == _expected_drops(jp, jc, x)
    assert (dropped > 0) == ("drops" in case), dropped
    assert torch.equal(TM.apply_moe(tp, tc, torch.from_numpy(x))[0], yt)
    if tied:   # the routing depends on the tie order: the last expert of the tie is not chosen
        probs = torch.softmax(torch.from_numpy(x.reshape(24, 64)) @ tp["router"], -1)
        assert int(TM._top_k(probs, 2)[1].eq(3).sum()) == 0


def test_top_k_tie_order_is_jax_lax_top_k():
    """Among equal values the lower index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` gives [2, 4] on this row)."""
    row = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    vals, idx = TM._top_k(torch.from_numpy(row), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(row), 2)
    np.testing.assert_array_equal(_np(idx), np.asarray(ji))
    np.testing.assert_array_equal(_np(idx), [[1, 2], [0, 1]])
    np.testing.assert_array_equal(_np(vals), np.asarray(jv))


def test_moe_configs_capacity_and_sizes_match_jax():
    """moe_config() field for field (less the sharding hints), _capacity at
    the dispatch sizes of the card's runs (JAX's Python-float formula
    rounded up to 8), and the full-width MoE's parameter count from the JAX
    package's shapes (no allocation): qwen3-moe's experts 2,415,919,104 a
    layer, arctic's 13,388,218,368 beside its dense branch."""
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        for variant in ("native", "stlt"):
            for j, t in ((j_get_config(arch, variant), t_get_config(arch, variant)),
                         (j_get_config(arch, variant).reduced(),
                          t_get_config(arch, variant).reduced())):
                jm, tm = j.moe_config(), t.moe_config()
                for f in dataclasses.fields(TM.MoEConfig):
                    if f.name != "param_dtype":
                        assert getattr(tm, f.name) == getattr(jm, f.name), (arch, f.name)
                for T in (2, 4, 8, 24, 512, 1024, 2048, 16384):
                    assert TM._capacity(T, tm) == JM._capacity(T, jm), (arch, T)
        cfg = t_get_config(arch).moe_config()
        shapes = jax.eval_shape(lambda k, a=arch: JM.init_moe(k, j_get_config(a).moe_config()),
                                jax.random.key(0))
        counts = {k: int(np.prod(v.shape)) for k, v in shapes.items() if k != "dense"}
        E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert counts == {"router": d * E, "w1": E * d * f, "w3": E * d * f, "w2": E * f * d}
        assert 3 * E * d * f == {"qwen3-moe-235b-a22b": 2_415_919_104,
                                 "arctic-480b": 13_388_218_368}[arch]
    q, a = (t_get_config(x).moe_config() for x in ("qwen3-moe-235b-a22b", "arctic-480b"))
    assert TM._capacity(512, q) == 40 and TM._capacity(4, q) == 8
    assert TM._capacity(1024, a) == 24


# ---------------------------------------------------------------------------
# (2) the LM: forward, loss, grads, layouts, train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lm_logits_loss_and_grads_match_jax(layout):
    """apply_lm logits and aux terms, lm_loss (ce + reg + aux_loss +
    router_z) and every grad leaf over 2 x 24 tokens, against
    ``jax.value_and_grad`` of the JAX loss; every block has ``moe`` and no
    ``ffn``, arctic's with its dense branch."""
    jcfg, tcfg, jp, tp = _model(layout)
    assert all("moe" in layer and "ffn" not in layer for layer in tp["layers"])
    assert ("dense" in tp["layers"][0]["moe"]) == (layout == "arctic")
    toks = _toks(6, (2, 25), tcfg.vocab)
    lj, aj = j_apply_lm(jp, jcfg, jnp.asarray(toks[:, :-1]))
    lt, at = TT.apply_lm(tp, tcfg, torch.from_numpy(toks[:, :-1]))
    _close(lt, lj, "logits")
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=2e-5, err_msg=k)
    assert float(at["aux_loss"]) > 0 and float(at["router_z"]) > 0
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (loss_j, mj), gj = j_loss_and_grads(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, mt, gt = t_train.loss_and_grads(tp, tcfg, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()}, tau=1.0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    for k in ("ce", "aux_loss", "router_z"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=2e-5, err_msg=k)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, gj), tcfg, device="cpu")
    for (path, g), (_, w) in zip(tree_flatten_with_paths(gt), tree_flatten_with_paths(want)):
        _close(g, w, f"grad {path}", 1e-3, 1e-3 * float(w.abs().max()) + 1e-7)


def test_stacked_layout_converts_and_matches_jax():
    """With scan_layers=True the JAX package stacks arctic's 4 reduced
    layers into one run (experts [4, E, d, f]): from_jax_params unstacks
    it, and logits and the monolithic prefill's state equal JAX's."""
    jcfg, tcfg, jp, tp = _model("arctic", scan_layers=True)
    assert TT.execution_plan(tcfg) == (("attn", 4),)
    assert jp["layers"][0]["moe"]["w1"].shape == (4, 4, 64, 128)
    assert len(tp["layers"]) == 4 and tuple(tp["layers"][2]["moe"]["w1"].shape) == (4, 64, 128)
    toks = _toks(7, (2, 20), tcfg.vocab)
    lj, _ = j_apply_lm(jp, jcfg, jnp.asarray(toks))
    lt, _ = TT.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(lt, lj, "logits")
    lj, sj = j_prefill(jp, jcfg, jnp.asarray(toks), MAX_LEN)
    lt, st = TT.prefill(tp, tcfg, torch.from_numpy(toks), MAX_LEN)
    _close(lt, lj, "prefill logits")
    _same_state(st, _state(sj, tcfg), "prefill")


TCFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRIC_RTOL = 2e-5    # test_torch_train.py's, fp32 through the blocks


@functools.lru_cache(maxsize=None)
def _j_make_step(layout):
    return j_train.make_step(_model(layout)[0], JTrainConfig(**TCFG))


@pytest.mark.parametrize("layout,steps", [("qwen3", 1), ("qwen3", 3), ("arctic", 1)])
def test_train_steps_match_jax_make_step(layout, steps):
    """make_step (adafactor, the configs' optimizer) against
    ``repro.launch.train.make_step`` on 2 x 32 tokens: loss, ce, aux_loss,
    router_z, grad_norm within 2e-5 each step, the factored second moments
    within 1e-4 of each leaf's largest entry, the params within 1e-5; with
    remat on, step 0's grads equal remat off exactly."""
    jcfg, tcfg, jp, tp = _model(layout)
    assert tcfg.optimizer == "adafactor"
    jopt, jstep = _j_make_step(layout)
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        b = j_synthetic.lm_batch_stream(0, step, 2, 32, tcfg.vocab)
        jp, js, mj = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()}, step)
        tp, ts, mt = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in b.items()}, step)
        for k in ("loss", "ce", "aux_loss", "router_z", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=METRIC_RTOL,
                                       err_msg=f"step {step} {k}")
    want = dict(tree_flatten_with_paths(convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, js["v"]), tcfg, device="cpu")))
    got = dict(tree_flatten_with_paths(ts["v"]))
    assert sorted(got) == sorted(want) and ts["count"] == steps
    assert any(path.endswith("w1/vc") for path in got)      # [E, d, f] factored
    for path, w in want.items():
        assert float((got[path] - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-30, path
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp), tree_flatten_with_paths(want)):
        assert float((p - w).abs().max()) <= 1e-5, path
    if steps == 1:
        b = {k: torch.from_numpy(v)
             for k, v in j_synthetic.lm_batch_stream(0, 0, 2, 32, tcfg.vocab).items()}
        _, _, g_off = t_train.loss_and_grads(tp, tcfg, b, tau=1.0)
        _, _, g_on = t_train.loss_and_grads(tp, dataclasses.replace(tcfg, remat=True), b,
                                            tau=1.0)
        for (path, x), (_, y) in zip(tree_flatten_with_paths(g_on), tree_flatten_with_paths(g_off)):
            assert torch.equal(x, y), path


# ---------------------------------------------------------------------------
# (3) prefill, decode, rollback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunked_prefill_matches_jax_and_monolithic(layout):
    """A 21-token prompt folded in chunks of 2, 1, 8 and 10, then 4 decode
    steps, equal the JAX package's (logits, state leaf for leaf), drops and
    all. With capacity E / K (no call can drop) the fold equals the
    monolithic prefill, and decode the teacher-forced apply_lm; at the
    configs' capacity factor they need not, since each call's capacity
    depends on its token count."""
    jcfg, tcfg, jp, tp = _model(layout)
    toks = _toks(8, (2, 25), tcfg.vocab)
    st = TT.init_decode_state(tcfg, 2, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 2, MAX_LEN)
    for a, b in ((0, 2), (2, 3), (3, 11), (11, 21)):
        lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, a:b]), st)
        lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, a:b]), sj)
    _close(lt, lj, "chunked vs JAX")
    _same_state(st, _state(sj, tcfg), "chunked")
    for i in range(21, 25):
        lt, st = TT.decode_step(tp, tcfg, torch.from_numpy(toks[:, i]), st)
        lj, sj = j_decode_step(jp, jcfg, jnp.asarray(toks[:, i]), sj)
        _close(lt, lj, f"step {i} vs JAX")
    _same_state(st, _state(sj, tcfg), "after decode")

    roomy = dataclasses.replace(tcfg, capacity_factor=tcfg.num_experts / tcfg.top_k)
    TM.DROPS.reset()
    lm, sm = TT.prefill(tp, roomy, torch.from_numpy(toks[:, :21]), MAX_LEN)
    st = TT.init_decode_state(roomy, 2, MAX_LEN, device="cpu")
    for a, b in ((0, 2), (2, 3), (3, 11), (11, 21)):
        lt, st = TT.prefill_chunk(tp, roomy, torch.from_numpy(toks[:, a:b]), st)
    _close(lt, lm, "chunked vs monolithic")
    _same_state(st, sm, "chunked vs monolithic")
    teacher, _ = TT.apply_lm(tp, roomy, torch.from_numpy(toks))
    for i in range(21, 25):
        la, sm = TT.decode_step(tp, roomy, torch.from_numpy(toks[:, i]), sm)
        _close(la, teacher[:, i], f"step {i} vs teacher-forced")
    assert TM.DROPS.read()["dropped"] == 0 and TM.DROPS.calls == 4 * 10


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_masked_admission_and_rollback_match_jax(layout):
    """Rows at different depths in [3, 8] masked dispatches with valid
    (8, 0, 3) then (2, 8, 0) (the padded positions and the idle row route
    too and take capacity, as in JAX): logits at each row's last valid
    token and states as JAX's, a valid == 0 row's state kept bit for bit;
    then spec_verify's scoring and rollback on the result."""
    jcfg, tcfg, jp, tp = _model(layout)
    r = np.random.default_rng(9)
    V = tcfg.vocab
    st = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 3, MAX_LEN)
    first = r.integers(0, V, (3, 11)).astype(np.int32)
    v0 = np.array([0, 5, 11], np.int32)
    _, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(first), st,
                             valid_len=torch.from_numpy(v0))
    _, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(first), sj, valid_len=jnp.asarray(v0))
    for valid in ([8, 0, 3], [2, 8, 0]):
        toks = r.integers(0, V, (3, 8)).astype(np.int32)
        idle_row = 1 if valid[1] == 0 else 2
        before = TT.extract_slot(st, idle_row, tcfg)
        lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks), st,
                                  valid_len=torch.tensor(valid, dtype=torch.int32))
        lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks), sj,
                                 valid_len=jnp.asarray(valid, jnp.int32))
        live = [b for b in range(3) if valid[b] > 0]
        _close(lt[live], np.asarray(lj)[live], f"logits {valid}")
        _same_state(st, _state(sj, tcfg), f"masked {valid}")
        idle = TT.extract_slot(st, idle_row, tcfg)
        for a, b in zip(idle["layers"], before["layers"]):
            assert all(torch.equal(a[k], b[k]) for k in b)
    inputs = r.integers(0, V, (3, 4)).astype(np.int32)
    valid = np.array([4, 2, 0], np.int32)
    gt, ct, st2 = TT.spec_verify(tp, tcfg, torch.from_numpy(inputs), st, torch.from_numpy(valid))
    gj, cj, sj2 = j_spec_verify(jp, jcfg, jnp.asarray(inputs), sj, jnp.asarray(valid))
    np.testing.assert_array_equal(_np(gt), np.asarray(gj))
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    _same_state(st2, _state(sj2, tcfg), "spec_verify")


# ---------------------------------------------------------------------------
# (4) the engine
# ---------------------------------------------------------------------------


def _prompts(seed, lengths, vocab):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).astype(np.int32) for n in lengths]


# (prompt length, max_new_tokens, arrival tick), as test_torch_hybrid.py's
SERVE_SPEC = [(21, 5, 0), (17, 6, 0), (5, 1, 0), (8, 7, 2), (2, 4, 3), (9, 3, 25)]
STAT_KEYS = ("arrival", "admit", "live", "finish", "n_tokens", "prompt_tokens",
             "prefilled_tokens")


def _requests(kind, prompts, spec):
    return [kind(p, m, id=i) for i, (p, (_, m, _)) in enumerate(zip(prompts, spec))]


def _same_serve(got, want, stats_t=None, stats_j=None):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
    for rid in want if stats_j is not None else ():
        for k in STAT_KEYS:
            assert stats_t[rid][k] == stats_j[rid][k], (rid, k)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_generate_and_continuous_serve_match_jax(layout):
    """Greedy ``generate`` (2 x 11 prompt tokens, 9 new) and continuous
    serve through the coalesced route (masked [slots, 8] admission over the
    whole pool: padding and idle rows take capacity) against the JAX engine
    on the same mix: streams token for token, ticks and counts as JAX's. At
    least one admission dispatch drops choices (a decode tick of 3 tokens
    has capacity 8 and never does), so the equal streams include dropped
    tokens."""
    jcfg, tcfg, jp, tp = _model(layout)
    prompts = np.stack(_prompts(11, [11, 11], tcfg.vocab))
    jeng = JServeEngine(jp, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK)
    want = jeng.generate(prompts, 9)
    got = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu").generate(prompts, 9)
    np.testing.assert_array_equal(got, want)
    prompts = _prompts(12, [s[0] for s in SERVE_SPEC], tcfg.vocab)
    arrivals = [s[2] for s in SERVE_SPEC]
    want, stats_j = jeng.serve(_requests(JRequest, prompts, SERVE_SPEC), slots=SLOTS,
                               arrivals=arrivals, return_stats=True)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu")
    (got, stats_t), dropped = _dropped(lambda: eng.serve(
        _requests(Request, prompts, SERVE_SPEC), slots=SLOTS, arrivals=arrivals,
        return_stats=True))
    _same_serve(got, want, stats_t, stats_j)
    assert dropped > 0


def test_ngram_spec_serve_matches_jax():
    """Speculative serve with the n-gram draft (k = 3) on arctic: the
    port's streams and spec_stats equal the JAX engine's on the same mix."""
    jcfg, tcfg, jp, tp = _model("arctic")
    r = np.random.default_rng(14)
    prompts = [np.tile(r.integers(0, tcfg.vocab, 4).astype(np.int32), 3) if i % 2 else
               r.integers(0, tcfg.vocab, 7).astype(np.int32) for i in range(4)]
    spec = [(len(p), 8 + i, [0, 0, 1, 3][i]) for i, p in enumerate(prompts)]
    arrivals = [s[2] for s in spec]
    kw = dict(max_len=MAX_LEN, prefill_chunk=CHUNK, spec_k=3, spec_draft="ngram")
    jeng = JServeEngine(jp, jcfg, **kw)
    want = jeng.serve(_requests(JRequest, prompts, spec), slots=2, arrivals=arrivals)
    eng = ServeEngine(tp, tcfg, device="cpu", **kw)
    got = eng.serve(_requests(Request, prompts, spec), slots=2, arrivals=arrivals)
    _same_serve(got, want)
    assert eng.spec_stats == jeng.spec_stats
    assert eng.serve_stats["decode_dispatches"] == 0 and eng.serve_stats["verify_dispatches"] > 0
