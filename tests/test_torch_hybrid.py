"""The PyTorch port's rg-LRU block and the hybrid family against the JAX
package on the CPU: the block's forward, its resumable and masked prefill
(fresh, resumed, short chunks, per-row valid lengths), its decode step, the
bf16 split between prefill and step, and the LM built from it: logits, loss
and grads, train steps against ``repro.launch.train.make_step``, chunked
and masked prefill, decode, the ``spec_verify`` rollback, the slot ops, and
``serve`` streams against the unsharded JAX ``ServeEngine`` (greedy in the
coalesced route, sampled with the JAX draws fed in, the n-gram draft, and
the node draft on the hybrid STLT variant).

Four layouts: the JAX package's own ``("rglru", "rglru")`` and
``("rglru", "local_attn")`` configs at ``small_cfg`` sizes (2 layers,
d_model 32, vocab 64; the window 8), and reduced recurrentgemma-9b in both
variants (4 layers ``rglru, rglru, local_attn | stlt, rglru``, d_model 64,
vocab 256, untied head). Both packages get the same weights
(``convert.from_jax_params``) and inputs from numpy seeds, in fp32, unless
a test says bf16. Tolerances: rtol 2e-4 / atol 1e-5 (the JAX package's own
for attention, which the hybrid carries) on logits; each state leaf within
2e-5 of (1 + its largest entry) (fp32 rounding of two scan orders,
log-depth against chunked, read 7e-6 at 4 layers); 2e-5 on the train
metrics (``test_torch_train.py``'s); the block alone 1e-5 / 1e-6; token
streams exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.utils import cast_params_for_compute, tree_flatten_with_paths  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

RTOL, ATOL = 2e-4, 1e-5
STATE_TOL = 2e-5
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-6
MAX_LEN, CHUNK, SLOTS = 48, 8, 3
SMALL = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
             blockwise_threshold=10_000)
LAYOUTS = ("rglru", "rglru_local", "rg_native", "rg_stlt")

j_apply_lm = jax.jit(JT.apply_lm, static_argnums=1)
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)
j_spec_verify = jax.jit(JT.spec_verify, static_argnums=1)
jr_block = jax.jit(JR.apply_rglru_block, static_argnums=1)
jr_prefill = jax.jit(JR.rglru_prefill, static_argnums=1)
jr_step = jax.jit(JR.apply_rglru_step, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def j_loss_and_grads(params, cfg, batch):
    return jax.value_and_grad(
        lambda p: JT.lm_loss(p, cfg, batch, deterministic=True)[0])(params)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _cfgs(layout: str, **extra):
    """(JAX config, port config) of a layout."""
    if layout in ("rglru", "rglru_local"):
        kw = {**SMALL, **(dict(layer_types=("rglru", "rglru")) if layout == "rglru" else
                          dict(layer_types=("rglru", "local_attn"), local_window=8)), **extra}
        return JModelConfig(**kw), TModelConfig(**kw)
    variant = "native" if layout == "rg_native" else "stlt"
    return (j_get_config("recurrentgemma-9b", variant).reduced(**extra),
            t_get_config("recurrentgemma-9b", variant).reduced(**extra))


@functools.lru_cache(maxsize=None)
def _model(layout: str, scan_layers: bool = False):
    jcfg, tcfg = _cfgs(layout, scan_layers=scan_layers)
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


# ---------------------------------------------------------------------------
# (1) the block alone
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _block(d=32, seed=0):
    """The JAX block's params (random biases, so they count) and the port's."""
    cfg = JModelConfig(**{**SMALL, "d_model": d})
    jp = jax.tree_util.tree_map(np.asarray, JR.init_rglru_block(jax.random.key(seed), cfg))
    r = np.random.default_rng(seed + 1)
    jp = {**jp, "b_a": r.normal(size=d).astype(np.float32),
          "b_i": r.normal(size=d).astype(np.float32)}
    return cfg, TModelConfig(**{**SMALL, "d_model": d}), jp, {
        k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _block_state(B, d, seed):
    r = np.random.default_rng(seed)
    return {"h": r.normal(size=(B, d)).astype(np.float32),
            "conv_buf": r.normal(size=(B, TR.CONV_W - 1, d)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


def test_rglru_init_and_block_forward_match_jax():
    """init_rglru_block draws what JAX's draws (shapes, dtypes, zero
    biases, sigmoid(lam)^8 in [0.9, 0.999], conv 0.1-scaled); the block's
    forward over 37 and 150 tokens (one and three of the port's 64-token
    scan chunks) equals JAX's."""
    jcfg, tcfg, jp, tp = _block()
    port = TR.init_rglru_block(torch.Generator().manual_seed(0), tcfg)
    assert sorted(port) == sorted(jp)
    for k, v in port.items():
        assert tuple(v.shape) == jp[k].shape and v.dtype == torch.float32, k
    assert not port["b_a"].any() and not port["b_i"].any()
    a = torch.sigmoid(port["lam"]) ** TR.C_EXP
    assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5
    assert 0.05 < float(port["conv"].std()) < 0.2
    r = np.random.default_rng(2)
    for n in (37, 150):
        x = r.normal(size=(2, n, 32)).astype(np.float32)
        want = jr_block(_j(jp), jcfg, jnp.asarray(x))
        got = TR.apply_rglru_block(tp, tcfg, torch.from_numpy(x))
        _close(got, want, f"block N={n}", BLOCK_RTOL, BLOCK_ATOL)


# (chunk length, resumed?, valid per row or None): fresh, resumed at chunk
# lengths 1 and 2 (shorter than CONV_W - 1: the old buffer keeps its head),
# 3 and 13, and masked with valid 0, 1, 2 and N, fresh and resumed
PREFILL_CASES = {"fresh": (13, False, None), "resumed_1": (1, True, None),
                 "resumed_2": (2, True, None), "resumed_3": (3, True, None),
                 "resumed_13": (13, True, None), "masked_fresh": (9, False, (0, 1, 2, 9)),
                 "masked_resumed": (9, True, (0, 1, 2, 9)),
                 "masked_short": (2, True, (0, 1, 2, 2))}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_rglru_prefill_matches_jax(case):
    """rglru_prefill's outputs and carried state (h, conv_buf) as JAX's; a
    valid == 0 row reads h at position 0 and its own old buffer, as JAX's
    does (the block's per-row select then keeps its state)."""
    n, resumed, valid = PREFILL_CASES[case]
    jcfg, tcfg, jp, tp = _block()
    B = 4
    x = np.random.default_rng(3).normal(size=(B, n, 32)).astype(np.float32)
    st = _block_state(B, 32, 4) if resumed else None
    v = None if valid is None else np.asarray(valid, np.int32)
    yj, sj = jr_prefill(_j(jp), jcfg, jnp.asarray(x), None if st is None else _j(st),
                        valid=None if v is None else jnp.asarray(v))
    yt, stt = TR.rglru_prefill(tp, tcfg, torch.from_numpy(x), None if st is None else _t(st),
                               valid=None if v is None else torch.from_numpy(v))
    rows = slice(None) if v is None else v > 0
    _close(_np(yt)[rows], np.asarray(yj)[rows], "outputs", BLOCK_RTOL, BLOCK_ATOL)
    for k in ("h", "conv_buf"):
        assert stt[k].dtype == torch.float32
        _close(stt[k], sj[k], k, BLOCK_RTOL, BLOCK_ATOL)


def test_rglru_step_matches_jax_and_prefill():
    """Six apply_rglru_step calls from a random state equal JAX's steps and,
    in fp32, the resumed prefill of the same six tokens (outputs and final
    state)."""
    jcfg, tcfg, jp, tp = _block()
    x = np.random.default_rng(5).normal(size=(3, 6, 32)).astype(np.float32)
    st = _block_state(3, 32, 6)
    sj, stt, ys = _j(st), _t(st), []
    for i in range(6):
        yj, sj = jr_step(_j(jp), jcfg, jnp.asarray(x[:, i]), sj)
        yt, stt = TR.apply_rglru_step(tp, tcfg, torch.from_numpy(x[:, i]), stt)
        _close(yt, yj, f"step {i}", BLOCK_RTOL, BLOCK_ATOL)
        ys.append(yt)
    for k in ("h", "conv_buf"):
        _close(stt[k], sj[k], k, BLOCK_RTOL, BLOCK_ATOL)
    yp, sp = TR.rglru_prefill(tp, tcfg, torch.from_numpy(x), _t(st))
    _close(torch.stack(ys, 1), yp, "steps vs prefill", BLOCK_RTOL, BLOCK_ATOL)
    for k in ("h", "conv_buf"):
        _close(stt[k], sp[k], f"steps vs prefill {k}", BLOCK_RTOL, BLOCK_ATOL)


def test_rglru_bf16_prefill_and_step_split_as_jax(monkeypatch):
    """In bf16 (matrices cast, the [4, d] conv left fp32 as
    ``cast_params_for_compute`` leaves it) the prefill's conv output enters
    the gates in fp32 and the step's in bf16, in both packages; each form
    follows JAX's op-by-op bf16 form within bf16 rounding (0.02 of the
    output scale), and the two forms' gap is JAX's own to within 0.02."""
    jcfg, tcfg, jp, tp = _block(d=64, seed=7)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = cast_params_for_compute(tp, torch.bfloat16, min_size=1024)
    jpb = {k: (jnp.asarray(v, jnp.bfloat16) if v.ndim >= 2 and v.size > 1024 else jnp.asarray(v))
           for k, v in jp.items()}
    assert tp["conv"].dtype == torch.float32 and tp["w_a"].dtype == torch.bfloat16
    seen = []
    gates = TR._rglru_gates
    monkeypatch.setattr(TR, "_rglru_gates",
                        lambda p, xc, *rest: (seen.append(xc.dtype), gates(p, xc, *rest))[1])
    x = np.random.default_rng(8).normal(size=(2, 5, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    st = _block_state(2, 64, 9)
    yj_pre, _ = JR.rglru_prefill(jpb, jcfg, jnp.asarray(x, jnp.bfloat16), _j(st))
    yj_step, _ = JR.apply_rglru_step(jpb, jcfg, jnp.asarray(x[:, 0], jnp.bfloat16), _j(st))
    yt_pre, _ = TR.rglru_prefill(tp, tcfg, xb, _t(st))
    yt_step, _ = TR.apply_rglru_step(tp, tcfg, xb[:, 0], _t(st))
    assert seen == [torch.float32, torch.bfloat16]
    assert yt_pre.dtype == yt_step.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(yj_pre, np.float32)).max())
    _close(yt_pre, np.asarray(yj_pre, np.float32), "prefill", 0, 0.02 * scale)
    _close(yt_step, np.asarray(yj_step, np.float32), "step", 0, 0.02 * scale)
    gap_j = np.abs(np.asarray(yj_pre[:, 0], np.float32) - np.asarray(yj_step, np.float32)).max()
    gap_t = float((yt_pre[:, 0].float() - yt_step.float()).abs().max())
    assert gap_j > 0 and abs(gap_t - gap_j) <= 0.02 * scale, (gap_t, gap_j)


# ---------------------------------------------------------------------------
# (2) the LM: forward, loss, grads, train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lm_logits_loss_and_grads_match_jax(layout):
    """apply_lm logits, lm_loss and every grad leaf over 2 x 24 tokens
    (past the reduced window of 8), against ``jax.value_and_grad`` of the
    JAX loss; s_eff is 0 without an STLT block. The STLT variant adds the
    sinusoidal PE at the input, the native form none (its local attention
    carries RoPE)."""
    jcfg, tcfg, jp, tp = _model(layout)
    assert (tcfg.mixer == "stlt") == (layout == "rg_stlt")
    toks = _toks(6, (2, 25), tcfg.vocab)
    lj, aj = j_apply_lm(jp, jcfg, jnp.asarray(toks[:, :-1]))
    lt, at = TT.apply_lm(tp, tcfg, torch.from_numpy(toks[:, :-1]))
    _close(lt, lj, "logits")
    _close(at["s_eff"], aj["s_eff"], "s_eff")
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    loss_j, gj = j_loss_and_grads(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, _, gt = t_train.loss_and_grads(tp, tcfg, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()}, tau=1.0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, gj), tcfg, device="cpu")
    for (path, g), (_, w) in zip(tree_flatten_with_paths(gt), tree_flatten_with_paths(want)):
        scale = float(w.abs().max())
        _close(g, w, f"grad {path}", 1e-3, 1e-3 * scale + 1e-7)


def test_stacked_runs_convert_and_match_jax():
    """With scan_layers=True the JAX package stacks recurrentgemma's runs of
    two rg-LRU blocks (the reduced pattern rglru, rglru, local_attn, rglru
    gives runs of 2, 1, 1): from_jax_params unstacks params and
    from_jax_state decode states into one entry per layer, and the logits
    and monolithic prefill state equal JAX's."""
    jcfg, tcfg, jp, tp = _model("rg_native", scan_layers=True)
    assert TT.execution_plan(tcfg) == (("rglru", 2), ("local_attn", 1), ("rglru", 1))
    assert jp["layers"][0]["rec"]["w_a"].shape == (2, 64, 64)
    assert len(tp["layers"]) == 4 and tuple(tp["layers"][1]["rec"]["w_a"].shape) == (64, 64)
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


@pytest.mark.parametrize("layout,steps", [("rg_stlt", 1), ("rg_stlt", 3), ("rglru_local", 1)])
def test_train_steps_match_jax_make_step(layout, steps):
    """make_step against ``repro.launch.train.make_step`` on 2 x 32 tokens
    (test_torch_train.py's tolerances): loss, ce, grad_norm within 2e-5
    each step, the moments within 1e-4 of each leaf's largest entry, the
    params within 1e-5; with remat on, step 0's grads equal remat off
    exactly."""
    jcfg, tcfg, jp, tp = _model(layout)
    jopt, jstep = _j_make_step(layout)
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        b = j_synthetic.lm_batch_stream(0, step, 2, 32, tcfg.vocab)
        jp, js, mj = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()}, step)
        tp, ts, mt = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in b.items()}, step)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=METRIC_RTOL,
                                       err_msg=f"step {step} {k}")

    def conv(t):
        return convert.from_jax_params(jax.tree_util.tree_map(np.asarray, t), tcfg, device="cpu")
    for name in ("mu", "nu"):
        for (path, g), (_, w) in zip(tree_flatten_with_paths(ts[name]),
                                     tree_flatten_with_paths(conv(js[name]))):
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-30, (name, path)
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp), tree_flatten_with_paths(conv(jp))):
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
# (3) prefill, decode, rollback, slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunked_prefill_matches_monolithic_and_jax(layout):
    """A 21-token prompt folded in chunks of 2, 1, 8 and 10 (two shorter
    than the conv window) equals the monolithic prefill (last logits, then
    4 decode steps against the teacher-forced apply_lm), and the JAX
    package's chunked fold, state leaf for leaf."""
    jcfg, tcfg, jp, tp = _model(layout)
    toks = _toks(8, (2, 25), tcfg.vocab)
    lm, sm = TT.prefill(tp, tcfg, torch.from_numpy(toks[:, :21]), MAX_LEN)
    st = TT.init_decode_state(tcfg, 2, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 2, MAX_LEN)
    for a, b in ((0, 2), (2, 3), (3, 11), (11, 21)):
        lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, a:b]), st)
        lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, a:b]), sj)
    _close(lt, lm, "chunked vs monolithic")
    _close(lt, lj, "chunked vs JAX")
    _same_state(st, _state(sj, tcfg), "chunked")
    teacher, _ = TT.apply_lm(tp, tcfg, torch.from_numpy(toks))
    for i in range(21, 25):
        tok = torch.from_numpy(toks[:, i])
        la, sm = TT.decode_step(tp, tcfg, tok, sm)
        lb, sj = j_decode_step(jp, jcfg, jnp.asarray(toks[:, i]), sj)
        _close(la, lb, f"step {i} vs JAX")
        _close(la, teacher[:, i], f"step {i} vs teacher-forced")
    _same_state(sm, _state(sj, tcfg), "after decode")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_admission_and_rollback_match_jax(layout):
    """Rows at different depths (pos 0, 5 and 11) in [3, 8] masked
    dispatches with valid (8, 0, 3) then (2, 8, 0): logits at each row's
    last valid token and states as JAX's, a valid == 0 row's state kept bit
    for bit; then spec_verify's scoring and rollback (masked prefill with
    valid = commit) on the result."""
    jcfg, tcfg, jp, tp = _model(layout)
    r = np.random.default_rng(9)
    V = tcfg.vocab
    st = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    first = torch.from_numpy(r.integers(0, V, (3, 11)).astype(np.int32))
    _, st = TT.prefill_chunk(tp, tcfg, first, st,
                             valid_len=torch.tensor([0, 5, 11], dtype=torch.int32))
    sj = jax.tree_util.tree_map(jnp.asarray, {"layers": [
        {k: np.asarray(t) for k, t in layer.items()} for layer in st["layers"]],
        "pos": np.asarray(st["pos"])})
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
    kept, before = TT.extract_slot(st2, 2, tcfg), TT.extract_slot(st, 2, tcfg)
    for a, b in zip(kept["layers"], before["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_slot_ops_carry_the_rglru_leaves():
    """insert_slot / extract_slot / reset_slot on a hybrid pool: the rg-LRU
    leaves h [B, d] and conv_buf [B, 3, d] and the ring's k, v, pos of a
    batch-1 state go into one row, neighbours untouched, extract copies,
    reset restores; the round trip equals JAX's insert + extract."""
    jcfg, tcfg, jp, tp = _model("rglru_local")
    toks = _toks(10, (1, 9), tcfg.vocab)
    _, st = TT.prefill(tp, tcfg, torch.from_numpy(toks), MAX_LEN)
    _, sj = j_prefill(jp, jcfg, jnp.asarray(toks), MAX_LEN)
    pool = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    assert sorted(pool["layers"][0]) == ["conv_buf", "h"]
    assert tuple(pool["layers"][0]["conv_buf"].shape) == (3, 3, 32)
    TT.insert_slot(pool, st, 1, tcfg)
    got = TT.extract_slot(pool, 1, tcfg)
    _same_state(got, st, "round trip", 0)
    want = JT.extract_slot(JT.insert_slot(JT.init_decode_state(jcfg, 3, MAX_LEN), sj, 1, jcfg),
                           1, jcfg)
    _same_state(got, _state(want, tcfg), "vs JAX")
    for nb in (0, 2):
        for layer in TT.extract_slot(pool, nb, tcfg)["layers"]:
            assert all(float(t.abs().sum()) == 0 for t in layer.values())
    TT.reset_slot(pool, 1, tcfg, MAX_LEN)
    _same_state(got, st, "extract is a copy", 0)
    assert all(float(layer[k].abs().sum()) == 0 for layer in pool["layers"] for k in layer)


# ---------------------------------------------------------------------------
# (4) the engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jeng(layout: str, **kw):
    jcfg, _, jp, _ = _model(layout)
    return JServeEngine(jp, jcfg, max_len=MAX_LEN, **kw)


def _prompts(seed, lengths, vocab):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).astype(np.int32) for n in lengths]


# (prompt length, max_new_tokens, arrival tick): 21 and 17 take three and
# two chunks with tails, 8 exactly one, 5 one tail, 2 shorter than the conv
# window; three co-pend at tick 0; id 2 is prefill-only; id 5 arrives after
# an idle gap
SERVE_SPEC = [(21, 5, 0), (17, 6, 0), (5, 1, 0), (8, 7, 2), (2, 4, 3), (9, 3, 25)]
STAT_KEYS = ("arrival", "admit", "live", "finish", "n_tokens", "prompt_tokens",
             "prefilled_tokens")


def _requests(kind, prompts, spec, **extra):
    return [kind(p, m, id=i, **extra) for i, (p, (_, m, _)) in enumerate(zip(prompts, spec))]


def _same_serve(got, want, stats_t=None, stats_j=None):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
    for rid in want if stats_j is not None else ():
        for k in STAT_KEYS:
            assert stats_t[rid][k] == stats_j[rid][k], (rid, k)


@pytest.mark.parametrize("layout", ["rglru_local", "rg_native", "rg_stlt"])
def test_generate_and_continuous_serve_match_jax(layout):
    """Greedy ``generate`` (2 x 11 prompt tokens, 9 new) and continuous
    serve through the coalesced route (masked [slots, 8] admission over the
    whole pool, so the idle rows' rg-LRU states ride along as exact
    no-ops): streams token for token, ticks and counts as the JAX
    engine's."""
    _, tcfg, _, tp = _model(layout)
    prompts = np.stack(_prompts(11, [11, 11], tcfg.vocab))
    want = _jeng(layout).generate(prompts, 9)
    got = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu").generate(prompts, 9)
    np.testing.assert_array_equal(got, want)
    prompts = _prompts(12, [s[0] for s in SERVE_SPEC], tcfg.vocab)
    arrivals = [s[2] for s in SERVE_SPEC]
    want, stats_j = _jeng(layout).serve(_requests(JRequest, prompts, SERVE_SPEC), slots=SLOTS,
                                        arrivals=arrivals, return_stats=True,
                                        prefill_chunk=CHUNK)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, SERVE_SPEC), slots=SLOTS,
                             arrivals=arrivals, return_stats=True)
    _same_serve(got, want, stats_t, stats_j)


class JaxDraws:
    """The JAX engine's per-request Gumbel draws (``test_torch_serve.py``'s,
    at this model's vocab): token 0 from ``split(fold_in(key(seed), id))[1]``,
    token t >= 1 from the t-th split of the carried half."""

    def __init__(self, seed: int, vocab: int):
        self.base, self.vocab, self.keys = jax.random.key(seed), vocab, {}

    def __call__(self, rid, step):
        if rid not in self.keys:
            carry, k0 = jax.random.split(jax.random.fold_in(self.base, rid))
            self.keys[rid] = ([k0], carry)
        subs, carry = self.keys[rid]
        while len(subs) <= step:
            carry, sub = jax.random.split(carry)
            subs.append(sub)
        self.keys[rid] = (subs, carry)
        return np.array(jax.random.gumbel(subs[step], (self.vocab,), jnp.float32))


def test_sampled_serve_matches_jax_with_its_draws():
    """Per-request temperatures (one greedy row) on the native hybrid with
    the JAX Gumbel draws fed in: streams token for token."""
    _, tcfg, _, tp = _model("rg_native")
    spec = SERVE_SPEC[:5]
    temps = [0.8, None, 1.0, 1.3, 0.9]
    prompts = _prompts(13, [s[0] for s in spec], tcfg.vocab)
    kw = dict(slots=SLOTS, arrivals=[s[2] for s in spec], rng_seed=7)

    def reqs(kind):
        return [dataclasses.replace(r, temperature=t)
                for r, t in zip(_requests(kind, prompts, spec), temps)]

    want = _jeng("rg_native").serve(reqs(JRequest), prefill_chunk=CHUNK, **kw)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu",
                      noise=lambda seed: JaxDraws(seed, tcfg.vocab))
    got = eng.serve(reqs(Request), **kw)
    _same_serve(got, want)
    greedy = _jeng("rg_native").serve(_requests(JRequest, prompts, spec), prefill_chunk=CHUNK,
                                      **kw)
    assert any(not np.array_equal(got[r], greedy[r]) for r in got)


@pytest.mark.parametrize("layout,draft", [("rg_native", "ngram"), ("rg_stlt", "ngram"),
                                          ("rg_stlt", "nodes")])
def test_spec_serve_matches_jax(layout, draft):
    """Speculative serve (k = 3): the port's streams equal the JAX engine's
    spec streams and the plain greedy ones, with the same spec_stats; the
    node draft on the hybrid STLT variant masks only its STLT layer's
    readout (the rg-LRU and FFN weights are the target's own tensors)."""
    jcfg, tcfg, jp, tp = _model(layout)
    r = np.random.default_rng(14)
    prompts = [np.tile(r.integers(0, tcfg.vocab, 4).astype(np.int32), 3) if i % 2 else
               r.integers(0, tcfg.vocab, 7).astype(np.int32) for i in range(4)]
    spec = [(len(p), 8 + i, [0, 0, 1, 3][i]) for i, p in enumerate(prompts)]
    arrivals = [s[2] for s in spec]
    kw = dict(max_len=MAX_LEN, prefill_chunk=CHUNK, spec_k=3, spec_draft=draft,
              spec_draft_nodes=2)
    jeng = JServeEngine(jp, jcfg, **kw)
    want = jeng.serve(_requests(JRequest, prompts, spec), slots=2, arrivals=arrivals)
    eng = ServeEngine(tp, tcfg, device="cpu", **kw)
    got = eng.serve(_requests(Request, prompts, spec), slots=2, arrivals=arrivals)
    _same_serve(got, want)
    plain = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu").serve(
        _requests(Request, prompts, spec), slots=2, arrivals=arrivals)
    _same_serve(got, plain)
    assert eng.spec_stats == jeng.spec_stats
    assert eng.serve_stats["decode_dispatches"] == 0 and eng.serve_stats["verify_dispatches"] > 0
    if draft == "nodes":
        from repro_torch.serving.speculative import draft_params
        dp = draft_params(tp, tcfg, 2)
        for bt, a, b in zip(tcfg.block_types(), dp["layers"], tp["layers"]):
            if bt == "stlt":
                assert int((a["stlt"]["nodes"]["u_re"] != 0).sum(-1).max()) == 2
            else:
                assert all(x is y for (_, x), (_, y) in zip(tree_flatten_with_paths(a),
                                                            tree_flatten_with_paths(b)))
