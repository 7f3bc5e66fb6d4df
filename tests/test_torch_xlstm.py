"""The PyTorch port's xLSTM cells and the xlstm family against the JAX
package on the CPU: ``mlstm_chunked`` (a window shorter than its chunk, a
length that is no multiple of it, resumed from a carried state), each
mLSTM and sLSTM function (init, forward, the resumable and masked prefill
with valid == 0 rows and chunks shorter than the conv window, the decode
step), the bf16 split between prefill and step, and reduced xlstm-350m
(4 layers ``mlstm, slstm, mlstm, slstm``, d_model 64, vocab 256, tied):
logits, loss and grads, the stacked runs of the JAX layout, train steps
against ``repro.launch.train.make_step`` (AdamW), the sinusoidal PE that the
family adds under ``mixer="attention"``, chunked and masked prefill,
decode, the ``spec_verify`` rollback, the slot ops on every state leaf, and
greedy ``generate``, continuous ``serve`` and n-gram spec streams against
the unsharded JAX ``ServeEngine``.

Both packages get the same weights (``convert.from_jax_params``) and inputs
from numpy seeds, in fp32 unless a test says bf16. Tolerances: the cells
alone 1e-5 relative / 1e-6 absolute (fp32 summation order; ``mlstm_chunked``
on raw random gates 1e-5 of 1 + its largest output); logits rtol
2e-4 / atol 1e-5 (the other LM tests'); each state leaf within 2e-5 of
(1 + its largest entry); the loss 2e-5 relative, grads 1e-3 of each leaf's
largest entry; token streams exactly.
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
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.utils import cast_params_for_compute, tree_flatten_with_paths  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

RTOL, ATOL = 2e-4, 1e-5
STATE_TOL = 2e-5
CELL_RTOL, CELL_ATOL = 1e-5, 1e-6
# mlstm_chunked on raw random gates: the normalizer's division amplifies
# fp32 rounding (read 2e-6 at an entry of 0.04): absolute, of 1 + max |h|
CHUNKED_TOL = 1e-5
MAX_LEN, CHUNK, SLOTS = 48, 8, 3
ARCH = "xlstm-350m"

j_apply_lm = jax.jit(JT.apply_lm, static_argnums=1)
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)
j_spec_verify = jax.jit(JT.spec_verify, static_argnums=1)
# the cells, jitted (a first eager call of a scan-bearing cell takes ~2 s)
JXJ = {name: jax.jit(getattr(JX, name), static_argnums=1) for name in (
    "init_mlstm", "init_slstm", "mlstm_prefill", "slstm_prefill", "apply_mlstm_step",
    "apply_slstm_step")}


@functools.partial(jax.jit, static_argnums=1)
def j_loss_and_grads(params, cfg, batch):
    return jax.value_and_grad(
        lambda p: JT.lm_loss(p, cfg, batch, deterministic=True)[0])(params)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _cfgs(**kw):
    return j_get_config(ARCH).reduced(**kw), t_get_config(ARCH).reduced(**kw)


@functools.lru_cache(maxsize=None)
def _model(**kw):
    jcfg, tcfg = _cfgs(**kw)
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
# (1) the cells alone
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cell(kind: str, seed=0):
    """The JAX cell's params (random gate biases, so they count) and the
    port's, at the reduced widths (d_model 64, 4 heads)."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray, JXJ[f"init_{kind}"](jax.random.key(seed), jcfg))
    r = np.random.default_rng(seed + 1)
    if kind == "mlstm":
        jp = {**jp, "b_i": r.normal(size=jp["b_i"].shape).astype(np.float32)}
    else:
        jp = {**jp, "b": (jp["b"] + r.normal(size=jp["b"].shape)).astype(np.float32)}
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, jp), tp


def _cell_state(kind, B, seed, tcfg):
    """A random carried state of the cell (m finite, as after real tokens)."""
    r = np.random.default_rng(seed)
    init = TX.init_mlstm_state if kind == "mlstm" else TX.init_slstm_state
    st = {k: r.normal(size=v.shape).astype(np.float32)
          for k, v in init(tcfg, B).items()}
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5
    return st


def test_cell_inits_match_jax():
    """init_mlstm and init_slstm draw what JAX's draw: the same keys,
    shapes and dtypes, the forget-open gate biases (3), zero input biases,
    conv and R 0.1-scaled; the states' inits (m = -1e30)."""
    jcfg, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    for kind, init in (("mlstm", TX.init_mlstm), ("slstm", TX.init_slstm)):
        port = init(g, tcfg)
        want = jax.tree_util.tree_map(np.asarray, JXJ[f"init_{kind}"](jax.random.key(0), jcfg))
        assert sorted(p for p, _ in tree_flatten_with_paths(port)) == sorted(
            p for p, _ in tree_flatten_with_paths(want))
        for path, a in tree_flatten_with_paths(port):
            w = np.asarray(functools.reduce(lambda t, k: t[k], path.split("/"), want))
            assert tuple(a.shape) == w.shape and a.dtype == torch.float32, (kind, path)
    m = TX.init_mlstm(g, tcfg)
    assert torch.equal(m["b_f"], torch.full((4,), 3.0)) and not m["b_i"].any()
    assert 0.05 < float(m["conv"].std()) < 0.2
    s = TX.init_slstm(g, tcfg)
    assert torch.equal(s["b"][128:192], torch.full((64,), 3.0)) and not s["b"][:128].any()
    assert 0.05 < float(s["r"].std()) < 0.2
    for kind, init, jinit in (("mlstm", TX.init_mlstm_state, JX.init_mlstm_state),
                              ("slstm", TX.init_slstm_state, JX.init_slstm_state)):
        got, want = init(tcfg, 3), jinit(jcfg, 3)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)


# (N, chunk, resumed?): a window shorter than the 8-token chunk apply_mlstm
# picks for it, 37 tokens in chunks of 16 (a padded tail), 64 in one chunk,
# and each resumed from a carried (C, n, m)
CHUNKED_CASES = {"short": (5, 8, False), "tail": (37, 16, False), "whole": (64, 64, False),
                 "short_resumed": (5, 8, True), "tail_resumed": (37, 16, True)}


@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_mlstm_chunked_matches_jax(case):
    """mlstm_chunked's outputs and final (C, n, m) equal JAX's on random
    q, k, v and gates; padding is state-transparent."""
    N, chunk, resumed = CHUNKED_CASES[case]
    r = np.random.default_rng(20 + N)
    B, H, dh = 2, 4, 8
    q, k, v = (r.normal(size=(B, N, H, dh)).astype(np.float32) for _ in range(3))
    li = r.normal(size=(B, N, H)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(r.normal(size=(B, N, H)) + 2)))).astype(np.float32)
    init = None
    if resumed:
        init = (r.normal(size=(B, H, dh, dh)).astype(np.float32),
                r.normal(size=(B, H, dh)).astype(np.float32),
                r.normal(size=(B, H)).astype(np.float32))
    hj, sj = JX.mlstm_chunked(*(jnp.asarray(t) for t in (q, k, v, li, lf)), chunk=chunk,
                              return_state=True,
                              init_state=None if init is None else tuple(map(jnp.asarray, init)))
    ht, st = TX.mlstm_chunked(*(torch.from_numpy(t) for t in (q, k, v, li, lf)), chunk=chunk,
                              return_state=True,
                              init_state=None if init is None else tuple(map(torch.from_numpy,
                                                                             init)))
    for name, a, b in zip(("h", "C", "n", "m"), (ht, *st), (hj, *sj)):
        _close(a, b, name, 0, CHUNKED_TOL * (1 + float(np.abs(np.asarray(b)).max())))


# (chunk length, resumed?, valid per row or None): fresh, resumed at chunk
# lengths 1 and 2 (shorter than CONV_W - 1: the old buffer keeps its head),
# 3 and 13, and masked with valid 0, 1, 2 and N, fresh and resumed
PREFILL_CASES = {"fresh": (13, False, None), "resumed_1": (1, True, None),
                 "resumed_2": (2, True, None), "resumed_3": (3, True, None),
                 "resumed_13": (13, True, None), "masked_fresh": (9, False, (0, 1, 2, 9)),
                 "masked_resumed": (9, True, (0, 1, 2, 9)),
                 "masked_short": (2, True, (0, 1, 2, 2))}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_cell_prefill_matches_jax(kind, case):
    """mlstm_prefill / slstm_prefill outputs and carried state as JAX's, on
    the rows with valid > 0 (a valid == 0 row's state is the block's
    per-row select's to keep) and, fresh and unmasked, the cell's
    whole-sequence forward."""
    n, resumed, valid = PREFILL_CASES[case]
    jcfg, tcfg, jp, tp = _cell(kind)
    B = 4
    x = np.random.default_rng(3).normal(size=(B, n, 64)).astype(np.float32)
    st = _cell_state(kind, B, 4, tcfg) if resumed else None
    v = None if valid is None else np.asarray(valid, np.int32)
    jfn = JXJ[f"{kind}_prefill"]
    tfn = TX.mlstm_prefill if kind == "mlstm" else TX.slstm_prefill
    yj, sj = jfn(jp, jcfg, jnp.asarray(x), None if st is None else _j(st),
                 valid=None if v is None else jnp.asarray(v))
    yt, stt = tfn(tp, tcfg, torch.from_numpy(x), None if st is None else _t(st),
                  valid=None if v is None else torch.from_numpy(v))
    rows = slice(None) if v is None else v > 0
    _close(_np(yt)[rows], np.asarray(yj)[rows], "outputs", CELL_RTOL, CELL_ATOL)
    assert sorted(stt) == sorted(sj)
    for k in sj:
        assert stt[k].dtype == torch.float32
        scale = 1 + float(np.abs(np.asarray(sj[k])[rows]).max())
        _close(_np(stt[k])[rows], np.asarray(sj[k])[rows], k, CELL_RTOL, CELL_ATOL * scale)
    if case == "fresh":
        fwd = TX.apply_mlstm if kind == "mlstm" else TX.apply_slstm
        _close(fwd(tp, tcfg, torch.from_numpy(x)), yj, "forward", CELL_RTOL, CELL_ATOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_step_matches_jax_and_prefill(kind):
    """Six decode steps from a random state equal JAX's steps and, in fp32,
    the resumed prefill of the same six tokens (outputs and final state)."""
    jcfg, tcfg, jp, tp = _cell(kind)
    x = np.random.default_rng(5).normal(size=(3, 6, 64)).astype(np.float32)
    st = _cell_state(kind, 3, 6, tcfg)
    jstep = JXJ[f"apply_{kind}_step"]
    tstep = TX.apply_mlstm_step if kind == "mlstm" else TX.apply_slstm_step
    sj, stt, ys = _j(st), _t(st), []
    for i in range(6):
        yj, sj = jstep(jp, jcfg, jnp.asarray(x[:, i]), sj)
        yt, stt = tstep(tp, tcfg, torch.from_numpy(x[:, i]), stt)
        _close(yt, yj, f"step {i}", CELL_RTOL, CELL_ATOL)
        ys.append(yt)
    for k in sj:
        _close(stt[k], sj[k], k, CELL_RTOL, CELL_ATOL * (1 + float(np.abs(sj[k]).max())))
    pre = TX.mlstm_prefill if kind == "mlstm" else TX.slstm_prefill
    yp, sp = pre(tp, tcfg, torch.from_numpy(x), _t(st))
    _close(torch.stack(ys, 1), yp, "steps vs prefill", 1e-4, 1e-5)
    for k in sp:
        _close(stt[k], sp[k], f"steps vs prefill {k}", 1e-4,
               1e-5 * (1 + float(sp[k].abs().max())))


def test_xlstm_bf16_prefill_and_step_split_as_jax(monkeypatch):
    """In bf16 (matrices of more than 1,024 elements cast, as the serve
    CLI's 65,536 cast does at full width: the mLSTM's conv taps [4, 2d] and
    gate projections w_i, w_f [2d, H] stay fp32, the sLSTM's R is cast),
    the mLSTM prefill's conv output enters wq, wk, w_i and w_f in fp32 and
    the step's in bf16, in both packages; the sLSTM step promotes R to
    fp32. Each form follows JAX's op-by-op bf16 form within bf16 rounding
    (0.02 of the output scale)."""
    seen, names = [], {}
    mm = TX.matmul

    def spy(a, w):
        seen.append((names.get(id(w)), a.dtype))
        return mm(a, w)
    monkeypatch.setattr(TX, "matmul", spy)
    for kind in ("mlstm", "slstm"):
        jcfg, tcfg, jp, tp = _cell(kind, seed=7)
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
        tpb = cast_params_for_compute(tp, torch.bfloat16, min_size=1024)
        names.update({id(v): k for k, v in tpb.items() if isinstance(v, torch.Tensor)})
        jpb = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.bfloat16) if v.ndim >= 2 and v.size > 1024 else v, jp)
        if kind == "mlstm":
            assert tpb["conv"].dtype == tpb["w_i"].dtype == tpb["w_f"].dtype == torch.float32
            assert tpb["wq"].dtype == tpb["w_up"].dtype == torch.bfloat16
        else:
            assert tpb["r"].dtype == tpb["w_in"].dtype == torch.bfloat16
        x = np.random.default_rng(8).normal(size=(2, 5, 64)).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        st = _cell_state(kind, 2, 9, tcfg)
        # JAX's op-by-op bf16 forms (jitted XLA would keep fused bf16 chains
        # in fp32)
        jpre = JX.mlstm_prefill if kind == "mlstm" else JX.slstm_prefill
        jstep = JX.apply_mlstm_step if kind == "mlstm" else JX.apply_slstm_step
        tpre = TX.mlstm_prefill if kind == "mlstm" else TX.slstm_prefill
        tstep = TX.apply_mlstm_step if kind == "mlstm" else TX.apply_slstm_step
        yj_pre, _ = jpre(jpb, jcfg, jnp.asarray(x, jnp.bfloat16), _j(st))
        yj_step, sj = jstep(jpb, jcfg, jnp.asarray(x[:, 0], jnp.bfloat16), _j(st))
        seen.clear()
        yt_pre, _ = tpre(tpb, tcfg, xb, _t(st))
        pre_seen = list(seen)
        seen.clear()
        yt_step, stt = tstep(tpb, tcfg, xb[:, 0], _t(st))
        if kind == "mlstm":
            for name in ("wq", "wk", "w_i", "w_f"):    # the products of the conv output
                assert {dt for n, dt in pre_seen if n == name} == {torch.float32}, name
                assert {dt for n, dt in seen if n == name} == {torch.bfloat16}, name
        assert all(v.dtype == torch.float32 for v in stt.values())
        assert all(np.asarray(v).dtype == np.float32 for v in sj.values())
        assert yt_pre.dtype == yt_step.dtype == torch.bfloat16
        scale = float(np.abs(np.asarray(yj_pre, np.float32)).max())
        _close(yt_pre, np.asarray(yj_pre, np.float32), f"{kind} prefill", 0, 0.02 * scale)
        _close(yt_step, np.asarray(yj_step, np.float32), f"{kind} step", 0, 0.02 * scale)


# ---------------------------------------------------------------------------
# (2) the LM: forward, loss, grads, layouts, train steps
# ---------------------------------------------------------------------------


def test_lm_logits_loss_and_grads_match_jax():
    """apply_lm logits, lm_loss and every grad leaf of reduced xlstm-350m
    over 2 x 40 tokens (an mLSTM chunk of 40), against
    ``jax.value_and_grad`` of the JAX loss. An xLSTM block has no norm2 or
    FFN; the aux terms are all 0."""
    jcfg, tcfg, jp, tp = _model()
    assert tcfg.block_types() == ("mlstm", "slstm", "mlstm", "slstm")
    assert all(sorted(layer) == ["cell", "norm1"] for layer in tp["layers"])
    toks = _toks(6, (2, 41), tcfg.vocab)
    lj, aj = j_apply_lm(jp, jcfg, jnp.asarray(toks[:, :-1]))
    lt, at = TT.apply_lm(tp, tcfg, torch.from_numpy(toks[:, :-1]))
    _close(lt, lj, "logits")
    assert all(float(v) == 0 for v in at.values())
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    loss_j, gj = j_loss_and_grads(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, _, gt = t_train.loss_and_grads(tp, tcfg, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()}, tau=1.0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, gj), tcfg, device="cpu")
    for (path, g), (_, w) in zip(tree_flatten_with_paths(gt), tree_flatten_with_paths(want)):
        _close(g, w, f"grad {path}", 1e-3, 1e-3 * float(w.abs().max()) + 1e-7)


def test_stacked_runs_convert_and_match_jax():
    """xlstm-350m's plan under scan_layers=True is three stacked runs of 7
    mLSTM, each followed by one sLSTM, in both packages; at reduced widths
    with 8 layers (one period, slstm_every=8) from_jax_params unstacks the
    run of 7 and from_jax_state its states, and logits and the monolithic
    prefill's state equal JAX's."""
    want = (("mlstm", 7), ("slstm", 1)) * 3
    assert TT.execution_plan(t_get_config(ARCH)) == JT.execution_plan(j_get_config(ARCH)) == want
    jcfg, tcfg, jp, tp = _model(num_layers=8, slstm_every=8, scan_layers=True)
    assert TT.execution_plan(tcfg) == (("mlstm", 7), ("slstm", 1))
    assert jp["layers"][0]["cell"]["wq"].shape == (7, 128, 128)
    assert len(tp["layers"]) == 8 and tuple(tp["layers"][6]["cell"]["wq"].shape) == (128, 128)
    toks = _toks(7, (2, 20), tcfg.vocab)
    lj, _ = j_apply_lm(jp, jcfg, jnp.asarray(toks))
    lt, _ = TT.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(lt, lj, "logits")
    lj, sj = j_prefill(jp, jcfg, jnp.asarray(toks), MAX_LEN)
    lt, st = TT.prefill(tp, tcfg, torch.from_numpy(toks), MAX_LEN)
    _close(lt, lj, "prefill logits")
    _same_state(st, _state(sj, tcfg), "prefill")


def test_sinusoidal_pe_under_attention_mixer_as_jax():
    """xlstm-350m keeps the default ``mixer="attention"``, yet the JAX
    package adds the sinusoidal PE for ``family == "xlstm"``: the port's
    ``prefill_chunk`` and ``decode_step`` at positions 7 and 11 (per-row
    offsets) and 12 match JAX's, and differ from the same model without
    the PE."""
    jcfg, tcfg, jp, tp = _model()
    assert tcfg.mixer == "attention" and TT._has_pe(tcfg)
    toks = _toks(17, (2, 13), tcfg.vocab)
    st = TT.init_decode_state(tcfg, 2, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 2, MAX_LEN)
    lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, :7]), st)
    lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, :7]), sj)
    v = torch.tensor([4, 5], dtype=torch.int32)
    lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, 7:12]), st, valid_len=v)
    lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, 7:12]), sj,
                             valid_len=jnp.asarray(v.numpy()))
    _close(lt, lj, "prefill_chunk at pos 7")
    np.testing.assert_array_equal(_np(st["pos"]), [11, 12])
    lt, st2 = TT.decode_step(tp, tcfg, torch.from_numpy(toks[:, 12]), st)
    lj, sj = j_decode_step(jp, jcfg, jnp.asarray(toks[:, 12]), sj)
    _close(lt, lj, "decode_step at pos 11 and 12")
    _same_state(st2, _state(sj, tcfg), "after decode")
    no_pe = dataclasses.replace(tcfg, family="lm", layer_types=tcfg.block_types())
    assert not TT._has_pe(no_pe)
    lb, _ = TT.decode_step(tp, no_pe, torch.from_numpy(toks[:, 12]), st)
    assert float((lb - lt).abs().max()) > 1e-3


TCFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRIC_RTOL = 2e-5    # test_torch_train.py's, fp32 through the blocks


@functools.lru_cache(maxsize=None)
def _j_make_step():
    return j_train.make_step(_model()[0], JTrainConfig(**TCFG))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_make_step(steps):
    """make_step (AdamW, the config's optimizer) against
    ``repro.launch.train.make_step`` on 2 x 32 tokens: loss, ce, grad_norm
    within 2e-5 each step, the moments within 1e-4 of each leaf's largest
    entry, the params within 1e-5 but for the sLSTM's input-gate bias
    ``b[d:2d]``, held to 2 lr per moving step: h = o c / n is a ratio of two
    sums with the same input-gate weights, so a constant shift of every
    step's log input gate cancels, its grad is rounding noise (~1e-11 here),
    and Adam moves it by lr times that noise's sign, in either package (as
    attention's key bias, ``test_torch_attention.py``); with remat on, step
    0's grads equal remat off exactly."""
    jcfg, tcfg, jp, tp = _model()
    assert tcfg.optimizer == "adamw"
    jopt, jstep = _j_make_step()
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
    d = tcfg.d_model
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp), tree_flatten_with_paths(conv(jp))):
        err = (p - w).abs()
        if path.endswith("cell/b"):      # an sLSTM's [z | i | f | o] biases
            assert float(err[d:2 * d].max()) <= 2 * TCFG["learning_rate"] * (steps - 1) + 1e-6
            err = torch.cat([err[:d], err[2 * d:]])
        assert float(err.max()) <= 1e-5, path
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


def test_chunked_prefill_matches_monolithic_and_jax():
    """A 21-token prompt folded in chunks of 2, 1, 8 and 10 (two shorter
    than the conv window) equals the monolithic prefill (last logits, then
    4 decode steps against the teacher-forced apply_lm), and the JAX
    package's chunked fold, state leaf for leaf."""
    jcfg, tcfg, jp, tp = _model()
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


def test_masked_admission_and_rollback_match_jax():
    """Rows at different depths (pos 0, 5 and 11) in [3, 8] masked
    dispatches with valid (8, 0, 3) then (2, 8, 0): logits at each row's
    last valid token and states as JAX's, a valid == 0 row's state kept bit
    for bit (a fresh row's m = -1e30 included); then spec_verify's scoring
    and rollback (masked prefill with valid = commit) on the result."""
    jcfg, tcfg, jp, tp = _model()
    r = np.random.default_rng(9)
    V = tcfg.vocab
    st = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    first = torch.from_numpy(r.integers(0, V, (3, 11)).astype(np.int32))
    _, st = TT.prefill_chunk(tp, tcfg, first, st,
                             valid_len=torch.tensor([0, 5, 11], dtype=torch.int32))
    assert torch.equal(st["layers"][0]["m"][0], torch.full((4,), -1e30))
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


def test_slot_ops_carry_the_xlstm_leaves():
    """insert_slot / extract_slot / reset_slot on an xLSTM pool: the mLSTM
    leaves C [B, H, dh, dh], n, m, conv_buf [B, 3, 2d] and the sLSTM's h,
    c, n, m of a batch-1 state go into one row, neighbours untouched,
    extract copies, reset restores the init (m = -1e30); the round trip
    equals JAX's insert + extract."""
    jcfg, tcfg, jp, tp = _model()
    toks = _toks(10, (1, 9), tcfg.vocab)
    _, st = TT.prefill(tp, tcfg, torch.from_numpy(toks), MAX_LEN)
    _, sj = j_prefill(jp, jcfg, jnp.asarray(toks), MAX_LEN)
    pool = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    assert sorted(pool["layers"][0]) == ["C", "conv_buf", "m", "n"]
    assert sorted(pool["layers"][1]) == ["c", "h", "m", "n"]
    assert tuple(pool["layers"][0]["C"].shape) == (3, 4, 32, 32)
    assert tuple(pool["layers"][0]["conv_buf"].shape) == (3, 3, 128)
    fresh = TT.extract_slot(pool, 0, tcfg)
    TT.insert_slot(pool, st, 1, tcfg)
    got = TT.extract_slot(pool, 1, tcfg)
    _same_state(got, st, "round trip", 0)
    want = JT.extract_slot(JT.insert_slot(JT.init_decode_state(jcfg, 3, MAX_LEN), sj, 1, jcfg),
                           1, jcfg)
    _same_state(got, _state(want, tcfg), "vs JAX")
    for nb in (0, 2):
        _same_state(TT.extract_slot(pool, nb, tcfg), fresh, f"neighbour {nb}", 0)
    TT.reset_slot(pool, 1, tcfg, MAX_LEN)
    _same_state(got, st, "extract is a copy", 0)
    _same_state(TT.extract_slot(pool, 1, tcfg), fresh, "reset", 0)


# ---------------------------------------------------------------------------
# (4) the engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jeng(**kw):
    jcfg, _, jp, _ = _model()
    return JServeEngine(jp, jcfg, max_len=MAX_LEN, **kw)


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


def test_generate_and_continuous_serve_match_jax():
    """Greedy ``generate`` (2 x 11 prompt tokens, 9 new) and continuous
    serve through the coalesced route (masked [slots, 8] admission over the
    whole pool, the idle rows' xLSTM states exact no-ops): streams token
    for token, ticks and counts as the JAX engine's."""
    _, tcfg, _, tp = _model()
    prompts = np.stack(_prompts(11, [11, 11], tcfg.vocab))
    want = _jeng().generate(prompts, 9)
    got = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu").generate(prompts, 9)
    np.testing.assert_array_equal(got, want)
    prompts = _prompts(12, [s[0] for s in SERVE_SPEC], tcfg.vocab)
    arrivals = [s[2] for s in SERVE_SPEC]
    want, stats_j = _jeng().serve(_requests(JRequest, prompts, SERVE_SPEC), slots=SLOTS,
                                  arrivals=arrivals, return_stats=True, prefill_chunk=CHUNK)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, SERVE_SPEC), slots=SLOTS,
                             arrivals=arrivals, return_stats=True)
    _same_serve(got, want, stats_t, stats_j)


def test_ngram_spec_serve_matches_jax():
    """Speculative serve with the n-gram draft (k = 3): the port's streams
    equal the JAX engine's and the plain greedy ones, with the same
    spec_stats; verify windows of 4 run the mLSTM as one padded 8-token
    chunk and roll each row back by masked prefill."""
    jcfg, tcfg, jp, tp = _model()
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
    plain = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu").serve(
        _requests(Request, prompts, spec), slots=2, arrivals=arrivals)
    _same_serve(got, plain)
    assert eng.spec_stats == jeng.spec_stats
    assert eng.serve_stats["decode_dispatches"] == 0 and eng.serve_stats["verify_dispatches"] > 0
