"""Parity of the PyTorch port's encoder-decoder family with the JAX package,
on the CPU: the generic scans (``scan_sequential``/``scan_associative``),
the bilateral STLT through ``ops.stlt_scan`` causal and anti-causal, the
``sequential``/``associative`` engine names, the cross-STLT (whole sequence,
and context + step), ``apply_encdec``/``encdec_loss`` of whisper-base's STLT
variant ``.reduced()`` (frame embeddings) and of the WMT proxy ``mt-stlt``
of ``benchmarks/translation.py`` (tokens), the enc-dec decode state and
greedy decode, the weight-decay mask and 1 and 3 train steps against
``repro.launch.steps.build_train_step``, and a bf16 forward and its grads.

Inputs are made with numpy from a seed and fed to both packages in fp32
(except the bf16 case); the JAX model functions are jitted with the config
static. Tolerances are stated beside each test: fp32 sums of O(1) terms in
a different order, so a few 1e-6 of the scale.
"""
import dataclasses
import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.core import scan as j_scan  # noqa: E402
from repro.core import stlt as j_stlt  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.core import scan as t_scan  # noqa: E402
from repro_torch.core import stlt as t_stlt  # noqa: E402
from repro_torch.data import synthetic as t_synthetic  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

j_adamw = importlib.import_module("repro.optim.adamw")  # the module (repro.optim re-exports)
ROOT = Path(__file__).resolve().parents[1]
# generic scans: max abs err / max |ref| (fp32 products of powers, summed
# in another order)
SCAN_REL = 1e-5
# the bilateral STLT layer: max abs err / (1 + max |ref|)
STLT_TOL = 2e-5
# cross-STLT and model logits, losses: max abs err / (1 + max |ref|)
MODEL_TOL = 2e-5
# a grad leaf of the cross-STLT alone: ||port - JAX|| / ||JAX||
GRAD_REL = 1e-4
# through the whole reduced model the cross-STLT's scores reach ~100, so its
# softmax amplifies fp32 rounding: the port against itself with only the
# scan's chunking changed spreads grad leaves by up to 9e-5 (relative norm),
# the port against JAX by up to 2.8e-4. AdamW's moments, max abs error over
# the leaf's largest entry, and grad leaves: 1e-3.
MODEL_GRAD_REL = 1e-3
# After two moving AdamW steps that rounding has grown: AdamW's moments part
# by up to 3.9e-3 (relative norm) and the params by up to 1.4e-4 (lr 3e-3;
# half of the entries by more than 1e-6), against 3.7e-3 and 9.1e-5 for the
# port against itself with only the scan's chunking changed (summation order).
TRAJ_REL, TRAJ_ATOL = 1e-2, 5e-4
# bf16 activations (tests/test_torch_spec.py's): max abs err / (1 + max |ref|)
BF16_TOL = 1e-2
# bf16 grads against JAX's op by op, ||port - JAX|| / ||JAX||: over the
# whole grad and for the worst leaf. Read at 0.025 and 0.126 (a decoder
# node's T_hat), against 0.125 and 0.68 for either package's bf16 grads
# against its fp32 ones; each gate is twice its reading.
BF16_GRAD_REL, BF16_LEAF_REL = 0.05, 0.25
TCFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
M, N = 40, 12          # encoder frames / source tokens, decoder tokens

j_apply_encdec = jax.jit(JW.apply_encdec, static_argnums=1)
j_init_state = jax.jit(JW.init_encdec_decode_state, static_argnums=(1, 3, 4))
j_decode_step = jax.jit(JW.encdec_decode_step, static_argnums=1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _f64(x):
    a = _np(x)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _close(got, want, tol, what=""):
    got, want = _f64(got), _f64(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * (1.0 + float(np.abs(want).max())), (what, err)
    return err


def _rel(got, want):
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# (1) the generic scans
# ---------------------------------------------------------------------------


def _scan_case(seed, varying):
    """(a, b): a complex static pole [BH, 1, S, 1] against per-token inputs
    [BH, N, S, d] (the STLT's materialized scan), or a real decay that
    varies per token (the recurrence's general form)."""
    r = np.random.default_rng(seed)
    BH, n, S, d = 3, 37, 5, 4
    if varying:
        a = r.uniform(0.5, 1.0, (BH, n, S, d)).astype(np.float32)
        b = r.normal(size=(BH, n, S, d)).astype(np.float32)
        return a, b
    lam = np.exp(-r.uniform(0.01, 0.3, (BH, 1, S, 1)) + 1j * r.uniform(-0.8, 0.8, (BH, 1, S, 1)))
    b = np.broadcast_to(r.normal(size=(BH, n, 1, d)), (BH, n, S, d))
    return lam.astype(np.complex64), np.ascontiguousarray(b).astype(np.complex64)


@pytest.mark.parametrize("engine", ["sequential", "associative"])
@pytest.mark.parametrize("reverse", [False, True], ids=["causal", "anti-causal"])
@pytest.mark.parametrize("varying", [False, True], ids=["static", "varying"])
def test_generic_scans_match_jax(engine, reverse, varying):
    """The port's scan engine against the JAX package's of the same name on
    the token axis (-3), both directions, at N = 37: the associative one at
    chunks 16 (three chunks, the last partial) and 64 (one). Within 1e-5 of
    the output's scale."""
    a, b = _scan_case(7, varying)
    jfn = getattr(j_scan, f"scan_{engine}")
    want = jfn(jnp.asarray(a), jnp.asarray(b), axis=-3, reverse=reverse)
    tfn = getattr(t_scan, f"scan_{engine}")
    chunks = (16, 64) if engine == "associative" else (None,)
    for chunk in chunks:
        kw = {} if chunk is None else {"chunk": chunk}
        got = tfn(torch.from_numpy(a), torch.from_numpy(b), axis=-3, reverse=reverse, **kw)
        assert tuple(got.shape) == want.shape
        assert _rel(got, want) <= SCAN_REL, (engine, chunk)


def test_associative_scan_takes_unexpanded_inputs():
    """A pole [BH, 1, S, 1] and inputs [BH, N, 1, d] broadcast to the
    output [BH, N, S, d] as if both were expanded (equal to the expanded
    call up to rounding), and the grads of both flow."""
    a, b = _scan_case(3, varying=False)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(np.ascontiguousarray(b[:, :, :1])).requires_grad_(True)
    got = t_scan.scan_associative(at, bt, axis=-3, chunk=16)
    want = t_scan.scan_sequential(at, bt.expand(b.shape), axis=-3)
    assert _rel(got, want) <= SCAN_REL
    ga = torch.autograd.grad(got.abs().sum(), (at, bt))
    wa = torch.autograd.grad(want.abs().sum(), (at, bt))
    for g, w in zip(ga, wa):
        assert _rel(g, w) <= 1e-4


# ---------------------------------------------------------------------------
# (2) the bilateral STLT and the engine names
# ---------------------------------------------------------------------------


def _stlt_cfgs(adaptive, engine="chunked"):
    kw = dict(d_model=32, num_heads=4, num_nodes=8, chunk=16, bidirectional=True,
              engine=engine)
    return (j_stlt.STLTConfig(adaptive=j_adaptive.AdaptiveConfig(enabled=adaptive), **kw),
            t_stlt.STLTConfig(adaptive=t_adaptive.AdaptiveConfig(enabled=adaptive), **kw))


def _stlt_params(cfg_j):
    p = j_stlt.init_stlt(jax.random.key(0), cfg_j)
    if "adaptive" in p:   # masks that differ per row
        p["adaptive"]["w_alpha"] = p["adaptive"]["w_alpha"] * 60.0
        p["adaptive"]["b_alpha"] = p["adaptive"]["b_alpha"] - 2.0
    return p


@pytest.mark.parametrize("engine", ["chunked", "sequential", "associative"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_bidirectional_apply_stlt_matches_jax(adaptive, engine):
    """apply_stlt with bidirectional=True at N = 37, chunk 16 (padded tail
    in both directions), fixed nodes and per-row adaptive masks (the centre
    term over the masked mixers); the port's chunked engine is ops.stlt_scan
    causal + anti-causal, the others the materialized scans. Within 2e-5."""
    cfg_j, cfg_t = _stlt_cfgs(adaptive, engine)
    p = _stlt_params(cfg_j)
    x = np.random.default_rng(1).normal(size=(3, 37, 32)).astype(np.float32)
    yj, auxj = jax.jit(j_stlt.apply_stlt, static_argnums=1)(p, cfg_j, jnp.asarray(x))
    yt, auxt = t_stlt.apply_stlt(_t(p), cfg_t, torch.from_numpy(x))
    _close(yt, yj, STLT_TOL, engine)
    if adaptive:
        assert auxj["masks"] is not None and float(jnp.std(auxj["masks"])) > 0
        _close(auxt["masks"], auxj["masks"], STLT_TOL)
    # bilateral: every output sees every input
    x2 = x.copy()
    x2[:, -1] += 1.0
    yt2, _ = t_stlt.apply_stlt(_t(p), cfg_t, torch.from_numpy(x2))
    assert float((yt2[:, 0] - yt[:, 0]).abs().max()) > 0


@pytest.mark.parametrize("entry", ["stlt_prefill", "init_stlt_state", "apply_stlt_step"])
def test_streaming_refuses_the_bilateral_stlt(entry):
    """Prefill, state and decode are causal: they refuse bidirectional=True,
    as the JAX package asserts."""
    _, cfg_t = _stlt_cfgs(False)
    causal = dataclasses.replace(cfg_t, bidirectional=False)
    p = t_stlt.init_stlt(torch.Generator().manual_seed(0), cfg_t)
    x = torch.zeros(1, 4, 32)
    calls = {"stlt_prefill": lambda: t_stlt.stlt_prefill(p, cfg_t, x),
             "init_stlt_state": lambda: t_stlt.init_stlt_state(cfg_t, 1),
             "apply_stlt_step": lambda: t_stlt.apply_stlt_step(
                 p, cfg_t, x[:, 0], t_stlt.init_stlt_state(causal, 1))}
    with pytest.raises(ValueError, match="bilateral"):
        calls[entry]()


# ---------------------------------------------------------------------------
# (3) the cross-STLT
# ---------------------------------------------------------------------------


def _cross_case(dtype=np.float32):
    cfg_j, cfg_t = _stlt_cfgs(False)
    cfg_j = dataclasses.replace(cfg_j, bidirectional=False)
    cfg_t = dataclasses.replace(cfg_t, bidirectional=False)
    p = j_stlt.init_cross_stlt(jax.random.key(4), cfg_j)
    r = np.random.default_rng(5)
    x_dec = r.normal(size=(2, 9, 32)).astype(dtype)
    x_enc = r.normal(size=(2, 21, 32)).astype(dtype)
    return cfg_j, cfg_t, p, x_dec, x_enc


def test_init_cross_stlt_layout_matches_jax():
    cfg_j, cfg_t, p, _, _ = _cross_case()
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    pt = t_stlt.init_cross_stlt(torch.Generator().manual_seed(0), cfg_t)
    assert shapes(pt) == shapes(p)


def test_apply_cross_stlt_matches_jax():
    """The whole-sequence cross-STLT: 9 decoder positions against 21
    encoder positions. Within 2e-5; the grad of every parameter within 1e-4
    of jax.grad's (relative), non-zero but for the node mixers u, which the
    cross-STLT does not read (zero in both)."""
    cfg_j, cfg_t, p, x_dec, x_enc = _cross_case()
    xd, xe = jnp.asarray(x_dec), jnp.asarray(x_enc)

    def j_fn(q):
        return j_stlt.apply_cross_stlt(q, cfg_j, xd, xe)
    zj = jax.jit(j_fn)(p)
    gj = jax.jit(jax.grad(lambda q: jnp.sum(j_fn(q) ** 2)))(p)
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), p)
    zt = t_stlt.apply_cross_stlt(pt, cfg_t, torch.from_numpy(x_dec), torch.from_numpy(x_enc))
    _close(zt, zj, MODEL_TOL)
    paths, leaves = zip(*tree_flatten_with_paths(pt))
    gt = torch.autograd.grad((zt ** 2).sum(), leaves, allow_unused=True,
                             materialize_grads=True)
    gj = dict(tree_flatten_with_paths(_t(gj)))
    for path, g in zip(paths, gt):
        assert (float(g.abs().max()) > 0) == (not path.endswith(("u_re", "u_im"))), path
        assert _rel(g, gj[path]) <= GRAD_REL or float(gj[path].abs().max()) == 0, path


def test_cross_context_and_step_match_jax():
    """cross_stlt_context (the encoder side, fp32 coefficients) and 9 steps
    of cross_stlt_step against the JAX package's, each step's output within
    2e-5; the steps equal the whole-sequence form too."""
    cfg_j, cfg_t, p, x_dec, x_enc = _cross_case()
    pt = _t(p)
    cj = jax.jit(j_stlt.cross_stlt_context, static_argnums=1)(p, cfg_j, jnp.asarray(x_enc))
    j_step = jax.jit(j_stlt.cross_stlt_step, static_argnums=1)
    ct = t_stlt.cross_stlt_context(pt, cfg_t, torch.from_numpy(x_enc))
    for k in ("L_re", "L_im", "v"):
        assert ct[k].dtype == torch.float32 and tuple(ct[k].shape) == cj[k].shape
        _close(ct[k], cj[k], MODEL_TOL, k)
    sj = j_stlt.init_cross_stlt_state(cfg_j, 2)
    st = t_stlt.init_cross_stlt_state(cfg_t, 2)
    whole = t_stlt.apply_cross_stlt(pt, cfg_t, torch.from_numpy(x_dec),
                                    torch.from_numpy(x_enc))
    for i in range(x_dec.shape[1]):
        zj, sj = j_step(p, cfg_j, jnp.asarray(x_dec[:, i]), sj, cj)
        zt, st = t_stlt.cross_stlt_step(pt, cfg_t, torch.from_numpy(x_dec[:, i]), st, ct)
        _close(zt, zj, MODEL_TOL, f"step {i}")
        _close(zt, whole[:, i], MODEL_TOL, f"step {i} vs whole")
        for k in ("h_re", "h_im"):
            _close(st[k], sj[k], MODEL_TOL, k)


# ---------------------------------------------------------------------------
# (4) the models: whisper-base-stlt reduced (frames), mt-stlt (tokens)
# ---------------------------------------------------------------------------


def _mt_cfg_j():
    """The WMT proxy's STLT config, from benchmarks/translation.py."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks.translation import _cfg

    return _cfg("stlt")


def _port_cfg(jcfg):
    names = {f.name for f in dataclasses.fields(TModelConfig)}
    return TModelConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg) if f.name in names})


@functools.lru_cache(maxsize=None)
def _models(arch: str, scan_layers: bool):
    if arch == "whisper":
        jcfg = j_get_config("whisper-base", "stlt").reduced(scan_layers=scan_layers)
    else:
        jcfg = dataclasses.replace(_mt_cfg_j(), scan_layers=scan_layers)
    tcfg = _port_cfg(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, JW.init_encdec(jax.random.key(0), jcfg))
    return jcfg, tcfg, tree


def _encdec_batch(cfg, seed, batch=2):
    r = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        b = j_synthetic.copy_task_batch(seed, 0, batch, N, cfg.vocab)
        return {k: np.ascontiguousarray(v) for k, v in b.items()}
    toks = r.integers(0, cfg.vocab, (batch, N + 1)).astype(np.int32)
    return {"enc_inputs": r.normal(size=(batch, M, cfg.d_model)).astype(np.float32),
            "dec_inputs": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("variant", ["stlt", "native"])
def test_whisper_config_matches_jax_and_native_raises(variant):
    """get_config("whisper-base", variant) field for field as the JAX
    package's (the fields the port has), and its .reduced() too. The native
    form (the attention encoder, decoder and cross-attention) is no longer
    refused: it initialises with the JAX package's leaves (attn, cross) and
    its shapes; tests/test_torch_attention.py holds its numerics."""
    for got, want in ((t_configs.get_config("whisper-base", variant),
                       j_get_config("whisper-base", variant)),
                      (t_configs.get_config("whisper-base", variant).reduced(),
                       j_get_config("whisper-base", variant).reduced())):
        for f in dataclasses.fields(TModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert "whisper-base" in t_configs.STLT_APPLICABLE
    cfg = t_configs.get_config("whisper-base", variant).reduced()
    jshapes = jax.eval_shape(lambda: JW.init_encdec(
        jax.random.key(0), j_get_config("whisper-base", variant).reduced()))
    want = convert.from_jax_encdec_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), jshapes), cfg, device="cpu")
    got = TW.init_encdec(cfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in tree_flatten_with_paths(got)} == \
        {p: tuple(t.shape) for p, t in tree_flatten_with_paths(want)}
    assert ("dec_layers/0/attn" in {p.rsplit("/", 1)[0] for p, _ in
                                    tree_flatten_with_paths(got)}) == (variant == "native")


def test_copy_task_batch_is_identical():
    for rev in (True, False):
        want = j_synthetic.copy_task_batch(3, 5, 4, 9, 32, reverse=rev)
        got = t_synthetic.copy_task_batch(3, 5, 4, 9, 32, reverse=rev)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch,scan_layers", [("whisper", False), ("whisper", True),
                                               ("mt", True)],
                         ids=["whisper-list", "whisper-stacked", "mt-stacked"])
def test_apply_encdec_and_loss_match_jax(arch, scan_layers):
    """Teacher-forced logits and encdec_loss of the reduced whisper-base-stlt
    (4 + 2 layers, 40 frame embeddings) on both JAX layouts (enc_list/
    dec_list and the stacked enc_layers/dec_layers) carried across, and of
    mt-stlt (2 + 2 layers, source tokens) stacked: the list layout is the
    same walk for either input mode. Within 2e-5."""
    jcfg, tcfg, tree = _models(arch, scan_layers)
    assert ("enc_layers" in tree) == (scan_layers and jcfg.num_layers > 1)
    assert ("enc_embed" in tree) == (arch == "mt")
    pt = convert.from_jax_encdec_params(tree, tcfg, device="cpu")
    assert len(pt["enc_layers"]) == jcfg.num_layers
    assert len(pt["dec_layers"]) == jcfg.num_decoder_layers
    b = _encdec_batch(jcfg, 2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    lj = j_apply_encdec(tree, jcfg, jb["enc_inputs"], jb["dec_inputs"])
    # encdec_loss's own body on those logits (the one program compiles once;
    # JAX's encdec_loss itself is held by the train-step tests' losses)
    loss_j = j_layers.cross_entropy(lj, jb["labels"])
    lt = TW.apply_encdec(pt, tcfg, tb["enc_inputs"], tb["dec_inputs"])
    _close(lt, lj, MODEL_TOL, "logits")
    loss_t, metrics = TW.encdec_loss(pt, tcfg, tb)
    assert sorted(metrics) == ["ce", "loss"]
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=MODEL_TOL)


@pytest.mark.parametrize("scan_layers", [False, True], ids=["list", "stacked"])
def test_greedy_decode_matches_jax(scan_layers):
    """init_encdec_decode_state (encode once, the cross contexts) and 7
    greedy encdec_decode_step calls from token 1: the converted JAX state
    equals the port's within 2e-5 (a stacked decoder's states come from
    jax.vmap), each step's logits within 2e-5, and the greedy streams are
    equal token for token."""
    jcfg, tcfg, tree = _models("whisper", scan_layers)
    pt = convert.from_jax_encdec_params(tree, tcfg, device="cpu")
    enc = _encdec_batch(jcfg, 6)["enc_inputs"]
    sj = j_init_state(tree, jcfg, jnp.asarray(enc), 2, 16)
    st = TW.init_encdec_decode_state(pt, tcfg, torch.from_numpy(enc), 2, 16)
    conv = convert.from_jax_encdec_state(jax.tree_util.tree_map(np.asarray, sj), tcfg,
                                         device="cpu")
    assert int(st["pos"]) == 0 and st["pos"].ndim == 0
    want = dict(tree_flatten_with_paths(conv["dec"]))
    got = dict(tree_flatten_with_paths(st["dec"]))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        _close(a, want[path], MODEL_TOL, path)
    tok_j = jnp.ones((2,), jnp.int32)
    tok_t = torch.ones((2,), dtype=torch.int64)
    stream_j, stream_t = [], []
    for step in range(7):
        lj, sj = j_decode_step(tree, jcfg, tok_j, sj)
        lt, st = TW.encdec_decode_step(pt, tcfg, tok_t, st)
        _close(lt, lj, MODEL_TOL, f"step {step}")
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        tok_t = lt.argmax(-1)
        stream_j.append(np.asarray(tok_j))
        stream_t.append(_np(tok_t))
    np.testing.assert_array_equal(np.stack(stream_t), np.stack(stream_j))
    assert int(st["pos"]) == int(sj["pos"]) == 7


def test_encdec_wd_mask_matches_jax_on_stacked_layers():
    """scan_layers=True: the JAX package stacks the reduced whisper's 4
    encoder and 2 decoder layers, so their FFN biases are 2-D there and
    decayed; the port's mask on its unstacked layers equals the JAX mask,
    unstacked, leaf by leaf. Unstacked (scan_layers=False) too."""
    for scan_layers in (True, False):
        _, tcfg, tree = _models("whisper", scan_layers)
        jmask = j_adamw.default_wd_mask(tree)
        want = convert.from_jax_encdec_params(jax.tree_util.tree_map(
            lambda m, a: np.full(a.shape, m, np.float32), jmask, tree), tcfg, device="cpu")
        got = t_optim.default_wd_mask(convert.from_jax_encdec_params(tree, tcfg,
                                                                     device="cpu"), tcfg)
        pairs = list(zip(tree_flatten_with_paths(got), tree_flatten_with_paths(want)))
        assert len(pairs) == len(tree_flatten_with_paths(got)) > 0
        for (path, m), (wpath, w) in pairs:
            assert path == wpath and bool((w == m).all()), path
        paths = dict(tree_flatten_with_paths(got))
        assert paths["enc_layers/1/ffn/b1"] == paths["dec_layers/0/ffn/b2"] == float(scan_layers)
        assert paths["dec_layers/1/cross/w_v"] == paths["lm_head/kernel"] == 1.0
        assert paths["dec_layers/1/cross/nodes/u_re"] == paths["dec_layers/0/norm_x/scale"] == 0


@functools.lru_cache(maxsize=None)
def _j_train_step():
    """The JAX package's ``build_train_step(...).fn`` on a 1 x 1 mesh for
    the stacked reduced whisper, jitted once."""
    jcfg = _models("whisper", True)[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    prog = j_steps.build_train_step(jcfg, ShapeConfig("t", N, 2, "train"), mesh,
                                    JTrainConfig(**TCFG))
    opt = j_adamw.adamw(weight_decay=0.1, b1=0.9, b2=0.98)
    return opt, jax.jit(prog.fn)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_build_train_step(steps):
    """launch/train.make_step on the stacked reduced whisper-base-stlt
    against ``build_train_step(...).fn`` (warmup 1: lr 0 at step 0, so only
    the later steps move the weights; the weight decay of the stacked FFN
    biases is in them): loss and ce each step within 2e-5, grad_norm within
    MODEL_GRAD_REL. After 1 step the AdamW moments (||port - JAX|| / ||JAX||
    per leaf) within MODEL_GRAD_REL and no weight moved; after 3, the
    moments within TRAJ_REL and every param within TRAJ_ATOL, each moved
    but the cross-STLT's node mixers."""
    jcfg, tcfg, tree = _models("whisper", True)
    jopt, jstep = _j_train_step()
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.from_jax_encdec_params(tree, tcfg, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        b = _encdec_batch(jcfg, 10 + step)
        jp, js, mj = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.int32(step))
        tp, ts, mt = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in b.items()}, step)
        assert sorted(mt) == ["ce", "grad_norm", "loss"]
        for k in mt:
            tol = MODEL_GRAD_REL if k == "grad_norm" else MODEL_TOL
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=tol,
                                       err_msg=f"step {step} {k}")
    assert ts["count"] == int(js["count"]) == steps

    def conv(t):
        return convert.from_jax_encdec_params(jax.tree_util.tree_map(np.asarray, t), tcfg,
                                              device="cpu")
    moment_tol = MODEL_GRAD_REL if steps == 1 else TRAJ_REL
    for name in ("mu", "nu"):
        for (path, g), (_, w) in zip(tree_flatten_with_paths(ts[name]),
                                     tree_flatten_with_paths(conv(js[name]))):
            gap = torch.linalg.vector_norm((g - w).double())
            assert float(gap) <= moment_tol * float(torch.linalg.vector_norm(w.double())), \
                (name, path)
    start = dict(tree_flatten_with_paths(conv(tree)))
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp), tree_flatten_with_paths(conv(jp))):
        if steps == 1:
            torch.testing.assert_close(p, start[path], rtol=0, atol=0)
        else:
            assert float((p - w).abs().max()) <= TRAJ_ATOL, path
            # the cross-STLT reads no node mixers u: no grad, no decay
            unread = "/cross/nodes/u_" in path
            assert torch.equal(p, start[path]) == unread, path


@functools.lru_cache(maxsize=None)
def _bf16_case():
    """The stacked reduced whisper-base-stlt with bf16 activations (fp32
    params: at these widths no matrix passes the 65,536-element cast) on
    one batch: JAX's logits, loss and grads from one program compiled with
    ``xla_allow_excess_precision`` off, so that each op rounds to bf16 as
    it does run op by op and as the port's ops do (by default XLA keeps
    fused bf16 chains in fp32: the logits move by 0.016 at a logit scale of
    0.45, and the grads by up to 1.46 of a leaf's norm). The loss is
    encdec_loss's own body on the logits, so both come out of the program."""
    jcfg = j_get_config("whisper-base", "stlt").reduced(scan_layers=True, dtype="bfloat16")
    tcfg = _port_cfg(jcfg)
    tree = _models("whisper", True)[2]
    b = _encdec_batch(jcfg, 8)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss(p, bb):
        logits = JW.apply_encdec(p, jcfg, bb["enc_inputs"], bb["dec_inputs"])
        return j_layers.cross_entropy(logits, bb["labels"]), logits

    prog = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(tree, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (loss_j, logits_j), grads_j = prog(tree, jb)
    return jcfg, tcfg, tree, b, float(loss_j), np.asarray(logits_j, np.float32), grads_j


def test_bf16_forward_matches_jax():
    """The reduced whisper-base-stlt with bf16 activations against the JAX
    package op by op (``_bf16_case``): logits within BF16_TOL of the scale,
    and the argmax equal wherever JAX's top-2 margin is clear of twice the
    largest error."""
    _, tcfg, tree, b, _, lj, _ = _bf16_case()
    pt = t_steps.serving_params(convert.from_jax_encdec_params(tree, tcfg, device="cpu"),
                                tcfg)
    with torch.no_grad():
        lt = TW.apply_encdec(pt, tcfg, torch.from_numpy(b["enc_inputs"]),
                             torch.from_numpy(b["dec_inputs"]))
    assert lt.dtype == torch.float32
    err = _close(lt, lj, BF16_TOL, "bf16 logits")
    top2 = np.sort(lj, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(_np(lt.argmax(-1))[clear], lj.argmax(-1)[clear])


def test_bf16_grads_match_jax_op_by_op():
    """launch/train.loss_and_grads in bf16 (fp32 masters) against JAX's
    grads op by op (``_bf16_case``): the loss within BF16_TOL, the whole
    grad (||port - JAX|| / ||JAX|| over every leaf) within BF16_GRAD_REL and
    each leaf within BF16_LEAF_REL. Both are bf16 rounding amplified by the
    cross-STLT's sharp softmax; the gates sit below the bf16-vs-fp32 spread
    of either package (a port whose grads were fp32, or wrong, fails)."""
    _, tcfg, tree, b, loss_j, _, grads_j = _bf16_case()
    pt = convert.from_jax_encdec_params(tree, tcfg, device="cpu")
    loss_t, _, grads_t = t_train.loss_and_grads(
        pt, tcfg, {k: torch.from_numpy(v) for k, v in b.items()}, tau=1.0)
    assert abs(float(loss_t) - loss_j) <= BF16_TOL * (1 + abs(loss_j))
    want = dict(tree_flatten_with_paths(convert.from_jax_encdec_params(
        jax.tree_util.tree_map(np.asarray, grads_j), tcfg, device="cpu")))
    got = dict(tree_flatten_with_paths(grads_t))
    assert sorted(got) == sorted(want)
    sq = lambda t: float((t.double() ** 2).sum())  # noqa: E731

    def whole(g):
        return (sum(sq(g[k] - want[k]) for k in g) / sum(sq(w) for w in want.values())) ** 0.5
    assert whole(got) <= BF16_GRAD_REL, whole(got)
    # the gate tells bf16 grads from fp32 ones
    _, _, grads32 = t_train.loss_and_grads(
        pt, dataclasses.replace(tcfg, dtype="float32"),
        {k: torch.from_numpy(v) for k, v in b.items()}, tau=1.0)
    assert whole(dict(tree_flatten_with_paths(grads32))) > BF16_GRAD_REL
    for path, g in got.items():
        w = want[path]
        if float(w.abs().max()) == 0:   # the cross-STLT's node mixers: unread
            assert float(g.abs().max()) == 0, path
            continue
        assert sq(g - w) ** 0.5 <= BF16_LEAF_REL * sq(w) ** 0.5, path


def test_steps_pick_the_family_and_the_clis_refuse_encdec():
    """launch/steps.py routes each family to its init, loss, prefill and
    decode; the serve and train CLIs refuse enc-dec configs with the JAX
    package's messages."""
    _, tcfg, tree = _models("whisper", False)
    assert t_steps.loss_fn(tcfg) is TW.encdec_loss
    p = t_steps.init_fn(tcfg)(device="cpu")
    assert sorted(p) == sorted(convert.from_jax_encdec_params(tree, tcfg, device="cpu"))
    enc = torch.from_numpy(_encdec_batch(tcfg, 1)["enc_inputs"])
    st = t_steps.prefill_fn(tcfg, 8)(p, enc)
    logits, st = t_steps.decode_fn(tcfg)(p, torch.ones(2, dtype=torch.int64), st)
    assert tuple(logits.shape) == (2, tcfg.vocab) and int(st["pos"]) == 1
    with pytest.raises(SystemExit, match="enc-dec serving"):
        t_serve.main(["--arch", "whisper-base", "--variant", "stlt", "--reduced",
                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="enc-dec training"):
        t_train.main(["--arch", "whisper-base", "--variant", "stlt", "--reduced",
                      "--device", "cpu"])
