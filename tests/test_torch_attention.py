"""The PyTorch port's softmax-attention mixer against the JAX package on the
CPU: RoPE, the projections, the dense and blockwise attention, the KV cache
(decode, chunked and masked prefill, the ring buffer), the LM forward and
loss, chunked and heterogeneous masked admission, greedy ``generate``,
continuous ``serve`` in its three admission routes, wave mode (with its
``max_len`` deferral), the prefix cache and the n-gram speculative draft,
the request checks, train steps, the weight-decay mask on the qkv biases,
the native configs, and native whisper (attention encoder and decoder,
cross-attention).

Both packages get the same weights (``convert.from_jax_params`` /
``from_jax_encdec_params``) and the same inputs from numpy seeds, in fp32.
The tolerances are the JAX package's own for this module
(``tests/test_attention.py``: rtol 2e-4, atol 1e-5) unless a test states
another; token streams, ticks and cache sizes are held exactly. The LM is
``small_cfg``'s size (2 layers, d_model 32, 4 heads, 2 KV heads, vocab 64),
where the JAX package's own chunked, masked and speculative tests run it;
``local_attn`` uses its ring of 6 slots. One JAX engine per model serves
every engine test (its programs compile once); the JAX functions are jitted
with the config static.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import ShapeConfig, TrainConfig as JTrainConfig  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.serving import PrefixCache, Request, ServeEngine  # noqa: E402
from repro_torch.serving.prefix_cache import pytree_nbytes  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

j_adamw = importlib.import_module("repro.optim.adamw")  # the module (repro.optim re-exports)

RTOL, ATOL = 2e-4, 1e-5
V, MAX_LEN, CHUNK, SLOTS = 64, 48, 8, 3
BASE = dict(name="t", family="lm", vocab=V, num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False,
            blockwise_threshold=10_000)
# the block layouts of the LM tests: the JAX package's own chunked and masked
# prefill kinds (tests/test_chunked_prefill.py), and qkv biases
KINDS = {"attn": dict(mixer="attention"),
         "local_attn": dict(layer_types=("local_attn", "local_attn"), local_window=6),
         "attn_bias": dict(mixer="attention", qkv_bias=True)}

j_apply_lm = jax.jit(JT.apply_lm, static_argnums=1)
j_lm_loss = jax.jit(JT.lm_loss, static_argnums=1, static_argnames="deterministic")
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)
j_spec_verify = jax.jit(JT.spec_verify, static_argnums=1)
ja_prefill_kv_cache = jax.jit(JA.prefill_kv_cache, static_argnums=(1, 3))
ja_step = jax.jit(JA.apply_attention_step, static_argnums=1)
ja_prefill_chunk = jax.jit(JA.prefill_chunk, static_argnums=1)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _with_biases(tree, seed=1):
    """Zero-initialised qkv biases replaced by random ones (so they count)."""
    r = np.random.default_rng(seed)

    def fill(path, a):
        name = getattr(path[-1], "key", None)
        return (0.3 * r.normal(size=a.shape)).astype(a.dtype) if name in ("bq", "bk", "bv") else a
    return jax.tree_util.tree_map_with_path(fill, tree)


@functools.lru_cache(maxsize=None)
def _model(kind: str, scan_layers: bool = False, **extra):
    fields = {**BASE, **KINDS[kind], "scan_layers": scan_layers, **extra}
    jcfg = JModelConfig(**fields, remat=False)
    tcfg = TModelConfig(**fields, remat=False)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    tree = _with_biases(tree)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.from_jax_params(tree, tcfg, device="cpu"))


def _state(tree, tcfg):
    return convert.from_jax_state(jax.tree_util.tree_map(np.asarray, tree), tcfg,
                                  device="cpu")


def _same_state(got, want, what):
    for li, (lg, lw) in enumerate(zip(got["layers"], want["layers"])):
        assert sorted(lg) == sorted(lw) == ["k", "pos", "v"], lg.keys()
        for k in lw:
            assert lg[k].dtype == lw[k].dtype and lg[k].shape == lw[k].shape, (what, li, k)
            _close(lg[k], lw[k], f"{what} layer {li} {k}")
    assert torch.equal(got["pos"], want["pos"]), what


# ---------------------------------------------------------------------------
# (1) RoPE, the projections, the attention itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
def test_rope_matches_jax(fraction):
    """rope_angles and apply_rope (interleaved pairs, the leading rot dims),
    at shared positions [N] and per-row positions [B, N]."""
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 3, 12)).astype(np.float32)
    rot = int(12 * fraction)
    rot -= rot % 2
    for pos in (np.arange(5), np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])):
        sj, cj = JL.rope_angles(jnp.asarray(pos), rot, 500.0)
        st, ct = TL.rope_angles(torch.from_numpy(pos), rot, 500.0)
        _close(st, sj, "sin")
        _close(ct, cj, "cos")
        want = JL.apply_rope(jnp.asarray(x), sj, cj, fraction)
        got = TL.apply_rope(torch.from_numpy(x), st, ct, fraction)
        _close(got, want, f"rope {fraction}")
        assert got.dtype == torch.float32
    if rot == 0:     # nothing rotated: x itself
        np.testing.assert_array_equal(_np(got), x)


def _acfgs(**kw):
    base = dict(d_model=32, num_heads=4, num_kv_heads=2, blockwise_threshold=10_000)
    base.update(kw)
    return JA.AttentionConfig(**base), TA.AttentionConfig(**base)


def _attn_params(jcfg, tcfg, seed=0):
    tree = _with_biases(jax.tree_util.tree_map(
        np.asarray, JA.init_attention(jax.random.key(seed), jcfg)), seed)
    return tree, {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "qkv_bias"])
def test_qkv_matches_jax(bias):
    """_qkv with and without the qkv biases, RoPE at per-row positions; and
    init_attention's leaves and shapes, and wo's scale: lecun_normal over a
    fan-in of H * dh (64 here, with head_dim 16, not d_model's 32); the
    [-2, 2]-truncated normal has std 0.88."""
    jcfg, tcfg = _acfgs(qkv_bias=bias)
    tree, params = _attn_params(jcfg, tcfg)
    wide = dataclasses.replace(tcfg, head_dim=16)
    mine = TA.init_attention(torch.Generator().manual_seed(0), wide)
    want = JA.init_attention(jax.random.key(0), dataclasses.replace(jcfg, head_dim=16))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert abs(float(mine["wo"].std()) - 0.88 / 8) < 0.01
    x = np.random.default_rng(1).normal(size=(2, 7, 32)).astype(np.float32)
    pos = np.arange(14).reshape(2, 7) + np.array([[0], [5]])
    for a, b in zip(TA._qkv(params, tcfg, torch.from_numpy(x), torch.from_numpy(pos)),
                    JA._qkv(tree, jcfg, jnp.asarray(x), jnp.asarray(pos))):
        _close(a, b, "qkv")


ATTN_CASES = {"causal": {}, "window_mha": dict(num_kv_heads=4, window=9),
              "mqa": dict(num_kv_heads=1), "bidirectional": dict(causal=False)}


@pytest.mark.parametrize("path", ["dense", "blockwise"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_sdpa_matches_jax(path, case):
    """_sdpa_dense and _sdpa_blockwise (blocks of 8 queries and 16 keys over
    50 tokens: padded tails, skipped blocks) each against the JAX package's
    same function, and against the other path; _mask_bias too."""
    jcfg, tcfg = _acfgs(block_q=8, block_kv=16, **ATTN_CASES[case])
    r = np.random.default_rng(2)
    q = r.normal(size=(2, 50, 4, 8)).astype(np.float32)
    k, v = (r.normal(size=(2, 50, jcfg.num_kv_heads, 8)).astype(np.float32) for _ in range(2))
    jfn, tfn = ((JA._sdpa_dense, TA._sdpa_dense) if path == "dense"
                else (JA._sdpa_blockwise, TA._sdpa_blockwise))
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg)
    got = tfn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tcfg)
    _close(got, want, path)
    other = (TA._sdpa_blockwise if path == "dense" else TA._sdpa_dense)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tcfg)
    _close(got, other, "dense vs blockwise")
    np.testing.assert_array_equal(_np(TA._mask_bias(6, 9, 3, tcfg)),
                                  np.asarray(JA._mask_bias(6, 9, 3, jcfg)))


def test_apply_attention_takes_the_blockwise_path_at_its_threshold(monkeypatch):
    """N >= blockwise_threshold runs _sdpa_blockwise unless force_dense; the
    two agree, and both match the JAX package's apply_attention."""
    jcfg, tcfg = _acfgs(blockwise_threshold=40, block_q=16, block_kv=16)
    tree, params = _attn_params(jcfg, tcfg)
    x = np.random.default_rng(3).normal(size=(1, 45, 32)).astype(np.float32)
    calls = []
    real = TA._sdpa_blockwise
    monkeypatch.setattr(TA, "_sdpa_blockwise", lambda *a: calls.append(1) or real(*a))
    got = TA.apply_attention(params, tcfg, torch.from_numpy(x))
    dense = TA.apply_attention(params, tcfg, torch.from_numpy(x), force_dense=True)
    assert len(calls) == 1
    _close(got, JA.apply_attention(tree, jcfg, jnp.asarray(x)), "blockwise")
    _close(dense, got, "dense vs blockwise")


def test_fully_masked_row_gets_uniform_weights_not_nan():
    """The additive -1e30 mask: a query with no readable key (here: a
    window query against keys that all lie past it, via q_off) averages the
    values as JAX's does, and stays finite."""
    jcfg, tcfg = _acfgs(window=2)
    r = np.random.default_rng(4)
    q = r.normal(size=(1, 3, 4, 8)).astype(np.float32)
    k, v = (r.normal(size=(1, 6, 2, 8)).astype(np.float32) for _ in range(2))
    want = JA._sdpa_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, q_off=20)
    got = TA._sdpa_dense(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         tcfg, q_off=20)
    assert bool(torch.isfinite(got).all())
    _close(got, want, "all masked")
    _close(got[0, :, 0], np.broadcast_to(v[0, :, 0].mean(0), (3, 8)), "uniform")


# ---------------------------------------------------------------------------
# (2) the KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 6], ids=["linear", "ring"])
def test_kv_cache_ops_match_jax(window):
    """init_kv_cache, prefill_kv_cache (for the ring also a prompt longer
    than it), apply_attention_step, and prefill_chunk plain, with per-row
    valid lengths (0 included; a valid length longer than the ring), and a
    chunk longer than the ring: outputs, and the caches leaf for leaf."""
    jcfg, tcfg = _acfgs(window=window)
    tree, params = _attn_params(jcfg, tcfg)
    r = np.random.default_rng(5)

    def same(cj, ct, what):
        assert sorted(ct) == ["k", "pos", "v"]
        for key in cj:
            assert ct[key].shape == cj[key].shape, (what, key)
            _close(ct[key], cj[key], f"{what} {key}")
        assert ct["pos"].dtype == torch.int32

    cj = JA.init_kv_cache(jcfg, 2, 20)
    ct = TA.init_kv_cache(tcfg, 2, 20)
    same(cj, ct, "init")
    assert ct["k"].shape[1] == (6 if window else 20)
    for n_prompt in ((4, 9) if window else (4, 11)):
        x = r.normal(size=(2, n_prompt, 32)).astype(np.float32)
        yj, cj = ja_prefill_kv_cache(tree, jcfg, jnp.asarray(x), 20)
        yt, ct = TA.prefill_kv_cache(params, tcfg, torch.from_numpy(x), 20)
        _close(yt, yj, "prefill_kv_cache")
        same(cj, ct, f"prefill {n_prompt}")
    for i in range(3):
        x = r.normal(size=(2, 32)).astype(np.float32)
        yj, cj = ja_step(tree, jcfg, jnp.asarray(x), cj)
        yt, ct = TA.apply_attention_step(params, tcfg, torch.from_numpy(x), ct)
        _close(yt, yj, f"step {i}")
        same(cj, ct, f"step {i}")
    chunks = [(3, None), (5, [5, 0]), (4, [2, 4]), (8, None), (9, [9, 7])]
    for n, valid in chunks:
        x = r.normal(size=(2, n, 32)).astype(np.float32)
        vj = None if valid is None else jnp.asarray(valid, jnp.int32)
        vt = None if valid is None else torch.tensor(valid, dtype=torch.int32)
        before = {key: t.clone() for key, t in ct.items()}
        yj, cj = ja_prefill_chunk(tree, jcfg, jnp.asarray(x), cj, valid=vj)
        yt, ct2 = TA.prefill_chunk(params, tcfg, torch.from_numpy(x), ct, valid=vt)
        for key in before:       # the input cache is only read
            assert torch.equal(ct[key], before[key]), key
        ct = ct2
        rows = range(2) if valid is None else [b for b in range(2) if valid[b] > 0]
        for b in rows:           # pad query outputs are unread
            m = n if valid is None else valid[b]
            _close(yt[b, :m], yj[b, :m], f"chunk {n} {valid}")
        same(cj, ct, f"chunk {n} {valid}")


# ---------------------------------------------------------------------------
# (3) the LM: forward, loss, prefill, admission, decode
# ---------------------------------------------------------------------------


LM_CASES = {"attn": ("attn", False, {}),
            "local_attn": ("local_attn", False, {}),
            "attn_bias_stacked": ("attn_bias", True, {}),
            "attn_blockwise": ("attn", False, dict(blockwise_threshold=16))}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_logits_and_loss_match_jax(case):
    """apply_lm logits and lm_loss over 40 tokens: plain GQA attention, the
    local window, qkv biases with the JAX layers stacked (converted), and
    the blockwise path (threshold 16). s_eff is 0 with no STLT block. The
    monolithic prefill's state, converted from the JAX one (a stacked run's
    KV caches unstacked), leaf for leaf."""
    kind, scan, extra = LM_CASES[case]
    jcfg, tcfg, jp, tp = _model(kind, scan, **extra)
    toks = np.random.default_rng(6).integers(0, V, (2, 41)).astype(np.int32)
    lj, aj = j_apply_lm(jp, jcfg, jnp.asarray(toks[:, :-1]))
    lt, at = TT.apply_lm(tp, tcfg, torch.from_numpy(toks[:, :-1]))
    _close(lt, lj, "logits")
    assert float(at["s_eff"]) == float(aj["s_eff"]) == 0.0
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    loss_j, _ = j_lm_loss(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          deterministic=True)
    loss_t, mt = TT.lm_loss(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                            deterministic=True)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    lj, sj = j_prefill(jp, jcfg, jnp.asarray(toks[:, :20]), MAX_LEN)
    lt, st = TT.prefill(tp, tcfg, torch.from_numpy(toks[:, :20]), MAX_LEN)
    _close(lt, lj, "prefill logits")
    _same_state(st, _state(sj, tcfg), "prefill")


@pytest.mark.parametrize("kind", ["attn", "local_attn"])
def test_chunked_prefill_matches_monolithic_and_jax(kind):
    """A 30-token prompt folded 8 tokens a chunk (7 + 8 + 8 + 7) through
    prefill_chunk equals the monolithic prefill (last logits, then 4 decode
    steps), and equals the JAX package's chunked fold, state leaf for leaf
    (the ring wraps for local_attn)."""
    jcfg, tcfg, jp, tp = _model(kind)
    toks = np.random.default_rng(7).integers(0, V, (2, 34)).astype(np.int32)
    lm, sm = TT.prefill(tp, tcfg, torch.from_numpy(toks[:, :30]), MAX_LEN)
    st = TT.init_decode_state(tcfg, 2, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 2, MAX_LEN)
    for a, b in ((0, 7), (7, 15), (15, 23), (23, 30)):
        lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, a:b]), st)
        lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, a:b]), sj)
    _close(lt, lm, "chunked vs monolithic")
    _close(lt, lj, "chunked vs JAX")
    _same_state(st, _state(sj, tcfg), "chunked")
    _, sjm = j_prefill(jp, jcfg, jnp.asarray(toks[:, :30]), MAX_LEN)
    _same_state(sm, _state(sjm, tcfg), "monolithic")
    for i in range(30, 34):
        tok = torch.from_numpy(toks[:, i])
        la, sm = TT.decode_step(tp, tcfg, tok, sm)
        lb, st = TT.decode_step(tp, tcfg, tok, st)
        _close(la, lb, f"step {i}")


@pytest.mark.parametrize("kind", ["attn", "local_attn"])
def test_masked_admission_matches_jax(kind):
    """Heterogeneous rows in one masked dispatch: rows at different depths
    (pos 0, 5 and 11), valid lengths 8, 0 and 3 of a [3, 8] chunk, then a
    second dispatch; logits at each row's last valid token, the valid == 0
    row an exact no-op, states as JAX's; and spec_verify's rollback (the
    masked prefill with valid = commit) on the result."""
    jcfg, tcfg, jp, tp = _model(kind)
    r = np.random.default_rng(8)
    st = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 3, MAX_LEN)
    first = torch.from_numpy(r.integers(0, V, (3, 11)).astype(np.int32))
    lt, st = TT.prefill_chunk(tp, tcfg, first, st,
                              valid_len=torch.tensor([0, 5, 11], dtype=torch.int32))
    sj = jax.tree_util.tree_map(jnp.asarray, {"layers": [
        {k: np.asarray(t) for k, t in layer.items()} for layer in st["layers"]],
        "pos": np.asarray(st["pos"])})
    for valid in ([8, 0, 3], [2, 8, 0]):
        toks = r.integers(0, V, (3, 8)).astype(np.int32)
        before = TT.extract_slot(st, 1 if valid[1] == 0 else 2, tcfg)
        lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks), st,
                                  valid_len=torch.tensor(valid, dtype=torch.int32))
        lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks), sj,
                                 valid_len=jnp.asarray(valid, jnp.int32))
        live = [b for b in range(3) if valid[b] > 0]
        _close(lt[live], np.asarray(lj)[live], f"logits {valid}")
        _same_state(st, _state(sj, tcfg), f"masked {valid}")
        idle = TT.extract_slot(st, 1 if valid[1] == 0 else 2, tcfg)
        for a, b in zip(idle["layers"], before["layers"]):
            assert all(torch.equal(a[k], b[k]) for k in b)
    inputs = r.integers(0, V, (3, 4)).astype(np.int32)
    valid = np.array([4, 2, 0], np.int32)
    gt, ct, st2 = TT.spec_verify(tp, tcfg, torch.from_numpy(inputs), st, torch.from_numpy(valid))
    gj, cj, sj2 = j_spec_verify(jp, jcfg, jnp.asarray(inputs), sj, jnp.asarray(valid))
    np.testing.assert_array_equal(_np(gt), np.asarray(gj))
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    _same_state(st2, _state(sj2, tcfg), "spec_verify")


def test_slot_ops_carry_the_kv_leaves():
    """insert_slot / extract_slot / reset_slot on a pool of KV caches: the
    k, v leaves [B, size, Hkv, dh] and the per-row pos of a batch-1 state
    go into one row, neighbours untouched, extract copies, reset restores."""
    jcfg, tcfg, jp, tp = _model("local_attn")
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, V, (1, 9)).astype(np.int32))
    _, st = TT.prefill(tp, tcfg, toks, MAX_LEN)
    pool = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    assert pool["layers"][0]["k"].shape == (3, 6, 2, 8)
    TT.insert_slot(pool, st, 1, tcfg)
    got = TT.extract_slot(pool, 1, tcfg)
    _same_state(got, st, "round trip")
    assert int(pool["layers"][1]["pos"][1]) == 9 and int(pool["pos"][1]) == 9
    assert int(pool["pos"][0]) == int(pool["pos"][2]) == 0
    TT.reset_slot(pool, 1, tcfg, MAX_LEN)
    _same_state(got, st, "extract is a copy")
    assert all(float(layer[k].abs().sum()) == 0 for layer in pool["layers"] for k in layer)


# ---------------------------------------------------------------------------
# (4) the engine: generate, serve, wave, prefix cache, spec, request checks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jeng(kind: str):
    jcfg, _, jp, _ = _model(kind)
    return JServeEngine(jp, jcfg, max_len=MAX_LEN)


def _prompts(seed, lengths):
    r = np.random.default_rng(seed)
    return [r.integers(0, V, n).astype(np.int32) for n in lengths]


# (prompt length, max_new_tokens, arrival tick): 21 and 17 take three and
# two chunks with tails, 8 exactly one, 5 one tail; three co-pend at tick 0;
# id 2 is prefill-only; id 5 arrives after an idle gap.
SERVE_SPEC = [(21, 5, 0), (17, 6, 0), (5, 1, 0), (8, 7, 2), (12, 4, 3), (9, 3, 25)]
ROUTES = {"monolithic": (0, True), "coalesced": (CHUNK, True), "one_per_tick": (CHUNK, False)}
STAT_KEYS = ("arrival", "admit", "live", "finish", "n_tokens", "prompt_tokens",
             "prefilled_tokens", "cached_tokens")


def _requests(kind, prompts, spec):
    return [kind(p, m, id=i) for i, (p, (_, m, _)) in enumerate(zip(prompts, spec))]


def _same_serve(got, want, stats_t=None, stats_j=None):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
    for rid in want if stats_j is not None else ():
        for k in STAT_KEYS:
            assert stats_t[rid][k] == stats_j[rid][k], (rid, k)


@pytest.mark.parametrize("kind", ["attn", "local_attn"])
def test_generate_matches_jax(kind):
    """Greedy ``generate``: a monolithic prefill of 2 x 11 tokens, 9 decode
    steps (the local ring wraps), token for token."""
    jcfg, tcfg, jp, tp = _model(kind)
    prompts = np.stack(_prompts(10, [11, 11]))
    want = _jeng(kind).generate(prompts, 9)
    got = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu").generate(prompts, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,route", [("attn", r) for r in sorted(ROUTES)]
                         + [("local_attn", "coalesced")])
def test_continuous_serve_matches_jax(kind, route):
    """Continuous serve in each admission route against the unsharded JAX
    engine: streams token for token, every request's ticks and counts; the
    local ring through the coalesced route (masked writes into the ring,
    slot ops on it)."""
    _, tcfg, _, tp = _model(kind)
    prompts = _prompts(11, [s[0] for s in SERVE_SPEC])
    arrivals = [s[2] for s in SERVE_SPEC]
    chunk, coalesce = ROUTES[route]
    want, stats_j = _jeng(kind).serve(_requests(JRequest, prompts, SERVE_SPEC), slots=SLOTS,
                                      arrivals=arrivals, return_stats=True,
                                      prefill_chunk=chunk, coalesce=coalesce)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=chunk, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, SERVE_SPEC), slots=SLOTS,
                             arrivals=arrivals, return_stats=True, coalesce=coalesce)
    _same_serve(got, want, stats_t, stats_j)


def test_wave_mode_defers_past_max_len_as_jax():
    """Wave mode with a KV cache: requests whose padded prompt + budget
    would pass max_len wait for the next wave (FIFO), as in the JAX engine;
    streams and ticks equal. Without the deferral the 30-token prompt would
    share a wave with budgets of 20 (30 + 20 > 48)."""
    _, tcfg, _, tp = _model("attn")
    spec = [(6, 20, 0), (30, 4, 0), (5, 20, 0), (7, 3, 1)]
    prompts = _prompts(12, [s[0] for s in spec])
    arrivals = [s[2] for s in spec]
    want, stats_j = _jeng("attn").serve(_requests(JRequest, prompts, spec), slots=SLOTS,
                                        mode="wave", arrivals=arrivals, return_stats=True)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, spec), slots=SLOTS, mode="wave",
                             arrivals=arrivals, return_stats=True)
    _same_serve(got, want, stats_t, stats_j)
    assert eng.serve_stats["admission_dispatches"] == 3   # waves {0}, {1}, {2, 3}
    assert stats_t[1]["admit"] > stats_t[0]["admit"]


def test_prefix_cache_serve_matches_jax_and_sizes_kv_entries():
    """A 12-token system prompt warmed at chunk 8, then requests sharing
    it: streams, ticks, cached tokens and the cache's stats as JAX's. A
    KV entry holds the whole max_len buffer (pytree_nbytes)."""
    jcfg, tcfg, jp, tp = _model("attn")
    sys_prompt = _prompts(13, [12])[0]
    prompts = [np.concatenate([sys_prompt, t]) for t in _prompts(14, [5, 9, 0, 3])]
    spec = [(len(p), 3 + i % 2, i) for i, p in enumerate(prompts)]
    jcache, tcache = JPrefixCache(), PrefixCache()
    jeng = JServeEngine(jp, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, prefix_cache=jcache)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefix_cache=tcache, prefill_chunk=CHUNK,
                      device="cpu")
    assert eng.warm_prefix(sys_prompt) == jeng.warm_prefix(sys_prompt) == 12
    kw = dict(slots=2, arrivals=[s[2] for s in spec], return_stats=True)
    want, stats_j = jeng.serve(_requests(JRequest, prompts, spec), **kw)
    got, stats_t = eng.serve(_requests(Request, prompts, spec), **kw)
    _same_serve(got, want, stats_t, stats_j)
    assert [stats_t[i]["cached_tokens"] for i in range(4)] == [12] * 4
    sj, st = jcache.stats(), tcache.stats()
    assert st == {k: sj[k] for k in st}
    entry = tcache.lookup(sys_prompt)
    kv = 2 * 2 * MAX_LEN * tcfg.num_kv_heads * tcfg.dh * 4    # 2 layers, k and v, fp32
    assert pytree_nbytes(entry.state) == kv + 4 * 3           # + the three int32 pos


@pytest.mark.parametrize("kind", ["attn", "local_attn"])
def test_ngram_spec_serve_matches_jax(kind):
    """n-gram speculative decoding (k = 3) on attention: the port's spec
    streams equal the JAX engine's spec streams and the plain greedy ones,
    token for token; verify replaces every decode dispatch and accepts."""
    jcfg, tcfg, jp, tp = _model(kind)
    r = np.random.default_rng(15)
    prompts = [np.tile(r.integers(0, V, 4).astype(np.int32), 3) if i % 2 else
               r.integers(0, V, 7).astype(np.int32) for i in range(4)]
    spec = [(len(p), 8 + i, [0, 0, 1, 3][i]) for i, p in enumerate(prompts)]
    arrivals = [s[2] for s in spec]
    jeng = JServeEngine(jp, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, spec_k=3,
                        spec_draft="ngram")
    want = jeng.serve(_requests(JRequest, prompts, spec), slots=2, arrivals=arrivals)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, spec_k=3,
                      spec_draft="ngram", device="cpu")
    got = eng.serve(_requests(Request, prompts, spec), slots=2, arrivals=arrivals)
    _same_serve(got, want)
    plain = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu").serve(
        _requests(Request, prompts, spec), slots=2, arrivals=arrivals)
    _same_serve(got, plain)
    ss = eng.serve_stats
    assert ss["decode_dispatches"] == 0 and ss["verify_dispatches"] > 0
    assert eng.spec_stats == jeng.spec_stats and eng.spec_stats["accepted"] > 0


def test_request_checks_and_stlt_refusals_on_attention():
    """_check_fits refuses a request whose prompt + budget pass max_len
    (with and without prompt_len), as the JAX engine does, and only where
    an ``attn`` block's cache bounds it (a local ring does not);
    serve_nodes (engine and request), slo_degrade and the node draft need
    an STLT block."""
    jcfg, tcfg, jp, tp = _model("attn")
    p = np.arange(3, 13, dtype=np.int32)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu")
    jeng = _jeng("attn")
    for kw, match in ((dict(requests=[(p, MAX_LEN - 9)]), "exceeds max_len=48"),
                      (dict(requests=[(p, 30)], prompt_len=20), "exceeds max_len=48")):
        for kind, e in ((JRequest, jeng), (Request, eng)):
            args = {**kw, "requests": [kind(q, m, id=i) for i, (q, m) in enumerate(kw["requests"])]}
            for mode in ("continuous", "wave"):
                with pytest.raises(ValueError, match=match):
                    e.serve(slots=2, mode=mode, **args)
    assert len(eng.serve([Request(p, MAX_LEN - 10, id=0)], slots=1)[0]) == MAX_LEN - 10
    _, lcfg, _, lp = _model("local_attn")
    ring = ServeEngine(lp, lcfg, max_len=MAX_LEN, device="cpu")
    assert len(ring.serve([Request(p, MAX_LEN, id=0)], slots=1)[0]) == MAX_LEN
    for kw in (dict(serve_nodes=2), dict(slo_degrade=(4, 2), slo_queue_depth=1)):
        match = f"{next(iter(kw))} requires an STLT mixer"
        with pytest.raises(ValueError, match=match):
            JServeEngine(jp, jcfg, max_len=MAX_LEN, **kw)
        with pytest.raises(ValueError, match=match):
            ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu", **kw)
    for kind, e in ((JRequest, jeng), (Request, eng)):
        with pytest.raises(ValueError, match="serve_nodes requires an STLT mixer"):
            e.serve([kind(p, 2, id=0, serve_nodes=2)], slots=1)
    with pytest.raises(ValueError, match="spec_draft='nodes' requires an STLT mixer"):
        ServeEngine(tp, tcfg, spec_k=2, spec_draft="nodes", device="cpu")


# ---------------------------------------------------------------------------
# (5) training, the wd mask
# ---------------------------------------------------------------------------


TCFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRIC_RTOL = 2e-5    # test_torch_train.py's, fp32 through 2 blocks
B, N = 2, 32


def _batch(step):
    return j_synthetic.lm_batch_stream(0, step, B, N, V)


@functools.lru_cache(maxsize=None)
def _j_make_step(kind, scan):
    return j_train.make_step(_model(kind, scan)[0], JTrainConfig(**TCFG))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_make_step(steps):
    """make_step on the 2-layer model with qkv biases, the JAX layers
    stacked, against ``repro.launch.train.make_step`` (test_torch_train.py's
    tolerances): loss, ce, grad_norm within 2e-5 each step, the moments
    within 1e-4 of each leaf's largest entry, the params within 2 lr per
    moving step and all but 0.1% of entries within 1e-6 (not ``bk``: a key
    bias shifts every score of a query by the same amount, which the softmax
    ignores, so its grad is rounding noise and Adam moves it by lr times
    that noise's sign, in either package); with remat on, step 0's grads
    equal remat off exactly."""
    jcfg, tcfg, jp, tp = _model("attn_bias", True)
    jopt, jstep = _j_make_step("attn_bias", True)
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        b = _batch(step)
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
        err = (p - w).abs()
        assert float(err.max()) <= 2 * TCFG["learning_rate"] * (steps - 1) + 1e-6, path
        if not path.endswith("/bk"):
            assert float((err > 1e-6).double().mean()) <= 1e-3, path
    if steps == 1:
        b = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
        _, _, g_off = t_train.loss_and_grads(tp, tcfg, b, tau=1.0)
        _, _, g_on = t_train.loss_and_grads(tp, dataclasses.replace(tcfg, remat=True), b,
                                            tau=1.0)
        for (path, x), (_, y) in zip(tree_flatten_with_paths(g_on), tree_flatten_with_paths(g_off)):
            assert torch.equal(x, y), path


@pytest.mark.parametrize("scan", [False, True], ids=["list", "stacked"])
def test_wd_mask_on_the_qkv_biases_matches_jax(scan):
    """The JAX mask judges by ndim: unstacked, the 1-D qkv biases are not
    decayed; stacked, they are 2-D there and decayed. The port's mask equals
    JAX's, unstacked, leaf by leaf."""
    _, tcfg, jp, tp = _model("attn_bias", scan)
    jmask = j_adamw.default_wd_mask(jp)
    want = convert.from_jax_params(jax.tree_util.tree_map(
        lambda m, a: np.full(a.shape, m, np.float32), jmask, jp), tcfg, device="cpu")
    got = dict(tree_flatten_with_paths(t_optim.default_wd_mask(tp, tcfg)))
    for path, w in tree_flatten_with_paths(want):
        assert bool((w == got[path]).all()), path
    assert got["layers/1/attn/bq"] == float(scan) and got["layers/1/attn/wq"] == 1.0


# ---------------------------------------------------------------------------
# (6) the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,variant", [("smollm-360m", "native"), ("whisper-base", "native"),
                                          ("qwen2-1.5b", "native"), ("qwen2-1.5b", "stlt")])
def test_configs_match_jax_field_for_field(arch, variant):
    """get_config and .reduced() (local_window, blockwise_threshold 64) of
    the native configs and qwen2-1.5b's STLT variant, every port field as
    the JAX package's; so are xlstm-350m's, once a refused arch, whose STLT
    variant raises JAX's ValueError."""
    for got, want in ((t_configs.get_config(arch, variant), j_get_config(arch, variant)),
                      (t_configs.get_config(arch, variant).reduced(),
                       j_get_config(arch, variant).reduced())):
        for f in dataclasses.fields(TModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    local = dataclasses.replace(t_configs.get_config(arch), local_window=2048,
                                layer_types=("local_attn",) * t_configs.get_config(arch).num_layers)
    assert local.reduced().local_window == 8 and local.reduced().layer_types == ("local_attn",) * 4
    for got, want in ((t_configs.get_config("xlstm-350m"), j_get_config("xlstm-350m")),
                      (t_configs.get_config("xlstm-350m").reduced(),
                       j_get_config("xlstm-350m").reduced())):
        for f in dataclasses.fields(TModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    with pytest.raises(ValueError, match="STLT variant undefined for xlstm-350m"):
        t_configs.get_config("xlstm-350m", "stlt")


def test_qwen2_reduced_logits_with_bias_match_jax():
    """The first ported config with qkv biases: reduced qwen2-1.5b (4
    layers, bf16 turned to fp32 by .reduced(), biases given values) over
    70 tokens, past its reduced blockwise threshold of 64."""
    jcfg = j_get_config("qwen2-1.5b").reduced()
    tcfg = t_configs.get_config("qwen2-1.5b").reduced()
    assert tcfg.qkv_bias and tcfg.blockwise_threshold == 64
    tree = _with_biases(jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg)))
    tp = convert.from_jax_params(tree, tcfg, device="cpu")
    toks = np.random.default_rng(16).integers(0, jcfg.vocab, (1, 70)).astype(np.int32)
    lj, _ = j_apply_lm(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(toks))
    lt, _ = TT.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(lt, lj, "qwen2 logits")


# ---------------------------------------------------------------------------
# (7) native whisper
# ---------------------------------------------------------------------------


M_FRAMES, N_DEC = 40, 12
j_apply_encdec = jax.jit(JW.apply_encdec, static_argnums=1)
j_init_state = jax.jit(JW.init_encdec_decode_state, static_argnums=(1, 3, 4))
j_encdec_step = jax.jit(JW.encdec_decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _whisper(scan_layers: bool):
    jcfg = dataclasses.replace(j_get_config("whisper-base").reduced(scan_layers=scan_layers),
                               qkv_bias=True)
    tcfg = dataclasses.replace(t_configs.get_config("whisper-base").reduced(
        scan_layers=scan_layers), qkv_bias=True)
    tree = _with_biases(jax.tree_util.tree_map(np.asarray, JW.init_encdec(jax.random.key(0), jcfg)))
    return jcfg, tcfg, tree


def _whisper_batch(cfg, seed):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (2, N_DEC + 1)).astype(np.int32)
    return {"enc_inputs": r.normal(size=(2, M_FRAMES, cfg.d_model)).astype(np.float32),
            "dec_inputs": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("scan_layers", [False, True], ids=["list", "stacked"])
def test_native_whisper_forward_loss_and_decode_match_jax(scan_layers):
    """Native whisper (reduced: 4 + 2 layers, the bidirectional attention
    encoder, causal decoder and cross-attention, qkv biases given values),
    both JAX layouts: apply_encdec logits and encdec_loss; the decode state
    (KV caches, xk/xv) leaf for leaf; 6 greedy decode steps, logits and
    tokens."""
    jcfg, tcfg, tree = _whisper(scan_layers)
    pt = convert.from_jax_encdec_params(tree, tcfg, device="cpu")
    assert sorted(pt["dec_layers"][0]) == ["attn", "cross", "ffn", "norm1", "norm2", "norm_x"]
    b = _whisper_batch(jcfg, 17)
    lj = j_apply_encdec(tree, jcfg, jnp.asarray(b["enc_inputs"]), jnp.asarray(b["dec_inputs"]))
    lt = TW.apply_encdec(pt, tcfg, torch.from_numpy(b["enc_inputs"]),
                         torch.from_numpy(b["dec_inputs"]))
    _close(lt, lj, "logits")
    loss_t, _ = TW.encdec_loss(pt, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss_t), float(JL.cross_entropy(lj, jnp.asarray(b["labels"]))),
                               rtol=RTOL)
    sj = j_init_state(tree, jcfg, jnp.asarray(b["enc_inputs"]), 2, 16)
    st = TW.init_encdec_decode_state(pt, tcfg, torch.from_numpy(b["enc_inputs"]), 2, 16)
    want = dict(tree_flatten_with_paths(convert.from_jax_encdec_state(
        jax.tree_util.tree_map(np.asarray, sj), tcfg, device="cpu")["dec"]))
    got = dict(tree_flatten_with_paths(st["dec"]))
    assert sorted(got) == sorted(want) and "0/xk" in got and "1/self/pos" in got
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        _close(a, want[path], path)
    tok_j, tok_t = jnp.ones((2,), jnp.int32), torch.ones((2,), dtype=torch.int64)
    for step in range(6):
        lj, sj = j_encdec_step(tree, jcfg, tok_j, sj)
        lt, st = TW.encdec_decode_step(pt, tcfg, tok_t, st)
        _close(lt, lj, f"step {step}")
        tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1)
        np.testing.assert_array_equal(_np(tok_t), np.asarray(tok_j))


def test_native_whisper_train_step_matches_jax():
    """One make_step on the stacked reduced native whisper against
    ``build_train_step(...).fn`` on a 1 x 1 mesh: loss and ce within 2e-5,
    grad_norm and the AdamW moments (||port - JAX|| / ||JAX|| per leaf)
    within 1e-4, and no weight moved (lr 0 at step 0). The key biases'
    grads are rounding noise (the softmax ignores a per-query shift of the
    scores): their moments are held below 1e-6 of the largest leaf's."""
    jcfg, tcfg, tree = _whisper(True)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    prog = j_steps.build_train_step(jcfg, ShapeConfig("t", N_DEC, 2, "train"), mesh,
                                    JTrainConfig(**TCFG))
    jopt = j_adamw.adamw(weight_decay=0.1, b1=0.9, b2=0.98)
    topt, tstep = t_train.make_step(tcfg, TrainConfig(**TCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.from_jax_encdec_params(tree, tcfg, device="cpu")
    b = _whisper_batch(jcfg, 18)
    jp2, js, mj = jax.jit(prog.fn)(jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in b.items()},
                                   jnp.int32(0))
    tp2, ts, mt = tstep(tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in b.items()}, 0)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=1e-4 if k == "grad_norm" else METRIC_RTOL, err_msg=k)
    for name in ("mu", "nu"):
        want = convert.from_jax_encdec_params(jax.tree_util.tree_map(np.asarray, js[name]),
                                              tcfg, device="cpu")
        pairs = list(zip(tree_flatten_with_paths(ts[name]), tree_flatten_with_paths(want)))
        top = max(float(torch.linalg.vector_norm(w.double())) for _, (_, w) in pairs)
        for (path, g), (_, w) in pairs:
            norm = float(torch.linalg.vector_norm(w.double()))
            if path.endswith("/bk"):   # a key bias's grad is rounding noise (see above)
                assert max(norm, float(torch.linalg.vector_norm(g.double()))) <= 1e-6 * top
                continue
            gap = float(torch.linalg.vector_norm((g - w).double()))
            assert gap <= 1e-4 * norm + 1e-30, (name, path)
    for (path, p), (_, w) in zip(tree_flatten_with_paths(tp2), tree_flatten_with_paths(tp)):
        assert torch.equal(p, w), path
