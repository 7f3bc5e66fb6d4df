"""The hann window through the port's LM and serving stack against the JAX
package, on the CPU: the ``stlt_hann`` kind of the JAX package's own
chunked-prefill, masked-prefill, scheduler, speculative and slot tests
(``small_cfg`` sizes: 2 layers, d_model 32, 4 heads, 4 nodes, chunk 8, vocab
64; W = 128, the ``STLTConfig`` default, as no ``ModelConfig`` field sets
it), and ``stlt_base`` reduced to 2 layers in its hann form (adaptive masks:
the filter is per row and every chunk and step recomputes it).

Both packages get the same weights (``convert.from_jax_params``) and inputs
from numpy seeds, in fp32. Tolerances: logits and states atol 1e-5 (fp32
FFT convolutions of length next_fast_len(N + 128), whose rounding differs
between ``torch.fft`` and ``jnp.fft``, then 2 blocks and a 64-way head);
token streams, ticks and cache stats exactly; a ``valid == 0`` row's ring and
a ``q == 0`` rollback bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.stlt_base import CONFIG as J_CONFIG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.prefix_cache import state_digest as j_state_digest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.stlt_base import CONFIG as T_CONFIG  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import PrefixCache, Request, ServeEngine  # noqa: E402
from repro_torch.serving.prefix_cache import state_digest  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

ATOL = 1e-5
V, MAX_LEN, CHUNK, SLOTS = 64, 64, 8, 3
SMALL = dict(name="t", family="lm", vocab=V, num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
             blockwise_threshold=10_000, mixer="stlt", stlt_window="hann",
             stlt_nodes=4, stlt_chunk=8)

j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)
j_spec_verify = jax.jit(JT.spec_verify, static_argnums=1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=what)


@functools.lru_cache(maxsize=None)
def _model(kind: str):
    """(JAX cfg, port cfg, JAX params, port params): ``small`` is the JAX
    tests' ``stlt_hann`` kind, ``base`` reduced stlt-base in its hann form
    with the adaptive gate scaled up so masks vary per row and chunk."""
    if kind == "small":
        jcfg, tcfg = JModelConfig(**SMALL), TModelConfig(**SMALL)
    else:
        jcfg = J_CONFIG.reduced(num_layers=2, stlt_window="hann")
        tcfg = T_CONFIG.reduced(num_layers=2, stlt_window="hann")
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    if kind == "base":
        for layer in tree["layers"]:
            layer["stlt"]["adaptive"]["w_alpha"] = layer["stlt"]["adaptive"]["w_alpha"] * 60.0
            layer["stlt"]["adaptive"]["b_alpha"] = layer["stlt"]["adaptive"]["b_alpha"] - 2.0
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.from_jax_params(tree, tcfg, device="cpu"))


def _state(tree, tcfg):
    return convert.from_jax_state(jax.tree_util.tree_map(np.asarray, tree), tcfg,
                                  device="cpu")


def _same_state(got, want, what, atol=ATOL):
    """Port state vs a converted JAX state: every layer's ring ``buf``
    [B, H, 128, dh] fp32 and ``pos`` [B] int32 (and ``asum``/``acnt`` under
    adaptive masks), the model's ``pos``."""
    for li, (lg, lw) in enumerate(zip(got["layers"], want["layers"])):
        assert sorted(lg) == sorted(lw) and {"buf", "pos"} <= set(lg), (what, sorted(lg))
        for k in lw:
            assert lg[k].dtype == lw[k].dtype and lg[k].shape == lw[k].shape, (what, li, k)
            _close(lg[k], lw[k], f"{what} layer {li} {k}",
                   atol=atol * (100 if k == "asum" else 1))
    assert torch.equal(got["pos"], want["pos"]), what


def _toks(seed, *shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the model: prefill, chunked and masked prefill, decode, rollback, slots
# ---------------------------------------------------------------------------


def test_chunked_prefill_matches_monolithic_and_jax():
    """A 30-token prompt folded 7 + 8 + 8 + 7 through ``prefill_chunk``
    (the ring carried as left context) equals the monolithic ``prefill``
    and JAX's chunked fold, state leaf for leaf; decode continues the same
    from both (the JAX test's ``stlt_hann`` kind)."""
    jcfg, tcfg, jp, tp = _model("small")
    toks = _toks(1, 2, 34)
    lm, sm = TT.prefill(tp, tcfg, torch.from_numpy(toks[:, :30]), MAX_LEN)
    ljm, sjm = j_prefill(jp, jcfg, jnp.asarray(toks[:, :30]), MAX_LEN)
    _close(lm, ljm, "monolithic vs JAX")
    _same_state(sm, _state(sjm, tcfg), "monolithic")
    st = TT.init_decode_state(tcfg, 2, MAX_LEN, device="cpu")
    sj = JT.init_decode_state(jcfg, 2, MAX_LEN)
    for a, b in ((0, 7), (7, 15), (15, 23), (23, 30)):
        lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, a:b]), st)
        lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, a:b]), sj)
    _close(lt, lm, "chunked vs monolithic")
    _close(lt, lj, "chunked vs JAX")
    _same_state(st, _state(sj, tcfg), "chunked")
    _same_state(st, sm, "chunked vs monolithic")
    for i in range(30, 34):
        tok = torch.from_numpy(toks[:, i])
        la, sm = TT.decode_step(tp, tcfg, tok, sm)
        lb, st = TT.decode_step(tp, tcfg, tok, st)
        lj, sj = j_decode_step(jp, jcfg, jnp.asarray(toks[:, i]), sj)
        _close(la, lb, f"step {i}")
        _close(lb, lj, f"step {i} vs JAX")
    _same_state(st, _state(sj, tcfg), "after decode")


@pytest.mark.parametrize("kind", ["small", "base"])
def test_masked_rows_match_batch1_and_jax(kind):
    """One masked [3, 8] dispatch over rows at depths 0, 6 and 3 with valid
    lengths 8, 4 and 0 (the coalesced-admission layout) equals each row's
    own batch-1 prefill and JAX's dispatch; the valid == 0 row keeps its
    ring (and pos) bit for bit."""
    jcfg, tcfg, jp, tp = _model(kind)
    r = np.random.default_rng(7)
    depths, valids = [0, 6, 3], [CHUNK, 4, 0]
    rows = [r.integers(0, V, (1, d + max(v, 1))).astype(np.int32)
            for d, v in zip(depths, valids)]
    pool = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    singles = []
    for s, (toks, d) in enumerate(zip(rows, depths)):
        st1 = TT.init_decode_state(tcfg, 1, MAX_LEN, device="cpu")
        if d:
            _, st1 = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, :d]), st1)
        singles.append((toks, st1))
        TT.insert_slot(pool, st1, s, tcfg)
    sj = jax.tree_util.tree_map(jnp.asarray, {
        "layers": [{k: _np(t) for k, t in layer.items()} for layer in pool["layers"]],
        "pos": _np(pool["pos"])})
    chunk_tok = r.integers(0, V, (3, CHUNK)).astype(np.int32)   # junk past valid
    for s, ((toks, _), d, v) in enumerate(zip(singles, depths, valids)):
        chunk_tok[s, :v] = toks[0, d:d + v]
    lt, pool = TT.prefill_chunk(tp, tcfg, torch.from_numpy(chunk_tok), pool,
                                valid_len=torch.tensor(valids, dtype=torch.int32))
    lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(chunk_tok), sj,
                             valid_len=jnp.asarray(valids, jnp.int32))
    _same_state(pool, _state(sj, tcfg), f"{kind} masked vs JAX")
    for s, ((toks, st1), d, v) in enumerate(zip(singles, depths, valids)):
        row = TT.extract_slot(pool, s, tcfg)
        if v == 0:
            for a, b in zip(row["layers"], st1["layers"]):
                assert all(torch.equal(a[k], b[k]) for k in b), f"{kind} idle row {s}"
            assert torch.equal(row["pos"], st1["pos"])
            continue
        ref_logits, ref_state = TT.prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, d:d + v]),
                                                 st1)
        _close(lt[s:s + 1], ref_logits, f"{kind} row {s} logits")
        _close(lt[s], np.asarray(lj)[s], f"{kind} row {s} logits vs JAX")
        _same_state(row, ref_state, f"{kind} row {s} state")


def test_spec_verify_rollback_matches_jax_and_incremental():
    """``spec_verify`` on a hann pool (windows valid 4, 2 and 0 of [3, 4]):
    greedy tokens, commits and the rolled-back rings as JAX's; then the
    rollback alone (``stlt_state_at`` through ``_block_state_at``) at every
    q equals the state after prefilling exactly q tokens, q == 0 bit for bit
    (the JAX test's ``hann`` window)."""
    jcfg, tcfg, jp, tp = _model("small")
    first = _toks(8, 3, 11)
    _, st = TT.prefill(tp, tcfg, torch.from_numpy(first), MAX_LEN)
    _, sj = j_prefill(jp, jcfg, jnp.asarray(first), MAX_LEN)
    inputs = _toks(9, 3, 4)
    valid = np.array([4, 2, 0], np.int32)
    gt, ct, st2 = TT.spec_verify(tp, tcfg, torch.from_numpy(inputs), st,
                                 torch.from_numpy(valid))
    gj, cj, sj2 = j_spec_verify(jp, jcfg, jnp.asarray(inputs), sj, jnp.asarray(valid))
    np.testing.assert_array_equal(_np(gt), np.asarray(gj))
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    _same_state(st2, _state(sj2, tcfg), "spec_verify")
    row = TT.extract_slot(st2, 2, tcfg)
    for a, b in zip(row["layers"], TT.extract_slot(st, 2, tcfg)["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    scfg = tcfg.stlt_config()
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(3, 5, 32)).astype(np.float32))
    layer = tp["layers"][0]["stlt"]
    from repro_torch.core import stlt as t_stlt
    st0 = st["layers"][0]
    st0 = {"buf": st0["buf"], "pos": st0["pos"]}
    for q in range(6):
        got = t_stlt.stlt_state_at(layer, scfg, x, st0, torch.full((3,), q, dtype=torch.int32))
        if q == 0:
            assert all(torch.equal(got[k], st0[k]) for k in st0)
            continue
        _, want = t_stlt.stlt_prefill(layer, scfg, x[:, :q], state=st0)
        for k in want:
            _close(got[k], want[k], f"q={q} {k}")


def test_slot_ops_carry_the_ring():
    """insert_slot / extract_slot / reset_slot on a pool of hann states: the
    ring ``buf`` and the int32 ``pos`` of a batch-1 state go into one row,
    neighbours untouched, extract copies, reset restores the init row."""
    jcfg, tcfg, jp, tp = _model("small")
    _, st = TT.prefill(tp, tcfg, torch.from_numpy(_toks(11, 1, 9)), MAX_LEN)
    pool = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    assert pool["layers"][0]["buf"].shape == (3, 4, 128, 8)
    assert pool["layers"][0]["pos"].dtype == torch.int32
    TT.insert_slot(pool, st, 1, tcfg)
    got = TT.extract_slot(pool, 1, tcfg)
    _same_state(got, st, "round trip", atol=0)
    assert int(pool["layers"][1]["pos"][1]) == 9 and int(pool["pos"][1]) == 9
    assert float(pool["layers"][0]["buf"][[0, 2]].abs().sum()) == 0
    TT.reset_slot(pool, 1, tcfg, MAX_LEN)
    _same_state(got, st, "extract is a copy", atol=0)
    assert all(float(layer[k].abs().sum()) == 0 for layer in pool["layers"] for k in layer)


# ---------------------------------------------------------------------------
# the engine: continuous, wave, spec, the prefix cache, generate
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jeng(kind: str):
    jcfg, _, jp, _ = _model(kind)
    return JServeEngine(jp, jcfg, max_len=MAX_LEN)


# (prompt length, max_new_tokens, arrival tick): 21 and 17 take three and
# two chunks with tails, 8 exactly one, 5 one tail; three co-pend at tick 0;
# id 2 is prefill-only; id 5 arrives after an idle gap
SERVE_SPEC = [(21, 5, 0), (17, 6, 0), (5, 1, 0), (8, 7, 2), (12, 4, 3), (9, 3, 25)]
STAT_KEYS = ("arrival", "admit", "live", "finish", "n_tokens", "prompt_tokens",
             "prefilled_tokens", "cached_tokens")
MODES = {"coalesced": dict(prefill_chunk=CHUNK), "monolithic": dict(prefill_chunk=0),
         "wave": dict(mode="wave")}


def _requests(kind, prompts, spec):
    return [kind(p, m, id=i) for i, (p, (_, m, _)) in enumerate(zip(prompts, spec))]


def _prompts(seed, lengths):
    r = np.random.default_rng(seed)
    return [r.integers(0, V, n).astype(np.int32) for n in lengths]


def _same_serve(got, want, stats_t=None, stats_j=None):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
    for rid in want if stats_j is not None else ():
        for k in STAT_KEYS:
            assert stats_t[rid][k] == stats_j[rid][k], (rid, k)


@pytest.mark.parametrize("kind,mode", [("small", m) for m in sorted(MODES)]
                         + [("base", "coalesced")])
def test_serve_matches_jax(kind, mode):
    """Continuous serve (coalesced masked chunks and monolithic admission)
    and wave mode against the unsharded JAX engine (the JAX scheduler test's
    ``stlt_hann`` kind): streams token for token, every request's ticks."""
    _, tcfg, _, tp = _model(kind)
    prompts = _prompts(12, [s[0] for s in SERVE_SPEC])
    arrivals = [s[2] for s in SERVE_SPEC]
    kw = dict(MODES[mode])
    chunk = kw.pop("prefill_chunk", 0)
    want, stats_j = _jeng(kind).serve(_requests(JRequest, prompts, SERVE_SPEC), slots=SLOTS,
                                      arrivals=arrivals, return_stats=True,
                                      prefill_chunk=chunk, **kw)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefill_chunk=chunk, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, SERVE_SPEC), slots=SLOTS,
                             arrivals=arrivals, return_stats=True, **kw)
    _same_serve(got, want, stats_t, stats_j)


def test_ngram_spec_serve_matches_jax():
    """n-gram speculative decoding (k = 3) on the hann form: the spec
    streams equal the JAX engine's and the plain greedy ones; verify
    replaces every decode dispatch, accepts, and rolls the rings back."""
    jcfg, tcfg, jp, tp = _model("small")
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
    assert eng.serve_stats["decode_dispatches"] == 0 and eng.serve_stats["verify_dispatches"] > 0
    assert eng.spec_stats == jeng.spec_stats and eng.spec_stats["accepted"] > 0


@pytest.mark.parametrize("kind", ["small", "base"])
def test_prefix_cache_serve_matches_jax(kind):
    """A 12-token system prompt warmed at chunk 8, then requests sharing
    it: streams, ticks, cached tokens and the cache's stats as JAX's; the
    warmed ring's ``state_digest`` is the JAX package's."""
    jcfg, tcfg, jp, tp = _model(kind)
    sys_prompt = _prompts(13, [12])[0]
    prompts = [np.concatenate([sys_prompt, t]) for t in _prompts(14, [5, 9, 0, 3])]
    spec = [(len(p), 3 + i % 2, i) for i, p in enumerate(prompts)]
    jcache, tcache = JPrefixCache(), PrefixCache()
    jeng = JServeEngine(jp, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, prefix_cache=jcache)
    eng = ServeEngine(tp, tcfg, max_len=MAX_LEN, prefix_cache=tcache, prefill_chunk=CHUNK,
                      device="cpu")
    assert eng.warm_prefix(sys_prompt) == jeng.warm_prefix(sys_prompt) == 12
    jentry, tentry = jcache.lookup(sys_prompt), tcache.lookup(sys_prompt)
    _same_state(tentry.state, _state(jentry.state, tcfg), "warmed entry")
    assert state_digest(_state(jentry.state, tcfg)) == j_state_digest(
        jax.tree_util.tree_map(np.asarray, jentry.state))
    kw = dict(slots=2, arrivals=[s[2] for s in spec], return_stats=True)
    want, stats_j = jeng.serve(_requests(JRequest, prompts, spec), **kw)
    got, stats_t = eng.serve(_requests(Request, prompts, spec), **kw)
    _same_serve(got, want, stats_t, stats_j)
    assert [stats_t[i]["cached_tokens"] for i in range(4)] == [12] * 4
    sj, st = jcache.stats(), tcache.stats()
    assert st == {k: sj[k] for k in st}


def test_generate_base_matches_jax():
    """Greedy ``generate`` of reduced stlt-base in its hann form (adaptive
    per-row filters recomputed every step): 2 x 20 prompt tokens, 10 new,
    token for token."""
    jcfg, tcfg, jp, tp = _model("base")
    prompts = np.stack(_prompts(16, [20, 20]))
    want = _jeng("base").generate(prompts, 10)
    got = ServeEngine(tp, tcfg, max_len=MAX_LEN, device="cpu").generate(prompts, 10)
    np.testing.assert_array_equal(got, want)
