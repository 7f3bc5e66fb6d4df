"""Speculative decoding, the SLO node ladder and the bf16 forward of the
PyTorch port, against the JAX package on the CPU.

Token streams are held exactly in fp32 at ``small_cfg``'s sizes (2 layers,
d_model 32, 4 heads, 4 nodes, chunk 8, vocab 64), where the JAX package's
own ``tests/test_speculative.py`` holds them; both packages get the same
weights (``convert.from_jax_params``). States and scores from the
closed-form rollback against JAX's within 2e-5 + 2e-5 |ref| (fp32, the
JAX test's own tolerance for the same function); ``greedy`` and ``commit``
exactly. One JAX engine per model serves every case (its jitted programs
compile once per shape); a test that changes its settings restores them.

bf16: ``get_config("smollm-360m", "stlt").reduced(dtype="bfloat16")``
(4 layers, d_model 64, 8 nodes, chunk 16, vocab 256; bf16 activations over
fp32 params, and over the serve CLI's cast params: bf16 matrices, fp32
nodes and norms). XLA may keep a fused bf16 chain in fp32 where torch rounds
each op, so one residual element may differ by a bf16 ulp (2^-8 relative)
and that difference travels up the stack (jitted, ~5e-3 at a logit scale
of 0.5): logits are held within 1e-2 x (1 + max |ref|), states within
1e-2 x (1 + max |ref|) per leaf, and the argmax must agree at every
position whose top-2 margin exceeds twice the observed error.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import scan as j_scan  # noqa: E402
from repro.core import stlt as j_stlt  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import speculative as j_spec  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.adaptive import AdaptiveConfig  # noqa: E402
from repro_torch.core import scan as t_scan  # noqa: E402
from repro_torch.core import stlt as t_stlt  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.serving import speculative as t_spec  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

MAX_LEN, CHUNK, V = 96, 8, 64
BASE = dict(name="t", family="lm", vocab=V, num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False)
STLT_KW = dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8)
ADAPTIVE_KW = dict(mixer="stlt", stlt_nodes=8, stlt_chunk=8, stlt_adaptive=True)
ATOL = RTOL = 2e-5
BF16_TOL = 1e-2

# the JAX functions, jitted (config static) so each compiles once per shape
j_spec_verify = jax.jit(JT.spec_verify, static_argnums=1)
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_apply_lm = jax.jit(JT.apply_lm, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)
j_stlt_prefill = jax.jit(j_stlt.stlt_prefill, static_argnums=1)
j_state_at = jax.jit(j_stlt.stlt_state_at, static_argnums=1)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    """The same small config in both packages."""
    fields = {**BASE, **kw}
    return (JModelConfig(**fields, remat=False, blockwise_threshold=10_000),
            TModelConfig(**fields))


def _model(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(seed), jcfg))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.from_jax_params(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _model(**STLT_KW)


@pytest.fixture(scope="module")
def jeng(model):
    """The module's JAX engine; tests that change its settings restore them."""
    jcfg, _, jparams, _ = model
    return JServeEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK)


def _trace(kind, n=6, seed=0, lo=3, hi=9, budget=lambda i: 6 + i % 7):
    """The JAX test's mix: half the prompts repeat a motif (n-gram
    friendly), half are random; staggered arrivals."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if i % 2:
            prompt = np.tile(rng.integers(3, V, 4).astype(np.int32), 3)
        else:
            prompt = rng.integers(3, V, int(rng.integers(lo, hi))).astype(np.int32)
        reqs.append(kind(prompt, budget(i), id=i))
    return reqs, [0, 0, 1, 3, 3, 5][:n] + [6] * max(0, n - 6)


@pytest.fixture(scope="module")
def plain(jeng):
    """JAX's plain greedy streams of the mix on 3 slots."""
    reqs, arrivals = _trace(JRequest)
    return jeng.serve(reqs, slots=3, arrivals=arrivals)


def _same(got, want, ctx):
    assert sorted(got) == sorted(want), ctx
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}: {ctx}")


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol, err_msg=what)


# ---------------------------------------------------------------------------
# the closed-form rollback
# ---------------------------------------------------------------------------


def _stlt_layer(adaptive):
    jcfg = j_stlt.STLTConfig(d_model=32, num_heads=4, num_nodes=4, chunk=8)
    if adaptive:
        jcfg = dataclasses.replace(jcfg, adaptive=jcfg.adaptive._replace(enabled=True))
    tcfg = t_stlt.STLTConfig(d_model=32, num_heads=4, num_nodes=4, chunk=8,
                             adaptive=AdaptiveConfig(enabled=adaptive))
    tree = jax.tree_util.tree_map(np.asarray, j_stlt.init_stlt(jax.random.key(1), jcfg))
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), tparams


@pytest.mark.parametrize("adaptive", [False, True])
def test_state_at_matches_jax_and_decode_steps(adaptive):
    """``scan.stlt_window_state`` and ``stlt.stlt_state_at`` against JAX's
    for q = 0..L per row (different q in each row), from a warmed state, and
    against q incremental ``apply_stlt_step`` calls; q == 0 rows give the old
    state back."""
    jcfg, tcfg, jp, tp = _stlt_layer(adaptive)
    rng = np.random.default_rng(0)
    L, B = 5, 6
    x = rng.normal(size=(B, L, 32)).astype(np.float32)
    warm = rng.normal(size=(B, 3, 32)).astype(np.float32)
    _, sj = j_stlt_prefill(jp, jcfg, jnp.asarray(warm))
    st = {k: torch.from_numpy(np.array(v)) for k, v in sj.items()}
    q = np.array([0, 1, 2, 3, 4, 5], np.int32)
    want = j_state_at(jp, jcfg, jnp.asarray(x), sj, jnp.asarray(q))
    got = t_stlt.stlt_state_at(tp, tcfg, torch.from_numpy(x), st, torch.from_numpy(q))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], what=k)
    for k in ("h_re", "h_im"):
        np.testing.assert_allclose(_np(got[k][0]), _np(st[k][0]), atol=1e-6, rtol=0)
    # the scan-level primitive on its own
    lm, th, _, _ = j_stlt._poles(jp, jcfg)
    v = rng.normal(size=(B, L, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, B, 4, 8)).astype(np.float32)
    wr, wi = j_scan.stlt_window_state(jnp.asarray(v), jnp.asarray(h0[0]), jnp.asarray(h0[1]),
                                      lm[0], th[0], jnp.asarray(q))
    gr, gi = t_scan.stlt_window_state(torch.from_numpy(v), torch.from_numpy(h0[0]),
                                      torch.from_numpy(h0[1]), torch.from_numpy(np.array(lm[0])),
                                      torch.from_numpy(np.array(th[0])), torch.from_numpy(q))
    _close(gr, wr, what="window h_re")
    _close(gi, wi, what="window h_im")
    # q incremental decode steps land on the same state
    step = {k: t.clone() for k, t in st.items()}
    for t in range(L):
        _, new = t_stlt.apply_stlt_step(tp, tcfg, torch.from_numpy(x[:, t]), step)
        live = torch.from_numpy(q > t)
        step = {k: torch.where(live.reshape((-1,) + (1,) * (n.ndim - 1)), n, step[k])
                for k, n in new.items()}
    for k in got:
        _close(got[k], step[k], atol=1e-5, rtol=1e-5, what=f"decode steps {k}")


def _verify_inputs(jcfg, jparams, B, L):
    """A prefilled state of B rows and [B, L] windows whose drafts follow
    the model's own greedy continuation fully (row 0), for one token (row
    1), not at all (row 2), with row 3 idle (valid 0) and row 4 cut by its
    budget (valid 2)."""
    rng = np.random.default_rng(3)
    prompts = rng.integers(3, V, (B, 11)).astype(np.int32)
    _, state = j_prefill(jparams, jcfg, jnp.asarray(prompts), MAX_LEN)
    inputs = rng.integers(3, V, (B, L)).astype(np.int32)
    inputs[:, 0] = prompts[:, -1]
    for _ in range(L):   # make each row's drafts its greedy continuation
        greedy, _, _ = j_spec_verify(jparams, jcfg, jnp.asarray(inputs), state,
                                     jnp.full((B,), L, jnp.int32))
        inputs[:, 1:] = np.asarray(greedy)[:, :-1]
    inputs[1, 2:] = (inputs[1, 2:] + 1) % V
    inputs[2, 1:] = (inputs[2, 1:] + 1) % V
    valid = np.full(B, L, np.int32)
    valid[3], valid[4] = 0, 2
    return inputs, valid, state


@pytest.mark.parametrize("capped", [False, True])
def test_spec_verify_matches_jax(model, capped):
    """greedy and commit exactly, the rolled-back state within tolerance;
    the idle row's state and pos come back unchanged; with per-row node
    caps the scoring pass runs under the cap masks, as JAX's."""
    jcfg, tcfg, jparams, tparams = model
    B, L = 5, 4
    inputs, valid, sj = _verify_inputs(jcfg, jparams, B, L)
    caps = np.array([4, 2, 1, 4, 3], np.int32) if capped else None
    gj, cj, nj = j_spec_verify(jparams, jcfg, jnp.asarray(inputs), sj, jnp.asarray(valid),
                               None if caps is None else jnp.asarray(caps))
    st = convert.from_jax_state(jax.tree_util.tree_map(np.asarray, sj), tcfg, device="cpu")
    gt, ct, nt = TT.spec_verify(tparams, tcfg, torch.from_numpy(inputs), st,
                                torch.from_numpy(valid),
                                node_cap=None if caps is None else torch.from_numpy(caps))
    np.testing.assert_array_equal(_np(gt), np.asarray(gj))
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    if not capped:
        assert list(_np(ct).astype(int)) == [L, 2, 1, 0, 2]
    want = convert.from_jax_state(jax.tree_util.tree_map(np.asarray, nj), tcfg, device="cpu")
    np.testing.assert_array_equal(_np(nt["pos"]), _np(want["pos"]))
    for lt, lw, l0 in zip(nt["layers"], want["layers"], st["layers"]):
        for k in lw:
            _close(lt[k], lw[k], what=k)
            assert torch.equal(lt[k][3], l0[k][3])        # the idle row
    assert int(nt["pos"][3]) == int(st["pos"][3])


@pytest.mark.parametrize("tied", [False, True])
def test_draft_params_mask_exactly_m_nodes_as_jax(model, tied):
    """The top-m mask per head equals JAX's; with every node tied the
    lowest-indexed m survive; nothing but u_re/u_im changes."""
    jcfg, tcfg, jparams, tparams = model
    if tied:
        jparams = {**jparams, "layers": [
            {**lp, "stlt": {**lp["stlt"], "nodes": {
                k: jnp.tile(v[..., :1], (1, v.shape[-1]))
                for k, v in lp["stlt"]["nodes"].items()}}}
            for lp in jparams["layers"]]}
        tparams = convert.from_jax_params(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    m = 2
    want = j_spec.draft_params(jparams, jcfg, m)
    got = t_spec.draft_params(tparams, tcfg, m)
    for lw, lg, lp in zip(want["layers"], got["layers"], tparams["layers"]):
        kept = _np(lg["stlt"]["nodes"]["u_re"]) != 0
        assert (kept.sum(-1) == m).all()
        if tied:
            assert (kept == (np.arange(kept.shape[-1]) < m)).all()
        for k in ("u_re", "u_im"):
            np.testing.assert_array_equal(_np(lg["stlt"]["nodes"][k]),
                                          np.asarray(lw["stlt"]["nodes"][k]))
        assert lg["stlt"]["w_v"] is lp["stlt"]["w_v"]
    with pytest.raises(ValueError, match="draft_nodes must be >= 1"):
        t_spec.draft_params(tparams, tcfg, 0)


def test_ngram_draft_proposes_as_jax():
    """The JAX test's cases, then random repetitive contexts with emits."""
    for lib in (j_spec, t_spec):
        d = lib.NGramDraft(k=3, n_slots=2, max_ngram=3)
        d.on_promote(0, np.asarray([5, 6, 7, 8, 5, 6], np.int32), t0=7)
        out = d.propose(np.asarray([7, 0]), np.asarray([True, False]))
        np.testing.assert_array_equal(out, [[8, 5, 6], [0, 0, 0]])
        d.on_promote(1, np.asarray([1, 2, 3], np.int32), t0=9)
        np.testing.assert_array_equal(
            d.propose(np.asarray([7, 9]), np.asarray([False, True]))[1], [9, 9, 9])
        with pytest.raises(ValueError, match="k must be >= 1"):
            lib.NGramDraft(k=0, n_slots=1)
    rng = np.random.default_rng(5)
    drafts = [lib.NGramDraft(k=4, n_slots=3) for lib in (j_spec, t_spec)]
    for g in range(3):
        prompt, t0 = np.tile(rng.integers(0, 6, 3), 4)[: 7 + g], int(rng.integers(0, 6))
        for d in drafts:
            d.on_promote(g, prompt, t0)
    live = np.array([True, True, True])
    for _ in range(6):
        want = drafts[0].propose(np.zeros(3), live)
        np.testing.assert_array_equal(drafts[1].propose(np.zeros(3), live), want)
        for g in range(3):
            toks = list(rng.integers(0, 6, int(rng.integers(1, 4))))
            for d in drafts:
                d.on_emit(g, toks)


def test_adaptive_k_ladder_matches_jax():
    """The same observe sequence on both ladders: the same k after every
    round and the same stats, with resets and no-signal rounds."""
    rng = np.random.default_rng(1)
    ladders = [lib.AdaptiveK(k_max=8, n_slots=3, floor=0.5, window=4, recovery=2)
               for lib in (j_spec, t_spec)]
    for step in range(200):
        g = int(rng.integers(0, 3))
        if step % 37 == 36:
            for a in ladders:
                a.reset(g)
            continue
        drafted = int(rng.integers(0, 9))
        accepted = int(rng.integers(0, drafted + 1)) if rng.random() < 0.6 else 0
        for a in ladders:
            a.observe(g, drafted, accepted)
        assert [ladders[1].k_for(s) for s in range(3)] == [ladders[0].k_for(s) for s in range(3)]
    assert ladders[1].stats() == ladders[0].stats()
    assert ladders[1].stats()["adapt_shrinks"] > 0 and ladders[1].stats()["adapt_restores"] > 0
    with pytest.raises(ValueError, match="k_max must be >= 2"):
        t_spec.AdaptiveK(k_max=1, n_slots=1)


# ---------------------------------------------------------------------------
# speculative serve and the SLO ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("draft", ["ngram", "nodes"])
def test_spec_serve_matches_jax(model, jeng, plain, draft, k, monkeypatch):
    """Token for token JAX's plain greedy stream and JAX's spec serve, with
    the same spec_stats; every verify round is one dispatch, and the node
    draft's dispatches are counted apart from the target's."""
    _, tcfg, _, tparams = model
    for name, val in (("spec_k", k), ("spec_draft", draft), ("spec_draft_nodes", 2)):
        monkeypatch.setattr(jeng, name, val)
    jreqs, arrivals = _trace(JRequest)
    want = jeng.serve(jreqs, slots=3, arrivals=arrivals)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, spec_k=k,
                      spec_draft=draft, spec_draft_nodes=2, device="cpu")
    got = eng.serve(_trace(Request)[0], slots=3, arrivals=arrivals)
    _same(got, plain, f"{draft} k={k} vs JAX plain")
    _same(got, want, f"{draft} k={k} vs JAX spec")
    assert eng.spec_stats == jeng.spec_stats
    ss = eng.serve_stats
    assert ss["decode_dispatches"] == 0
    assert ss["verify_dispatches"] == eng.spec_stats["verify_calls"] > 0
    assert eng.spec_stats["emitted"] == sum(len(v) for v in want.values()) - len(want)
    if draft == "nodes":
        assert ss["draft_decode_dispatches"] == k * ss["verify_dispatches"]
        # each promoted request's prompt (one or two chunks of 8) + a commit a tick
        n_chunks = sum(-(-len(r.prompt) // CHUNK) for r in jreqs)
        assert ss["draft_prefill_dispatches"] == n_chunks + ss["verify_dispatches"]


@pytest.mark.parametrize("case", ["eos_inside_draft", "budget_1", "budget_2",
                                  "serve_nodes", "adaptive"])
def test_spec_serve_edges_match_jax(model, jeng, case, monkeypatch):
    """An EOS inside an accepted window, budgets at or below the window,
    per-request node caps, and the adaptive window (with a hostile floor):
    the port's streams and spec_stats equal JAX's, and the plain stream."""
    _, tcfg, _, tparams = model
    kw, serve_kw = dict(spec_k=4, spec_draft="ngram"), {}
    jreqs, arrivals = _trace(JRequest, n=4)
    treqs = _trace(Request, n=4)[0]
    if case == "eos_inside_draft":
        jreqs, treqs, arrivals = jreqs[:1], treqs[:1], [0]
        for r in jreqs + treqs:
            r.max_new_tokens = 12
        ref = jeng.serve(jreqs, slots=2)[0]
        kw["eos_id"] = int(ref[5])
    elif case.startswith("budget"):
        for r in jreqs + treqs:
            r.max_new_tokens = int(case[-1])
    elif case == "serve_nodes":
        kw["spec_k"] = 3
        for r in jreqs + treqs:
            r.serve_nodes = 2
    else:
        jreqs, arrivals = _trace(JRequest, budget=lambda i: 10 + i % 4)
        treqs = _trace(Request, budget=lambda i: 10 + i % 4)[0]
        kw.update(spec_adaptive=True, spec_accept_floor=0.9, spec_adapt_window=4,
                  spec_adapt_recovery=2)
    serve_kw = dict(slots=2, arrivals=arrivals)
    eos = kw.get("eos_id", -1)
    monkeypatch.setattr(jeng, "eos_id", eos)
    plain = jeng.serve(jreqs, **serve_kw)
    for name, val in kw.items():
        monkeypatch.setattr(jeng, name, val)
    want = jeng.serve(jreqs, **serve_kw)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, device="cpu", **kw)
    got = eng.serve(treqs, **serve_kw)
    _same(want, plain, f"{case}: JAX spec vs JAX plain")
    _same(got, want, case)
    assert eng.spec_stats == jeng.spec_stats
    if case == "eos_inside_draft":
        assert got[0][-1] == eos and len(got[0]) < 12
    elif case.startswith("budget"):
        assert all(len(v) == int(case[-1]) for v in got.values())
    elif case == "adaptive":
        assert eng.spec_stats["adapt_shrinks"] > 0


def test_slo_queue_depth_ladder_matches_jax():
    """The JAX package's queue-depth SLO test on the port: 4 requests on one
    slot back the queue up; the ladder steps down and fully back up, with
    the same node_stats and streams as JAX's, reset at the next serve."""
    jcfg, tcfg, jparams, tparams = _model(**ADAPTIVE_KW)
    kw = dict(max_len=64, prefill_chunk=16, slo_queue_depth=1, slo_degrade=(4, 2),
              slo_recovery_ticks=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, V, 8).astype(np.int32) for _ in range(4)]
    jeng = JServeEngine(jparams, jcfg, **kw)
    eng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    want = jeng.serve([JRequest(p, 6, id=i) for i, p in enumerate(prompts)], slots=1)
    got = eng.serve([Request(p, 6, id=i) for i, p in enumerate(prompts)], slots=1)
    _same(got, want, "SLO ladder")
    ns = eng.node_stats
    assert ns == jeng.node_stats
    assert ns["ladder"] == [4, 2] and ns["queue_breaches"] > 0 and ns["gap_breaches"] == 0
    assert ns["degrade_steps"] >= 1 and ns["ticks_degraded"] > 0
    assert ns["min_nodes"] < tcfg.stlt_nodes and ns["restore_steps"] == ns["degrade_steps"]
    assert all(len(v) == 6 for v in got.values())
    eng.serve([Request(prompts[0], 2, id=0)], slots=1)
    assert eng.node_stats["degrade_steps"] == 0


REFUSALS = [
    (dict(spec_k=-1), "spec_k must be >= 0"),
    (dict(spec_k=2, spec_draft="nope"), "unknown spec_draft"),
    (dict(spec_k=1, spec_adaptive=True), "spec_adaptive needs spec_k >= 2"),
    (dict(spec_k=2, spec_accept_floor=0.0), "spec_accept_floor must be in"),
    (dict(spec_k=2, spec_adapt_window=0), "spec_adapt_window and spec_adapt_recovery"),
    (dict(spec_k=2, spec_adapt_recovery=0), "spec_adapt_window and spec_adapt_recovery"),
    (dict(slo_degrade=(4, 2)), "needs a trigger"),
    (dict(slo_degrade=(9,), slo_queue_depth=1), "slo_degrade levels must be in"),
    (dict(slo_degrade=(0,), slo_gap_ms=5.0), "slo_degrade levels must be in"),
    (dict(slo_recovery_ticks=0), "slo_recovery_ticks must be >= 1"),
    (dict(spec_k=2, adaptive=True), "incompatible with adaptive node masks"),
]


@pytest.mark.parametrize("kw,match", REFUSALS, ids=[m for _, m in REFUSALS])
def test_constructor_refusals_match_jax(model, kw, match):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(kw)
    if kw.pop("adaptive", False):
        jcfg = dataclasses.replace(jcfg, stlt_adaptive=True)
        tcfg = dataclasses.replace(tcfg, stlt_adaptive=True)
    with pytest.raises(ValueError, match=match) as want:
        JServeEngine(jparams, jcfg, **kw)
    with pytest.raises(ValueError, match=match) as got:
        ServeEngine(tparams, tcfg, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_spec_refuses_sampling_as_jax(model, jeng, monkeypatch):
    """Greedy only: an engine temperature or a sampled request is refused
    when the serve starts, with JAX's messages."""
    _, tcfg, _, tparams = model
    p = np.arange(3, 8, dtype=np.int32)
    monkeypatch.setattr(jeng, "spec_k", 2)
    cases = [(0.7, None), (0.0, 1.0)]
    for temp, rtemp in cases:
        monkeypatch.setattr(jeng, "temperature", temp)
        eng = ServeEngine(tparams, tcfg, temperature=temp, spec_k=2, device="cpu")
        with pytest.raises(ValueError, match="greedy") as want:
            jeng.serve([JRequest(p, 4, id=0, temperature=rtemp)], slots=1)
        with pytest.raises(ValueError, match="greedy") as got:
            eng.serve([Request(p, 4, id=0, temperature=rtemp)], slots=1)
        assert str(got.value) == str(want.value)


def test_draft_and_target_pools_never_share_storage(model):
    """Aliasing regression. The port writes slot pools in place (insert at
    promote, reset at release), where JAX's pools are immutable and the node
    draft keeps its checkpoint as a plain reference. After every spec tick
    of a node-draft serve with mid-flight promotes and releases, each live
    row of the target pool and of the draft pool must equal a fresh prefill
    of exactly the tokens that row has consumed (target and draft params),
    and no tensor of one pool may share storage with the other. A decode
    step that wrote its input state, or a draft pool that viewed the
    target's, fails this."""
    _, tcfg, _, tparams = model
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, spec_k=3,
                      spec_draft="nodes", spec_draft_nodes=2, device="cpu")
    reqs, arrivals = _trace(Request)
    prompts = {r.id: r.prompt for r in reqs}
    real = eng._spec_tick
    checked = []

    def consumed_state(params, toks):
        _, st = TT.prefill(params, tcfg, torch.from_numpy(np.asarray(toks, np.int32)[None]),
                           MAX_LEN)
        return st

    def checking(run, caps):
        real(run, caps)
        ptrs = {t.data_ptr() for layer in run.pool["layers"] for t in layer.values()}
        assert not ptrs & {t.data_ptr() for layer in run.spec.pool["layers"]
                           for t in layer.values()}
        sched = run.host.sched
        for local in np.flatnonzero(sched.live):
            rid = sched.req[local].id
            toks = np.concatenate([prompts[rid], run.results[rid][:-1]])
            for pool, params in ((run.pool, eng.params), (run.spec.pool, run.spec.params)):
                want = consumed_state(params, toks)
                assert int(pool["pos"][local]) == len(toks)
                for lp, lw in zip(pool["layers"], want["layers"]):
                    for k in lw:
                        _close(lp[k][local], lw[k][0], atol=1e-4, rtol=1e-4,
                               what=f"request {rid} {k}")
            checked.append(rid)

    eng._spec_tick = checking
    eng.serve(reqs, slots=3, arrivals=arrivals)
    assert len(set(checked)) == len(reqs) and len(checked) > 2 * len(reqs)


# ---------------------------------------------------------------------------
# bf16: SmolLM-360M's STLT variant, and the variant switch
# ---------------------------------------------------------------------------


# the matrices of more than CAST_MIN elements go bf16 (both packages'
# ``cast_params_for_compute``): at the reduced widths that is every weight
# matrix and the embedding, as 65,536 selects them at full width; the
# [heads, nodes] Laplace nodes, the norms and T_hat stay fp32
CAST_MIN = 1024


@pytest.fixture(scope="module")
def bf16_model():
    """{"fp32": fp32 params, "cast": the JAX serve CLI's cast params}, each
    (jcfg, tcfg, jparams, tparams) on the same weights."""
    from repro.utils import cast_params_for_compute as j_cast
    from repro_torch.utils import cast_params_for_compute as t_cast
    from repro_torch.utils import tree_flatten_with_paths

    jcfg = j_get_config("smollm-360m", "stlt").reduced(dtype="bfloat16")
    tcfg = t_configs.get_config("smollm-360m", "stlt").reduced(dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree, tcfg, device="cpu")
    jcast = j_cast(jparams, jnp.bfloat16, min_size=CAST_MIN)
    tcast = t_cast(tparams, torch.bfloat16, min_size=CAST_MIN)
    jleaves = jax.tree_util.tree_leaves_with_path(jcast)
    assert len(jleaves) == len(tree_flatten_with_paths(tcast))
    cast = sorted(str(x.dtype) for _, x in jleaves)
    assert cast == sorted(str(x.dtype).replace("torch.", "")
                          for _, x in tree_flatten_with_paths(tcast))
    assert "bfloat16" in cast and "float32" in cast
    return {"fp32": (jcfg, tcfg, jparams, tparams),
            "cast": (jcfg, tcfg, jcast, tcast)}


def _bf16_close(got, want, what):
    """Within BF16_TOL of the scale; returns the largest error."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= BF16_TOL * (1.0 + float(np.abs(want).max())), (what, err)
    return err


def _bf16_states_close(st, sj, tcfg, what, rows=slice(None)):
    conv = convert.from_jax_state(jax.tree_util.tree_map(np.asarray, sj), tcfg,
                                  device="cpu")
    np.testing.assert_array_equal(_np(st["pos"]), _np(conv["pos"]))
    for lt, lw in zip(st["layers"], conv["layers"]):
        for k in lw:
            assert lt[k].dtype == torch.float32
            _bf16_close(lt[k][rows], lw[k][rows], f"{what} {k}")


def _bf16_spec_verify(jcfg, tcfg, jparams, tparams, toks):
    """spec_verify on a prefilled bf16 state: rows whose drafts follow JAX's
    greedy continuation fully, for one token, not at all, or are cut by
    their budget (valid 2), in turn, and one idle row (valid 0). At the
    reduced widths random-init logits sit ~1e-2 apart, a few bf16 ulps, so
    most rows hold a near tie somewhere in the window: 32 rows leave several
    decided ones. JAX's
    chunk-form logits at each window position say where the row's top-2
    margin is clear of twice the port's error in that row; greedy must
    agree at every clear position, commit on every row whose accept
    decisions all sit at clear positions, and those rows' rolled-back
    states within BF16_TOL; the idle row comes back bit for bit."""
    B, L, idle = toks.shape[0], 4, 3
    tt = torch.from_numpy(toks)
    _, sj = j_prefill(jparams, jcfg, jnp.asarray(toks[:, :24]), MAX_LEN)
    _, st = TT.prefill(tparams, tcfg, tt[:, :24], MAX_LEN)
    inputs = np.asarray(toks[:, 24:24 + L]).copy()
    full = jnp.full((B,), L, jnp.int32)
    for _ in range(L):   # each row's drafts: JAX's greedy continuation
        greedy, _, _ = j_spec_verify(jparams, jcfg, jnp.asarray(inputs), sj, full)
        inputs[:, 1:] = np.asarray(greedy)[:, :-1]
    kind = np.arange(B) % 4
    inputs[kind == 1, 2:] = (inputs[kind == 1, 2:] + 1) % tcfg.vocab
    inputs[kind == 2, 1:] = (inputs[kind == 2, 1:] + 1) % tcfg.vocab
    valid = np.where(kind == 3, 2, L).astype(np.int32)
    valid[idle] = 0
    clear = np.zeros((B, L), bool)
    for j in range(L):   # the logits after inputs[:, :j + 1], both packages
        upto = np.full(B, j + 1, np.int32)
        want, _ = j_prefill_chunk(jparams, jcfg, jnp.asarray(inputs), sj, jnp.asarray(upto))
        got, _ = TT.prefill_chunk(tparams, tcfg, torch.from_numpy(inputs), st,
                                  valid_len=torch.from_numpy(upto))
        _bf16_close(got, want, f"spec_verify window position {j}")
        want = np.asarray(want, np.float32)
        err = np.abs(_np(got) - want).max(-1)          # per row
        top2 = np.sort(want, -1)[:, -2:]
        clear[:, j] = top2[:, 1] - top2[:, 0] > 2 * err
    gj, cj, nj = j_spec_verify(jparams, jcfg, jnp.asarray(inputs), sj, jnp.asarray(valid))
    gt, ct, nt = TT.spec_verify(tparams, tcfg, torch.from_numpy(inputs), st,
                                torch.from_numpy(valid))
    gt, ct, gj, cj = _np(gt), _np(ct).astype(int), np.asarray(gj), np.asarray(cj)
    np.testing.assert_array_equal(gt[clear], gj[clear])
    # commit reads greedy at positions 0 .. valid - 2 (each draft's check)
    decided = np.array([clear[b, :max(int(valid[b]) - 1, 0)].all() for b in range(B)])
    np.testing.assert_array_equal(ct[decided], cj[decided])
    assert ct[idle] == 0
    # rows decided beside the idle one, and one of them accepted a draft
    assert decided.sum() >= 4 and (cj[decided] >= 2).any(), (clear, cj)
    _bf16_states_close(nt, nj, tcfg, "spec_verify", rows=torch.from_numpy(decided))
    for lt, l0 in zip(nt["layers"], st["layers"]):
        for k in l0:
            assert torch.equal(lt[k][idle], l0[k][idle])


BF16_PATHS = ("apply_lm", "prefill", "prefill_chunk_valid", "decode_step", "spec_verify")
BF16_CASES = [(p, w) for w in ("fp32", "cast") for p in BF16_PATHS]


@pytest.mark.parametrize("path,weights", BF16_CASES,
                         ids=[p if w == "fp32" else f"{p}-cast" for p, w in BF16_CASES])
def test_bf16_smollm_matches_jax(bf16_model, path, weights):
    """bf16 activations, as JAX types them: over fp32 params, fp32 logits
    and states; over the serve CLI's cast params (bf16 matrices), bf16
    logits and fp32 states. Each within the stated tolerance; the argmax
    agrees wherever the top-2 margin is clear of twice the error."""
    jcfg, tcfg, jparams, tparams = bf16_model[weights]
    assert tcfg.act_dtype == torch.bfloat16
    assert tparams["embed"]["embed"].dtype == (torch.float32 if weights == "fp32"
                                               else torch.bfloat16)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (32 if path == "spec_verify" else 3, 40)).astype(np.int32)
    tt = torch.from_numpy(toks)
    if path == "spec_verify":
        _bf16_spec_verify(jcfg, tcfg, jparams, tparams, toks)
        return
    if path == "apply_lm":
        want, _ = j_apply_lm(jparams, jcfg, jnp.asarray(toks))
        got, _ = TT.apply_lm(tparams, tcfg, tt)
        sj = st = None
    else:
        want, sj = j_prefill(jparams, jcfg, jnp.asarray(toks[:, :24]), MAX_LEN)
        got, st = TT.prefill(tparams, tcfg, tt[:, :24], MAX_LEN)
        if path == "prefill_chunk_valid":
            valid = np.array([16, 0, 7], np.int32)
            want, sj = j_prefill_chunk(jparams, jcfg, jnp.asarray(toks[:, 24:]), sj,
                                       jnp.asarray(valid))
            got, st = TT.prefill_chunk(tparams, tcfg, tt[:, 24:], st,
                                       valid_len=torch.from_numpy(valid))
        elif path == "decode_step":
            want, sj = j_decode_step(jparams, jcfg, jnp.asarray(toks[:, 24]), sj)
            got, st = TT.decode_step(tparams, tcfg, tt[:, 24], st)
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert got.dtype == (torch.float32 if weights == "fp32" else torch.bfloat16)
    err = _bf16_close(got, want, path)
    # two logits each off by at most err can swap only within 2 err
    want = np.asarray(want, np.float32)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * err
    assert clear.any()
    np.testing.assert_array_equal(_np(got).argmax(-1)[clear], want.argmax(-1)[clear])
    if sj is not None:
        _bf16_states_close(st, sj, tcfg, path)


@pytest.mark.parametrize("min_size", [CAST_MIN, 65536])
def test_cast_params_for_compute_matches_jax(min_size):
    """The serve CLI's mixed-precision cast casts the same leaves as the JAX
    package's, to the same values: the default 65,536 at SmolLM-360M's
    full width (d_model 960, d_ff 2560, 49,152-token vocab) picks the
    embedding and every weight matrix and leaves the [15, 32] nodes, the
    norms and T_hat fp32; the shapes here stand in for them."""
    from repro.utils import cast_params_for_compute as j_cast
    from repro_torch.utils import cast_params_for_compute as t_cast
    from repro_torch.utils import tree_flatten_with_paths

    rng = np.random.default_rng(5)
    shapes = {"embed": (300, 256), "w_v": (256, 256), "w1": (256, 300),
              "small": (64, 64), "nodes": (15, 32), "scale": (96000,), "T_hat": (15,)}
    tree = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    tree["ids"] = np.arange(70000, dtype=np.int32).reshape(2, 35000)
    want = j_cast(jax.tree_util.tree_map(jnp.asarray, tree), jnp.bfloat16,
                  min_size=min_size)
    got = t_cast({k: torch.from_numpy(v) for k, v in tree.items()}, torch.bfloat16,
                 min_size=min_size)
    for path, leaf in tree_flatten_with_paths(got):
        w = want[path]
        assert str(leaf.dtype) == f"torch.{w.dtype}", path
        np.testing.assert_array_equal(_np(leaf), np.asarray(w, np.float32), err_msg=path)
    bf16 = sorted(k for k, v in got.items() if v.dtype == torch.bfloat16)
    assert bf16 == (["embed", "small", "w1", "w_v"] if min_size == CAST_MIN
                    else ["embed", "w1"])


def test_get_config_variant_switch():
    """``variant="stlt"`` swaps SmolLM-360M's attention for the STLT, field
    for field as the JAX package does; the native form is the published
    config (attention, ported); undefined variants are refused; the MoE
    archs' STLT variants, once refused, swap their attention as the JAX
    package does and keep their experts; stlt-base is unchanged."""
    got = t_configs.get_config("smollm-360m", "stlt")
    want = j_get_config("smollm-360m", "stlt")
    for f in dataclasses.fields(TModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.block_types() == ("stlt",) * 32 and got.stlt_nodes == 32
    assert not got.stlt_adaptive and got.dtype == "bfloat16"
    assert t_configs.get_config("stlt-base") is t_configs.ARCHS["stlt-base"]
    native = t_configs.get_config("smollm-360m")
    assert native.mixer == "attention" and native.block_types() == ("attn",) * 32
    with pytest.raises(ValueError, match="STLT variant undefined"):
        t_configs.get_config("stlt-base", "stlt")
    with pytest.raises(ValueError, match="unknown variant"):
        t_configs.get_config("smollm-360m", "hybrid")
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        got, want = t_configs.get_config(arch, "stlt"), j_get_config(arch, "stlt")
        for f in dataclasses.fields(TModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.block_types() == ("stlt",) * got.num_layers and got.is_moe
