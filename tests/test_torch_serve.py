"""Parity of the PyTorch port's continuous serving with the JAX package's
unsharded ``ServeEngine.serve``, on the CPU: the slot-pool ops, the three
admission routes (monolithic, coalesced two-shape masked chunks, one request
per tick), wave mode, sampled streams with the JAX package's own Gumbel
draws fed in, the prefix cache and ``warm_prefix``, and the request checks.

The model is ``test_torch_lm_serve.py``'s: ``stlt_base`` cut to 2 layers
(``reduced()`` widths, vocab 256) with ``scan_layers=True`` and the adaptive
gate scaled up so node masks vary per row, the JAX weights carried over by
``convert.from_jax_params``. One JAX engine is shared by the module (its
jitted programs compile once). Token streams are held exactly, and the
scheduler's per-request ticks and token counts equal the JAX engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.stlt_base import CONFIG as J_CONFIG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.sampler import sample_slot_tokens as j_sample_slot_tokens  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.stlt_base import CONFIG as T_CONFIG  # noqa: E402
from repro_torch.launch import serve as t_serve_cli  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import PrefixCache, Request, ServeEngine  # noqa: E402
from repro_torch.serving import sampler as t_sampler  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

MAX_LEN, CHUNK, SLOTS, V = 256, 16, 3, 256
STAT_KEYS = ("arrival", "admit", "live", "finish", "n_tokens", "prompt_tokens",
             "prefilled_tokens", "cached_tokens")
# requests of the continuous parity test: (prompt length, max_new_tokens,
# serve_nodes, arrival tick). At CHUNK = 16: 40 and 50 take three chunks
# with a tail, 21 and 33 two, 16 exactly one, 9 and 12 one tail chunk; three
# co-pend at tick 0, id 2 is prefill-only (one token), id 6 arrives after
# an idle gap.
SPEC = [(40, 5, None, 0), (21, 3, 3, 0), (9, 1, None, 0), (50, 6, None, 2),
        (16, 4, 5, 3), (33, 7, None, 9), (12, 2, None, 30)]
# (prefill_chunk, coalesce) of each admission route
ROUTES = {"monolithic": (0, True), "coalesced": (CHUNK, True),
          "one_per_tick": (CHUNK, False)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def model():
    jcfg = J_CONFIG.reduced(num_layers=2, scan_layers=True)
    tcfg = T_CONFIG.reduced(num_layers=2, scan_layers=True)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    ad = tree["layers"][0]["stlt"]["adaptive"]     # stacked [2, ...]
    ad["w_alpha"] = ad["w_alpha"] * 60.0
    ad["b_alpha"] = ad["b_alpha"] - 2.0
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def jeng(model):
    """The module's one JAX engine; tests that set ``eos_id`` or
    ``prefix_cache`` on it restore them."""
    jcfg, _, jparams, _ = model
    return JServeEngine(jparams, jcfg, max_len=MAX_LEN)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n).astype(np.int32) for n in lengths]


def _requests(kind, prompts, spec, **extra):
    return [kind(p, m, id=i, serve_nodes=c, **extra)
            for i, (p, (_, m, c, _)) in enumerate(zip(prompts, spec))]


def _same_streams_and_stats(got, want, stats_t=None, stats_j=None):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
    if stats_j is not None:
        for rid in want:
            for k in STAT_KEYS:
                assert stats_t[rid][k] == stats_j[rid][k], (rid, k)
            assert len(stats_t[rid]["token_walls"]) == len(got[rid])


@pytest.fixture(scope="module")
def eos(jeng):
    """An eos id that cuts the coalesced run's longest request short: its
    third token in an eos-free run."""
    prompts = _prompts(0, [s[0] for s in SPEC])
    res = jeng.serve(_requests(JRequest, prompts, SPEC), slots=SLOTS,
                     arrivals=[s[3] for s in SPEC], prefill_chunk=CHUNK)
    return int(res[5][2])


# ---------------------------------------------------------------------------
# the slot pool
# ---------------------------------------------------------------------------


def test_slot_ops_round_trip_and_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _prompts(1, [7])[0][None]
    _, sj = JT.prefill(jparams, jcfg, jnp.asarray(toks), MAX_LEN)
    _, st = TT.prefill(tparams, tcfg, torch.from_numpy(toks), MAX_LEN)
    pool = TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")
    pristine = TT.extract_slot(pool, 0, tcfg)
    TT.insert_slot(pool, st, 1, tcfg)
    got = TT.extract_slot(pool, 1, tcfg)
    want = convert.from_jax_state(jax.tree_util.tree_map(
        np.asarray, JT.extract_slot(JT.insert_slot(JT.init_decode_state(jcfg, 3, MAX_LEN),
                                                   sj, 1, jcfg), 1, jcfg)),
        tcfg, device="cpu")
    for lg, ls, lw in zip(got["layers"], st["layers"], want["layers"]):
        for k in ls:
            torch.testing.assert_close(lg[k], ls[k], rtol=0, atol=0)
            torch.testing.assert_close(lg[k], lw[k], rtol=0, atol=1e-4 * (1 + float(lw[k].abs().max())))
    assert int(got["pos"][0]) == int(want["pos"][0]) == 7
    for nb in (0, 2):   # neighbours untouched
        for lp, lq in zip(TT.extract_slot(pool, nb, tcfg)["layers"], pristine["layers"]):
            assert all(torch.equal(lp[k], lq[k]) for k in lq)
    # extract returns a copy: resetting the row leaves it as it was
    TT.reset_slot(pool, 1, tcfg, MAX_LEN)
    for lg, ls in zip(got["layers"], st["layers"]):
        assert all(torch.equal(lg[k], ls[k]) for k in ls)
    for lp, lq in zip(pool["layers"], TT.init_decode_state(tcfg, 3, MAX_LEN, device="cpu")["layers"]):
        assert all(torch.equal(lp[k], lq[k]) for k in lq)
    assert int(pool["pos"].abs().sum()) == 0


# ---------------------------------------------------------------------------
# continuous serve, wave mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_continuous_serve_matches_jax(model, jeng, eos, route, monkeypatch):
    """Greedy streams token for token and every request's ticks and counts
    equal to the JAX engine's, with staggered arrivals, mixed serve_nodes,
    an eos id and a prefill-only request; the coalesced route dispatches at
    [1, chunk] and [slots, chunk] only, the one-per-tick route at batch 1."""
    _, tcfg, _, tparams = model
    prompts = _prompts(0, [s[0] for s in SPEC])
    arrivals = [s[3] for s in SPEC]
    chunk, coalesce = ROUTES[route]
    monkeypatch.setattr(jeng, "eos_id", eos)
    want, stats_j = jeng.serve(_requests(JRequest, prompts, SPEC), slots=SLOTS,
                               arrivals=arrivals, return_stats=True,
                               prefill_chunk=chunk, coalesce=coalesce)
    shapes = []
    real = TT.prefill_chunk

    def recording(params, cfg, inputs, state, valid_len=None):
        shapes.append(tuple(inputs.shape))
        return real(params, cfg, inputs, state, valid_len=valid_len)

    monkeypatch.setattr(TT, "prefill_chunk", recording)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, eos_id=eos,
                      prefill_chunk=chunk, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, SPEC), slots=SLOTS,
                             arrivals=arrivals, return_stats=True, coalesce=coalesce)
    _same_streams_and_stats(got, want, stats_t, stats_j)
    assert any(len(got[r]) < SPEC[r][1] and got[r][-1] == eos for r in got)
    assert len(got[2]) == 1
    if route == "coalesced":
        assert set(shapes) == {(1, CHUNK), (SLOTS, CHUNK)}, shapes
    elif route == "one_per_tick":
        assert {s[0] for s in shapes} == {1} and (1, 8) in shapes and (1, CHUNK) in shapes
    else:
        assert not shapes
    assert eng.serve_stats["admission_dispatches"] == (
        len(SPEC) if route == "monolithic" else len(shapes))


def test_wave_mode_matches_jax(model, jeng):
    """Waves padded to their longest prompt, drained before the next."""
    _, tcfg, _, tparams = model
    prompts = _prompts(2, [s[0] for s in SPEC])
    arrivals = [s[3] for s in SPEC]
    want, stats_j = jeng.serve(_requests(JRequest, prompts, SPEC), slots=SLOTS,
                               mode="wave", arrivals=arrivals, return_stats=True)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    got, stats_t = eng.serve(_requests(Request, prompts, SPEC), slots=SLOTS,
                             mode="wave", arrivals=arrivals, return_stats=True)
    _same_streams_and_stats(got, want, stats_t, stats_j)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


class JaxDraws:
    """The JAX engine's per-request Gumbel draws: token 0 from
    ``split(fold_in(key(seed), id))[1]``, token t >= 1 from the t-th
    ``split`` of the carried half (its second output), as
    ``jax.random.categorical`` draws them (``gumbel(key, (V,))``)."""

    def __init__(self, seed: int):
        self.base = jax.random.key(seed)
        self.keys: dict = {}

    def __call__(self, rid, step):
        if rid not in self.keys:
            carry, k0 = jax.random.split(jax.random.fold_in(self.base, rid))
            self.keys[rid] = ([k0], carry)
        subs, carry = self.keys[rid]
        while len(subs) <= step:
            carry, sub = jax.random.split(carry)
            subs.append(sub)
        self.keys[rid] = (subs, carry)
        return np.array(jax.random.gumbel(subs[step], (V,), jnp.float32))


@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_slot_tokens_matches_jax(top_k):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, V)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 1.6], np.float32)
    keys = jax.random.split(jax.random.key(1), 4)
    want = j_sample_slot_tokens(jnp.asarray(logits), keys, jnp.asarray(temps), top_k)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (V,), jnp.float32)) for k in keys])
    got = t_sampler.sample_slot_tokens(torch.from_numpy(logits), torch.from_numpy(noise),
                                       torch.from_numpy(temps), top_k)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert int(got[0]) == int(np.argmax(logits[0]))


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_sampled_streams_match_jax_with_its_draws(model, jeng, mode):
    """Per-request temperatures (one greedy row) with the JAX draws fed in."""
    _, tcfg, _, tparams = model
    spec = SPEC[:5]
    temps = [0.8, None, 1.0, 1.3, 0.9]
    prompts = _prompts(4, [s[0] for s in spec])
    kw = dict(slots=SLOTS, arrivals=[s[3] for s in spec], rng_seed=7, mode=mode)
    chunk = CHUNK if mode == "continuous" else 0

    def reqs(kind):
        return [dataclasses.replace(r, temperature=t)
                for r, t in zip(_requests(kind, prompts, spec), temps)]

    want = jeng.serve(reqs(JRequest), prefill_chunk=chunk, **kw)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                      device="cpu", noise=JaxDraws)
    got = eng.serve(reqs(Request), **kw)
    _same_streams_and_stats(got, want)
    greedy = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefill_chunk=chunk,
                         device="cpu").serve(_requests(Request, prompts, spec), **kw)
    assert any(not np.array_equal(got[r], greedy[r]) for r in got)
    np.testing.assert_array_equal(got[1], greedy[1])


def test_default_noise_streams_are_locked_across_modes(model):
    """Equal-length prompts (wave padding is then a no-op): continuous and
    wave mode replay each request's stream exactly, and a rerun does too."""
    _, tcfg, _, tparams = model
    def engine(chunk):
        return ServeEngine(tparams, tcfg, max_len=MAX_LEN, temperature=1.0, top_k=20,
                           prefill_chunk=chunk, device="cpu")

    chunked, monolithic = engine(CHUNK), engine(0)
    reqs = [Request(p, 5, id=i) for i, p in enumerate(_prompts(5, [12] * 4))]
    cont = chunked.serve(reqs, slots=2, rng_seed=3)
    wave = chunked.serve(reqs, slots=4, mode="wave", rng_seed=3)
    again = monolithic.serve(reqs, slots=3, rng_seed=3)
    other = chunked.serve(reqs, slots=2, rng_seed=4)
    for r in reqs:
        np.testing.assert_array_equal(cont[r.id], wave[r.id])
        np.testing.assert_array_equal(cont[r.id], again[r.id])
    assert any(not np.array_equal(cont[r.id], other[r.id]) for r in reqs)


# ---------------------------------------------------------------------------
# the prefix cache
# ---------------------------------------------------------------------------


def _cache_script(cache, state):
    """The same operations on either package's cache; returns what each
    lookup found and the stats after every operation (common keys)."""
    keys = ("entries", "bytes", "hits", "misses", "pinned", "unique_states",
            "dedup_hits", "bytes_saved", "ttl_evictions", "clock")
    out = []
    ops = [("insert", [1, 2], 1, False), ("insert", [1, 2, 3], 2, False),
           ("insert", [9, 9], 1, False),            # content dedup of state 1
           ("insert", [5, 5, 5], 3, True),          # pinned
           ("lookup", [1, 2, 3, 4]), ("lookup", [1, 2, 7]), ("lookup", [8]),
           ("insert", [6], 4, False),               # over capacity: LRU out
           ("tick", 3), ("lookup", [9, 9, 1]),
           ("insert", [7, 7], 5, False, 40),        # big: over max_bytes
           ("tick", 4),                             # TTL expiries
           ("insert", [1, 2], 2, False),            # replaced key, dedup of 2
           ("lookup", [5, 5, 5, 5]), ("lookup", [1, 2]), ("tick", 9),
           ("lookup", [1, 2, 3]), ("lookup", [5, 5, 5])]
    for op in ops:
        if op[0] == "insert":
            size = op[4] if len(op) > 4 else 8
            cache.insert(op[1], {"h": state(op[2], size), "pos": state(op[2], 1)},
                         logits=state(-op[2], 4) if op[3] else None, pinned=op[3])
        elif op[0] == "lookup":
            e = cache.lookup(op[1])
            out.append(None if e is None else (e.n_tokens, e.pinned))
        else:
            out.append(cache.tick(op[1]))
        s = cache.stats()
        out.append({k: s[k] for k in keys})
    return out


def test_prefix_cache_matches_jax_sequence():
    """LRU, the entry and byte caps, TTL, content dedup and pinning: the
    same hits, misses, evictions and stats after every operation."""
    want = _cache_script(JPrefixCache(capacity=4, max_bytes=300, ttl_ticks=5),
                         lambda v, n: np.full(n, v, np.float32))
    got = _cache_script(PrefixCache(capacity=4, max_bytes=300, ttl_ticks=5),
                        lambda v, n: torch.full((n,), float(v)))
    assert got == want
    flat = [x for x in want if isinstance(x, dict)]
    assert flat[-1]["ttl_evictions"] > 0 and max(s["dedup_hits"] for s in flat) > 0


def test_warm_prefix_and_cached_serve_match_jax(model, jeng, monkeypatch):
    """A 24-token system prompt warmed at chunk 16 (entries at 16 and at the
    exact, non-boundary 24), then requests sharing it, one equal to it (a
    full-prompt hit) and one sharing only its first 20 tokens: streams,
    ticks, cached/prefilled tokens and the cache's stats as JAX's."""
    _, tcfg, _, tparams = model
    sys_prompt = _prompts(6, [24])[0]
    tails = _prompts(7, [5, 30, 0, 11, 3])
    prompts = [np.concatenate([sys_prompt, t]) for t in tails]
    prompts.append(np.concatenate([sys_prompt[:20], _prompts(8, [6])[0]]))
    spec = [(len(p), 3 + i % 3, None, i) for i, p in enumerate(prompts)]
    jcache = JPrefixCache(ttl_ticks=6)
    monkeypatch.setattr(jeng, "prefix_cache", jcache)
    tcache = PrefixCache(ttl_ticks=6)
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefix_cache=tcache,
                      prefill_chunk=CHUNK, device="cpu")
    assert eng.warm_prefix(sys_prompt) == jeng.warm_prefix(sys_prompt, chunk=CHUNK) == 24
    assert sorted(tcache._lengths) == sorted(jcache._lengths) == [16, 24]
    kw = dict(slots=SLOTS, arrivals=[s[3] for s in spec], return_stats=True)
    want, stats_j = jeng.serve(_requests(JRequest, prompts, spec), prefill_chunk=CHUNK, **kw)
    got, stats_t = eng.serve(_requests(Request, prompts, spec), **kw)
    _same_streams_and_stats(got, want, stats_t, stats_j)
    assert [stats_t[i]["cached_tokens"] for i in range(6)] == [24, 24, 24, 24, 24, 16]
    sj, st = jcache.stats(), tcache.stats()
    assert {k: st[k] for k in st} == {k: sj[k] for k in st}
    assert eng.warm_prefix(sys_prompt) == 0


class _RecordingCache(PrefixCache):
    """Keeps a copy of every state as it was inserted."""

    def __init__(self):
        super().__init__(capacity=64)
        self.copies = []

    def insert(self, tokens, state, logits=None, pinned=False):
        copy = {"layers": [{k: t.clone() for k, t in layer.items()}
                           for layer in state["layers"]]}
        self.copies.append((np.asarray(tokens).copy(), copy))
        super().insert(tokens, state, logits, pinned)


def test_cached_entry_is_unchanged_after_its_row_is_reused(model):
    """A prefill-only request finishes in the coalesced dispatch while
    another is still pending; its full-prompt state goes to the cache and its
    row of the prefill pool is refilled by the next request at once. The
    cache must hold a copy, not a view of that row."""
    _, tcfg, _, tparams = model
    cache = _RecordingCache()
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, prefix_cache=cache,
                      prefill_chunk=CHUNK, device="cpu")
    prompts = _prompts(9, [40, 10, 30, 20])
    reqs = [Request(prompts[0], 3, id=0), Request(prompts[1], 1, id=1),
            Request(prompts[2], 2, id=2), Request(prompts[3], 2, id=3)]
    eng.serve(reqs, slots=2, arrivals=[0, 0, 1, 1])
    assert len(cache.copies) >= 3
    for tokens, copy in cache.copies:
        entry = cache.lookup(tokens)
        assert entry.n_tokens == len(tokens)
        for le, lc in zip(entry.state["layers"], copy["layers"]):
            assert all(torch.equal(le[k], lc[k]) for k in lc), len(tokens)


# ---------------------------------------------------------------------------
# request checks, the CLI
# ---------------------------------------------------------------------------


def test_request_checks_raise_as_jax(model, jeng):
    _, tcfg, _, tparams = model
    eng = ServeEngine(tparams, tcfg, max_len=MAX_LEN, device="cpu")
    p = np.arange(3, 9, dtype=np.int32)
    bad = [
        (dict(requests=[(p, 2, 0, None), (p, 2, 0, None)]), "duplicate request ids"),
        (dict(requests=[(p, 0, 0, None)]), "max_new_tokens must be >= 1"),
        (dict(requests=[(p, 2, 0, 0)]), "serve_nodes must be in"),
        (dict(requests=[(p, 2, 0, tcfg.stlt_nodes + 1)]), "serve_nodes must be in"),
        (dict(requests=[(p, 2, 0, None)], prompt_len=4), "exceeds prompt_len"),
        (dict(requests=[(p, 2, 0, None)], arrivals=[0, 1]), "arrivals has 2 entries"),
        (dict(requests=[(p, 2, 0, None)], slots=0), "slots must be >= 1"),
        (dict(requests=[(p, 2, 0, None)], mode="bogus"), "unknown serve mode"),
    ]
    for kw, match in bad:
        for kind, e in ((JRequest, jeng), (Request, eng)):
            args = dict(kw)
            args["requests"] = [kind(q, m, id=i, serve_nodes=c)
                                for q, m, i, c in kw["requests"]]
            with pytest.raises(ValueError, match=match):
                e.serve(**{"slots": 2, **args})
    # the JAX engine takes prefill_chunk per call, the port's at construction
    with pytest.raises(ValueError, match="prefill_chunk must be >= 0"):
        jeng.serve([JRequest(p, 2, id=0)], slots=2, prefill_chunk=-1)
    with pytest.raises(ValueError, match="prefill_chunk must be >= 0"):
        ServeEngine(tparams, tcfg, prefill_chunk=-1, device="cpu")
    with pytest.raises(ValueError, match="serve_nodes"):
        ServeEngine(tparams, tcfg, serve_nodes=0, device="cpu")
    with pytest.raises(ValueError, match="warm_prefix requires a prefix_cache"):
        eng.warm_prefix(p)
    # speculative decoding and the SLO ladder: refused as the JAX engine
    # refuses them (stlt-base's node masks are adaptive; a ladder needs a
    # trigger)
    jcfg, jparams = model[0], model[2]
    for kw, match in ((dict(spec_k=2), "incompatible with adaptive node masks"),
                      (dict(slo_degrade=(4, 2)), "slo_degrade needs a trigger")):
        with pytest.raises(ValueError, match=match):
            JServeEngine(jparams, jcfg, **kw)
        with pytest.raises(ValueError, match=match):
            ServeEngine(tparams, tcfg, device="cpu", **kw)


SPEC_CLI = ["--arch", "smollm-360m", "--variant", "stlt", "--spec-k", "3",
            "--spec-draft", "nodes", "--slo-degrade", "4,2", "--slo-queue-depth", "2"]


@pytest.mark.parametrize("mode,extra", [("continuous", []), ("wave", []),
                                        ("continuous", SPEC_CLI)],
                         ids=["continuous", "wave", "spec"])
def test_serve_cli_runs_on_the_cpu(capsys, mode, extra):
    """The CLI on the CPU; the spec case serves SmolLM-360M's STLT variant
    (bf16) with the node draft and the SLO ladder."""
    arch = [] if extra else ["--arch", "stlt-base"]
    t_serve_cli.main(arch + ["--reduced", "--device", "cpu",
                             "--requests", "5", "--slots", "2", "--max-new", "4",
                             "--prefill-chunk", "16", "--system-prompt-len", "20",
                             "--mode", mode] + extra)
    out = capsys.readouterr().out
    assert out.count("  req ") == 5 and f"[serve] mode={mode}: 5 requests, 20 tokens" in out
    assert ("prefilled" in out) == (mode == "continuous")
    if extra:
        assert "[serve] spec: {'verify_calls': " in out and "[serve] slo: " in out
        assert "'verify_dispatches'" in out and "'draft_prefill_dispatches'" in out
