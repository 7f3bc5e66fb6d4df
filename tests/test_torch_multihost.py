"""The port's sharded serving engine (``serving/multihost.py``) and its
replicated prefix cache against the JAX package, on the CPU.

Every host of a port mesh sits on one device, so the tests run the port at
2 and 3 hosts; the JAX package's ``ShardedServeEngine`` runs on the
one-shard mesh the plain CPU run gives. Its ``serve`` raises on this jax
(ROADMAP Queue 3), so sharded streams are held to JAX's UNSHARDED
``ServeEngine.serve`` with the same total slots, token for token, and the
routing to its rule (queued + live + pending, lowest host id on ties). The
models are the JAX multihost tests' (``small_cfg`` sizes: 2 layers, d_model
32, 4 heads, 4 nodes, chunk 8, vocab 64; ``scanned_stlt`` 3 layers stacked)
with the JAX weights converted. Slot splices are held bit for bit, cache
stats exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving import ReplicatedPrefixCache as JReplicatedPrefixCache  # noqa: E402
from repro.serving import ShardedServeEngine as JShardedServeEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve as t_serve_cli  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import (PrefixCache, ReplicatedPrefixCache, Request,  # noqa: E402
                                 ShardedServeEngine, make_serve_mesh)
from repro_torch.serving.engine import _Host  # noqa: E402
from repro_torch.serving.multihost import ServeMesh  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

V, MAX_LEN, CHUNK = 64, 128, 8
SMALL = dict(name="t", family="lm", vocab=V, num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
             blockwise_threshold=10_000)
# the JAX multihost tests' kinds, and the hann form
KINDS = {"stlt": dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8),
         "attn": dict(mixer="attention"),
         "scanned_stlt": dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8, scan_layers=True,
                              num_layers=3),
         "stlt_hann": dict(mixer="stlt", stlt_window="hann", stlt_nodes=4, stlt_chunk=8)}


@functools.lru_cache(maxsize=None)
def _model(kind: str):
    fields = {**SMALL, **KINDS[kind]}
    jcfg, tcfg = JModelConfig(**fields), TModelConfig(**fields)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.from_jax_params(tree, tcfg, device="cpu"))


def _state(tree, tcfg):
    return convert.from_jax_state(jax.tree_util.tree_map(np.asarray, tree), tcfg,
                                  device="cpu")


def _bit_equal(a, b, what):
    assert len(a["layers"]) == len(b["layers"]), what
    for la, lb in zip(a["layers"], b["layers"]):
        assert sorted(la) == sorted(lb), what
        for k in lb:
            assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), (what, k)
    assert torch.equal(a["pos"], b["pos"]), what


def _engine(kind="stlt", H=2, K=2, **kw):
    _, tcfg, _, tp = _model(kind)
    return ShardedServeEngine(tp, tcfg, n_hosts=H, slots_per_host=K, max_len=MAX_LEN,
                              prefill_chunk=CHUNK, device="cpu", **kw)


# ---------------------------------------------------------------------------
# slot splicing by global id
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["stlt", "attn", "scanned_stlt"])
def test_slot_splice_by_global_id_matches_jax(kind):
    """One distinct-depth state per host (from JAX's ``prefill_chunk``,
    converted), spliced at each host's SECOND row of a 3 x 2 pool by global
    id, comes back bit for bit, and equals what JAX's ``_insert_sh`` /
    ``_extract_sh`` hand back on the one-shard mesh; untouched rows stay
    pristine and a reset restores the init row (JAX's
    ``test_sharded_slot_splice_roundtrip`` contract)."""
    jcfg, tcfg, jp, tp = _model(kind)
    H, K = 3, 2
    eng = _engine(kind, H, K)
    jeng = JShardedServeEngine(jp, jcfg, n_hosts=1, slots_per_host=K, max_len=MAX_LEN,
                               prefill_chunk=CHUNK)
    rng = np.random.default_rng(0)
    pool = TT.init_decode_state(tcfg, H * K, MAX_LEN, device="cpu")
    fresh1 = TT.init_decode_state(tcfg, 1, MAX_LEN, device="cpu")
    jfresh1 = JT.init_decode_state(jcfg, 1, MAX_LEN)
    singles = {}
    for h in range(H):
        toks = jnp.asarray(rng.integers(3, V, (1, 4 + 2 * h)), jnp.int32)
        _, st1 = JT.prefill_chunk(jp, jcfg, toks, jfresh1)
        jback = jeng._extract_sh(jeng._insert_sh(JT.init_decode_state(jcfg, K, MAX_LEN),
                                                 st1, 1), 1)
        singles[h * K + 1] = (_state(st1, tcfg), _state(jback, tcfg))
        pool = eng._ops_insert(pool, singles[h * K + 1][0], h * K + 1)
    for g, (st1, jback) in singles.items():
        got = eng._ops_extract(pool, g)
        _bit_equal(got, st1, f"slot {g}")
        _bit_equal(got, jback, f"slot {g} vs JAX's one-shard splice")
    for h in range(H):
        _bit_equal(eng._ops_extract(pool, h * K), fresh1, f"untouched slot {h * K}")
    g = (H - 1) * K + 1
    pool = eng._ops_reset(pool, g)
    _bit_equal(eng._ops_extract(pool, g), fresh1, "reset row")


# ---------------------------------------------------------------------------
# the replicated prefix cache
# ---------------------------------------------------------------------------


def test_replicated_prefix_cache_matches_jax():
    """The same insert, lookup and tick trace through JAX's and the port's
    ``ReplicatedPrefixCache`` (3 shards, capacity 3, TTL 4): pinned inserts
    on every shard and digested once, unpinned ones on the owner only, an
    eviction, a TTL expiry; every lookup's hit and length and the stats
    (per shard and in all) equal JAX's."""
    jcfg, tcfg, jp, _ = _model("stlt")
    states = []
    for n in (5, 9, 12, 7):
        toks = np.random.default_rng(n).integers(3, V, (1, n)).astype(np.int32)
        _, sj = JT.prefill(jp, jcfg, jnp.asarray(toks), MAX_LEN)
        sj = jax.tree_util.tree_map(np.asarray, sj)
        states.append((sj, _state(sj, tcfg)))
    logits = np.random.default_rng(1).normal(size=(1, V)).astype(np.float32)
    caches = (JReplicatedPrefixCache(3, capacity=3, ttl_ticks=4),
              ReplicatedPrefixCache(3, capacity=3, ttl_ticks=4))
    trace = [("insert", [1, 2, 3], 0, dict(pinned=True)),
             ("insert", [4, 4], 1, dict(shard=1)),
             ("insert", [4, 4, 5], 2, dict(shard=1)),
             ("insert", [7, 7], 3, dict(shard=2)),
             ("lookup", [4, 4, 9], None, dict(shard=1)),
             ("lookup", [4, 4, 5, 1], None, dict(shard=0)),
             ("lookup", [1, 2, 3, 8], None, dict(shard=2)),
             ("insert", [9, 9], 1, dict(shard=1)),   # shard 1 over capacity: LRU out
             ("tick", 3, None, {}),
             ("lookup", [7, 7], None, dict(shard=2)),
             ("tick", 5, None, {}),                  # [9, 9] and [4, 4] expire
             ("lookup", [9, 9], None, dict(shard=1)),
             ("lookup", [1, 2, 3], None, dict(shard=1))]
    for op, arg, si, kw in trace:
        out = []
        for c, side in zip(caches, (0, 1)):
            if op == "insert":
                c.insert(arg, states[si][side], logits if si == 0 else None, **kw)
            elif op == "lookup":
                e = c.lookup(arg, **kw)
                out.append(None if e is None else (e.n_tokens, e.pinned))
            else:
                out.append(c.tick(arg))
        assert len(set(map(str, out))) <= 1, (op, arg, out)
    sj, st = caches[0].stats(), caches[1].stats()
    assert st == sj
    assert st["replicated_pinned"] == 1 and st["replication_ok"]
    assert [len(c) for c in caches[1].shards] == [len(c) for c in caches[0].shards]
    assert caches[1].nbytes == caches[0].nbytes and len(caches[1]) == len(caches[0])


# ---------------------------------------------------------------------------
# the constructor, the mesh
# ---------------------------------------------------------------------------


def test_constructor_refusals_match_jax():
    """JAX's ``test_sharded_engine_validates_shape`` and cache checks, with
    JAX's messages; and the port's own: a mesh over distinct devices is not
    ported, nor a device other than the mesh's."""
    jcfg, tcfg, jp, tp = _model("stlt")
    cases = [(dict(prefill_chunk=0), ValueError),
             (dict(slots_per_host=0), ValueError),
             (dict(prefix_cache="bare"), TypeError),
             (dict(prefix_cache="two"), ValueError)]
    for kw, exc in cases:
        jkw, tkw = dict(kw), dict(kw)
        if "prefix_cache" in kw:
            bare = kw["prefix_cache"] == "bare"
            jkw["prefix_cache"] = JPrefixCache(capacity=4) if bare else JReplicatedPrefixCache(2)
            tkw["prefix_cache"] = PrefixCache(capacity=4) if bare else ReplicatedPrefixCache(2)
        jkw.setdefault("prefill_chunk", CHUNK)
        tkw.setdefault("prefill_chunk", CHUNK)
        with pytest.raises(exc) as want:
            JShardedServeEngine(jp, jcfg, n_hosts=1, **jkw)
        with pytest.raises(exc) as got:
            ShardedServeEngine(tp, tcfg, n_hosts=1, device="cpu", **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_hosts must be >= 1"):
        make_serve_mesh(0, "cpu")
    two = ServeMesh(devices=(torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(NotImplementedError, match="distinct devices"):
        ShardedServeEngine(tp, tcfg, mesh=two, prefill_chunk=CHUNK)
    with pytest.raises(ValueError, match="differs from the mesh"):
        ShardedServeEngine(tp, tcfg, mesh=make_serve_mesh(2, "cpu"), prefill_chunk=CHUNK,
                           device="meta")
    mesh = t_mesh.make_serve_mesh(3, "cpu")
    assert mesh.shape == {"data": 3}
    eng = ShardedServeEngine(tp, tcfg, mesh=mesh, slots_per_host=2, prefill_chunk=CHUNK)
    assert (eng.n_hosts, eng.slots_per_host, eng.n_slots) == (3, 2, 6)
    assert eng.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _rule(loads):
    """Least-loaded, the lowest host id on ties."""
    return min(range(len(loads)), key=lambda h: (loads[h], h))


def test_least_loaded_routing_on_a_hand_built_trace():
    """Hosts with load 1 (one live row), 2 (two live rows) and 1 (one
    queued request): arrivals at ticks 0, 0, 0 and 1 go to hosts 0, 2, 0
    (ties to the lowest id, each routed request adding to its host's
    load) and, at tick 1, 1; a request due later waits in the arrival queue."""
    eng = _engine("stlt", H=3, K=2)
    reqs = [Request(np.arange(3, 8, dtype=np.int32), 2, id=i) for i in range(6)]
    run = eng._serve_start([_Host(2) for _ in range(3)], [], None, None, 0, CHUNK)
    run.hosts[0].sched.live[0] = True
    run.hosts[1].sched.live[:] = True
    run.hosts[2].queue.append((0, reqs[5]))
    run.queue = [(0, reqs[0]), (0, reqs[1]), (0, reqs[2]), (1, reqs[3]), (4, reqs[4])]

    def queued():
        return [[r.id for _, r in h.queue] for h in run.hosts]
    eng._route_arrivals(run)
    assert queued() == [[0, 2], [], [5, 1]]
    run.tick = 1
    eng._route_arrivals(run)
    assert queued() == [[0, 2], [3], [5, 1]]
    assert [a for a, _ in run.queue] == [4] and sorted(run.arrival_walls) == [0, 1, 2, 3]


def test_routing_in_a_serve_follows_the_rule(monkeypatch):
    """In a staggered serve every routed request goes where the rule sends
    it, the loads read off the Schedulers before the tick's admission; each
    request's stats name that host, and both hosts serve."""
    eng = _engine("stlt", H=2, K=2)
    seen = []
    enqueue = eng._enqueue

    def spy(run, h, arrival, req):
        loads = [len(x.queue) + int(x.sched.live.sum()) + int(x.sched.pending.sum())
                 for x in run.hosts]
        seen.append((req.id, h, _rule(loads)))
        return enqueue(run, h, arrival, req)
    monkeypatch.setattr(eng, "_enqueue", spy)
    reqs, arrivals = _trace(Request, 10, 3)
    _, stats = eng.serve(reqs, arrivals=arrivals, return_stats=True)
    assert len(seen) == 10 and all(h == want for _, h, want in seen)
    assert {rid: h for rid, h, _ in seen} == {rid: s["host"] for rid, s in stats.items()}
    assert {s["host"] for s in stats.values()} == {0, 1}


# ---------------------------------------------------------------------------
# streams against JAX's unsharded engine
# ---------------------------------------------------------------------------


def _trace(kind, n, seed, base=9, stride=3):
    """JAX's multihost trace: distinct lengths and budgets, staggered
    arrivals."""
    rng = np.random.default_rng(seed)
    reqs = [kind(rng.integers(3, V, base + stride * i).astype(np.int32), 3 + i % 4, id=i)
            for i in range(n)]
    return reqs, sorted(int(a) for a in rng.integers(0, 3 * n, n))


def _spec_trace(kind, seed=15):
    """Half the prompts repeat a motif (n-gram friendly), half random."""
    r = np.random.default_rng(seed)
    prompts = [np.tile(r.integers(3, V, 4).astype(np.int32), 3) if i % 2 else
               r.integers(3, V, 7 + i).astype(np.int32) for i in range(6)]
    return [kind(p, 8 + i % 3, id=i) for i, p in enumerate(prompts)], [0, 0, 1, 3, 3, 5]


def _slo_trace(kind, seed=7):
    """Six equal requests at tick 0 on two slots: the queue backs up and
    drains in the same steps however the rows are sharded."""
    r = np.random.default_rng(seed)
    return [kind(r.integers(3, V, 10).astype(np.int32), 6, id=i) for i in range(6)], None


# case -> (kind, hosts, slots per host, engine settings, trace)
CASES = {"plain": ("stlt", 2, 2, {}, lambda k: _trace(k, 10, 3)),
         "hann": ("stlt_hann", 2, 2, {}, lambda k: _trace(k, 10, 3)),
         "spec": ("stlt", 2, 2, dict(spec_k=3, spec_draft="ngram"), _spec_trace),
         "spec_nodes": ("stlt", 2, 2, dict(spec_k=2, spec_draft="nodes", spec_draft_nodes=2),
                        _spec_trace),
         "slo": ("stlt", 2, 1, dict(slo_queue_depth=1, slo_degrade=(2, 1),
                                    slo_recovery_ticks=2), _slo_trace)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_serve_matches_jax_unsharded(case):
    """The sharded ``serve`` (plain, the hann form, n-gram and node-draft
    spec, the SLO queue-depth ladder) against JAX's unsharded
    ``ServeEngine.serve`` on H x K slots: every stream token for token;
    spec's drafted, accepted and emitted counts (per request, so
    independent of the placement; the verify calls are ticks, which
    per-host admission can shift) and the ladder's node_stats equal JAX's."""
    kind, H, K, kw, trace = CASES[case]
    jcfg, _, jp, _ = _model(kind)
    jreqs, arrivals = trace(JRequest)
    jeng = JServeEngine(jp, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK, **kw)
    want = jeng.serve(jreqs, slots=H * K, arrivals=arrivals)
    eng = _engine(kind, H, K, **kw)
    got, stats = eng.serve(trace(Request)[0], arrivals=arrivals, return_stats=True)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
    assert {s["host"] for s in stats.values()} == set(range(H))
    if case.startswith("spec"):
        per_request = ("drafted", "accepted", "emitted", "k")
        assert ({k: eng.spec_stats[k] for k in per_request}
                == {k: jeng.spec_stats[k] for k in per_request})
        assert eng.spec_stats["accepted"] > 0
        assert eng.serve_stats["decode_dispatches"] == 0
    if case == "slo":
        assert eng.node_stats == jeng.node_stats and eng.node_stats["degrade_steps"] > 0


def test_sharded_serve_with_replicated_cache_matches_jax():
    """A warmed system prompt serves from EVERY host's replica: each
    request's cached tokens cover it, each host's hits are on its own shard,
    and the streams equal JAX's unsharded engine with a plain cache."""
    jcfg, _, jp, _ = _model("stlt")
    H, K = 2, 2
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(3, V, 2 * CHUNK + 3).astype(np.int32)
    tails = [rng.integers(3, V, 4 + i).astype(np.int32) for i in range(2 * H)]
    cache = ReplicatedPrefixCache(H, capacity=32)
    eng = _engine("stlt", H, K, prefix_cache=cache)
    jeng = JServeEngine(jp, jcfg, max_len=MAX_LEN, prefill_chunk=CHUNK,
                        prefix_cache=JPrefixCache(capacity=32))
    assert eng.warm_prefix(sys_prompt) == jeng.warm_prefix(sys_prompt) == len(sys_prompt)
    st = cache.stats()
    assert st["replication_ok"] and st["replicated_pinned"] == 3   # 2 boundaries + full
    got, stats = eng.serve([Request(np.concatenate([sys_prompt, t]), 4, id=i)
                            for i, t in enumerate(tails)], return_stats=True)
    want = jeng.serve([JRequest(np.concatenate([sys_prompt, t]), 4, id=i)
                       for i, t in enumerate(tails)], slots=H * K)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"request {rid}")
        assert stats[rid]["cached_tokens"] == len(sys_prompt)
    for h in {s["host"] for s in stats.values()}:
        assert cache.shards[h].hits > 0, f"host {h} missed its replica"
    assert {s["host"] for s in stats.values()} == {0, 1}


def test_two_dispatch_shapes(monkeypatch):
    """A sharded serve over 8 distinct tail residues dispatches ONE prefill
    shape, [H*K, chunk], and warm_prefix adds [1, chunk] only; the
    monolithic prefill is never called."""
    H, K = 2, 2
    shapes = []
    chunk_fn = TT.prefill_chunk

    def spy(params, cfg, inputs, state, valid_len=None):
        shapes.append(tuple(inputs.shape))
        return chunk_fn(params, cfg, inputs, state, valid_len=valid_len)

    def never(*a, **k):
        raise AssertionError("monolithic prefill in a sharded serve")
    monkeypatch.setattr(TT, "prefill_chunk", spy)
    monkeypatch.setattr(TT, "prefill", never)
    eng = _engine("stlt", H, K, prefix_cache=ReplicatedPrefixCache(H, capacity=64))
    rng = np.random.default_rng(7)
    reqs = [Request(rng.integers(3, V, CHUNK + 1 + i).astype(np.int32), 3 + i % 3, id=i)
            for i in range(8)]
    res = eng.serve(reqs, arrivals=[0, 0, 2, 2, 5, 9, 12, 12])
    assert all(len(res[r.id]) == r.max_new_tokens for r in reqs)
    assert set(shapes) == {(H * K, CHUNK)}
    assert eng.serve_stats["admission_dispatches"] == len(shapes)
    sys_prompt = rng.integers(3, V, 2 * CHUNK + 3).astype(np.int32)
    assert eng.warm_prefix(sys_prompt) == len(sys_prompt)
    eng.serve([Request(np.concatenate([sys_prompt, rng.integers(3, V, 5 + i).astype(np.int32)]),
                       3, id=100 + i) for i in range(4)])
    assert set(shapes) == {(1, CHUNK), (H * K, CHUNK)}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "stlt-base", "--reduced", "--device", "cpu", "--requests", "5",
       "--max-new", "4", "--system-prompt-len", "20"]
REFUSALS = [(["--mesh-data", "2", "--prefill-chunk", "16", "--mode", "wave"],
             "shards the continuous engine only"),
            (["--mesh-data", "2", "--prefill-chunk", "16", "--sequential-admission"],
             "single-host legacy path"),
            (["--mesh-data", "2"], "pass --prefill-chunk N"),
            (["--mesh-data", "2", "--prefill-chunk", "16", "--role", "disagg"],
             "separate fleet layouts")]


@pytest.mark.parametrize("extra,match", REFUSALS, ids=[m for _, m in REFUSALS])
def test_cli_mesh_data_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        t_serve_cli.main(CLI + extra)


def test_cli_serves_sharded_on_the_cpu(capsys):
    """``--mesh-data 2 --slots-per-host 2``: the sharded line, every
    request, the per-host line (both hosts) and a replicated cache."""
    t_serve_cli.main(CLI + ["--mesh-data", "2", "--slots-per-host", "2",
                            "--prefill-chunk", "16"])
    out = capsys.readouterr().out
    assert "[serve] sharded: 2 hosts x 2 slots over mesh {'data': 2} on cpu" in out
    assert out.count("  req ") == 5 and "[serve] mode=continuous: 5 requests, 20 tokens" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("[serve] per-host requests: "))
    per_host = eval(line.split(": ", 1)[1])  # noqa: S307  (a dict literal)
    assert sorted(per_host) == [0, 1] and sum(per_host.values()) == 5 and min(per_host.values())
    assert "'replication_ok': True" in out
