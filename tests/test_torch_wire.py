"""The port's wire format of shipped decode states
(``repro_torch.serving.disagg.wire``) against the JAX package's, on the CPU,
and the port's prefix cache's bf16 handling.

The same states are made by the JAX package's ``prefill`` at ``small_cfg``
sizes (2 layers, ``scan_layers=False``) for every layer kind the port
serves and carried over with ``convert.from_jax_state``: the port's blob of
the converted state must be the JAX package's blob byte for byte at both
stores, and blobs must unpack across the packages. Then the port's own
round trips, the flat bytes, the rejects, and the bf16 ``state_digest``
repair (the digest of a bf16 leaf used to raise in ``.numpy()``).
"""
import dataclasses
import json
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import small_cfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving.disagg import wire as jwire  # noqa: E402
from repro.serving.prefix_cache import state_digest as j_state_digest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import PrefixCache, Request, ServeEngine  # noqa: E402
from repro_torch.serving.disagg import wire  # noqa: E402
from repro_torch.serving.disagg.failover import corrupt_blob  # noqa: E402
from repro_torch.serving.prefix_cache import state_digest  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

# the layer kinds the port serves, as tests/test_wire.py builds them
KINDS = {
    "stlt": dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8),
    "stlt_adaptive": dict(mixer="stlt", stlt_nodes=4, stlt_chunk=8, stlt_adaptive=True),
    "attn": dict(mixer="attention"),
    "attn_bf16": dict(mixer="attention"),   # its KV cache cast to bf16 (_jax_state)
    "rglru": dict(layer_types=("rglru", "rglru")),
    "xlstm": dict(family="xlstm", slstm_every=2),   # an mLSTM and an sLSTM layer
}
MAX_LEN = 64
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))


# small_cfg's fields, for the port's config
SMALL = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
             blockwise_threshold=10_000)


def _cfgs(kind):
    return small_cfg(**KINDS[kind]), TModelConfig(**{**SMALL, **KINDS[kind]})


def _jax_state(kind, n_tokens=12, seed=0):
    """A real (non-zero) batch-1 JAX decode state: a random prompt prefilled,
    as numpy leaves."""
    jcfg, _ = _cfgs(kind)
    params = JT.init_lm(jax.random.key(0), jcfg)
    prompt = np.random.default_rng(seed).integers(3, jcfg.vocab, n_tokens).astype(np.int32)
    _, state = j_prefill(params, jcfg, jnp.asarray(prompt[None]), MAX_LEN)
    state = jax.tree_util.tree_map(np.asarray, state)
    if kind == "attn_bf16":   # a bf16 model's KV cache (small widths keep fp32 matrices)
        for layer in state["layers"]:
            layer["k"], layer["v"] = (layer[k].astype(jnp.bfloat16) for k in ("k", "v"))
    return state


def _port_state(kind, jstate):
    return convert.from_jax_state(jstate, _cfgs(kind)[1], device="cpu")


def _leaves(tree) -> dict:
    return dict(tree_flatten_with_paths(tree))


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(got, want):
    """Two port trees equal leaf for leaf (dtype, shape, bits), whatever
    their dicts' key order."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(_bits(g[k]), _bits(w[k])), k


@pytest.fixture(scope="module")
def states():
    """{kind: (JAX numpy state, port state)}."""
    out = {}
    for kind in KINDS:
        js = _jax_state(kind)
        out[kind] = (js, _port_state(kind, js))
    return out


def _payload_len(blob):
    fixed = 8 + struct.calcsize("<HHII")
    _, _, hlen, mlen = struct.unpack("<HHII", blob[8:fixed])
    return len(blob) - fixed - hlen - mlen


def _header(blob):
    fixed = 8 + struct.calcsize("<HHII")
    _, flags, hlen, _ = struct.unpack("<HHII", blob[8:fixed])
    return flags, json.loads(blob[fixed:fixed + hlen])


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_blob_is_the_jax_blob(states, kind, store):
    js, ts = states[kind]
    meta = {"req_id": 3, "kind": kind}
    want = jwire.pack_state(js, store=store, meta=meta)
    got = wire.pack_state(ts, store=store, meta=meta)
    assert got == want
    if kind == "attn_bf16":   # the KV cache is bf16 already: stored as it is
        assert {e["dtype"] for e in _header(got)[1]["leaves"]} >= {"bfloat16"}


@pytest.mark.parametrize("compress", [None, "zstd"])
@pytest.mark.parametrize("kind", ["stlt_adaptive", "attn_bf16", "xlstm"])
def test_blobs_cross_unpack(states, kind, compress):
    js, ts = states[kind]
    for store in ("f32", "bf16"):
        jblob = jwire.pack_state(js, store=store, compress=compress)
        tblob = wire.pack_state(ts, store=store, compress=compress)
        # port unpacks JAX's blob: the JAX logical state, converted
        got, digest, _ = wire.unpack_state(jblob)
        want_j, want_digest, _ = jwire.unpack_state(jblob)
        assert digest == want_digest
        _same(got, _port_state(kind, jax.tree_util.tree_map(np.asarray, want_j)))
        # JAX unpacks the port's blob
        back, jdigest, _ = jwire.unpack_state(tblob)
        assert jdigest == digest
        _same(_port_state(kind, jax.tree_util.tree_map(np.asarray, back)), got)


def test_cross_unpack_with_zlib_forced(states, monkeypatch):
    """With no zstandard module both packages fall back to zlib, record it
    in the header, and read each other's blobs."""
    js, ts = states["stlt"]
    monkeypatch.setattr(wire, "_zstd", None)
    monkeypatch.setattr(jwire, "_zstd", None)
    assert wire.wire_codec("zstd") == "zlib"
    tblob = wire.pack_state(ts, compress="zstd")
    assert tblob == jwire.pack_state(js, compress="zstd")
    assert _header(tblob)[1]["codec"] == "zlib"
    _same(wire.unpack_state(tblob)[0], ts)
    jwire.unpack_state(tblob)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_roundtrip_f32_bit_exact_and_digest_stable(states, kind):
    _, ts = states[kind]
    blob = wire.pack_state(ts, meta={"kind": kind})
    out, digest, meta = wire.unpack_state(blob)
    assert meta == {"kind": kind}
    _same(out, ts)
    assert digest == state_digest(out) == state_digest(ts)
    assert wire.pack_state(out, meta={"kind": kind}) == blob
    assert any(float(t.float().abs().sum()) > 0 for t in _leaves(ts).values())


@pytest.mark.parametrize("kind", ["stlt", "stlt_adaptive", "xlstm"])
def test_roundtrip_bf16_halves_and_repacks(states, kind):
    _, ts = states[kind]
    b32, b16 = wire.pack_state(ts), wire.pack_state(ts, store="bf16")
    assert _payload_len(b16) < 0.6 * _payload_len(b32)
    out, digest, _ = wire.unpack_state(b16)
    for k, t in _leaves(ts).items():
        got = _leaves(out)[k]
        assert got.dtype == t.dtype, k
        if t.dtype == torch.float32:
            torch.testing.assert_close(got, t, rtol=1e-2, atol=1e-2)
            assert torch.equal(got, t.to(torch.bfloat16).float()), k   # RNE, as ml_dtypes
        else:
            assert torch.equal(got, t), k
    b16_again = wire.pack_state(out, store="bf16")
    assert b16_again == b16 and wire.unpack_state(b16_again)[1] == digest


def test_flat_bytes_and_attention_contrast():
    sizes = {n: len(wire.pack_state(_port_state("stlt", _jax_state("stlt", n_tokens=n))))
             for n in (4, 24, 48)}
    assert len(set(sizes.values())) == 1, sizes
    attn = len(wire.pack_state(_port_state("attn", _jax_state("attn"))))
    assert attn > 4 * sizes[4]


@pytest.mark.parametrize("compress", [None, "zstd"])
@pytest.mark.parametrize("variant", ["magic", "version", "truncate", "bitflip"])
def test_corrupt_blobs_rejected(states, variant, compress):
    _, ts = states["stlt"]
    blob = wire.pack_state(ts, compress=compress)
    bad = corrupt_blob(blob, variant)
    assert bad != blob
    with pytest.raises(ValueError):
        wire.unpack_state(bad)
    if variant == "bitflip" and compress is None:
        wire.unpack_state(bad, verify=False)   # only the digest catches it


def test_bad_magic_version_and_arguments(states):
    _, ts = states["stlt"]
    blob = wire.pack_state(ts)
    with pytest.raises(ValueError, match="magic"):
        wire.unpack_state(b"NOTAWIRE" + blob[8:])
    bad = bytearray(blob)
    struct.pack_into("<H", bad, 8, 2)
    with pytest.raises(ValueError, match="version"):
        wire.unpack_state(bytes(bad))
    with pytest.raises(ValueError, match="truncated"):
        wire.unpack_state(blob[:len(blob) - 100])
    with pytest.raises(ValueError, match="store"):
        wire.pack_state(ts, store="f16")
    with pytest.raises(ValueError, match="compress"):
        wire.pack_state(ts, compress="lz77")


def test_quantize_dequantize_helpers():
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 5, generator=g), "b": torch.arange(4, dtype=torch.int32)}
    q = wire.quantize_tree(tree)
    assert q["a"].dtype == torch.bfloat16 and q["b"].dtype == torch.int32
    d = wire.dequantize_tree(q)
    assert d["a"].dtype == torch.float32
    torch.testing.assert_close(d["a"], tree["a"], rtol=1e-2, atol=1e-2)
    assert torch.equal(wire.quantize_tree(d)["a"], q["a"])


# ---------------------------------------------------------------------------
# the prefix cache: the bf16 state_digest repair and the bf16 store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["attn_bf16", "stlt_adaptive", "xlstm"])
def test_state_digest_equals_jax(states, kind):
    """The digest of a converted state is the JAX package's, bf16 leaves
    (hashed as "bfloat16" and their raw bits) and sorted key order too."""
    js, ts = states[kind]
    assert state_digest(ts) == j_state_digest(js)


def _bf16_smollm():
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), dtype="bfloat16")
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def test_bf16_prefix_cache_warm_prefix_serves_like_no_cache():
    """The fault: ``warm_prefix`` on a bf16 attention model raised
    ``TypeError: Got unsupported ScalarType BFloat16`` in ``state_digest``.
    Repaired, a warmed system prompt serves the same streams as a serve
    without a cache."""
    cfg, params = _bf16_smollm()
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(3, cfg.vocab, 24).astype(np.int32)
    reqs = [Request(np.concatenate([sys_prompt, rng.integers(3, cfg.vocab, n).astype(np.int32)]),
                    4, id=i) for i, n in enumerate((5, 9, 3))]
    kw = dict(max_len=64, prefill_chunk=8, device="cpu")
    base = ServeEngine(params, cfg, **kw).serve(reqs, slots=2)
    cache = PrefixCache()
    eng = ServeEngine(params, cfg, prefix_cache=cache, **kw)
    assert eng.warm_prefix(sys_prompt) == 24
    out, stats = eng.serve(reqs, slots=2, return_stats=True)
    assert all(stats[r.id]["cached_tokens"] == 24 for r in reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.id], base[r.id])
    entry = cache.lookup(sys_prompt)
    assert any(t.dtype == torch.bfloat16 for t in _leaves(entry.state).values())


def test_prefix_cache_bf16_store_matches_jax(states):
    """``store_dtype="bf16"`` narrows as the JAX package's does (the same
    resident bytes and ``quant_bytes_saved``), hands out float32 copies, and
    never narrows the logits."""
    js, ts = states["stlt_adaptive"]
    prompt = np.arange(12, dtype=np.int32)
    logits_np = np.random.default_rng(0).standard_normal((1, 64)).astype(np.float32)
    logits = torch.from_numpy(logits_np.copy())
    c32, c16 = PrefixCache(max_bytes=1 << 26), PrefixCache(max_bytes=1 << 26, store_dtype="bf16")
    j16 = JPrefixCache(max_bytes=1 << 26, store_dtype="bf16")
    c32.insert(prompt, ts, logits)
    c16.insert(prompt, ts, logits)
    j16.insert(prompt, js, logits_np)
    st, sj = c16.stats(), j16.stats()
    assert {k: st[k] for k in ("bytes", "quant_bytes_saved", "store_dtype", "unique_states")} \
        == {k: sj[k] for k in ("bytes", "quant_bytes_saved", "store_dtype", "unique_states")}
    assert st["quant_bytes_saved"] > 0 and c16.nbytes < c32.nbytes
    e16, je16 = c16.lookup(prompt), j16.lookup(prompt)
    assert e16.digest == je16.digest == state_digest(ts)
    got = _leaves(e16.state)
    for k, t in _leaves(ts).items():
        assert got[k].dtype == t.dtype, k
        assert torch.equal(got[k], t.to(torch.bfloat16).float() if t.dtype == torch.float32
                           else t), k
    _same(e16.state, _port_state("stlt_adaptive", jax.tree_util.tree_map(np.asarray,
                                                                           je16.state)))
    assert torch.equal(e16.logits, logits)   # never narrowed
    resident = next(iter(c16._entries.values())).state
    assert c16.lookup(prompt).state is not resident
    assert all(t.dtype != torch.float32 or t.ndim == 0
               for t in _leaves(resident).values() if t.is_floating_point())
    # a state inserted under the digest it arrived with dedups against it
    c16.insert(np.arange(13, dtype=np.int32), ts, logits, digest=state_digest(ts))
    assert c16.stats()["dedup_hits"] == 1
    assert c16.clear() == 2 and c16.nbytes == 0 and len(c16) == 0
