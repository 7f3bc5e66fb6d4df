"""The PyTorch port's checkpoints (``repro_torch.checkpoint``) on the CPU:
the counterparts of tests/test_checkpoint.py (roundtrip, a partial write is
invisible, manifest validation, rotation, async save and resume, a fresh
start), and the on-disk format held to the JAX package's both ways: the
port reads what ``repro.checkpoint`` writes and the JAX package reads what
the port writes, bf16 leaves and the optimizer's int count included.
``from_jax_checkpoint`` rebuilds a JAX-written tree from the manifest's
names. Values must come back bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.checkpoint.checkpointer import SHARD_LEAVES, latest_step  # noqa: E402
from repro_torch.convert import _nest  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths, tree_map  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)


@pytest.fixture
def tree():
    """The JAX test's tree in the port's form: the count is a Python int."""
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"mu": torch.ones((5,)), "count": 7}}


def _zeros_like(tree):
    return tree_map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
                    tree)


def _assert_equal(got, want):
    got, want = tree_flatten_with_paths(got), tree_flatten_with_paths(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, path
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)
        else:
            assert type(a) is int and a == b, path


def test_roundtrip(tmp_path, tree):
    save_checkpoint(str(tmp_path), 42, tree)
    restored, step = load_checkpoint(str(tmp_path), _zeros_like(tree))
    assert step == 42
    _assert_equal(restored, tree)


def test_partial_write_is_invisible(tmp_path, tree):
    """A .tmp dir (a crash mid-save) is never picked up."""
    save_checkpoint(str(tmp_path), 10, tree)
    os.makedirs(tmp_path / "step_00000020.tmp")
    (tmp_path / "step_00000020.tmp" / "shard_0000.npz").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 10
    assert CheckpointManager(str(tmp_path)).latest_step() == 10


def test_manifest_validation_rejects_mismatches(tmp_path, tree):
    """Shape, name and leaf count are checked before any array is read (the
    shard is made unreadable first)."""
    save_checkpoint(str(tmp_path), 1, tree)
    (tmp_path / "step_00000001" / "shard_0000.npz").write_bytes(b"garbage")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros((2, 2)), "opt": tree["opt"]})
    with pytest.raises(ValueError, match="leaf mismatch"):
        load_checkpoint(str(tmp_path), {"v": tree["w"], "opt": tree["opt"]})
    with pytest.raises(ValueError, match="3 leaves"):
        load_checkpoint(str(tmp_path), {"w": tree["w"]})


def test_rotation_keeps_newest_and_periodic(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, keep_period=100,
                            async_saves=False)
    for s in [50, 100, 150, 200, 250]:
        mgr.save(s, tree)
    kept = sorted(int(d[5:]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == [100, 200, 250]  # the 2 newest + the keep_period multiples


def test_async_save_and_resume(tmp_path, tree):
    """Two queued saves, ``wait``, then ``restore_or_init`` finds the later;
    a failing save surfaces at the next ``save`` and at ``wait``."""
    mgr = CheckpointManager(str(tmp_path), async_saves=True)
    mgr.save(5, tree)
    mgr.save(9, tree)
    mgr.wait()
    restored, step = mgr.restore_or_init(lambda: _zeros_like(tree))
    assert step == 9
    _assert_equal(restored, tree)
    bad = CheckpointManager(str(tmp_path / "bad"), async_saves=True)
    bad.save(1, {"x": object()})       # not a tensor or an int: the worker fails
    with pytest.raises(RuntimeError, match="async save failed") as err:
        bad.wait()
    assert isinstance(err.value.__cause__, TypeError)
    with pytest.raises(RuntimeError, match="previous async save failed"):
        bad.save(2, tree)


def test_restore_or_init_fresh(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    restored, step = mgr.restore_or_init(lambda: tree)
    assert step == -1 and restored is tree


def _jax_tree():
    r = np.random.default_rng(0)
    return {"params": {"w": jnp.asarray(r.normal(size=(3, 4)).astype(np.float32)),
                       "layers": [{"b": jnp.arange(3, dtype=jnp.float32)},
                                  {"b": jnp.ones((3,), jnp.float32)}],
                       "h": jnp.asarray(r.normal(size=(2, 2)), jnp.bfloat16)},
            "opt": {"count": jnp.asarray(7, jnp.int32),
                    "mu": jnp.full((5,), 0.5, jnp.bfloat16)}}


def _as_port(jtree):
    """The JAX tree's values in the port's form (int count, bf16 tensors),
    its dicts in insertion order reversed (the port's own order is not
    JAX's sorted one)."""
    def conv(x):
        if x.ndim == 0 and x.dtype == jnp.int32:
            return int(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    def rev(t):
        if isinstance(t, dict):
            return {k: rev(t[k]) for k in reversed(list(t))}
        if isinstance(t, list):
            return [rev(v) for v in t]
        return conv(t)
    return rev(jtree)


def test_format_matches_the_jax_package_both_ways(tmp_path):
    """The same tree written by the JAX package and by the port: identical
    manifests (names, keys, shards, shapes, dtypes; bf16 as "bfloat16", the
    count as a 0-d int32) and identical arrays; each reads the other's
    checkpoint back bit for bit."""
    jtree = _jax_tree()
    ptree = _as_port(jtree)
    j_save(str(tmp_path / "jax"), 3, jtree)
    save_checkpoint(str(tmp_path / "port"), 3, ptree)
    manifests = [json.loads((tmp_path / d / "step_00000003" / "MANIFEST.json").read_text())
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    dtypes = {m["name"]: m["dtype"] for m in manifests[0]["leaves"]}
    assert dtypes["opt/count"] == "int32" and dtypes["params/h"] == "bfloat16"
    arrays = [np.load(tmp_path / d / "step_00000003" / "shard_0000.npz") for d in ("jax", "port")]
    for key in arrays[0].files:
        assert arrays[0][key].tobytes() == arrays[1][key].tobytes(), key
    # the port reads the JAX package's checkpoint, by name
    restored, step = load_checkpoint(str(tmp_path / "jax"), _zeros_like(ptree))
    assert step == 3
    _assert_equal(restored, ptree)
    # the JAX package reads the port's (bf16 comes back as raw 2-byte values)
    got, _ = j_load(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jtree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_many_leaves_span_shards(tmp_path):
    """More than SHARD_LEAVES leaves go to a second shard file; restore reads
    each leaf from its own shard."""
    tree = {"layers": [{"w": torch.full((2,), float(i))} for i in range(SHARD_LEAVES + 3)]}
    save_checkpoint(str(tmp_path), 0, tree)
    manifest = json.loads((tmp_path / "step_00000000" / "MANIFEST.json").read_text())
    assert manifest["num_shards"] == 2
    assert {m["shard"] for m in manifest["leaves"][-3:]} == {1}
    restored, _ = load_checkpoint(str(tmp_path), _zeros_like(tree))
    _assert_equal(restored, tree)


def test_nest_rebuilds_lists_from_numeric_names():
    """``from_jax_checkpoint``'s tree from "/"-names: numeric levels become
    lists in index order, whatever order the names come in (JAX sorts
    "10" before "2"); a gap in the indices is refused."""
    pairs = [("opt/count", 1), ("params/layers/10/b", 3), ("params/embed", 0)] + \
        [(f"params/layers/{i}/b", i) for i in range(10)]
    got = _nest(pairs)
    assert got == {"opt": {"count": 1}, "params": {
        "layers": [{"b": i} for i in range(10)] + [{"b": 3}], "embed": 0}}
    with pytest.raises(ValueError, match="not 0..1"):
        _nest([("layers/0/b", 0), ("layers/2/b", 1)])
