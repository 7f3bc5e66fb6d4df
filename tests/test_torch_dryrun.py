"""The port's dry-run on the CPU: ``comm.RankMesh`` and its shape-only
collectives, K1's and K2's ops in their shape-only form on ``meta``, the
counters of ``launch/lowering.py`` and ``launch/dryrun.py``'s cells.

* A ``RankMesh`` answers ``coord``, ``axis_size``, ``group`` and
  ``member`` for its rank as ``DistMesh`` lays ranks out (row-major over
  the axis names); its collectives give the result's shape and dtype and
  count through ``comm._count`` (``STATS``, ``CALLS``, ``RESULT_BYTES``).
* K1 (``repro_torch::stlt_scan``) and K2 (``repro_torch::relevance_flash``)
  on ``meta`` give the plain versions' shapes and dtypes, count their
  launches, run no plain version, and the counters charge them the work of
  ``chip_smoke.k1_bound`` and ``k2_bound`` at every row's snapshot at N and
  every node and key live.
* The counters: a view adds no live bytes, a freed storage leaves; the
  memo that replays a repeated op gives the counts of a run without it.
* ``run_cell`` on a reduced LM cell on the 16 x 16 mesh: ``cost_corrected``
  from the depth probes equals the full count; ``main`` writes the JAX
  dry-run's keys and its tally, and records a cell whose heads do not
  divide over ``model`` as ``ok: false`` with ``ShardCtx``'s message, exit
  code 1.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import relevance_flash as k2  # noqa: E402
from repro_torch.kernels import stlt_scan as k1  # noqa: E402
from repro_torch.launch import dryrun, lowering, steps  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

META = torch.device("meta")
CFG_KW = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=True,
              mixer="stlt", stlt_nodes=4, stlt_chunk=8, stlt_adaptive=True, fsdp=True)


@pytest.fixture(autouse=True)
def _clean_stats():
    comm.reset_stats()
    yield
    comm.reset_stats()


def _reduced(arch: str, variant: str = "native", **kw) -> dict:
    """The fields ``reduced(**kw)`` changes on ``arch``: a cell's overrides."""
    full = t_configs.get_config(arch, variant)
    small = full.reduced(**kw)
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(full, f.name)}


# ---------------------------------------------------------------------------
# the shape-only rank mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 5, 13, 15])
def test_rank_mesh_coordinates_and_groups(rank):
    """Coordinates row-major over the axis names; a group's size is the
    product of its axes' sizes and the rank's index in it its coordinate
    over them in mesh order, whatever order they are named in."""
    mesh = comm.RankMesh((2, 2, 4), ("pod", "data", "model"), rank)
    want = np.unravel_index(rank, (2, 2, 4))
    assert [mesh.coord(a) for a in mesh.axis_names] == [int(w) for w in want]
    assert mesh.coord(("pod", "data")) == want[0] * 2 + want[1]
    g = mesh.group(("model", "pod"))
    assert (g.size, g.rank) == (8, int(want[0]) * 4 + int(want[2]))
    assert mesh.axis_size(("data", "model")) == 8 and mesh.size == 16
    assert mesh.member and mesh.device == META
    assert (comm.group_size(g), comm.group_rank(g)) == (g.size, g.rank)
    with pytest.raises(ValueError, match="outside a mesh of 16"):
        comm.RankMesh((2, 2, 4), ("pod", "data", "model"), 16)


def test_shape_only_collectives_give_result_shapes_and_count():
    """Each collective gives its result's shape and dtype on the input's
    device and counts what the rank hands in (``STATS``), one call
    (``CALLS``) and its result's bytes (``RESULT_BYTES``: the all-gather n
    shards, the reduce-scatter 1/n); a group of one exchanges nothing."""
    mesh = comm.RankMesh((2, 4), ("data", "model"), 6)
    g = mesh.group("model")
    x = torch.empty(3, 8, 5, device=META, dtype=torch.bfloat16)
    n = x.numel() * 2
    assert comm.all_reduce(x, g).shape == x.shape
    got = comm.all_gather(x, 1, g)
    assert (got.shape, got.dtype, got.device) == ((3, 32, 5), torch.bfloat16, META)
    assert comm.reduce_scatter(x, 1, g).shape == (3, 2, 5)
    assert comm.broadcast(x, 0, g).shape == x.shape
    recv = comm.exchange(x, 1, torch.empty(2, 2, device=META), 3, g)
    assert recv.shape == (2, 2) and comm.exchange(None, None, None, None, g) is None
    assert comm.all_gather(x, 0, mesh.group(())).shape == x.shape    # size 1
    assert comm.STATS == {k: n for k in ("all_reduce", "all_gather", "reduce_scatter",
                                         "broadcast", "p2p")}
    assert comm.CALLS == dict.fromkeys(comm.STATS, 1)
    assert comm.RESULT_BYTES == {"all_reduce": n, "all_gather": 4 * n,
                                 "reduce_scatter": n // 4, "broadcast": n, "p2p": n}
    # the Megatron operators read the group's size and rank the same way
    assert comm.gather_replicated(x, 2, g).shape == (3, 8, 20)
    assert comm.slice_replicated(x, 1, g).shape == (3, 2, 5)


# ---------------------------------------------------------------------------
# K1 and K2 in their shape-only form
# ---------------------------------------------------------------------------


def _k1_args(device, BH=6, N=37, d=16, C=8, S=4, dtype=torch.float32):
    nc = -(-N // C)
    shapes = [(BH, N, d), (BH, C, C), (BH, C, S), (BH, C, S), (BH, S, C), (BH, S, C),
              (BH, 2, S), (BH, S, d), (BH, S, d), (BH, S, C), (BH, S, C), (BH, 2, S)]
    g = torch.Generator().manual_seed(0)
    gate = torch.zeros((BH, nc), dtype=torch.int32)
    ts = [torch.randn(s, generator=g, dtype=dtype) for s in shapes]
    return [t.to(device) for t in [gate] + ts]


def test_k1_op_on_meta_gives_the_plain_versions_shapes_and_work():
    """``stlt_scan_kernel`` on meta tensors returns what the plain version
    returns on the CPU (shapes, dtypes), launches nothing (the wrapper's
    count stays), the counters count one dispatch of its op and charge it
    ``chip_smoke.k1_bound``'s flops and bytes with every row's snapshot at
    N."""
    BH, N, d, C, S = 6, 37, 16, 8, 4
    want = k1.stlt_scan_reference(*_k1_args("cpu"), chunk=C)
    before = k1.stlt_scan_kernel.launches
    args, counter = _k1_args(META), lowering._Counter()
    with counter:
        got = k1.stlt_scan_kernel(*args, chunk=C)
    assert k1.stlt_scan_kernel.launches == before
    assert counter.launches == {"stlt_scan": 1, "relevance_flash": 0}
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    assert all(t.device == META for t in got)
    _, _, _, flops, nbytes = chip_smoke.k1_bound(BH, N, d, C, S, np.full(BH, N))
    assert (counter.flops, counter.bytes) == (int(flops), nbytes)
    with pytest.raises(ValueError, match="x has dtype"):
        k1.stlt_scan_kernel(*_k1_args(META, dtype=torch.float64), chunk=C)


@pytest.mark.parametrize("stateful", [False, True])
def test_k1_scan_on_meta_runs_no_plain_version(stateful, monkeypatch):
    """``ops.stlt_scan`` on meta (the training call with its backward, and
    the stateful one through ``_aligned``, whose address check passes on
    meta) takes K1's op, never its plain version."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran on meta")

    monkeypatch.setattr(ops, "stlt_scan_reference", plain)
    monkeypatch.setattr(k1, "stlt_scan_reference", plain)
    assert ops._runner(torch.empty(1, device=META)) is k1.stlt_scan_kernel
    BH, N, d, S = 4, 40, 8, 4
    x = torch.empty(BH, N, d, device=META, requires_grad=True)
    poles = [torch.empty(BH, S, device=META, requires_grad=True) for _ in range(4)]
    before, counter = k1.stlt_scan_kernel.launches, lowering._Counter()
    with counter:
        if stateful:
            z, (h_re, h_im) = ops.stlt_scan(x, *poles, chunk=8, return_state=True,
                                            valid=torch.full((BH,), N, device=META))
            assert h_re.shape == (BH, S, d) and counter.launches["stlt_scan"] == 1
        else:
            z = ops.stlt_scan(x, *poles, chunk=8)
            z.sum().backward()
            assert x.grad.shape == x.shape and poles[0].grad.shape == (BH, S)
            assert counter.launches["stlt_scan"] == 2     # forward, dx
    assert z.shape == x.shape and k1.stlt_scan_kernel.launches == before


@pytest.mark.parametrize("causal", [True, False])
def test_k2_op_on_meta_gives_the_plain_versions_shape_and_work(causal):
    """K2 on meta through ``relevance_flash`` gives the plain version's
    shape and dtype, launches nothing, and the counters count one dispatch
    of its op and charge it ``chip_smoke.k2_bound``'s flops and bytes with
    every node and key live."""
    BH, N, dh, S = 3, 70, 16, 8
    g = torch.Generator().manual_seed(1)
    cpu = [torch.randn(BH, N, dh, generator=g), torch.randn(BH, N, dh, generator=g),
           -torch.rand(BH, S, generator=g), torch.rand(BH, S, generator=g)]
    want = k2.relevance_flash(*cpu, causal=causal, tile=32)
    before = k2.relevance_flash_kernel.launches
    counter = lowering._Counter()
    with counter:
        got = k2.relevance_flash(*(t.to(META) for t in cpu), causal=causal)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert k2.relevance_flash_kernel.launches == before
    assert counter.launches == {"stlt_scan": 0, "relevance_flash": 1}
    _, _, _, flops, nbytes = chip_smoke.k2_bound(torch.ones(BH, S), torch.ones(BH, N), dh,
                                                 causal)
    assert counter.flops == int(flops)      # the masks' elementwise ops count no flops
    args = [torch.empty(s, device=META) for s in ((BH, N, dh), (BH, N, dh), (BH, S), (BH, S),
                                                  (BH, S), (BH, N))]
    ones = lowering._Counter()
    with ones:
        k2.relevance_flash_kernel(*args, causal=causal)
    assert (ones.flops, ones.bytes) == (int(flops), nbytes)


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------


def test_counter_keys_on_storages():
    """A view shares its storage's bytes; a freed storage leaves the live
    count; the peak keeps the most live at once."""
    counter = lowering._Counter()
    with counter:
        a = torch.empty(256, device=META)
        v = a[:128].view(2, 64)
        b = a * 2
        assert counter.now == 2 * 1024
        del a, b
        assert counter.now == 1024            # v keeps a's storage alive
        del v
        c = torch.empty(16, device=META)
    assert counter.now == 64 and counter.peak == 2048
    del c
    assert counter.now == 0


def test_memo_replays_meta_ops_only():
    """Under the counter an op on the CPU runs every time (its values are
    data); a repeated op on meta is replayed with its shape and counts."""
    counter = lowering._Counter()
    with counter:
        got = [torch.arange(5) * 2 for _ in range(2)]
        metas = [torch.empty(4, 8, device=META) @ torch.empty(8, 3, device=META)
                 for _ in range(2)]
    assert all(g.tolist() == [0, 2, 4, 6, 8] for g in got)
    assert [m.shape for m in metas] == [(4, 3)] * 2 and counter.flops == 2 * 2 * 4 * 8 * 3
    assert not any(k[0] in (torch.ops.aten.arange.default, torch.ops.aten.mul.Tensor)
                   for k in counter.memo)


def test_memo_keeps_every_count(monkeypatch):
    """The memo that replays a repeated op's metadata leaves flops, bytes,
    collectives, launches and memory as a run without it gives them (a
    2 x 2 train cell with FSDP, adaptive masks and remat)."""
    cfg = ModelConfig(**CFG_KW)
    mesh = comm.RankMesh((2, 2), ("data", "model"), 3)

    def run():
        c = steps.lower_cell(steps.build_train_step(cfg, ShapeConfig("t", 40, 4, "train"),
                                                    mesh), mesh).compile()
        return (c.cost_analysis(), c.handed_in, c.calls, c.launches, c.memory_analysis())

    with_memo = run()
    monkeypatch.setattr(lowering, "_fresh", lambda func: False)
    assert run() == with_memo
    assert with_memo[3]["stlt_scan"] == 6      # 2 layers x (forward, recompute, dx)


def test_compile_leaves_the_counters_as_they_were():
    """``compile`` restores ``comm``'s counters and leaves the kernels'
    launch counts alone (nothing launches on meta); what it counted is on
    the result."""
    comm.STATS["all_reduce"] = 7
    before = k1.stlt_scan_kernel.launches
    mesh = comm.RankMesh((1, 2), ("data", "model"), 1)
    prog = steps.build_prefill_step(ModelConfig(**CFG_KW), ShapeConfig("p", 24, 2, "prefill"),
                                    mesh)
    c = steps.lower_cell(prog, mesh).compile()
    assert comm.STATS == {"all_reduce": 7} and k1.stlt_scan_kernel.launches == before
    assert c.launches["stlt_scan"] == 2 and c.handed_in["all_reduce"] > 0
    coll = c.collectives()
    assert coll["all-reduce"]["handed_in_bytes"] == c.handed_in["all_reduce"]
    assert coll["total_bytes"] == sum(c.result_bytes.values())


# ---------------------------------------------------------------------------
# run_cell and main on the production meshes (reduced widths)
# ---------------------------------------------------------------------------


def test_cost_corrected_equals_the_full_count(tmp_path):
    """An LM cell whose counts grow linearly with depth: the JAX dry-run's
    probe correction (depth 1 and 2, scaled to 4 layers) gives back the
    full run's flops, bytes accessed and collective bytes exactly."""
    rec = dryrun.run_cell("chatglm3-6b", "decode_32k", "native", False, str(tmp_path),
                          verbose=False, overrides=_reduced("chatglm3-6b", num_heads=16))
    assert rec["ok"], rec.get("error")
    raw = rec["cost_raw"]
    assert rec["cost_corrected"] == {k: raw[k] for k in ("flops", "bytes accessed",
                                                         "collective_bytes")}
    assert raw["collective_bytes"] > 0 and rec["devices"] == 256


def test_main_writes_the_jax_keys_and_refuses_what_does_not_divide(tmp_path, monkeypatch,
                                                                   capsys):
    """``main`` on chatglm3-6b's decode cell at reduced widths: with 16 heads
    it writes the JAX dry-run's keys (and the handed-in bytes beside the
    result-shape ones) and exit code 0; with reduced()'s 4 heads it records
    ``ShardCtx``'s refusal as ``ok: false`` and exits 1, as JAX's tally
    does."""
    real = t_configs.get_config
    argv = ["--arch", "chatglm3-6b", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path)]
    for heads, code in ((16, 0), (4, 1)):
        monkeypatch.setattr(t_configs, "get_config", lambda a, v="native", h=heads: real(
            a, v).reduced(num_heads=h))
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv)
        assert e.value.code == code
        rec = json.loads((tmp_path / "single" / "chatglm3-6b__decode_32k__native.json")
                         .read_text())
        tally = capsys.readouterr().out.strip().splitlines()[-1]
        if code == 0:
            assert tally == "[dryrun] done: 1 ok, 0 failed, 0 skipped-by-design"
            for key in ("arch", "shape", "variant", "mesh", "ok", "overrides", "kind",
                        "memory", "analytic_arg_bytes_per_device", "cost_raw", "devices",
                        "compile_s", "cost_corrected", "depth_probe", "wall_s"):
                assert key in rec, key
            for key in ("temp_size_in_bytes", "argument_size_in_bytes",
                        "output_size_in_bytes", "alias_size_in_bytes", "repr"):
                assert key in rec["memory"], key
            assert rec["memory"]["alias_size_in_bytes"] > 0       # the donated state
            for key in ("flops", "bytes accessed", "collective_bytes", "_collectives",
                        "collective_handed_in_bytes"):
                assert key in rec["cost_raw"], key
            assert rec["cost_raw"]["_collectives"]["all-gather"]["count"] > 0
        else:
            assert tally == "[dryrun] done: 0 ok, 1 failed, 0 skipped-by-design"
            assert rec["ok"] is False
            assert rec["error"] == ("NotImplementedError: num_heads = 4 does not divide "
                                    "over a 'model' axis of 16")
