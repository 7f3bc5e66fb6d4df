"""Expert parallelism: the port's train, prefill and decode cells of the MoE
archs on 4 gloo ranks on the CPU, the experts on ``model``, against the
JAX package.

One job of 4 ranks (``tests/torch_dist_worker.py DIR RANK 4 ep``, a file
store in the test's temporary directory, one torch thread per rank) runs
every scenario once for the module; one JAX subprocess per config
(``--xla_force_host_platform_device_count=4``, all at once) compiles the
JAX package's cells (``lower_cell(build_*_step(...)).compile()``), runs its
single-device step, ``prefill`` and ``decode_step``, and differentiates its
``apply_moe`` under ``with mesh:``. fp32 reduced configs at 1 layer, with
FSDP (their configs' layout): qwen3-moe-235b-a22b native (GQA with 2 KV
heads), its STLT form (K1's algebra on each rank's heads) and arctic-480b
(the dense residual branch on ``dense_ff`` columns); 4 experts, top-2,
capacity factor 1.25, so a 4 x 72 prompt or batch drops choices.

* ``dispatch="gather"`` (the configs' default, the global view) on 2 x 2,
  1 x 4 (one expert a rank) and 4 x 1 (``model`` = 1): the train cell, 2
  steps of 4 x 72, every param within 1e-4 (1 + max |ref|) of JAX's
  compiled cell and of its single-device step, the metrics (``aux_loss``
  and ``router_z`` among them) within 1e-4 relative; the prefill cell (4 x
  72) and 3 greedy decode-cell steps from the single-device prefill's state
  at 80 positions, logits and state shards within 1e-4 (1 + max |ref|),
  greedy tokens equal; the cells' spec trees equal to JAX's; the prefill
  cell's drops summed over the ranks equal to the single-device
  ``prefill``'s, and some 2 x 2 cell drops.
* ``dispatch="shard_map"`` (per data shard capacity and positions, the aux
  losses the shards' mean): ``tensor_parallel.apply_moe_ep``'s output, aux
  losses and the grads of 1e-3 sum(y^2) + aux_loss + router_z on 2 x 2 and
  4 x 1 against JAX's ``apply_moe`` under ``with mesh:`` and
  ``jax.value_and_grad`` (a module-level check, as
  ``tests/test_distributed.py::test_shardmap_moe_matches_gather_dispatch``
  holds JAX's two dispatches together); the STLT form's prefill and decode
  cells against JAX's compiled shard_map cells on the three meshes. On jax
  0.9.0 JAX's shard_map train cell does not compile in any form
  (``ShardingTypeError``: "Contracting dimensions are sharded" in the STLT
  form, "Splitting on more than 1 axis" in the native forms), nor do the
  native forms' prefill cell ("Splitting on more than 1 axis") and decode
  cell (a scatter asking for its ``out_sharding``): no oracle there.
* The dry-run (``launch.steps.lower_cell`` on each rank's
  ``comm.RankMesh``) of every cell's first train step, prefill and first
  decode step hands each kind of collective the bytes the rank's real call
  handed it, with as many calls and scan passes; its
  ``analytic_arg_bytes`` equal the JAX dry-run's (in the JAX subprocess).
* The router's grad at 1 x 4: each rank's gates' cotangent comes from its
  own expert, so it is summed over ``model`` (``partial_replicated``)
  while the aux losses' grads, whole on every rank, are counted once; the
  rank's grad equals the single-device one, and with the sum made the
  identity it misses more than a tenth of its scale.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_lib  # noqa: E402
from repro_torch.launch import dryrun as t_dryrun  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from test_torch_tp_blocks import (JAX_CELLS, TCFG, _check_state, _close, _Coords,  # noqa: E402
                                  _flat, _jax_cfg, _norm, _rows, _state_specs)
from torch_threads import JAX_ENV, cpu_test_settings  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, N, M, D, STEPS = 4, 72, 80, 3, 2   # batch, prompt, decode cell's positions, steps
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
APPLY_MESHES = ("2x2", "4x1")
ARCHS = {"qwen3": ("qwen3-moe-235b-a22b", "native"),
         "qwen3-stlt": ("qwen3-moe-235b-a22b", "stlt"),
         "arctic": ("arctic-480b", "native")}
SM_CELL_ARCH = "qwen3-stlt"           # the one form whose JAX shard_map cells compile
CELLS = [f"{k}-{m}" for k in ARCHS for m in MESHES]
SM_CELLS = [f"sm-{SM_CELL_ARCH}-{m}" for m in MESHES]
APPLY = [f"apply-{k}-{m}" for k in ARCHS for m in APPLY_MESHES]

JAX_EP = textwrap.dedent(JAX_CELLS).rsplit("pickle.dump", 1)[0] + textwrap.dedent("""
    import dataclasses
    from repro.models import moe as JM

    smcfg = dataclasses.replace(jcfg, moe_dispatch="shard_map")
    mx = jnp.asarray(inp["moe_x"])

    def mloss(q):
        y, aux = JM.apply_moe(q, smcfg.moe_config(), mx)
        return 1e-3 * (y ** 2).sum() + aux["aux_loss"] + aux["router_z"], (y, aux)

    res["apply"] = {}
    for mname in inp["apply_meshes"]:
        mesh = jax.make_mesh(inp["meshes"][mname], ("data", "model"))
        with mesh:
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(mloss, has_aux=True))(
                p["layers"][0]["moe"])
        res["apply"][mname] = {"y": np.asarray(y), "grads": flat(g),
                               "aux": {k: float(v) for k, v in aux.items()}}
    res["sm"] = {}
    for mname in inp["sm_meshes"]:
        mesh = jax.make_mesh(inp["meshes"][mname], ("data", "model"))
        pre = S.build_prefill_step(smcfg, ShapeConfig("p", N, B, "prefill"), mesh)
        dec = S.build_decode_step(smcfg, ShapeConfig("d", M, B, "decode"), mesh)
        cp, cd = (S.lower_cell(c, mesh).compile() for c in (pre, dec))
        got = cp(put(p, pre.in_shardings[0], mesh), put(x, pre.in_shardings[1], mesh))
        steps_out, tok, st = [], tok0, np_tree(st0)
        for _ in range(D):
            logits, st = cd(put(p, dec.in_shardings[0], mesh),
                            put(tok, dec.in_shardings[1], mesh),
                            put(st, dec.in_shardings[2], mesh))
            st = np_tree(st)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            steps_out.append((np.asarray(logits), st))
        res["sm"][mname] = {"prefill": np_tree(got), "decode": steps_out}
    import os
    from repro.configs.base import TrainConfig
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD    # its import sets XLA_FLAGS; the backend is up
    os.environ["XLA_FLAGS"] = flags
    res["arg_bytes"] = {}
    for mname, shape in inp["meshes"].items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        res["arg_bytes"][mname] = {
            "train": JD.analytic_arg_bytes(S.build_train_step(
                jcfg, ShapeConfig("t", N, B, "train"), mesh, TrainConfig(**inp["tcfg"])), mesh),
            "prefill": JD.analytic_arg_bytes(S.build_prefill_step(
                jcfg, ShapeConfig("p", N, B, "prefill"), mesh), mesh),
            "decode": JD.analytic_arg_bytes(S.build_decode_step(
                jcfg, ShapeConfig("d", M, B, "decode"), mesh), mesh)}
    pickle.dump(res, open(sys.argv[2], "wb"))
""")


def _cfgs():
    out = {}
    for key, (arch, variant) in ARCHS.items():
        cfg = t_configs.get_config(arch, variant).reduced(name=f"{arch}-{variant}",
                                                          num_layers=1, fsdp=True)
        out[key] = cfg
        out[f"{key}:sm"] = dataclasses.replace(cfg, moe_dispatch="shard_map")
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep")
    cfgs = _cfgs()
    rng = np.random.default_rng(0)
    moe_x = rng.normal(size=(B, N, 64)).astype(np.float32)
    params, prompts, batches, jin = {}, {}, {}, {}
    for key in ARCHS:
        cfg = cfgs[key]
        jcfg = _jax_cfg(cfg)
        tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
        params[cfg.name] = convert.from_jax_params(tree, cfg, device="cpu")
        prompts[key] = prompts[f"{key}:sm"] = rng.integers(0, cfg.vocab, (B, N)).astype(np.int32)
        batches[key] = [{"inputs": rng.integers(0, cfg.vocab, (B, N)).astype(np.int32),
                         "labels": rng.integers(0, cfg.vocab, (B, N)).astype(np.int32)}
                        for _ in range(STEPS)]
        jin[key] = {"B": B, "N": N, "M": M, "D": D, "STEPS": STEPS, "cfg": jcfg,
                    "params": tree, "prompt": prompts[key], "batches": batches[key],
                    "tcfg": TCFG, "meshes": MESHES, "moe_x": moe_x,
                    "apply_meshes": APPLY_MESHES,
                    "sm_meshes": tuple(MESHES) if key == SM_CELL_ARCH else ()}
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    cells = {f"{k}-{m}": {"cfg": k, "mesh": shape, "train": True} for k in ARCHS
             for m, shape in MESHES.items()}
    cells.update({f"sm-{SM_CELL_ARCH}-{m}": {"cfg": f"{SM_CELL_ARCH}:sm", "mesh": shape}
                  for m, shape in MESHES.items()})
    torch.save({
        "cfgs": cfgs, "params": params, "B": B, "N": N, "M": M, "D": D, "steps": STEPS,
        "tcfg": TCFG, "prompts": {k: t(v) for k, v in prompts.items()},
        "batches": {k: [{n: t(a) for n, a in b.items()} for b in v]
                    for k, v in batches.items()},
        "cells": cells, "moe_x": t(moe_x),
        "apply": {f"apply-{k}-{m}": {"cfg": f"{k}:sm", "mesh": MESHES[m]}
                  for k in ARCHS for m in APPLY_MESHES},
        "router": {"cfg": "qwen3", "mesh": (1, 4)}, "dry": True,
    }, root / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu", **JAX_ENV)
    procs = []
    for key in ARCHS:
        with open(root / f"jax_in_{key}.pkl", "wb") as f:
            pickle.dump(jin[key], f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_EP, str(root / f"jax_in_{key}.pkl"),
             str(root / f"jax_out_{key}.pkl")], env=jenv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                                str(root), str(r), str(WORLD), "ep"], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
              for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-4000:]
    jax_out = {}
    for key in ARCHS:
        with open(root / f"jax_out_{key}.pkl", "rb") as f:
            jax_out[key] = pickle.load(f)
    return {"ranks": torch.load(root / "results.pt", weights_only=False), "jax": jax_out,
            "cfgs": cfgs}


def _cell(job, name):
    key, mname = name.rsplit("-", 1)
    key = key[len("sm-"):] if key.startswith("sm-") else key
    return (job["cfgs"][key], MESHES[mname], [r[name] for r in job["ranks"]], job["jax"][key],
            mname)


# ---------------------------------------------------------------------------
# dispatch="gather": the cells against JAX's compiled cells and one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", CELLS)
def test_train_cell_matches_jax(job, name, ref):
    """After each of 2 steps, every param (gathered from the ranks' shards;
    adafactor's factored moments reduced over the sharded dims) within 1e-4
    (1 + max |ref|) of JAX's compiled train cell and of its single-device
    step, and the loss, ce, aux_loss, router_z, reg and grad norm within
    1e-4 relative."""
    cfg, _, ranks, j, mname = _cell(job, name)
    want = j[mname]["train"] if ref == "sharded" else j["ref_train"]
    got = ranks[0]["train"]
    for step, (g, w) in enumerate(zip(got, want)):
        gp = _flat(g["params"])
        assert sorted(gp) == sorted(w["params"])
        for path, wv in w["params"].items():
            _close(gp[path], wv, f"{name} step {step} {path}")
        for k in ("loss", "ce", "reg", "aux_loss", "router_z", "s_eff", "grad_norm", "lr"):
            np.testing.assert_allclose(g["metrics"][k], w["metrics"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} step {step} {k}")


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", CELLS)
def test_prefill_cell_matches_jax(job, name, ref):
    """Every rank's last-token logits (its rows) and its shards of the
    prefill state against JAX's compiled cell and its single-device
    ``prefill``: the global view's capacity and slot positions make the
    sharded cell the one-device function."""
    cfg, shape, ranks, j, mname = _cell(job, name)
    want = j[mname]["prefill"] if ref == "sharded" else j["ref_prefill"]
    specs = _state_specs(cfg, shape)
    want_state = _flat(convert.from_jax_state(want[1], cfg, device="cpu"))
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        _close(r["prefill"][0], _rows(want[0], coords, shape, cfg), f"{name} logits")
        _check_state(_flat(r["prefill"][1]), want_state, specs, coords,
                     f"{name} rank {r['coords']}")


def _check_decode(name, cfg, shape, ranks, want, tok0):
    specs = _state_specs(cfg, shape)
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        np.testing.assert_array_equal(r["tok0"], _rows(tok0, coords, shape, cfg))
        for i, ((gl, gs), (wl, ws)) in enumerate(zip(r["decode"], want)):
            wl = _rows(np.asarray(wl), coords, shape, cfg)
            _close(gl, wl, f"{name} step {i} logits")
            np.testing.assert_array_equal(np.argmax(gl, -1), np.argmax(wl, -1))
            _check_state(_flat(gs), _flat(convert.from_jax_state(ws, cfg, device="cpu")),
                         specs, coords, f"{name} step {i} rank {r['coords']}")


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", CELLS)
def test_decode_cell_matches_jax(job, name, ref):
    """3 greedy decode-cell steps from the single-device prefill's state at
    80 positions (the 4 tokens of a step route together, capacity 8): each
    rank's tokens equal JAX's, its logits and state shards within 1e-4 (1 +
    max |ref|) of JAX's compiled cell and its ``decode_step``."""
    cfg, shape, ranks, j, mname = _cell(job, name)
    want = j[mname]["decode"] if ref == "sharded" else j["ref_decode"]
    _check_decode(name, cfg, shape, ranks, want, j["tok0"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_specs_equal_jax(job, name):
    """``in_shardings`` and ``out_shardings`` of the three cells (the
    experts ``P("model", fsdp, None)``, the router ``P(fsdp, None)``, the
    dense branch column- and row-sharded, adafactor's moments) equal the JAX
    package's spec trees leaf for leaf."""
    cfg, shape, _, j, mname = _cell(job, name)
    mesh = comm.MeshSpec(shape, ("data", "model"))
    cells = {"train": t_steps.build_train_step(cfg, ShapeConfig("t", N, B, "train"), mesh),
             "prefill": t_steps.build_prefill_step(cfg, ShapeConfig("p", N, B, "prefill"), mesh),
             "decode": t_steps.build_decode_step(cfg, ShapeConfig("d", M, B, "decode"), mesh)}
    want = j[mname]["specs"]
    for kind, prog in cells.items():
        for got, side in ((prog.in_shardings, "in"), (prog.out_shardings, "out")):
            got = {k: _norm(v) for k, v in tree_flatten_with_paths(got)}
            assert got == {k: _norm(v) for k, v in want[f"{kind}_{side}"].items()}, \
                (kind, side)


@pytest.mark.parametrize("name", CELLS)
def test_prefill_drops_equal_single_device(job, name):
    """Each rank counts the dropped choices of its experts on its rows; over
    the ranks they are the single-device ``prefill``'s (the exclusive prefix
    of the data ranks' counts gives every choice its global slot)."""
    ranks = [r[name] for r in job["ranks"]]
    key = name.rsplit("-", 1)[0]
    assert sum(r["prefill_drops"] for r in ranks) == job["ranks"][0]["single_drops"][key]


def test_some_2x2_cell_drops(job):
    """Capacity factor 1.25 at random init drops choices in a 2 x 2 cell, so
    the global capacity and the offsets are exercised."""
    assert max(sum(r[f"{k}-2x2"]["prefill_drops"] for r in job["ranks"]) for k in ARCHS) > 0


# ---------------------------------------------------------------------------
# dispatch="shard_map"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", APPLY)
def test_shardmap_apply_moe_ep_matches_jax(job, name):
    """``apply_moe_ep`` with per-shard capacity on the rank's rows and
    experts: its y (whole on every model rank) and aux losses (the batch
    shards' mean), and the grads of every MoE leaf, against JAX's
    ``apply_moe`` under ``with mesh:`` differentiated by
    ``jax.value_and_grad``."""
    key, mname = name[len("apply-"):].rsplit("-", 1)
    cfg, shape = job["cfgs"][key], MESHES[mname]
    want = job["jax"][key]["apply"][mname]
    for r in job["ranks"]:
        got = r[name]
        coords = _Coords(shape, got["coords"])
        _close(got["y"], _rows(want["y"], coords, shape, cfg), f"{name} y")
        for k in ("aux_loss", "router_z"):
            np.testing.assert_allclose(got["aux"][k], want["aux"][k], rtol=1e-5,
                                       err_msg=f"{name} {k}")
        assert sorted(got["grads"]) == sorted(want["grads"])
        for path, wv in want["grads"].items():
            _close(got["grads"][path], wv, f"{name} grad {path}")


@pytest.mark.parametrize("name", SM_CELLS)
def test_shardmap_prefill_cell_matches_jax(job, name):
    """The STLT form's prefill cell with per-shard capacity against JAX's
    compiled shard_map cell (which differs from the one-device
    ``prefill`` where a shard's capacity drops other choices)."""
    cfg, shape, ranks, j, mname = _cell(job, name)
    want = j["sm"][mname]["prefill"]
    specs = _state_specs(cfg, shape)
    want_state = _flat(convert.from_jax_state(want[1], cfg, device="cpu"))
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        _close(r["prefill"][0], _rows(want[0], coords, shape, cfg), f"{name} logits")
        _check_state(_flat(r["prefill"][1]), want_state, specs, coords,
                     f"{name} rank {r['coords']}")


@pytest.mark.parametrize("name", SM_CELLS)
def test_shardmap_decode_cell_matches_jax(job, name):
    """The STLT form's decode cell with per-shard capacity, 3 greedy steps,
    against JAX's compiled shard_map decode cell."""
    cfg, shape, ranks, j, mname = _cell(job, name)
    _check_decode(name, cfg, shape, ranks, j["sm"][mname]["decode"], j["tok0"])


# ---------------------------------------------------------------------------
# the router's grad; the refusal's removal
# ---------------------------------------------------------------------------


def test_router_grad_sums_the_ranks_gate_paths(job):
    """qwen3-moe native at 1 x 4 (one expert a rank): every rank's router
    grad equals the single-device one; with ``partial_replicated`` made the
    identity (each rank's gates' cotangent from its own expert only) it
    misses more than a tenth of its scale."""
    for r in job["ranks"]:
        got = r["router"]
        assert "model" not in got["router_spec"]      # whole on every model rank
        _close(got["router_grad"], got["router_ref"], "router")
        assert got["router_own_gap"] > 0.1 * np.abs(got["router_ref"]).max()


def test_tp_refusal_passes_the_moe_archs():
    """Both forms of both MoE archs pass ``tp_refusal`` at full width, and a
    4-rank ``model`` axis divides their experts."""
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        for variant in ("native", "stlt"):
            cfg = t_configs.get_config(arch, variant)
            assert tp_lib.tp_refusal(cfg) is None, (arch, variant)
            assert cfg.num_experts % 4 == 0


@pytest.mark.parametrize("name", CELLS + SM_CELLS)
def test_dry_run_counts_equal_each_ranks(job, name):
    """On every rank, the dry-run of the cell's first train step (the
    gather dispatch's cells), its prefill and its first decode step hands
    each kind of collective the bytes the rank's real call handed it
    (``comm.STATS``), makes as many calls of each kind (``comm.CALLS``) and
    as many scan passes: the shape-only MoE (its slot table at capacity)
    exchanges what the real one does."""
    _, _, ranks, _, _ = _cell(job, name)
    for r in ranks:
        for kind, c in r["counts"].items():
            assert c["dry"] == c["real"], (name, kind, r["coords"], c)
    assert sorted(ranks[0]["counts"]) == (["decode", "prefill"] if name in SM_CELLS
                                          else ["decode", "prefill", "train"])


@pytest.mark.parametrize("name", CELLS)
def test_analytic_arg_bytes_equal_jax(job, name):
    """The port's ``dryrun.analytic_arg_bytes`` of the train, prefill and
    decode cells (the experts' shards over ``model``, FSDP over ``data``)
    equals the JAX dry-run's, byte for byte, but for adafactor's step
    count: an int32 on the device in the JAX package, a Python int on the
    host in the port (4 bytes less in ``opt_state`` and the total)."""
    cfg, shape, _, j, mname = _cell(job, name)
    mesh = comm.MeshSpec(shape, ("data", "model"))
    cells = {"train": t_steps.build_train_step(cfg, ShapeConfig("t", N, B, "train"), mesh),
             "prefill": t_steps.build_prefill_step(cfg, ShapeConfig("p", N, B, "prefill"), mesh),
             "decode": t_steps.build_decode_step(cfg, ShapeConfig("d", M, B, "decode"), mesh)}
    for kind, prog in cells.items():
        want = dict(j["arg_bytes"][mname][kind])
        if kind == "train":
            want["opt_state"] -= 4
            want["total"] -= 4
        assert t_dryrun.analytic_arg_bytes(prog, mesh) == want, kind
