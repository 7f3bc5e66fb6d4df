"""Tensor parallelism beyond the STLT block: the port's train, prefill and
decode cells of the attention LMs and of recurrentgemma-9b on 4 gloo ranks
on the CPU, against the JAX package.

One job of 4 ranks (``tests/torch_dist_worker.py DIR RANK 4 tp``, a file
store in the test's temporary directory, one torch thread per rank) runs
every cell once for the module; one JAX subprocess per config
(``--xla_force_host_platform_device_count=4``, all at once) compiles the
JAX package's cells (``lower_cell(build_*_step(...)).compile()``) on the
same meshes and runs its single-device step, ``prefill`` and
``decode_step``. fp32 reduced configs: qwen2-1.5b (q/k/v biases, tied
head), chatglm3-6b and granite-20b with FSDP (GQA with 2 KV heads, MQA),
internvl2-76b (embedding train and prefill inputs), recurrentgemma-9b in
both forms at one period (rg-LRU, rg-LRU, then ``local_attn`` with an
8-token ring or the STLT at head dim 16). Meshes (``data``, ``model``):
2 x 2, where 2 KV heads divide, and 1 x 4, where no KV count divides and
the decode cache's time axis is sharded. Prompts of 72 tokens, past the
reduced ``blockwise_threshold`` of 64, so the blockwise core runs on each
rank's heads.

* the train cell, 2 steps of 4 x 72: every param after each step within
  1e-4 (1 + max |ref|) of JAX's compiled sharded cell and of JAX's
  single-device step (qwen2's ``bk`` within twice the learning rate: its
  grad is rounding noise in both packages), the metrics within 1e-4
  relative;
* the prefill cell (4 x 72) and 3 greedy decode-cell steps from the
  single-device prefill's state at 80 positions: every rank's logits and
  state shards within 1e-4 (1 + max |ref|) of both references, greedy
  tokens equal;
* the cells' spec trees equal to JAX's, and ``tp_refusal`` passing these
  configs and the MoE archs while it still refuses ``stlt_rel``, the hann
  window and a non-scan engine, each naming its ROADMAP item;
* ``comm.partial_replicated``: granite's MQA projections, whole on every
  rank, get the sum of the ranks' partial grads.
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

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_lib  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import JAX_ENV, cpu_test_settings  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, N, M, D, STEPS = 4, 72, 80, 3, 2   # batch, prompt, decode cell's positions, steps
TCFG = dict(total_steps=10, warmup_steps=2)
TOL = 1e-4                            # x (1 + max |ref|)
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = {"qwen2": ("qwen2-1.5b", "native", 2, {}),
         "chatglm3": ("chatglm3-6b", "native", 2, {"fsdp": True}),
         "granite": ("granite-20b", "native", 2, {"fsdp": True}),
         "internvl2": ("internvl2-76b", "native", 2, {}),
         "rg": ("recurrentgemma-9b", "native", 3, {}),
         "rg-stlt": ("recurrentgemma-9b", "stlt", 3, {})}
CELLS = [f"{k}-{m}" for k in ARCHS for m in MESHES]


def _cfgs():
    out = {}
    for key, (arch, variant, layers, kw) in ARCHS.items():
        cfg = t_configs.get_config(arch, variant)
        if cfg.layer_types:
            kw = {**kw, "layer_types": cfg.layer_types[:layers]}
        out[key] = cfg.reduced(name=f"{arch}-{variant}", num_layers=layers, **kw)
    return out


def _jax_cfg(cfg: ModelConfig) -> JModelConfig:
    names = {f.name for f in dataclasses.fields(JModelConfig)}
    return JModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                           if f.name in names})


JAX_CELLS = """
    import pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.launch import steps as S
    from repro.models import transformer as T
    from repro.optim import make_optimizer
    from repro.utils import tree_flatten_with_paths

    inp = pickle.load(open(sys.argv[1], "rb"))
    B, N, M, D, STEPS = inp["B"], inp["N"], inp["M"], inp["D"], inp["STEPS"]
    jcfg, p0, x, batches = inp["cfg"], inp["params"], inp["prompt"], inp["batches"]
    tcfg = TrainConfig(**inp["tcfg"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    flat = lambda t: {k: np.asarray(v) for k, v in tree_flatten_with_paths(t)}

    def specs(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                tuple(sp) for path, sp in leaves}

    def put(tree, spec, mesh):
        return jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a),
                                                                  NamedSharding(mesh, s)),
                                      tree, spec, is_leaf=lambda x: isinstance(x, P))

    def opt_state(p):
        if jcfg.optimizer == "adamw":
            return make_optimizer("adamw", weight_decay=tcfg.weight_decay, b1=tcfg.beta1,
                                  b2=tcfg.beta2,
                                  moment_dtype=jnp.dtype(jcfg.opt_moment_dtype)).init(p)
        return make_optimizer(jcfg.optimizer, weight_decay=0.0).init(p)

    def train(step_fn):
        p = jax.tree_util.tree_map(jnp.asarray, p0)
        o, out = opt_state(p), []
        for step, batch in enumerate(batches):
            p, o, m = step_fn(p, o, batch, step)
            out.append({"params": flat(p), "metrics": {k: float(v) for k, v in m.items()}})
        return out

    tshape = ShapeConfig("t", N, B, "train")
    p = jax.tree_util.tree_map(jnp.asarray, p0)
    one = jax.jit(S.build_train_step(jcfg, tshape, jax.make_mesh((1, 1), ("data", "model")),
                                     tcfg).fn)
    res = {"ref_train": train(lambda p, o, b, s: one(p, o, jax.tree_util.tree_map(
        jnp.asarray, b), jnp.asarray(s, jnp.int32)))}
    res["ref_prefill"] = np_tree(jax.jit(lambda p, x: T.prefill(p, jcfg, x, max_len=N))(
        p, jnp.asarray(x)))
    l0, st0 = jax.jit(lambda p, x: T.prefill(p, jcfg, x, max_len=M))(p, jnp.asarray(x))
    step = jax.jit(lambda p, t, s: T.decode_step(p, jcfg, t, s))
    tok0 = jnp.argmax(l0, -1).astype(jnp.int32)
    res["tok0"], res["ref_decode"] = np.asarray(tok0), []
    tok, st = tok0, st0
    for _ in range(D):
        logits, st = step(p, tok, st)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        res["ref_decode"].append(np_tree((logits, st)))
    for mname, shape in inp["meshes"].items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        tr = S.build_train_step(jcfg, tshape, mesh, tcfg)
        pre = S.build_prefill_step(jcfg, ShapeConfig("p", N, B, "prefill"), mesh)
        dec = S.build_decode_step(jcfg, ShapeConfig("d", M, B, "decode"), mesh)
        ct, cp, cd = (S.lower_cell(c, mesh).compile() for c in (tr, pre, dec))
        trained = train(lambda p, o, b, s: ct(put(p, tr.in_shardings[0], mesh),
                                              put(o, tr.in_shardings[1], mesh),
                                              put(b, tr.in_shardings[2], mesh),
                                              put(np.int32(s), tr.in_shardings[3], mesh)))
        got = cp(put(p, pre.in_shardings[0], mesh), put(x, pre.in_shardings[1], mesh))
        steps_out = []
        tok, st = tok0, np_tree(st0)
        for _ in range(D):
            # the decode cell donates its state: a fresh placement each step
            logits, st = cd(put(p, dec.in_shardings[0], mesh),
                            put(tok, dec.in_shardings[1], mesh),
                            put(st, dec.in_shardings[2], mesh))
            st = np_tree(st)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            steps_out.append((np.asarray(logits), st))
        res[mname] = {"train": trained, "prefill": np_tree(got), "decode": steps_out,
                      "specs": {"train_in": specs(tr.in_shardings),
                                "train_out": specs(tr.out_shardings),
                                "prefill_in": specs(pre.in_shardings),
                                "prefill_out": specs(pre.out_shardings),
                                "decode_in": specs(dec.in_shardings),
                                "decode_out": specs(dec.out_shardings)}}
    pickle.dump(res, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    cfgs = _cfgs()
    rng = np.random.default_rng(0)
    params, prompts, batches, jin = {}, {}, {}, {}
    for key, cfg in cfgs.items():
        jcfg = _jax_cfg(cfg)
        tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
        params[cfg.name] = convert.from_jax_params(tree, cfg, device="cpu")
        embeds = cfg.input_mode in ("embeddings", "both")
        prompts[key] = (rng.normal(size=(B, N, cfg.d_model)).astype(np.float32) if embeds
                        else rng.integers(0, cfg.vocab, (B, N)).astype(np.int32))
        batches[key] = [{"inputs": (rng.normal(size=(B, N, cfg.d_model)).astype(np.float32)
                                    if embeds else
                                    rng.integers(0, cfg.vocab, (B, N)).astype(np.int32)),
                         "labels": rng.integers(0, cfg.vocab, (B, N)).astype(np.int32)}
                        for _ in range(STEPS)]
        jin[key] = {"B": B, "N": N, "M": M, "D": D, "STEPS": STEPS, "cfg": jcfg,
                    "params": tree, "prompt": prompts[key], "batches": batches[key],
                    "tcfg": TCFG, "meshes": MESHES}
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    torch.save({
        "cfgs": cfgs, "params": params, "B": B, "N": N, "M": M, "D": D, "steps": STEPS,
        "tcfg": TCFG, "prompts": {k: t(v) for k, v in prompts.items()},
        "batches": {k: [{n: t(a) for n, a in b.items()} for b in v]
                    for k, v in batches.items()},
        "cells": {f"{k}-{m}": {"cfg": k, "mesh": shape} for k in ARCHS
                  for m, shape in MESHES.items()},
        "partial": {"cfg": "granite", "mesh": (2, 2)},
    }, root / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu", **JAX_ENV)
    procs = []
    for key in ARCHS:
        with open(root / f"jax_in_{key}.pkl", "wb") as f:
            pickle.dump(jin[key], f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_CELLS), str(root / f"jax_in_{key}.pkl"),
             str(root / f"jax_out_{key}.pkl")], env=jenv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                                str(root), str(r), str(WORLD), "tp"], env=env,
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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


class _Coords:
    """A rank's place in a mesh, as ``sharding.local_slice`` reads it."""

    def __init__(self, shape, coords):
        self.shape, self._coords = dict(zip(("data", "model"), shape)), coords

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def coord(self, axes):
        idx = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx = idx * self.shape[a] + self._coords[a]
        return idx


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree_flatten_with_paths(tree)}


def _close(got, want, what, tol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.abs(got - want).max()) if got.size else 0.0
    bound = tol if tol is not None else TOL * (1 + float(np.abs(want).max()))
    assert gap <= bound, (what, gap, bound)


def _state_specs(cfg, shape):
    return dict(tree_flatten_with_paths(t_steps.build_decode_step(
        cfg, ShapeConfig("d", M, B, "decode"),
        comm.MeshSpec(shape, ("data", "model"))).out_shardings[1]))


def _check_state(rank_state: dict, want_full: dict, specs: dict, coords, what):
    assert sorted(rank_state) == sorted(want_full), what
    for path, w in want_full.items():
        want = sh.local_slice(torch.from_numpy(np.ascontiguousarray(w)), specs[path],
                              coords).numpy()
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(rank_state[path], want, err_msg=f"{what} {path}")
        else:
            _close(rank_state[path], want, f"{what} {path}")


def _rows(a, coords, mesh_shape, cfg):
    bax = sh.batch_axes(cfg, comm.MeshSpec(mesh_shape, ("data", "model")), B)
    return sh.local_slice(torch.from_numpy(np.ascontiguousarray(a)), sh.P(bax or None),
                          coords).numpy()


def _norm(spec) -> tuple:
    out = []
    for ax in tuple(spec):
        if isinstance(ax, tuple):
            ax = ax[0] if len(ax) == 1 else (ax or None)
        out.append(ax)
    return tuple(out)


def _cell(job, name):
    key, mname = name.rsplit("-", 1)
    cfg = job["cfgs"][key]
    return cfg, key, MESHES[mname], [r[name] for r in job["ranks"]], job["jax"][key], mname


def _lr_bound(step: int) -> float:
    """Twice the learning rates summed over the steps so far: how far Adam
    can move a leaf whose grad is rounding noise."""
    sched = t_steps.train_schedules(t_steps.TrainConfig(**TCFG))
    return 2 * sum(sched(s)[1] for s in range(step + 1))


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", CELLS)
def test_train_cell_matches_jax(job, name, ref):
    """After each of 2 steps, every param (gathered from the ranks' shards)
    within 1e-4 (1 + max |ref|) of JAX's compiled sharded train cell and of
    its single-device step (a ``bk`` within twice the summed learning
    rates), and the loss, ce, reg, s_eff and grad norm within 1e-4
    relative."""
    cfg, key, _, ranks, j, mname = _cell(job, name)
    want = j[mname]["train"] if ref == "sharded" else j["ref_train"]
    got = ranks[0]["train"]
    for step, (g, w) in enumerate(zip(got, want)):
        gp = _flat(g["params"])
        assert sorted(gp) == sorted(w["params"])
        for path, wv in w["params"].items():
            _close(gp[path], wv, f"{name} step {step} {path}",
                   tol=_lr_bound(step) if path.endswith("/bk") else None)
        for k in ("loss", "ce", "reg", "s_eff", "grad_norm", "lr"):
            np.testing.assert_allclose(g["metrics"][k], w["metrics"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} step {step} {k}")


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", CELLS)
def test_prefill_cell_matches_jax(job, name, ref):
    """Every rank's last-token logits (its rows, the whole vocab) and its
    shards of the prefill state (KV heads or a time slice of the cache,
    the rg-LRU's whole ``h``/``conv_buf``, the STLT's heads) against JAX's
    compiled sharded cell and its single-device ``prefill``."""
    cfg, key, shape, ranks, j, mname = _cell(job, name)
    want = j[mname]["prefill"] if ref == "sharded" else j["ref_prefill"]
    specs = _state_specs(cfg, shape)
    want_state = _flat(convert.from_jax_state(want[1], cfg, device="cpu"))
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        _close(r["prefill"][0], _rows(want[0], coords, shape, cfg), f"{name} logits")
        _check_state(_flat(r["prefill"][1]), want_state, specs, coords,
                     f"{name} rank {r['coords']}")


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", CELLS)
def test_decode_cell_matches_jax(job, name, ref):
    """From the single-device prefill's state at 80 positions, 3 greedy
    decode-cell steps (a time-sharded cache: the owner writes the new
    token, every head's softmax combined over the ranks' slices): each
    rank's tokens equal JAX's, its logits and state shards within 1e-4 (1
    + max |ref|) of JAX's compiled sharded cell and its ``decode_step``."""
    cfg, key, shape, ranks, j, mname = _cell(job, name)
    want = j[mname]["decode"] if ref == "sharded" else j["ref_decode"]
    specs = _state_specs(cfg, shape)
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        np.testing.assert_array_equal(r["tok0"], _rows(j["tok0"], coords, shape, cfg))
        for i, ((gl, gs), (wl, ws)) in enumerate(zip(r["decode"], want)):
            wl = _rows(np.asarray(wl), coords, shape, cfg)
            _close(gl, wl, f"{name} step {i} logits")
            np.testing.assert_array_equal(np.argmax(gl, -1), np.argmax(wl, -1))
            _check_state(_flat(gs), _flat(convert.from_jax_state(ws, cfg, device="cpu")),
                         specs, coords, f"{name} step {i} rank {r['coords']}")


@pytest.mark.parametrize("name", CELLS)
def test_cell_specs_equal_jax(job, name):
    """``in_shardings`` and ``out_shardings`` of the three cells equal the
    JAX package's spec trees leaf for leaf."""
    cfg, key, shape, _, j, mname = _cell(job, name)
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


def test_partial_replicated_sums_the_ranks_grads(job):
    """granite's MQA on 2 x 2: ``wk``/``wv`` stay whole on every rank (1 KV
    head), each rank's query heads reading the one KV head; the
    ``partial_replicated`` operator sums the ranks' partial grads, so
    every rank of a model group holds the whole grad, equal to the
    single-device one; a rank's own partial (the operator made the
    identity) misses more than a tenth of its scale."""
    for r in job["ranks"]:
        got = r["partial"]
        for leaf in ("wk", "wv"):
            assert got[f"{leaf}_spec"] == ("data", None)
            _close(got[f"{leaf}_grad"], got[f"{leaf}_ref"], leaf)
            assert got[f"{leaf}_own_gap"] > 0.1 * np.abs(got[f"{leaf}_ref"]).max()


def test_refusals_name_their_roadmap_item():
    """The five configs and the MoE archs (expert parallelism) pass
    ``tp_refusal``; a relevance block, the hann window and a non-scan engine
    still refuse a ``model`` axis > 1, each naming its ROADMAP Queue 1 item
    7 entry."""
    moe = [t_configs.get_config("qwen3-moe-235b-a22b").reduced(num_layers=1),
           t_configs.get_config("arctic-480b", "native").reduced(num_layers=1)]
    for cfg in list(_cfgs().values()) + moe:
        assert tp_lib.tp_refusal(cfg) is None, cfg.name
    base = t_configs.get_config("stlt-base").reduced()
    refused = {
        "stlt_rel": dataclasses.replace(base, mixer="stlt_relevance"),
        "hann": dataclasses.replace(base, stlt_window="hann"),
        "engine": dataclasses.replace(base, stlt_engine="sequential"),
    }
    for what, cfg in refused.items():
        why = tp_lib.tp_refusal(cfg)
        assert why is not None and "ROADMAP Queue 1 item 7" in why, what
    assert "stlt_rel" in tp_lib.tp_refusal(refused["stlt_rel"])
