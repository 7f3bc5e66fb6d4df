"""The port's sharded serving cells and the process form of its sharded
engine on 4 gloo ranks on the CPU, against the JAX package.

One job of 4 ranks (``tests/torch_dist_worker.py DIR RANK 4 serve``, a file
store in the test's temporary directory, one torch thread per rank) runs
every scenario once for the module; one JAX subprocess
(``--xla_force_host_platform_device_count=4``) compiles the JAX package's
cells (``lower_cell(build_prefill_step(...)).compile()`` and the same for
``build_decode_step``) on the same meshes and runs its single-device
``prefill``/``decode_step``; the tests below read both:

* stlt-base's form at the JAX distributed tests' config (2 layers, d 32, 4
  heads, stlt, 4 nodes, chunk 8; adaptive masks off and on) on 2 x 2, 4 x 1
  and 1 x 4 (``data``, ``model``): the prefill of 4 x 32 tokens and 3 greedy
  decode steps from the single-device prefill's state at 40 positions.
  Every rank's logits and state shards against the matching slices of
  JAX's sharded cells and of its single-device functions within 1e-4 (1 +
  max |ref|), greedy tokens equal, and ``in_shardings``/``out_shardings``
  equal to JAX's spec trees;
* the data-axis cells of qwen2-1.5b reduced and whisper-base reduced (fp32)
  on 4 x 1, the same way (whisper encodes 32 frames: both packages'
  ``WHISPER_ENC_FRAMES`` set to the prompt length);
* the ``model`` > 1 refusal for an STLT form off the TP path (the hann
  window), naming its ROADMAP item;
* the dry-run (``launch.steps.lower_cell`` on each rank's
  ``comm.RankMesh``) of every cell's prefill and decode step: its bytes
  handed to each kind of collective, its calls and its scan passes equal
  the rank's real call's, and its ``analytic_arg_bytes`` the JAX
  dry-run's (in the JAX subprocess, ``repro.launch.dryrun`` imported after
  JAX's backend is up: its import sets ``XLA_FLAGS``); ``lower_cell`` of a
  cell built on a shape-only ``MeshSpec`` compiles and counts;
* the process form of ``ShardedServeEngine`` on 2 host ranks x 2 slots,
  each with its own warmed prefix-cache shard: streams, per-request ticks
  and host assignment equal to the one-process engine's, and greedy streams
  equal to JAX's unsharded ``ServeEngine`` (JAX's sharded engine fails on
  this jax, ROADMAP Queue 3).
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
from repro.models import whisper as JW  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun as t_dryrun  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.serving import (ReplicatedPrefixCache, Request,  # noqa: E402
                                 ShardedServeEngine, make_serve_mesh)
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import JAX_ENV, cpu_test_settings  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
              mixer="stlt", stlt_nodes=4, stlt_chunk=8)
B, N, M, D = 4, 32, 40, 3       # batch, prompt, decode cell's positions, decode steps
TOL = 1e-4                      # x (1 + max |ref|)
WORLD = 4
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
CELLS = {**{f"{c}-{m}": (c, shape) for c in ("stlt", "stlt-adaptive")
            for m, shape in MESHES.items()},
         "qwen2-4x1": ("qwen2", (4, 1)), "whisper-4x1": ("whisper", (4, 1))}
ENGINE = dict(cfg="stlt-adaptive", hosts=2, slots=2, chunk=8, max_len=128)


def _cfgs():
    return {"stlt": ModelConfig(**CFG_KW),
            "stlt-adaptive": ModelConfig(**{**CFG_KW, "name": "t-adaptive",
                                            "stlt_adaptive": True}),
            "qwen2": t_configs.get_config("qwen2-1.5b").reduced(num_layers=2,
                                                                dtype="float32"),
            "whisper": t_configs.get_config("whisper-base").reduced(dtype="float32"),
            "stlt-hann": ModelConfig(**{**CFG_KW, "name": "t-hann", "stlt_window": "hann"})}


def _jax_cfg(cfg: ModelConfig) -> JModelConfig:
    names = {f.name for f in dataclasses.fields(JModelConfig)}
    return JModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                           if f.name in names})


JAX_CELLS = """
    import pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ShapeConfig
    from repro.launch import steps as S
    from repro.models import transformer as T, whisper as W

    inp = pickle.load(open(sys.argv[1], "rb"))
    B, N, M, D = inp["B"], inp["N"], inp["M"], inp["D"]
    S.WHISPER_ENC_FRAMES = N
    import os
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD    # its import sets XLA_FLAGS; the backend is up
    os.environ["XLA_FLAGS"] = flags
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)

    def specs(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                tuple(sp) for path, sp in leaves}

    def put(tree, spec, mesh):
        return jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a),
                                                                  NamedSharding(mesh, s)),
                                      tree, spec, is_leaf=lambda x: isinstance(x, P))

    out = {}
    for key, (jcfg, meshes) in inp["cases"].items():
        p = jax.tree_util.tree_map(jnp.asarray, inp["params"][key])
        x = jnp.asarray(inp["prompts"][key])
        enc = jcfg.family == "encdec"
        if enc:
            ref_pre = jax.jit(lambda p, x: W.init_encdec_decode_state(p, jcfg, x, B, N))(p, x)
            st0 = jax.jit(lambda p, x: W.init_encdec_decode_state(p, jcfg, x, B, M))(p, x)
            step = jax.jit(lambda p, t, s: W.encdec_decode_step(p, jcfg, t, s))
            tok0 = jnp.asarray(inp["tok0"])
        else:
            ref_pre = jax.jit(lambda p, x: T.prefill(p, jcfg, x, max_len=N))(p, x)
            l0, st0 = jax.jit(lambda p, x: T.prefill(p, jcfg, x, max_len=M))(p, x)
            step = jax.jit(lambda p, t, s: T.decode_step(p, jcfg, t, s))
            tok0 = jnp.argmax(l0, -1).astype(jnp.int32)
        res = {"ref_prefill": np_tree(ref_pre), "tok0": np.asarray(tok0), "ref_decode": []}
        tok, st = tok0, st0
        for _ in range(D):
            logits, st = step(p, tok, st)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            res["ref_decode"].append(np_tree((logits, st)))
        for mname, shape in meshes.items():
            mesh = jax.make_mesh(shape, ("data", "model"))
            pre = S.build_prefill_step(jcfg, ShapeConfig("p", N, B, "prefill"), mesh)
            dec = S.build_decode_step(jcfg, ShapeConfig("d", M, B, "decode"), mesh)
            cp, cd = (S.lower_cell(c, mesh).compile() for c in (pre, dec))
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
            res[mname] = {"prefill": np_tree(got), "decode": steps_out,
                          "arg_bytes": {"prefill": JD.analytic_arg_bytes(pre, mesh),
                                        "decode": JD.analytic_arg_bytes(dec, mesh)},
                          "specs": {"prefill_in": specs(pre.in_shardings),
                                    "prefill_out": specs(pre.out_shardings),
                                    "decode_in": specs(dec.in_shardings),
                                    "decode_out": specs(dec.out_shardings)}}
        out[key] = res
    pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _engine_inputs(vocab):
    rng = np.random.default_rng(11)
    sys_prompt = rng.integers(3, vocab, 2 * ENGINE["chunk"] + 3).astype(np.int32)
    tails = [rng.integers(3, vocab, 3 + 4 * i).astype(np.int32) for i in range(7)]
    prompts = [np.concatenate([sys_prompt, t]) if i % 3 else t for i, t in enumerate(tails)]
    budgets = [4, 6, 3, 5, 8, 2, 5]
    arrivals = [0, 0, 1, 1, 4, 9, 30]
    return sys_prompt, prompts, budgets, arrivals


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    cfgs = _cfgs()
    jcfgs = {k: _jax_cfg(c) for k, c in cfgs.items()}
    jparams, params = {}, {}
    for key, cfg in cfgs.items():
        if cfg.family == "encdec":
            tree = jax.tree_util.tree_map(np.asarray, JW.init_encdec(jax.random.key(0),
                                                                     jcfgs[key]))
            params[cfg.name] = convert.from_jax_encdec_params(tree, cfg, device="cpu")
        else:
            tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfgs[key]))
            params[cfg.name] = convert.from_jax_params(tree, cfg, device="cpu")
        jparams[key] = tree
    rng = np.random.default_rng(0)
    prompts = {k: (rng.normal(size=(B, N, c.d_model)).astype(np.float32)
                   if c.family == "encdec" else
                   rng.integers(0, c.vocab, (B, N)).astype(np.int32))
               for k, c in cfgs.items()}
    tok0 = rng.integers(0, cfgs["whisper"].vocab, (B,)).astype(np.int32)
    sys_prompt, eprompts, budgets, arrivals = _engine_inputs(cfgs[ENGINE["cfg"]].vocab)
    cases = {}
    for name, (key, shape) in CELLS.items():
        cases.setdefault(key, (jcfgs[key], {}))[1][name.split("-")[-1]] = shape
    with open(root / "jax_in.pkl", "wb") as f:
        pickle.dump({"B": B, "N": N, "M": M, "D": D, "cases": cases, "params": jparams,
                     "prompts": prompts, "tok0": tok0}, f)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    torch.save({
        "cfgs": cfgs, "params": params, "B": B, "N": N, "M": M, "D": D, "whisper_frames": N,
        "prompts": {k: t(v) for k, v in prompts.items()}, "tok0": t(tok0),
        "cells": {name: {"cfg": key, "mesh": shape} for name, (key, shape) in CELLS.items()},
        "refusals": {"refuse-hann-2x2": ("stlt-hann", (2, 2))}, "dry": True,
        "engine": {**ENGINE, "sys_prompt": sys_prompt, "arrivals": arrivals,
                   "requests": [Request(p, b, id=i) for i, (p, b) in
                                enumerate(zip(eprompts, budgets))]},
    }, root / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu", **JAX_ENV)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_CELLS),
                               str(root / "jax_in.pkl"), str(root / "jax_out.pkl")],
                              env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                                str(root), str(r), str(WORLD), "serve"], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
              for r in range(WORLD)]
    try:
        refs = _engine_refs(cfgs[ENGINE["cfg"]], jcfgs[ENGINE["cfg"]], jparams[ENGINE["cfg"]],
                            params[cfgs[ENGINE["cfg"]].name], sys_prompt, eprompts, budgets,
                            arrivals)
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-4000:]
    with open(root / "jax_out.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return {"ranks": torch.load(root / "results.pt", weights_only=False), "jax": jax_out,
            "cfgs": cfgs, "refs": refs}


def _engine_refs(cfg, jcfg, jtree, tparams, sys_prompt, prompts, budgets, arrivals):
    """The one-process engine (both hosts on the CPU, a replicated cache)
    and JAX's unsharded engine (H x K slots, a plain cache) on the same
    requests."""
    H, K = ENGINE["hosts"], ENGINE["slots"]
    eng = ShardedServeEngine(tparams, cfg, n_hosts=H, slots_per_host=K,
                             max_len=ENGINE["max_len"], prefill_chunk=ENGINE["chunk"],
                             prefix_cache=ReplicatedPrefixCache(H, capacity=32), device="cpu")
    eng.warm_prefix(sys_prompt)
    one, one_stats = eng.serve([Request(p, b, id=i) for i, (p, b) in
                                enumerate(zip(prompts, budgets))],
                               arrivals=arrivals, return_stats=True)
    jeng = JServeEngine(jax.tree_util.tree_map(jax.numpy.asarray, jtree), jcfg,
                        max_len=ENGINE["max_len"], prefill_chunk=ENGINE["chunk"],
                        prefix_cache=JPrefixCache(capacity=32))
    jeng.warm_prefix(sys_prompt)
    want = jeng.serve([JRequest(p, b, id=i) for i, (p, b) in enumerate(zip(prompts, budgets))],
                      slots=H * K, arrivals=arrivals)
    return {"one": one, "one_stats": one_stats,
            "jax": {k: np.asarray(v) for k, v in want.items()}}


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


def _port_tree(tree, cfg):
    """A JAX output (numpy) in the port's layout: an LM state's or an
    enc-dec state's leaves by the port's paths."""
    if cfg.family == "encdec":
        return _flat(convert.from_jax_encdec_state(tree, cfg, device="cpu"))
    return _flat(convert.from_jax_state(tree, cfg, device="cpu"))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree_flatten_with_paths(tree)}


def _state_specs(cfg, shape):
    return dict(tree_flatten_with_paths(t_steps.build_decode_step(
        cfg, ShapeConfig("d", M, B, "decode"),
        comm.MeshSpec(shape, ("data", "model"))).out_shardings[1]))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.abs(got - want).max()) if got.size else 0.0
    assert gap <= TOL * (1 + float(np.abs(want).max() if want.size else 0.0)), (what, gap)


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
    """A spec's entries with one-name tuples as the name (JAX keeps them)."""
    out = []
    for ax in tuple(spec):
        if isinstance(ax, tuple):
            ax = ax[0] if len(ax) == 1 else (ax or None)
        out.append(ax)
    return tuple(out)


def _port_specs(tree) -> dict:
    return {k.replace("enc_layers", "enc_list").replace("dec_layers", "dec_list"): _norm(v)
            for k, v in tree_flatten_with_paths(tree)}


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _cell(job, name):
    key, shape = CELLS[name]
    cfg = job["cfgs"][key]
    return cfg, shape, [r[name] for r in job["ranks"]], job["jax"][key]


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", list(CELLS))
def test_prefill_cell_matches_jax(job, name, ref):
    """Every rank's last-token logits (its rows, the whole vocab) and its
    shards of the prefill state against JAX's compiled sharded cell and
    its single-device ``prefill`` (an enc-dec: the encode plus its decode
    state), within 1e-4 (1 + max |ref|)."""
    cfg, shape, ranks, j = _cell(job, name)
    want = j[name.split("-")[-1]]["prefill"] if ref == "sharded" else j["ref_prefill"]
    specs = _state_specs(cfg, shape)
    if cfg.family == "encdec":
        want_logits, want_state = None, _port_tree(want, cfg)
    else:
        want_logits, want_state = want[0], _port_tree(want[1], cfg)
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        got = r["prefill"]
        if want_logits is not None:
            _close(got[0], _rows(want_logits, coords, shape, cfg), f"{name} logits")
            got = got[1]
        _check_state(_flat(got), want_state, specs, coords, f"{name} rank {r['coords']}")


@pytest.mark.parametrize("ref", ["sharded", "single"])
@pytest.mark.parametrize("name", list(CELLS))
def test_decode_cell_matches_jax(job, name, ref):
    """From the single-device prefill's state at 40 positions, 3 greedy
    decode-cell steps: each rank's first tokens and every step's greedy
    tokens equal JAX's; its logits and state shards within 1e-4 (1 + max
    |ref|) of JAX's compiled sharded cell and its single-device
    ``decode_step`` (an enc-dec: ``encdec_decode_step``)."""
    cfg, shape, ranks, j = _cell(job, name)
    want = j[name.split("-")[-1]]["decode"] if ref == "sharded" else j["ref_decode"]
    specs = _state_specs(cfg, shape)
    for r in ranks:
        coords = _Coords(shape, r["coords"])
        np.testing.assert_array_equal(r["tok0"], _rows(j["tok0"], coords, shape, cfg))
        for i, ((gl, gs), (wl, ws)) in enumerate(zip(r["decode"], want)):
            wl = _rows(np.asarray(wl), coords, shape, cfg)
            _close(gl, wl, f"{name} step {i} logits")
            np.testing.assert_array_equal(np.argmax(gl, -1), np.argmax(wl, -1))
            _check_state(_flat(gs), _port_tree(ws, cfg), specs, coords,
                         f"{name} step {i} rank {r['coords']}")


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_specs_equal_jax(job, name):
    """``in_shardings`` and ``out_shardings`` of both cells equal the JAX
    package's spec trees leaf for leaf (the enc-dec's layer lists by JAX's
    ``enc_list``/``dec_list`` names), and the decode cell donates its
    state as JAX's does."""
    cfg, shape, _, j = _cell(job, name)
    mesh = comm.MeshSpec(shape, ("data", "model"))
    pre = t_steps.build_prefill_step(cfg, ShapeConfig("p", N, B, "prefill"), mesh)
    dec = t_steps.build_decode_step(cfg, ShapeConfig("d", M, B, "decode"), mesh)
    want = j[name.split("-")[-1]]["specs"]
    for got, key in ((pre.in_shardings, "prefill_in"), (pre.out_shardings, "prefill_out"),
                     (dec.in_shardings, "decode_in"), (dec.out_shardings, "decode_out")):
        assert _port_specs(got) == {k: _norm(v) for k, v in want[key].items()}, key
    assert dec.donate_argnums == (2,) and pre.donate_argnums == ()
    assert tuple(dec.args[1].shape) == (B,) and dec.args[1].dtype == torch.int32


def test_model_axis_refusal_names_its_roadmap_item(job):
    """A ``model`` axis > 1 on an STLT form off the TP path (the hann
    window; a relevance LM has no decode state to serve) raises
    NotImplementedError naming ROADMAP Queue 1 item 7, on every rank."""
    for r in job["ranks"]:
        msg = r["refuse-hann-2x2"]
        assert msg is not None and "'model' axis > 1" in msg and "ROADMAP Queue 1 item 7" in msg


def test_lower_cell_compiles_and_counts():
    """``lower_cell`` of a prefill cell built on a shape-only ``MeshSpec``
    builds it again on rank 0's ``comm.RankMesh`` and runs that rank's step
    on ``meta``: K1 once a layer on its 2 rows x 2 heads, the model-axis
    all-reduces and the last logits' all-gather counted, the arguments'
    bytes the rank's shards; the program's own ``fn`` still raises."""
    mesh = comm.MeshSpec((2, 2), ("data", "model"))
    prog = t_steps.build_prefill_step(_cfgs()["stlt"], ShapeConfig("p", N, B, "prefill"), mesh)
    c = t_steps.lower_cell(prog, mesh).compile()
    assert c.launches == {"stlt_scan": 2, "relevance_flash": 0}
    assert c.calls["all_reduce"] > 0 and c.calls["all_gather"] > 0
    assert c.cost_analysis()["flops"] > 0 and c.cost_analysis()["bytes accessed"] > 0
    mem = c.memory_analysis()
    assert mem.argument_size_in_bytes == t_dryrun.analytic_arg_bytes(prog, mesh)["total"]
    assert mem.peak_memory_in_bytes > mem.argument_size_in_bytes
    with pytest.raises(RuntimeError, match="shape-only mesh"):
        prog.fn(None, None)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(CELLS))
def test_dry_run_counts_equal_each_ranks(job, name, kind):
    """On every rank, the dry-run of the cell's prefill and of its decode
    step hands each kind of collective the bytes the rank's real call
    handed it (``comm.STATS``), makes as many calls of each kind
    (``comm.CALLS``) and as many scan passes."""
    for r in job["ranks"]:
        c = r[name]["counts"][kind]
        assert c["dry"] == c["real"], (name, kind, r[name]["coords"], c)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(CELLS))
def test_analytic_arg_bytes_equal_jax(job, name, kind, monkeypatch):
    """The port's ``dryrun.analytic_arg_bytes`` of the cell (params, inputs
    or token and state: shapes over their specs) equals the JAX dry-run's,
    byte for byte."""
    cfg, shape, _, j = _cell(job, name)
    monkeypatch.setattr(t_steps, "WHISPER_ENC_FRAMES", N)
    mesh = comm.MeshSpec(shape, ("data", "model"))
    prog = (t_steps.build_prefill_step(cfg, ShapeConfig("p", N, B, "prefill"), mesh)
            if kind == "prefill" else
            t_steps.build_decode_step(cfg, ShapeConfig("d", M, B, "decode"), mesh))
    assert t_dryrun.analytic_arg_bytes(prog, mesh) == j[name.split("-")[-1]]["arg_bytes"][kind]


# ---------------------------------------------------------------------------
# the process form of the sharded engine
# ---------------------------------------------------------------------------


def _ticks(stats):
    return {rid: (s["host"], s["arrival"], s["admit"], s["live"], s["finish"], s["n_tokens"],
                  s["cached_tokens"], s["prefilled_tokens"]) for rid, s in stats.items()}


def test_process_form_matches_the_one_process_engine(job):
    """2 host ranks x 2 slots: every stream, every request's host and ticks
    (arrival, admit, first token, finish) and its cached and prefilled
    tokens equal the one-process engine's; both ranks return the same
    gathered result and both hosts serve."""
    ranks = [r["engine"] for r in job["ranks"][:ENGINE["hosts"]]]
    assert [r["host"] for r in ranks] == [0, 1]
    assert all(r is None for r in (x["engine"] for x in job["ranks"][ENGINE["hosts"]:]))
    one, one_stats = job["refs"]["one"], job["refs"]["one_stats"]
    for r in ranks:
        assert sorted(r["streams"]) == sorted(one)
        for rid in one:
            np.testing.assert_array_equal(r["streams"][rid], one[rid], err_msg=f"request {rid}")
        assert _ticks(r["stats"]) == _ticks(one_stats)
    assert {s["host"] for s in one_stats.values()} == {0, 1}


def test_process_form_matches_jax_unsharded(job):
    """The gathered greedy streams equal JAX's unsharded engine's on H x K
    slots, token for token."""
    got, want = job["ranks"][0]["engine"]["streams"], job["refs"]["jax"]
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")


def test_process_form_shards_and_exchange(job):
    """Each rank warmed its own shard (the whole system prompt), its
    admission dispatches are [K, chunk] on its own rows, and it exchanged
    one all-gather of 4 integers a tick (32 B handed in) plus the final
    gather of results."""
    ranks = [r["engine"] for r in job["ranks"][:ENGINE["hosts"]]]
    for r in ranks:
        assert r["warmed"] == 2 * ENGINE["chunk"] + 3 and r["cache"]["pinned"] == 3
        assert r["bytes"] == {"all_gather": 32 * r["serve_stats"]["exchanges"]}
        assert r["serve_stats"]["admission_dispatches"] > 0
        served = [rid for rid, s in r["stats"].items() if s["host"] == r["host"]]
        hits = [rid for rid in served if rid % 3 and r["stats"][rid]["cached_tokens"]]
        assert served and hits and r["cache"]["hits"] >= len(hits)


def test_process_form_refusals():
    """Without a process group the process form raises (it never becomes
    the one-process form); the wall-gap SLO trigger's refusal names its
    ROADMAP item."""
    with pytest.raises(RuntimeError, match="needs a job of 2 ranks"):
        make_serve_mesh(2, "cpu", processes=True)
    assert make_serve_mesh(2, "cpu").shape == {"data": 2}
    from repro_torch.serving import multihost

    assert "ROADMAP Queue 1 item 7" in multihost.ROADMAP_SLO_GAP


CLI = ["--arch", "stlt-base", "--reduced", "--device", "cpu", "--requests", "5", "--max-new",
       "4", "--mesh-data", "2", "--slots-per-host", "2", "--prefill-chunk", "16",
       "--system-prompt-len", "20"]


def test_cli_as_a_job_of_one_rank_per_host(tmp_path):
    """``--mesh-data 2`` launched as a job of 2 ranks (torchrun's
    environment, gloo on the CPU): rank 0 prints every stream, equal to the
    one-process CLI's, and the per-host line; rank 1 prints nothing. A job
    of 1 rank for 2 hosts raises."""
    import socket

    from repro_torch.launch import serve as t_serve_cli

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"] + CLI
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        lone_port = s.getsockname()[1]
    lone = subprocess.run(cmd, env=dict(env, WORLD_SIZE="1", RANK="0",
                                        MASTER_PORT=str(lone_port)),
                          capture_output=True, text=True, timeout=300)
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for _, e in outs]
    assert lone.returncode != 0 and "a serve mesh of 2 hosts in a job of 1 ranks" in lone.stderr
    assert outs[1][0] == ""
    got = outs[0][0]
    want, _ = t_serve_cli.main(CLI)
    for rid, toks in want.items():
        line = f"  req {rid}: {toks[:12]}"
        assert line in got, line
    assert "[serve] per-host requests: {0: " in got and "1: " in got
