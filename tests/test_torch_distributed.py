"""The port's multi-device layer on 4 gloo ranks on the CPU, against the JAX
package.

One job of 4 ranks (``tests/torch_dist_worker.py``, a file store in the
test's temporary directory, one torch thread per rank) runs every scenario
once for the module and writes its results; the tests below read them:

* the sharded train step (``launch.steps.build_train_step``) of the JAX
  package's ``test_sharded_train_step_matches_single_device`` config (2
  layers, d 32, 4 heads, stlt, 4 nodes, chunk 8, 4 x 32 tokens) on 2 x 2, 4
  x 1 and 1 x 4 (``data``, ``model``) meshes, with ``fsdp=True`` on 2 x 2 and
  with adaptive masks on 2 x 2 (the JAX step's draws fed in: each rank takes
  its rows and heads), against the JAX package's step (``jax.jit(prog.fn)``,
  one device) and the port's ``make_step``, after 1 and 3 steps: loss within
  1e-4, every param within 1e-4, and ce, reg, s_eff, the grad norm and lr
  within 1e-4 relative;
* the data axes of an arch off the TP path (qwen2-1.5b reduced, FSDP, AdamW
  and adafactor) on 4 x 1, and a d_model-4096 STLT LM on 1 x 4 (norm scales
  sharded on ``model``), against ``make_step``;
* ``stlt_context_parallel`` (forward, and grads of x and the poles and
  mixers at 4 x 16 and 4 x 24 tokens) and ``pipeline_apply`` (forward and
  grads) against the JAX package's own functions on a forced 4-device mesh
  (one subprocess, ``--xla_force_host_platform_device_count=4``, as
  tests/test_distributed.py runs them; ``jax.grad`` through JAX's CP),
  within 1e-5 relative (JAX's pipeline grads are 1/D of the gradient:
  ``test_pipeline_matches_jax``);
* ``remesh`` from 2 x 2 to 1 x 2 against the unsharded tree;
* the refusals: a ``model`` axis > 1 on a block off the TP path (the
  relevance readout, ``stlt_rel``) and on the hann window, a MoE off the TP
  path over more than one batch shard;
* the dry-run (``launch.steps.lower_cell`` on a ``comm.RankMesh``) of every
  train cell on every rank: the bytes it hands to each kind of collective,
  its calls and its scan passes equal what the rank's first real step did,
  and its ``analytic_arg_bytes`` the JAX dry-run's (computed in the JAX
  subprocess, where ``repro.launch.dryrun`` is imported after JAX's backend
  is up: its import sets ``XLA_FLAGS``).
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

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.utils import fold_key  # noqa: E402
from repro.utils import tree_flatten_with_paths as j_flatten  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.launch import dryrun as t_dryrun  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import JAX_ENV, cpu_test_settings  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(name="t", family="lm", vocab=64, num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, dtype="float32", scan_layers=False, remat=False,
              mixer="stlt", stlt_nodes=4, stlt_chunk=8)
TCFG = dict(total_steps=10, warmup_steps=2)
B, N, STEPS = 4, 32, 3
LOSS_TOL = PARAM_TOL = 1e-4
REL_TOL = 1e-5
WORLD = 4
TRAIN = {"2x2": ("stlt", (2, 2)), "4x1": ("stlt", (4, 1)), "1x4": ("stlt", (1, 4)),
         "fsdp-2x2": ("stlt-fsdp", (2, 2)), "adaptive-2x2": ("stlt-adaptive", (2, 2))}
JAX_INIT = ("stlt", "stlt-fsdp", "stlt-adaptive")    # params converted from the JAX init
DP = {"dp-qwen2-4x1": ("qwen2-fsdp", (4, 1)), "dp-qwen2-adafactor-4x1": ("qwen2-adafactor", (4, 1)),
      "tp-wide-1x4": ("stlt-wide", (1, 4))}
REFUSALS = {"refuse-rel-2x2": ("stlt-rel", (2, 2)), "refuse-hann-2x2": ("stlt-hann", (2, 2)),
            "refuse-moe-4x1": ("moe-hann", (4, 1))}


def _cfgs():
    qwen2 = t_configs.get_config("qwen2-1.5b").reduced(num_layers=2)
    return {"stlt": ModelConfig(**CFG_KW),
            "stlt-fsdp": ModelConfig(**{**CFG_KW, "name": "t-fsdp", "fsdp": True}),
            "stlt-adaptive": ModelConfig(**{**CFG_KW, "name": "t-adaptive",
                                            "stlt_adaptive": True}),
            "qwen2": qwen2,
            "qwen2-fsdp": dataclasses.replace(qwen2, name="q-fsdp", fsdp=True),
            "qwen2-adafactor": dataclasses.replace(qwen2, name="q-ada", fsdp=True,
                                                   optimizer="adafactor"),
            "stlt-hann": ModelConfig(**{**CFG_KW, "name": "t-hann", "stlt_window": "hann"}),
            # MoE off the TP path (the hann window): its data axes run dp_lm_loss
            "moe-hann": ModelConfig(**{**CFG_KW, "name": "t-moe-hann", "stlt_window": "hann",
                                       "num_experts": 4, "top_k": 2}),
            "stlt-rel": ModelConfig(**{**CFG_KW, "name": "t-rel", "mixer": "stlt_relevance"}),
            # d_model 4096: the rules shard the norm scales (1-D, >= 4096) on model
            "stlt-wide": ModelConfig(**{**CFG_KW, "name": "t-wide", "num_layers": 1,
                                        "d_model": 4096, "num_heads": 8})}


def _jax_draws(jcfg, seed, step):
    """The adaptive masks' per-layer draws of the JAX package's train step:
    rng = fold_in(key(seed), step), then fold_key(rng, li) per (unstacked)
    layer, uniform in (1e-6, 1 - 1e-6) as ``node_masks`` draws them."""
    rng = jax.random.fold_in(jax.random.key(seed), step)
    shape = (B, jcfg.num_heads, jcfg.stlt_nodes)
    return [torch.from_numpy(np.array(jax.random.uniform(fold_key(rng, li), shape,
                                                         minval=1e-6, maxval=1.0 - 1e-6)))
            for li in range(jcfg.num_layers)]


def _batches(vocab):
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, vocab, (B, N)).astype(np.int32) for k in ("inputs", "labels")}
            for _ in range(STEPS)]


# the backward's cases: 4 shards of 16 tokens (one chunk each), and of 24
# (not a multiple of the chunk: the end state is a mid-chunk snapshot)
CP_GRAD_N = {"4x16": 64, "4x24": 96}


def _cp_inputs():
    rng = np.random.default_rng(0)
    S = 6
    out = {"x": rng.normal(size=(2, 64, 16)).astype(np.float32),
           "lm": (-rng.uniform(0.01, 0.5, S)).astype(np.float32),
           "th": (-rng.uniform(0, 1, S)).astype(np.float32),
           "u": (rng.normal(size=(2, S)) / S).astype(np.float32), "chunk": 16}
    for case, n in CP_GRAD_N.items():
        xs = out["x"] if n == 64 else rng.normal(size=(2, n, 16)).astype(np.float32)
        out["grad_" + case] = (xs, rng.normal(size=(2, n, 16)).astype(np.float32))
    return out


def _pipe_inputs():
    rng = np.random.default_rng(0)
    D, M, mb, dd = 4, 6, 2, 8
    return {"W": (rng.normal(size=(D, dd, dd)) / np.sqrt(dd)).astype(np.float32),
            "x": rng.normal(size=(M, mb, dd)).astype(np.float32),
            "cot": rng.normal(size=(M, mb, dd)).astype(np.float32)}


JAX_REFS = """
    import sys, numpy as np, jax, jax.numpy as jnp
    from repro.distributed.context_parallel import stlt_context_parallel
    from repro.distributed.pipeline import pipeline_apply
    d = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((4,), ("data",))
    z = stlt_context_parallel(jnp.asarray(d["x"]), jnp.asarray(d["lm"]), jnp.asarray(d["th"]),
                              jnp.asarray(d["u"][0]), jnp.asarray(d["u"][1]), mesh, chunk=16)
    from repro.core.scan import stlt_chunked
    poles = tuple(jnp.asarray(a) for a in (d["lm"], d["th"], d["u"][0], d["u"][1]))
    cp_grads = {}
    for case in ("4x16", "4x24"):
        w = jnp.asarray(d["w_" + case])
        cp = lambda x, *p: (stlt_context_parallel(x, *p, mesh, chunk=16) * w).sum()
        serial = lambda x, *p: (stlt_chunked(x, *p, chunk=16) * w).sum()
        for name, f in (("cp", cp), ("serial", serial)):
            with jax.set_mesh(mesh):   # jitted: op by op the grads take ~25x longer
                g = jax.jit(jax.grad(f, argnums=tuple(range(5))))(jnp.asarray(d["x_" + case]),
                                                                  *poles)
            for k, a in zip(("dx", "lm", "th", "ur", "ui"), g):
                cp_grads[f"{name}_{case}_{k}"] = np.asarray(a)
    pmesh = jax.make_mesh((4,), ("pipe",))
    stage = lambda W, x: jnp.tanh(x @ W)
    def loss(W, x):
        y = pipeline_apply(stage, W, x, pmesh)
        return (y * d["cot"]).sum(), y
    def serial(W, x):
        for i in range(W.shape[0]):
            x = stage(W[i], x)
        return (x * d["cot"]).sum()
    W, x = jnp.asarray(d["W"]), jnp.asarray(d["pW_x"])
    with jax.set_mesh(pmesh):
        (_, y), (dW, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(W, x)
    sW, sx = jax.grad(serial, argnums=(0, 1))(W, x)
    np.savez(sys.argv[2], z=np.asarray(z), y=np.asarray(y), dW=np.asarray(dW),
             dx=np.asarray(dx), serial_dW=np.asarray(sW), serial_dx=np.asarray(sx),
             **cp_grads)
    import os, pickle
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.launch import steps as S
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD    # its import sets XLA_FLAGS; the backend is up
    os.environ["XLA_FLAGS"] = flags
    cells = pickle.load(open(sys.argv[3], "rb"))
    arg_bytes = {}
    for name, (jcfg, shape) in cells["train"].items():
        m = jax.make_mesh(shape, ("data", "model"))
        prog = S.build_train_step(jcfg, ShapeConfig("t", cells["N"], cells["B"], "train"), m,
                                  TrainConfig(**cells["tcfg"]))
        arg_bytes[name] = JD.analytic_arg_bytes(prog, m)
    pickle.dump(arg_bytes, open(sys.argv[4], "wb"))
"""


def _jax_cfg(cfg: ModelConfig) -> JModelConfig:
    names = {f.name for f in dataclasses.fields(JModelConfig)}
    return JModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                           if f.name in names})


def _jax_steps(jcfg, params_np, batches):
    """The JAX package's step on one device: params (as numpy, flattened by
    path) and metrics after each step."""
    shape = dataclasses.replace(J_SHAPES["train_4k"], seq_len=N, global_batch=B)
    prog = j_steps.build_train_step(jcfg, shape, jax.make_mesh((1, 1), ("data", "model")),
                                    JTrainConfig(**TCFG))
    fn = jax.jit(prog.fn)
    p = jax.tree_util.tree_map(jnp.asarray, params_np)
    o = j_make_optimizer("adamw").init(p)
    out = []
    for step, batch in enumerate(batches):
        p, o, m = fn(p, o, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(step))
        out.append({"params": {k: np.asarray(v) for k, v in j_flatten(p)},
                    "metrics": {k: float(v) for k, v in m.items()}})
    return out


def _port_steps(cfg, params, batches, draws=None):
    """The port's single-device ``make_step`` (CPU); ``draws`` per step, or
    None for the step's own."""
    opt, step_fn = t_train.make_step(cfg, TrainConfig(**TCFG))
    state = opt.init(params)
    out = []
    for step, batch in enumerate(batches):
        params, state, m = step_fn(params, state,
                                   {k: torch.from_numpy(v) for k, v in batch.items()}, step,
                                   draws=draws[step] if draws else None)
        out.append({"params": {k: v.numpy().copy() for k, v in tree_flatten_with_paths(params)},
                    "metrics": {k: float(v) for k, v in m.items()}})
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    cfgs = _cfgs()
    jcfgs = {key: _jax_cfg(cfgs[key]) for key in JAX_INIT}
    jparams = {key: jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
               for key, jcfg in jcfgs.items()}
    params = {}
    for key, cfg in cfgs.items():
        if key in JAX_INIT:
            params[cfg.name] = convert.from_jax_params(jparams[key], cfg, device="cpu")
        else:
            params[cfg.name] = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batches = _batches(64)
    adaptive = cfgs["stlt-adaptive"]
    draws = {adaptive.name: [_jax_draws(jcfgs["stlt-adaptive"], JTrainConfig(**TCFG).seed,
                                        step)
                             for step in range(STEPS)]}
    cp, pipe = _cp_inputs(), _pipe_inputs()
    np.savez(root / "jax_in.npz", x=cp["x"], lm=cp["lm"], th=cp["th"], u=cp["u"],
             W=pipe["W"], pW_x=pipe["x"], cot=pipe["cot"],
             **{f"{k}_{case}": cp["grad_" + case][i] for case in CP_GRAD_N
                for i, k in enumerate(("x", "w"))})
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    torch.save({
        "cfgs": cfgs, "params": params, "draws": draws, "tcfg": TCFG, "seq": N, "batch": B,
        "batches": [{k: t(v) for k, v in b.items()} for b in batches],
        "train": {**{k: (c, m, STEPS) for k, (c, m) in TRAIN.items()},
                  **{k: (c, m, 2) for k, (c, m) in DP.items()}},
        "refusals": REFUSALS, "dry": True,
        "cp": {"x": t(cp["x"]), "lm": t(cp["lm"]), "th": t(cp["th"]), "ur": t(cp["u"][0]),
               "ui": t(cp["u"][1]), "chunk": cp["chunk"],
               "grad": {case: tuple(map(t, cp["grad_" + case])) for case in CP_GRAD_N}},
        "pipe": {k: t(v) for k, v in pipe.items()},
    }, root / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu", **JAX_ENV)
    with open(root / "jax_cells.pkl", "wb") as f:
        pickle.dump({"train": {k: (jcfgs[c], m) for k, (c, m) in TRAIN.items()}, "N": N,
                     "B": B, "tcfg": TCFG}, f)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_REFS),
                               str(root / "jax_in.npz"), str(root / "jax_out.npz"),
                               str(root / "jax_cells.pkl"), str(root / "jax_arg_bytes.pkl")],
                              env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                                str(root), str(r), str(WORLD)], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
              for r in range(WORLD)]
    try:
        refs = {"jax": {key: _jax_steps(jcfgs[key], jparams[key], batches)
                        for key in JAX_INIT},
                "port": {key: _port_steps(cfgs[key], params[cfgs[key].name], batches,
                                          draws.get(cfgs[key].name))
                         for key in ("stlt", "stlt-adaptive")}}
        refs["port"]["stlt-fsdp"] = refs["port"]["stlt"]   # make_step has no layout
        for key in ("qwen2-fsdp", "qwen2-adafactor", "stlt-wide"):
            cfg = cfgs[key]
            refs[key] = _port_steps(cfg, params[cfg.name], batches[:2])
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-4000:]
    with open(root / "jax_arg_bytes.pkl", "rb") as f:
        arg_bytes = pickle.load(f)
    return {"res": torch.load(root / "results.pt", weights_only=False), "refs": refs,
            "jax": dict(np.load(root / "jax_out.npz")), "cp": cp, "pipe": pipe,
            "arg_bytes": arg_bytes, "cfgs": cfgs}


def _param_gap(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _flat(params) -> dict:
    return dict(tree_flatten_with_paths(params))


@pytest.mark.parametrize("ref", ["jax", "port"])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("mesh", list(TRAIN))
def test_sharded_step_matches_single_device(job, mesh, steps, ref):
    """Loss within 1e-4, every param within 1e-4 and the other metrics
    within 1e-4 relative of the single-device step after 1 and 3 steps
    (JAX's fsdp config is the same step). The grad norm holds the grads'
    scale, which AdamW's update does not show."""
    got = job["res"][mesh][steps - 1]
    want = job["refs"][ref][TRAIN[mesh][0]][steps - 1]
    assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= LOSS_TOL
    assert _param_gap(_flat(got["params"]), want["params"]) <= PARAM_TOL
    for k in [k for k in ("ce", "reg", "s_eff", "grad_norm", "lr") if k in want["metrics"]]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(DP))
def test_layouts_against_make_step(job, name):
    """Against ``make_step``, loss within 1e-4 and params within 1e-4 after
    2 steps: qwen2-1.5b reduced off the TP path (attention, FSDP over 4
    data ranks; AdamW, and adafactor, whose factored update runs on the
    gathered leaves), and a d_model-4096 STLT LM on 1 x 4, whose norm
    scales the rules shard on ``model`` and the forward gathers."""
    if name == "tp-wide-1x4":
        from repro_torch.distributed import comm
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch import steps as t_steps

        cfg = _cfgs()["stlt-wide"]
        specs = sh.param_specs(t_steps.abstract_params(cfg), cfg,
                               comm.MeshSpec((1, 4), ("data", "model")))
        assert tuple(specs["final_norm"]["scale"]) == ("model",)
    key = DP[name][0]
    for got, want in zip(job["res"][name], job["refs"][key]):
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= LOSS_TOL
        assert _param_gap(_flat(got["params"]), want["params"]) <= PARAM_TOL


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_context_parallel_matches_jax(job):
    """4 ranks, each K1's stateful call on its 16 tokens, one all-gather of
    end states: against JAX's ``stlt_context_parallel`` on 4 devices."""
    assert _rel(job["res"]["cp"], job["jax"]["z"]) <= REL_TOL


def test_context_parallel_matches_serial(job):
    """And against the serial scan over all 64 tokens (the port's plain K1
    version, one row per batch row)."""
    from repro_torch.kernels import ops

    c = job["cp"]
    S = c["lm"].shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    rows = [t(np.broadcast_to(a, (2, S))) for a in (c["lm"], c["th"], c["u"][0], c["u"][1])]
    want = ops.stlt_scan(t(c["x"]), *rows, chunk=c["chunk"]).numpy()
    assert _rel(job["res"]["cp"], want) <= REL_TOL


CP_GRADS = ("dx", "lm", "th", "ur", "ui")
# The backward's gate, relative to each grad's largest entry: JAX's own
# context-parallel grads sit within 5e-7 of its serial scan's here (the test
# reads that gap too), the port's within 5.4e-7 of both; 1e-5 leaves room
# for the port's other fp32 rounding order (K1's plain version, the
# analytic pole grads), ~20x that gap.
CP_GRAD_TOL = 1e-5


def _serial_cp_grads(c, case):
    """The port's serial training call (``ops.stlt_scan`` over all tokens, the
    poles repeated over the rows) differentiated by autograd: (dx, dlm, dth,
    dur, dui)."""
    from repro_torch.kernels import ops

    x, w = (torch.from_numpy(a) for a in c["grad_" + case])
    x.requires_grad_(True)
    poles = [torch.from_numpy(c[k]).requires_grad_(True) for k in ("lm", "th")]
    poles += [torch.from_numpy(np.ascontiguousarray(u)).requires_grad_(True) for u in c["u"]]
    rows = [p[None].expand(x.shape[0], -1) for p in poles]
    z = ops.stlt_scan(x, *rows, chunk=c["chunk"])
    return [g.numpy() for g in torch.autograd.grad((z * w).sum(), [x, *poles])]


@pytest.mark.parametrize("ref", ["jax", "serial"])
@pytest.mark.parametrize("case", list(CP_GRAD_N))
def test_context_parallel_grads(job, case, ref):
    """The backward: sum(w z) through ``stlt_context_parallel`` on 4 ranks,
    dx gathered over the ranks and every rank's grads of log_mag, theta,
    u_re and u_im, against ``jax.grad`` through the JAX package's function
    on 4 devices and against the port's serial training call, within
    ``CP_GRAD_TOL`` of each grad's largest entry; 4 x 24 tokens is not a
    multiple of the chunk. JAX's own CP-vs-serial gap is held to a tenth of
    the gate."""
    res, j = job["res"]["cp_grad"][case], job["jax"]
    if ref == "jax":
        want = [j[f"cp_{case}_{k}"] for k in CP_GRADS]
        for k, w in zip(CP_GRADS, want):
            assert _rel(w, j[f"serial_{case}_{k}"]) <= CP_GRAD_TOL / 10, k
    else:
        want = _serial_cp_grads(job["cp"], case)
    assert _rel(res["dx"], want[0]) <= CP_GRAD_TOL
    for r in range(WORLD):
        for k, got, w in zip(CP_GRADS[1:], res["poles"][r], want[1:]):
            assert _rel(got, w) <= CP_GRAD_TOL, (r, k)


def test_context_parallel_backward_runs_two_passes_per_rank(job):
    """Each rank's forward + backward runs the scan's pass twice (K1's
    stateful forward and its anti-causal dx pass on the card), and every
    rank holds the whole pole and mixer gradient."""
    for res in job["res"]["cp_grad"].values():
        assert res["passes"] == [2] * WORLD
        assert all(np.array_equal(res["poles"][r], res["poles"][0]) for r in range(WORLD))


@pytest.mark.parametrize("what", ["y", "dW", "dx"])
def test_pipeline_matches_jax(job, what):
    """4 stages of tanh(x W), 6 microbatches of 2: the outputs, every
    stage's weight grad and the input grad against JAX's ``pipeline_apply``
    differentiated by ``jax.value_and_grad``. The JAX package's autodiff
    through its ``shard_map`` (``check_vma=False``, an unmapped ``P(None)``
    output) gives 1/D of the gradient: the test first holds JAX's grads
    times D to JAX's own serial grads, then the port's grads to them."""
    j = job["jax"]
    scale = 1.0 if what == "y" else float(job["pipe"]["W"].shape[0])
    if what != "y":
        assert _rel(scale * j[what], j["serial_" + what]) <= REL_TOL
    assert _rel(job["res"]["pipe"][what], scale * j[what]) <= REL_TOL


def test_pipeline_matches_serial(job):
    """The outputs and grads against autograd through the 4 stages in turn."""
    p = job["pipe"]
    W = torch.from_numpy(p["W"]).requires_grad_(True)
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    y = x
    for i in range(W.shape[0]):
        y = torch.tanh(y @ W[i])
    (y * torch.from_numpy(p["cot"])).sum().backward()
    res = job["res"]["pipe"]
    for got, want in ((res["y"], y), (res["dW"], W.grad), (res["dx"], x.grad)):
        assert _rel(got, want.detach().numpy()) <= REL_TOL


def test_remesh_two_by_two_to_one_by_two(job):
    """After a data rank is lost: ranks 0 and 1 hold exactly the 1 x 2
    mesh's shards of the unsharded tree, and gathering them gives the tree
    back bit for bit; ranks 2 and 3 hold nothing."""
    r = job["res"]["remesh"]
    assert r[0] == r[1] == {"same": True, "whole": True}
    assert r[2] == r[3] == {"none": True}


@pytest.mark.parametrize("name,what", [("refuse-rel-2x2", "'model' axis > 1"),
                                       ("refuse-hann-2x2", "/hann/"),
                                       ("refuse-moe-4x1", "MoE over more than one batch")])
def test_unported_layouts_raise(job, name, what):
    """A ``model`` axis > 1 on a relevance block (``stlt_rel``) and on the
    hann window, and a MoE off the TP path (its balance losses and capacity
    would be per shard) over several batch shards, raise
    NotImplementedError naming the ROADMAP item."""
    msg = job["res"][name]
    assert msg is not None and what in msg and "ROADMAP Queue 1 item 7" in msg


@pytest.mark.parametrize("name", [*TRAIN, *DP])
def test_dry_run_counts_equal_each_ranks(job, name):
    """On every rank, the dry-run of the train cell (``lower_cell`` on the
    rank's ``comm.RankMesh``, on ``meta``) hands each kind of collective
    the bytes the rank's first real step handed it (``comm.STATS``), makes
    as many calls of each kind (``comm.CALLS``) and as many scan passes."""
    for rank, counts in enumerate(job["res"]["counts"]):
        c = counts[name]
        assert c["dry"] == c["real"], (name, rank, c)
        assert c["real"]["bytes"], name     # every cell here exchanges something


@pytest.mark.parametrize("name", list(TRAIN))
def test_analytic_arg_bytes_equal_jax(job, name):
    """The port's ``dryrun.analytic_arg_bytes`` of the train cell (params,
    AdamW state, batch, step: shapes over their specs) equals the JAX
    dry-run's, byte for byte, but for AdamW's step count: an int32 on the
    device in the JAX package, a Python int on the host in the port (4
    bytes less in ``opt_state`` and the total)."""
    key, shape = TRAIN[name]
    mesh = comm.MeshSpec(shape, ("data", "model"))
    prog = t_steps.build_train_step(job["cfgs"][key], ShapeConfig("t", N, B, "train"), mesh,
                                    TrainConfig(**TCFG))
    want = dict(job["arg_bytes"][name])
    want["opt_state"] -= 4
    want["total"] -= 4
    assert t_dryrun.analytic_arg_bytes(prog, mesh) == want
