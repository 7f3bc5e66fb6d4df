"""The port's sharding rules against the JAX package's, leaf for leaf, for
every arch and variant on five meshes: (1, 1), (2, 2), (4, 2) and the
production (16, 16) and (2, 16, 16).

The JAX functions read only ``mesh.axis_names`` and ``mesh.shape``, so a
``types.SimpleNamespace`` stand-in runs them in this process with no forced
devices; the port's take a shape-only ``comm.MeshSpec``. Param and
optimizer-state shapes are abstract on both sides (``jax.eval_shape``; the
port's init on fake tensors). The JAX configs are taken at
``scan_layers=False``, the port's layout (one dict per layer).
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.utils import _path_str  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as t_sh  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import make_optimizer as t_make_optimizer  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CONFIGS = [(a, v) for a in t_configs.ARCH_IDS for v in ("native", "stlt")
           if v == "native" or a in t_configs.STLT_APPLICABLE]
DECODE_B, DECODE_N = 128, 4096


def _j_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _t_mesh(name):
    return comm.MeshSpec(*MESHES[name])


def _j_specs(tree) -> dict:
    """By path; an enc-dec model's unstacked layer lists (``enc_list``,
    ``dec_list`` at ``scan_layers=False``) under the port's names
    (``enc_layers``, ``dec_layers``: one dict per layer in every layout)."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, sp in flat:
        name = "/".join(_path_str(p) for p in path)
        out[name.replace("enc_list/", "enc_layers/").replace("dec_list/", "dec_layers/")] = \
            tuple(sp)
    return out


def _t_specs(tree) -> dict:
    return {k: tuple(sp) for k, sp in tree_flatten_with_paths(tree)}


@functools.lru_cache(maxsize=None)
def _cfgs(arch, variant):
    jcfg = dataclasses.replace(j_configs.get_config(arch, variant), scan_layers=False)
    tcfg = dataclasses.replace(t_configs.get_config(arch, variant), scan_layers=False)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _j_shapes(arch, variant):
    jcfg, _ = _cfgs(arch, variant)
    p = j_steps.abstract_params(jcfg)
    opts = {name: jax.eval_shape(j_make_optimizer(name).init, p)
            for name in ("adamw", "adafactor")}
    return p, opts


@functools.lru_cache(maxsize=None)
def _t_shapes(arch, variant):
    _, tcfg = _cfgs(arch, variant)
    init = t_steps.init_fn(tcfg)
    p = t_steps.abstract_params(tcfg)
    opts = {name: t_steps._abstract(
        lambda name=name: t_make_optimizer(name).init(init(torch.Generator(), "cpu")))
        for name in ("adamw", "adafactor")}
    return p, opts


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,variant", CONFIGS)
def test_param_and_opt_state_specs_match_jax(arch, variant, mesh):
    """``param_specs``, ``opt_state_specs`` (AdamW and adafactor, whose
    factored moments drop a dim of their param's spec) and ``batch_axes``
    equal the JAX package's leaf for leaf."""
    jcfg, tcfg = _cfgs(arch, variant)
    jm, tm = _j_mesh(mesh), _t_mesh(mesh)
    jp, jopts = _j_shapes(arch, variant)
    tp, topts = _t_shapes(arch, variant)
    jspecs = j_sh.param_specs(jp, jcfg, jm)
    tspecs = t_sh.param_specs(tp, tcfg, tm)
    assert _t_specs(tspecs) == _j_specs(jspecs)
    for name in ("adamw", "adafactor"):
        want = _j_specs(j_sh.opt_state_specs(jopts[name], jp, jspecs, jcfg, jm))
        got = _t_specs(t_sh.opt_state_specs(topts[name], tp, tspecs, tcfg, tm))
        assert got == want, name
    for batch in (1, 4, 256):
        assert t_sh.batch_axes(tcfg, tm, batch) == j_sh.batch_axes(jcfg, jm, batch)


@pytest.mark.parametrize("arch,variant", [c for c in CONFIGS if c[0] != "whisper-base"])
def test_decode_state_specs_match_jax(arch, variant):
    """``launch.steps.decode_state_specs`` (rows over the batch axes, heads
    over ``model``) and the serving pool's ``sharding.decode_state_specs``
    equal the JAX package's on every mesh (the LM families' states)."""
    jcfg, tcfg = _cfgs(arch, variant)
    jstate = jax.eval_shape(lambda: JT.init_decode_state(jcfg, DECODE_B, DECODE_N))
    tstate = TT.init_decode_state(tcfg, DECODE_B, DECODE_N, device="meta")
    for mesh in MESHES:
        jm, tm = _j_mesh(mesh), _t_mesh(mesh)
        want = _j_specs(j_steps.decode_state_specs(jstate, jcfg, jm, DECODE_B))
        assert _t_specs(t_steps.decode_state_specs(tstate, tcfg, tm, DECODE_B)) == want, mesh
    want = _j_specs(j_sh.decode_state_specs(jstate, JT.execution_plan(jcfg)))
    assert _t_specs(t_sh.decode_state_specs(tstate)) == want


def test_production_mesh_is_shape_only_without_a_job():
    """Without a process group of 256 (512) ranks the production meshes are
    their shape-only descriptions, which the specs read."""
    from repro_torch.launch import mesh as t_mesh

    m = t_mesh.make_production_mesh()
    assert type(m) is comm.MeshSpec and m.shape == {"data": 16, "model": 16}
    m = t_mesh.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_host_mesh(2, 2)


def test_train_step_specs_match_jax():
    """``build_train_step`` on a shape-only 16 x 16 mesh: its in/out specs
    (params, optimizer state, batch, metrics) equal the JAX program's, and
    calling its step raises (it needs a process mesh)."""
    shape = j_configs.SHAPES["train_4k"]
    for arch in ("stlt-base", "qwen3-moe-235b-a22b"):
        jcfg = dataclasses.replace(j_configs.get_config(arch), scan_layers=False)
        tcfg = dataclasses.replace(t_configs.get_config(arch), scan_layers=False)
        jprog = j_steps.build_train_step(jcfg, shape, _j_mesh("16x16"))
        tprog = t_steps.build_train_step(tcfg, t_configs.SHAPES["train_4k"], _t_mesh("16x16"))
        for j, t in zip(jprog.in_shardings[:3], tprog.in_shardings[:3]):
            assert _t_specs(t) == _j_specs(j), arch
        assert _t_specs(tprog.out_shardings[2]) == _j_specs(jprog.out_shardings[2])
        assert tprog.donate_argnums == jprog.donate_argnums
        with pytest.raises(RuntimeError, match="process mesh"):
            tprog.fn()
