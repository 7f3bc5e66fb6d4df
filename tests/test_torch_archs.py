"""The port's arch registry, the assigned shape set and the untied LM head
against the JAX package on the CPU: chatglm3-6b, granite-20b, internvl2-76b
recurrentgemma-9b, xlstm-350m, qwen3-moe-235b-a22b and arctic-480b field for
field (native and STLT, full and reduced), xlstm-350m's STLT refusal,
``all_cells()`` and ``input_specs``, the head
drawn last by ``init_lm``, and reduced chatglm3-6b, granite-20b and
internvl2-76b in both variants: logits, loss and every grad leaf through
the untied head, with token inputs and, for ``input_mode`` "both" and
"embeddings", float inputs [B, N, d] (prefill and decode steps too); then
the serve and train command lines on the new archs.

Both packages get the same weights (``convert.from_jax_params``) and inputs
from numpy seeds, in fp32. Tolerances: logits rtol 2e-4 / atol 1e-5 (the
JAX package's own for attention), the loss 2e-5 relative, each grad leaf
within 1e-3 of its largest entry (fp32 summation order through 4 layers).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import serve as t_serve_cli  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths  # noqa: E402
from torch_threads import cpu_test_settings  # noqa: E402,F401  (autouse)

RTOL, ATOL = 2e-4, 1e-5
NEW_ARCHS = ("chatglm3-6b", "granite-20b", "internvl2-76b", "recurrentgemma-9b",
             "xlstm-350m", "qwen3-moe-235b-a22b", "arctic-480b")


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# (1) the registry, the shape set, the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("variant", ["native", "stlt"])
def test_new_configs_match_jax_field_for_field(arch, variant):
    """get_config and .reduced() of the archs ported after the attention
    mixer, every port field as the JAX package's (the sharding hints
    ``fsdp`` and ``dp_only``, the MoE fields and ``slstm_every`` included,
    with their reduced sizes); the hybrid's STLT
    variant replaces only its local-attention third; xlstm-350m's STLT
    variant is refused with JAX's ValueError."""
    if (arch, variant) == ("xlstm-350m", "stlt"):
        with pytest.raises(ValueError) as want:
            j_configs.get_config(arch, variant)
        with pytest.raises(ValueError) as got:
            t_configs.get_config(arch, variant)
        assert str(got.value) == str(want.value)
        return
    for got, want in ((t_configs.get_config(arch, variant), j_configs.get_config(arch, variant)),
                      (t_configs.get_config(arch, variant).reduced(),
                       j_configs.get_config(arch, variant).reduced())):
        for f in dataclasses.fields(TModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    if arch == "recurrentgemma-9b":
        types = t_configs.get_config(arch, variant).block_types()
        assert types.count("rglru") == 26
        assert types.count("stlt" if variant == "stlt" else "local_attn") == 12
    if arch == "xlstm-350m":
        types = t_configs.get_config(arch).block_types()
        assert types.count("slstm") == 3 and types[7::8] == ("slstm",) * 3
    if arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        assert t_configs.get_config(arch, variant).is_moe
        assert t_configs.get_config(arch, variant).optimizer == "adafactor"


def test_unported_archs_are_refused_and_registry_order_matches_jax():
    """The port has every arch of the JAX package, in JAX's order, none
    refused; the one undefined variant (xlstm-350m's STLT form) and an
    unknown one are refused as the JAX package refuses them; the shape set
    is JAX's."""
    assert list(t_configs.ARCH_IDS) == list(t_configs.ARCHS) == list(j_configs.ARCHS)
    assert t_configs.list_archs() == j_configs.list_archs()
    assert t_configs.STLT_APPLICABLE == j_configs.STLT_APPLICABLE
    assert t_configs.NATIVE_SUBQUADRATIC == j_configs.NATIVE_SUBQUADRATIC
    for arch in j_configs.ARCHS:
        for variant in ("native", "stlt"):
            if arch in j_configs.STLT_APPLICABLE or variant == "native":
                assert t_configs.get_config(arch, variant).name == arch
                continue
            with pytest.raises(ValueError, match="STLT variant undefined"):
                j_configs.get_config(arch, variant)
            with pytest.raises(ValueError, match="STLT variant undefined"):
                t_configs.get_config(arch, variant)
    with pytest.raises(ValueError, match="unknown variant"):
        t_configs.get_config("xlstm-350m", "hybrid")
    for name, shape in j_configs.SHAPES.items():
        assert dataclasses.astuple(t_configs.SHAPES[name]) == dataclasses.astuple(shape)


def test_all_cells_match_jax():
    """Every cell's key, shape, variant and skip reason as the JAX
    package's, for all eleven archs."""
    got = [(c.key, dataclasses.astuple(c.shape), c.variant, c.skip)
           for c in t_configs.all_cells()]
    want = [(c.key, dataclasses.astuple(c.shape), c.variant, c.skip)
            for c in j_configs.all_cells()]
    assert got == want and len(got) == 40


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("cell", [c for c in t_configs.all_cells() if not c.skip],
                         ids=lambda c: c.key)
def test_input_specs_match_jax(cell):
    """input_specs of every cell that is not skipped: the same names,
    shapes and dtypes as the JAX package's ShapeDtypeStructs, as tensors on
    the meta device (no storage)."""
    want = j_steps.input_specs(cell.arch, cell.shape.name, cell.variant)
    got = t_steps.input_specs(cell.arch, cell.shape.name, cell.variant)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _DTYPES[str(w.dtype)], k


# ---------------------------------------------------------------------------
# (2) the untied head and embedding inputs
# ---------------------------------------------------------------------------


def test_init_lm_draws_the_head_last():
    """An untied head is drawn after every other leaf, so a tied config's
    params do not move; ``embed`` exists for "tokens" and "both" inputs,
    ``lm_head`` for an untied head or "embeddings" inputs, as in JAX."""
    cfg = t_configs.get_config("chatglm3-6b").reduced()
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    untied_p = TT.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    tied_p = TT.init_lm(tied, torch.Generator().manual_seed(3), device="cpu")
    assert "lm_head" not in tied_p and tuple(untied_p["lm_head"]["kernel"].shape) == (64, 256)
    for (path, a), (_, b) in zip(tree_flatten_with_paths({k: v for k, v in untied_p.items()
                                                         if k != "lm_head"}),
                                 tree_flatten_with_paths(tied_p)):
        assert torch.equal(a, b), path
    for mode, tie in (("tokens", True), ("tokens", False), ("both", False),
                      ("embeddings", True), ("embeddings", False)):
        tc = dataclasses.replace(cfg, input_mode=mode, tie_embeddings=tie)
        jc = dataclasses.replace(j_configs.get_config("chatglm3-6b").reduced(),
                                 input_mode=mode, tie_embeddings=tie)
        want = JT.init_lm(jax.random.key(0), jc)
        got = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
        assert sorted(got) == sorted(want), (mode, tie)
        shapes = dict((p, tuple(x.shape)) for p, x in tree_flatten_with_paths(got))
        converted = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, want), tc,
                                            device="cpu")
        assert shapes == {p: tuple(x.shape) for p, x in tree_flatten_with_paths(converted)}


@functools.partial(jax.jit, static_argnums=1)
def j_forward_and_grads(params, cfg, batch):
    """(loss, logits) and the loss's grads, one JAX program."""
    def f(p):
        loss, _ = JT.lm_loss(p, cfg, batch, deterministic=True)
        return loss, JT.apply_lm(p, cfg, batch["inputs"])[0]
    return jax.value_and_grad(f, has_aux=True)(params)


@functools.lru_cache(maxsize=None)
def _model(arch, variant, **extra):
    jcfg = dataclasses.replace(j_configs.get_config(arch, variant).reduced(), **extra)
    tcfg = dataclasses.replace(t_configs.get_config(arch, variant).reduced(), **extra)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(1), jcfg))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.from_jax_params(tree, tcfg, device="cpu"))


def _inputs(tcfg, seed, B=2, N=20):
    r = np.random.default_rng(seed)
    labels = r.integers(0, tcfg.vocab, (B, N)).astype(np.int32)
    if tcfg.input_mode == "tokens":
        return r.integers(0, tcfg.vocab, (B, N)).astype(np.int32), labels
    return r.normal(size=(B, N, tcfg.d_model)).astype(np.float32), labels


# (arch, variant, extra config fields): internvl2-76b's "both" takes the
# float stand-ins (its token table gets a zero grad), and an "embeddings"
# model, tied, has a head and no token table
UNTIED_CASES = [("chatglm3-6b", "native", ()), ("chatglm3-6b", "stlt", ()),
                ("granite-20b", "native", ()), ("granite-20b", "stlt", ()),
                ("internvl2-76b", "native", ()), ("internvl2-76b", "stlt", ()),
                ("internvl2-76b", "native", (("input_mode", "embeddings"),
                                             ("tie_embeddings", True)))]


@pytest.mark.parametrize("arch,variant,extra", UNTIED_CASES,
                         ids=[f"{a}-{v}{'-embeddings' if e else ''}" for a, v, e in UNTIED_CASES])
def test_untied_head_logits_loss_and_grads_match_jax(arch, variant, extra):
    """apply_lm logits, lm_loss and every grad leaf (the head's, and the
    token table's where there is one) on 2 x 20 inputs against JAX."""
    jcfg, tcfg, jp, tp = _model(arch, variant, **dict(extra))
    assert "lm_head" in tp and ("embed" in tp) == (tcfg.input_mode != "embeddings")
    inputs, labels = _inputs(tcfg, 2)
    (loss_j, logits_j), gj = j_forward_and_grads(
        jp, jcfg, {"inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)})
    batch = {"inputs": torch.from_numpy(inputs), "labels": torch.from_numpy(labels)}
    logits_t, _ = TT.apply_lm(tp, tcfg, batch["inputs"])
    _close(logits_t, logits_j, "logits")
    loss_t, _, gt = t_train.loss_and_grads(tp, tcfg, batch, tau=1.0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, gj), tcfg, device="cpu")
    for (path, g), (_, w) in zip(tree_flatten_with_paths(gt), tree_flatten_with_paths(want)):
        _close(g, w, f"grad {path}", 1e-3, 1e-3 * float(w.abs().max()) + 1e-7)
    assert float(gt["lm_head"]["kernel"].abs().max()) > 0
    if tcfg.input_mode == "both":
        assert not gt["embed"]["embed"].any()


j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)


@pytest.mark.parametrize("mode", ["both", "embeddings"])
def test_float_inputs_prefill_and_decode_match_jax(mode):
    """internvl2-76b's float inputs through the serving forms: prefill of
    [2, 12, d] stand-ins, a chunk of [2, 5, d], then decode steps from
    tokens ("both") or from [2, d] embeddings ("embeddings"), logits as
    JAX's."""
    extra = () if mode == "both" else (("input_mode", "embeddings"), ("tie_embeddings", True))
    jcfg, tcfg, jp, tp = _model("internvl2-76b", "native", **dict(extra))
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 17, tcfg.d_model)).astype(np.float32)
    lj, sj = j_prefill(jp, jcfg, jnp.asarray(x[:, :12]), 32)
    lt, st = TT.prefill(tp, tcfg, torch.from_numpy(x[:, :12]), 32)
    _close(lt, lj, "prefill")
    lj, sj = j_prefill_chunk(jp, jcfg, jnp.asarray(x[:, 12:]), sj)
    lt, st = TT.prefill_chunk(tp, tcfg, torch.from_numpy(x[:, 12:]), st)
    _close(lt, lj, "prefill_chunk")
    for i in range(3):
        step = (r.integers(0, tcfg.vocab, 2).astype(np.int32) if mode == "both"
                else r.normal(size=(2, tcfg.d_model)).astype(np.float32))
        lj, sj = j_decode_step(jp, jcfg, jnp.asarray(step), sj)
        lt, st = TT.decode_step(tp, tcfg, torch.from_numpy(step), st)
        _close(lt, lj, f"decode step {i}")


# ---------------------------------------------------------------------------
# (3) the command lines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--arch", "recurrentgemma-9b", "--prefill-chunk", "8", "--max-len", "64"],
    ["--arch", "recurrentgemma-9b", "--variant", "stlt", "--prefill-chunk", "8",
     "--spec-k", "3", "--spec-draft", "nodes", "--spec-draft-nodes", "4"],
    ["--arch", "chatglm3-6b", "--variant", "stlt", "--prefill-chunk", "8"],
    ["--arch", "granite-20b", "--max-len", "64"],
    ["--arch", "internvl2-76b", "--variant", "stlt"],
], ids=["rg-native", "rg-stlt-nodes", "chatglm3-stlt", "granite", "internvl2-stlt"])
def test_serve_cli_runs_the_new_archs_on_the_cpu(capsys, argv):
    """The serve CLI takes the new arch ids with --variant and --reduced."""
    results, _ = t_serve_cli.main(argv + ["--reduced", "--device", "cpu", "--requests", "3",
                                          "--slots", "2", "--max-new", "4",
                                          "--prompt-len", "20"])
    assert sorted(results) == [0, 1, 2] and all(len(v) == 4 for v in results.values())
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch,variant", [("recurrentgemma-9b", "stlt"),
                                          ("internvl2-76b", "native")])
def test_train_cli_runs_the_new_archs_on_the_cpu(capsys, arch, variant):
    """The train CLI trains reduced recurrentgemma-9b's STLT variant and
    internvl2-76b (on tokens, as the JAX CLI does: its token table and the
    head both take steps; adafactor, the config's optimizer)."""
    state = t_train.main(["--arch", arch, "--variant", variant, "--reduced", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "32", "--log-every", "1",
                          "--data", "synthetic"])
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "done" in out
    assert all(bool(torch.isfinite(x).all()) for _, x in tree_flatten_with_paths(state["params"]))
