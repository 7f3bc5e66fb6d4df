"""Parity of the PyTorch port's LM and greedy serving with the JAX package,
on the CPU.

The model is ``stlt_base`` cut to 2 layers (``reduced()`` widths: d_model
64, 4 heads, 8 nodes, chunk 16, vocab 256) with ``scan_layers=True``, so the
JAX package stacks both blocks on one leading axis and
``convert.from_jax_params`` has to unstack them. The adaptive gate's weights
are scaled up so node masks vary per row. Tolerances: logits atol 1e-4
(fp32 through 2 blocks and a 256-way head); greedy token streams exactly,
with every step's top-2 logit margin checked to exceed 10x that tolerance
so the equality is not a tie-break accident.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.stlt_base import CONFIG as J_CONFIG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.stlt_base import CONFIG as T_CONFIG  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

LOGIT_ATOL = 1e-4
B, PROMPT, NEW = 2, 24, 12

# the JAX model functions, jitted (config static) so each compiles once
j_apply_lm = jax.jit(JT.apply_lm, static_argnums=1)
j_lm_loss = jax.jit(JT.lm_loss, static_argnums=1, static_argnames="deterministic")
j_prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
j_prefill_chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
j_decode_step = jax.jit(JT.decode_step, static_argnums=1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=LOGIT_ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _state_close(st, sj, atol=1e-4):
    """Port state vs a JAX state (stacked runs unstacked by the converter)."""
    conv = convert.from_jax_state(jax.tree_util.tree_map(np.asarray, sj),
                                  st_cfg(), device="cpu")
    np.testing.assert_array_equal(_np(st["pos"]), _np(conv["pos"]))
    for lt, lj in zip(st["layers"], conv["layers"]):
        assert sorted(lt) == sorted(lj)
        for k in lt:
            _close(lt[k], lj[k], atol=atol * (100 if k == "asum" else 1))


def st_cfg():
    return T_CONFIG.reduced(num_layers=2, scan_layers=True)


@pytest.fixture(scope="module")
def model():
    jcfg = J_CONFIG.reduced(num_layers=2, scan_layers=True)
    tcfg = st_cfg()
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jax.random.key(0), jcfg))
    ad = tree["layers"][0]["stlt"]["adaptive"]     # stacked [2, ...]
    ad["w_alpha"] = ad["w_alpha"] * 60.0
    ad["b_alpha"] = ad["b_alpha"] - 2.0
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree, tcfg, device="cpu")
    return jcfg, tcfg, tree, jparams, tparams


def _prompts(seed, b=B, n=PROMPT, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n)).astype(np.int32)


def test_config_mirrors_jax():
    for jc, tc in ((J_CONFIG, T_CONFIG), (J_CONFIG.reduced(), T_CONFIG.reduced())):
        for f in dataclasses.fields(TModelConfig):
            if f.name in ("dtype", "param_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name)
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.block_types() == jc.block_types()
        assert TT.execution_plan(tc) == JT.execution_plan(jc)


def test_converter_unstacks_scanned_layers(model):
    jcfg, tcfg, tree, _, tparams = model
    assert JT.execution_plan(jcfg) == (("stlt", 2),)
    assert len(tree["layers"]) == 1 and len(tparams["layers"]) == 2
    for j, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(_np(layer["stlt"]["w_v"]),
                                      tree["layers"][0]["stlt"]["w_v"][j])
        np.testing.assert_array_equal(_np(layer["ffn"]["w1"]),
                                      tree["layers"][0]["ffn"]["w1"][j])
    unstacked = dataclasses.replace(tcfg, scan_layers=False)
    with pytest.raises(ValueError, match="layer runs"):
        convert.from_jax_params(tree, unstacked, device="cpu")


def test_apply_lm_and_loss_match_jax(model):
    jcfg, tcfg, _, jparams, tparams = model
    toks = _prompts(1, n=37)
    lj, auxj = j_apply_lm(jparams, jcfg, jnp.asarray(toks))
    lt, auxt = TT.apply_lm(tparams, tcfg, torch.from_numpy(toks))
    _close(lt, lj)
    _close(auxt["reg"], auxj["reg"], atol=1e-6)
    _close(auxt["s_eff"], auxj["s_eff"], atol=1e-5)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1)}
    lossj, mj = j_lm_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          deterministic=True)
    losst, mt = TT.lm_loss(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                           deterministic=True)
    _close(losst, lossj, atol=1e-5)
    _close(mt["ce"], mj["ce"], atol=1e-5)


def test_prefill_and_decode_match_jax(model):
    jcfg, tcfg, _, jparams, tparams = model
    toks = _prompts(2)
    lj, sj = j_prefill(jparams, jcfg, jnp.asarray(toks), 64)
    lt, st = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 64)
    _close(lt, lj)
    _state_close(st, sj)
    cap = np.array([8, 3], np.int32)
    tok = np.argmax(_np(lj), -1).astype(np.int32)
    for _ in range(3):
        lj, sj = j_decode_step(jparams, jcfg, jnp.asarray(tok), sj,
                               node_cap=jnp.asarray(cap))
        lt, st = TT.decode_step(tparams, tcfg, torch.from_numpy(tok), st,
                                node_cap=torch.from_numpy(cap))
        _close(lt, lj)
        tok = np.argmax(_np(lj), -1).astype(np.int32)
    _state_close(st, sj)


def test_prefill_chunk_resumes_from_a_jax_state(model):
    """The port resumes from a state the JAX package produced: a padded
    chunk with per-row valid lengths, one row 0 (an exact no-op)."""
    jcfg, tcfg, _, jparams, tparams = model
    b = 3
    first = _prompts(3, b=b, n=20)
    _, sj = j_prefill_chunk(jparams, jcfg, jnp.asarray(first),
                            JT.init_decode_state(jcfg, b, 64))
    st = convert.from_jax_state(jax.tree_util.tree_map(np.asarray, sj), tcfg,
                                device="cpu")
    nxt = _prompts(4, b=b, n=16)
    valid = np.array([16, 0, 9], np.int32)
    lj, sj2 = j_prefill_chunk(jparams, jcfg, jnp.asarray(nxt), sj,
                              valid_len=jnp.asarray(valid))
    lt, st2 = TT.prefill_chunk(tparams, tcfg, torch.from_numpy(nxt), st,
                               valid_len=torch.from_numpy(valid))
    _close(lt[valid > 0], np.asarray(lj)[valid > 0])
    _state_close(st2, sj2)
    for k, v in st["layers"][0].items():  # the valid == 0 row is untouched
        torch.testing.assert_close(st2["layers"][0][k][1], v[1], rtol=0, atol=0)


def _margins(tparams, tcfg, prompts, steps, serve_nodes):
    """Top-2 logit margin at every greedy step of the port."""
    caps = torch.full((len(prompts),), serve_nodes, dtype=torch.int32)
    logits, st = TT.prefill(tparams, tcfg, torch.from_numpy(prompts), 64)
    out = []
    for i in range(steps):
        top2 = torch.topk(logits, 2, dim=-1).values
        out.append(_np(top2[:, 0] - top2[:, 1]))
        if i + 1 < steps:
            logits, st = TT.decode_step(tparams, tcfg, logits.argmax(-1), st,
                                        node_cap=caps)
    return np.stack(out, 1)


@pytest.mark.parametrize("serve_nodes", [None, 3])
def test_generate_greedy_matches_jax_token_for_token(model, serve_nodes):
    jcfg, tcfg, _, jparams, tparams = model
    prompts = _prompts(5)
    want = JServeEngine(jparams, jcfg, max_len=64).generate(
        prompts, NEW, serve_nodes=serve_nodes)
    got = ServeEngine(tparams, tcfg, max_len=64, device="cpu").generate(
        prompts, NEW, serve_nodes=serve_nodes)
    margins = _margins(tparams, tcfg, prompts, NEW,
                       serve_nodes if serve_nodes is not None else tcfg.stlt_nodes)
    assert margins.min() > 10 * LOGIT_ATOL, margins.min()
    np.testing.assert_array_equal(got, want)


def test_entry_points_default_to_cuda_and_raise_without_it(model, monkeypatch):
    _, tcfg, tree, _, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(tparams, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.init_lm(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.from_jax_params(tree, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.init_decode_state(tcfg, 1, 64)


@pytest.mark.parametrize("top_k", [0, 5])
def test_temperature_sampling_is_reproducible(model, top_k):
    _, tcfg, _, _, tparams = model
    eng = ServeEngine(tparams, tcfg, max_len=64, temperature=0.9, top_k=top_k,
                      device="cpu")
    prompts = _prompts(6)
    a = eng.generate(prompts, 8, generator=torch.Generator().manual_seed(7))
    b = eng.generate(prompts, 8, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, 8) and a.dtype == np.int32
    assert ((a >= 0) & (a < tcfg.vocab)).all()


def test_init_lm_layout_matches_jax_unstacked(model):
    jcfg, tcfg, tree, _, _ = model
    tp = TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    conv = convert.from_jax_params(tree, tcfg, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(tp) == shapes(conv)
    logits, _ = TT.apply_lm(tp, tcfg, torch.from_numpy(_prompts(8)))
    assert torch.isfinite(logits).all()
