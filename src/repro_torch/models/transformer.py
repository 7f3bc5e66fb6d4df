"""Decoder-only LM with pluggable token mixers: forward, loss and serving.

Parameters mirror the JAX pytree keys (``embed/embed`` for token inputs,
``layers``, ``final_norm``, ``lm_head/kernel`` for an untied head or
embedding inputs; per block ``norm1``, one of ``stlt``, ``attn``, ``rec``
or ``cell``, then ``norm2`` and ``ffn`` or ``moe``, which xLSTM blocks
lack) with one
difference: ``params["layers"]`` always holds one dict per layer. The JAX
package stacks runs of equal blocks on a leading axis when
``scan_layers=True``; ``convert.from_jax_params`` unstacks them along
``execution_plan``. Decode states follow suit: ``{"layers": [one state per
layer], "pos": [B] int32}``; a state of ``n_slots`` rows is the serving
engine's slot pool (``insert_slot``, ``extract_slot``, ``reset_slot``).
``spec_verify`` scores a speculative draft window and rolls each row's
state to its accepted length. Activations run in ``cfg.dtype`` over
parameters in ``cfg.param_dtype``, products promoted as JAX promotes them
(``layers.matmul``): a bf16 model's logits come out fp32.

Block types, all of the JAX package's: ``stlt`` (factorized), ``stlt_rel``
(the relevance readout, ``mixer="stlt_relevance"``), ``attn`` (GQA softmax
attention with RoPE, ``models/attention.py``), ``local_attn`` (the same in
a window of ``cfg.local_window`` keys, a ring-buffer KV cache), ``rglru``
(Griffin's recurrent block, ``models/rglru.py``; with ``local_attn`` it
makes the hybrid family), and ``mlstm`` and ``slstm`` (the xLSTM cells,
``models/xlstm.py``, ``family="xlstm"``: no FFN). With ``cfg.num_experts``
the FFN of every block that has one is a mixture of experts
(``models/moe.py``), whose ``aux_loss`` and ``router_z`` enter the loss; the
serving paths discard them. An attention
block's decode state is its KV cache (``k``, ``v`` [B, size, Hkv, dh] in the
activation dtype, ``pos`` [B]); the STLT's is O(S*d), the rg-LRU's O(d)
(``h`` [B, d], ``conv_buf`` [B, 3, d], fp32), the mLSTM's O(d^2/H) (``C``,
``n``, ``m``, ``conv_buf``) and the sLSTM's O(d) (``h``, ``c``, ``n``,
``m``), all fp32. The sinusoidal PE is added at the input unless the mixer
is attention, and always for ``family="xlstm"``, as in the JAX package. A
relevance block has no streaming state, so
``init_decode_state``, ``prefill``, ``prefill_chunk`` and ``decode_step``
raise ValueError on such a model, as the JAX package asserts.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import stlt as stlt_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.utils import default_generator, resolve_device, trunc_normal

AUX_KEYS = ("reg", "aux_loss", "router_z", "s_eff")
_ATTN_BLOCKS = ("attn", "local_attn")
_STLT_BLOCKS = ("stlt", "stlt_rel")
_XLSTM_BLOCKS = ("mlstm", "slstm")


def _attn_cfg(cfg: ModelConfig, btype: str) -> attn_lib.AttentionConfig:
    """An attention block's config; ``local_attn`` reads ``cfg.local_window``
    keys."""
    return attn_lib.AttentionConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, rope_fraction=cfg.rope_fraction,
        rope_theta=cfg.rope_theta, causal=True,
        window=cfg.local_window if btype == "local_attn" else 0,
        blockwise_threshold=cfg.blockwise_threshold, param_dtype=cfg.p_dtype)


def execution_plan(cfg: ModelConfig):
    """(block_type, count) runs, as in the JAX package: count > 1 marks a run
    the JAX package stacks on a leading axis (``scan_layers=True``)."""
    groups: list[list] = []
    for t in cfg.block_types():
        if groups and groups[-1][0] == t:
            groups[-1][1] += 1
        else:
            groups.append([t, 1])
    plan = []
    for t, c in groups:
        if cfg.scan_layers and c > 1:
            plan.append((t, c))
        else:
            plan.extend((t, 1) for _ in range(c))
    return tuple(plan)


# ---------------------------------------------------------------------------
# init / forward
# ---------------------------------------------------------------------------


def init_block(generator, cfg: ModelConfig, block_type: str, device=None) -> dict:
    """One block's params: the mixer's, then (but for an xLSTM cell, which
    embeds its projections) ``norm2`` and the FFN or the MoE."""
    d = cfg.d_model
    p = {"norm1": L.init_norm(cfg.norm, d, cfg.p_dtype, device)}
    if block_type in _ATTN_BLOCKS:
        p["attn"] = attn_lib.init_attention(generator, _attn_cfg(cfg, block_type),
                                            device=device)
    elif block_type in _STLT_BLOCKS:
        p["stlt"] = stlt_lib.init_stlt(generator, cfg.stlt_config(), device=device)
    elif block_type == "rglru":
        p["rec"] = rglru_lib.init_rglru_block(generator, cfg, device=device)
    elif block_type == "mlstm":
        p["cell"] = xlstm_lib.init_mlstm(generator, cfg, device=device)
    elif block_type == "slstm":
        p["cell"] = xlstm_lib.init_slstm(generator, cfg, device=device)
    else:
        raise ValueError(block_type)
    if block_type not in _XLSTM_BLOCKS:
        p["norm2"] = L.init_norm(cfg.norm, d, cfg.p_dtype, device)
        if cfg.is_moe:
            p["moe"] = moe_lib.init_moe(generator, cfg.moe_config(), device=device)
        else:
            p["ffn"] = L.init_ffn(generator, d, cfg.d_ff, act=cfg.act,
                                  dtype=cfg.p_dtype, device=device)
    return p


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device=None) -> dict:
    """Random parameters drawn from ``generator`` (seed 0 when None), on
    ``device`` (CUDA unless the caller names another). ``embed`` exists for
    token inputs (``input_mode`` "tokens" or "both"); ``lm_head`` for an
    untied head or embedding inputs, drawn last."""
    device = resolve_device(device)
    gen = generator if generator is not None else default_generator(device)
    params = {}
    if cfg.input_mode in ("tokens", "both"):
        params["embed"] = {"embed": trunc_normal(gen, (cfg.vocab, cfg.d_model),
                                                 stddev=0.02, dtype=cfg.p_dtype,
                                                 device=device)}
    params["layers"] = [init_block(gen, cfg, bt, device) for bt in cfg.block_types()]
    params["final_norm"] = L.init_norm(cfg.norm, cfg.d_model, cfg.p_dtype, device)
    if not cfg.tie_embeddings or cfg.input_mode == "embeddings":
        params["lm_head"] = {"kernel": trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                                    stddev=0.02, dtype=cfg.p_dtype,
                                                    device=device)}
    return params


def _embed(params, cfg: ModelConfig, inputs):
    if inputs.dtype.is_floating_point:
        return inputs.to(cfg.act_dtype)
    return L.embed(params["embed"], inputs).to(cfg.act_dtype)


def _has_pe(cfg: ModelConfig) -> bool:
    """STLT and xLSTM paths carry no RoPE: they get the absolute sinusoidal
    PE (paper: X + P), as the JAX package's test ``cfg.mixer != "attention"
    or cfg.family in ("xlstm",)`` gives it."""
    return cfg.mixer != "attention" or cfg.family == "xlstm"


def _with_pe(cfg: ModelConfig, x, offset=0):
    if not _has_pe(cfg):
        return x
    return x + L.sinusoidal_pe(x.shape[1], cfg.d_model, offset=offset,
                               dtype=x.dtype, device=x.device)


def _head(params, cfg: ModelConfig, x):
    """Final norm and the LM head: ``lm_head`` when the model has one, else
    the tied read-out through ``embed``."""
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    if "lm_head" in params:
        return L.matmul(x, params["lm_head"]["kernel"])
    return L.unembed(params["embed"], x)


def _ffn_aux(params, cfg: ModelConfig, x):
    """The post-mixer half of a block (norm2, then the FFN or the MoE, as a
    residual) and the MoE's aux losses (None without experts); an xLSTM
    block has none and returns x."""
    if "norm2" not in params:
        return x, None
    h2 = L.apply_norm(cfg.norm, params["norm2"], x)
    if cfg.is_moe:
        y, aux = moe_lib.apply_moe(params["moe"], cfg.moe_config(), h2)
    else:
        y, aux = L.ffn(params["ffn"], h2, act=cfg.act), None
    return x + y.to(x.dtype), aux


def _block_ffn(params, cfg: ModelConfig, x):
    """``_ffn_aux`` with the aux losses discarded: the serving paths'."""
    return _ffn_aux(params, cfg, x)[0]


def _mixer(params, cfg: ModelConfig, block_type: str, h):
    """A block's mixer over a whole sequence from a zero state (not the
    STLT, whose forward also returns its aux terms)."""
    if block_type in _ATTN_BLOCKS:
        return attn_lib.apply_attention(params["attn"], _attn_cfg(cfg, block_type), h)
    if block_type == "rglru":
        return rglru_lib.apply_rglru_block(params["rec"], cfg, h)
    if block_type == "mlstm":
        return xlstm_lib.apply_mlstm(params["cell"], cfg, h)
    if block_type == "slstm":
        return xlstm_lib.apply_slstm(params["cell"], cfg, h)
    raise ValueError(block_type)


def apply_block(params: dict, cfg: ModelConfig, block_type: str, x, *,
                deterministic: bool = True, draws=None, tau=None):
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    zero = torch.zeros((), device=x.device)
    aux = {k: zero for k in AUX_KEYS}
    if block_type in _STLT_BLOCKS:
        mixed, sa = stlt_lib.apply_stlt(params["stlt"], cfg.stlt_config(), h,
                                        deterministic=deterministic, draws=draws,
                                        tau=tau)
        aux["reg"] = sa["reg"].float()
        aux["s_eff"] = sa["s_eff"].mean().float()
    else:
        mixed = _mixer(params, cfg, block_type, h)
    x, ma = _ffn_aux(params, cfg, x + mixed.to(x.dtype))
    if ma is not None:
        aux["aux_loss"] = ma["aux_loss"].float()
        aux["router_z"] = ma["router_z"].float()
    return x, aux


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of un-batched products
    (JAX's ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in backward (``cfg.remat``), the counterpart of the
    JAX package's ``_maybe_remat``: its activations are not kept past the
    forward. Remat changes no values. Without grad there is no backward, so
    nothing is wrapped."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if cfg.remat_policy == "dots":
        kw = {"context_fn": lambda: create_selective_checkpoint_contexts(_dots_policy)}
    elif cfg.remat_policy == "full":
        kw = {}
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return lambda *args, **kwargs: checkpoint(fn, *args, use_reentrant=False,
                                              **kw, **kwargs)


def apply_lm(params: dict, cfg: ModelConfig, inputs, *,
             deterministic: bool = True,
             draws: Optional[Sequence[torch.Tensor]] = None, tau=None):
    """Forward pass. inputs: int tokens [B, N] (or embeddings [B, N, d]).
    Returns (logits [B, N, V], aux).

    The stochastic adaptive masks (``deterministic=False``) take layer i's
    uniform draws [B, H, S] from ``draws[i]`` when given (one per layer, in
    layer order); without draws their noise is 0. With ``cfg.remat`` each
    block is recomputed in backward (``_maybe_remat``)."""
    x = _with_pe(cfg, _embed(params, cfg, inputs))
    btypes = cfg.block_types()
    if draws is not None and len(draws) != len(btypes):
        raise ValueError(f"expected {len(btypes)} layers of draws, got {len(draws)}")
    total = {k: torch.zeros((), device=x.device) for k in AUX_KEYS}
    block = _maybe_remat(apply_block, cfg)
    for li, (btype, p) in enumerate(zip(btypes, params["layers"])):
        x, aux = block(p, cfg, btype, x, deterministic=deterministic,
                       draws=None if draws is None else draws[li], tau=tau)
        total = {k: total[k] + aux[k] for k in AUX_KEYS}
    # s_eff is summed over the STLT blocks only (0 of them: no division)
    n_stlt = sum(bt in _STLT_BLOCKS for bt in cfg.block_types())
    total["s_eff"] = total["s_eff"] / max(1, n_stlt)
    return _head(params, cfg, x), total


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, *,
            deterministic: bool = False,
            draws: Optional[Sequence[torch.Tensor]] = None, tau=None):
    """batch: {"inputs": [B, N] or [B, N, d], "labels": [B, N], optional "mask"}.
    Differentiable on both devices: factorized blocks through the scan's
    autograd Function (K1 forward and anti-causal on the card), relevance
    blocks through K2's. ``aux_loss`` and ``router_z`` (summed over the MoE
    blocks, 0 without experts) enter the loss as in the JAX package."""
    logits, aux = apply_lm(params, cfg, batch["inputs"],
                           deterministic=deterministic, draws=draws, tau=tau)
    ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + aux["reg"] + aux["aux_loss"] + aux["router_z"]
    return loss, {"loss": loss, "ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def _init_block_state(cfg: ModelConfig, btype: str, batch: int, max_len: int, device):
    if btype in _ATTN_BLOCKS:
        return attn_lib.init_kv_cache(_attn_cfg(cfg, btype), batch, max_len,
                                      dtype=cfg.act_dtype, device=device)
    if btype in _STLT_BLOCKS:
        return stlt_lib.init_stlt_state(cfg.stlt_config(), batch, device=device)
    if btype == "rglru":
        return rglru_lib.init_rglru_state(cfg, batch, device=device)
    if btype == "mlstm":
        return xlstm_lib.init_mlstm_state(cfg, batch, device=device)
    if btype == "slstm":
        return xlstm_lib.init_slstm_state(cfg, batch, device=device)
    raise ValueError(btype)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Per-layer streaming states and per-row positions [batch]. ``max_len``
    sizes the attention blocks' KV caches (a ``local_attn`` ring holds
    ``min(max_len, local_window)`` slots); STLT states are O(S*d), xLSTM
    and rg-LRU states do not depend on it."""
    device = resolve_device(device)
    layers = [_init_block_state(cfg, bt, batch, max_len, device)
              for bt in cfg.block_types()]
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mixer_prefill(params, cfg: ModelConfig, btype: str, h, state, valid=None,
                   node_cap=None):
    """A block's mixer over a chunk from ``state`` (None: fresh), positions
    past ``valid[b]`` kept out of row b's state: (outputs, new state).
    ``node_cap`` reaches the STLT only."""
    if btype in _ATTN_BLOCKS:
        return attn_lib.prefill_chunk(params["attn"], _attn_cfg(cfg, btype), h, state,
                                      valid=valid)
    if btype in _STLT_BLOCKS:   # a relevance block raises: it has no streaming state
        return stlt_lib.stlt_prefill(params["stlt"], cfg.stlt_config(), h, state,
                                     valid=valid, node_cap=node_cap)
    if btype == "rglru":
        return rglru_lib.rglru_prefill(params["rec"], cfg, h, state, valid=valid)
    if btype == "mlstm":
        return xlstm_lib.mlstm_prefill(params["cell"], cfg, h, state, valid=valid)
    if btype == "slstm":
        return xlstm_lib.slstm_prefill(params["cell"], cfg, h, state, valid=valid)
    raise ValueError(f"prefill unsupported for block type {btype!r}")


def _block_prefill_chunk(params, cfg: ModelConfig, btype: str, x, state,
                         valid=None, node_cap=None):
    """Advance one block's state by one prompt chunk (state=None: a fresh
    prefill). With ``valid``, rows whose valid length is 0 keep their old
    state exactly (a per-row select: a fresh mLSTM row, whose stabilizer is
    -1e30, would not survive the gates' neutralization of pad-only steps)."""
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    old_state = state
    mixed, state = _mixer_prefill(params, cfg, btype, h, state, valid=valid,
                                  node_cap=node_cap)
    if valid is not None and old_state is not None:
        keep = valid > 0
        state = {k: torch.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)),
                                n, old_state[k])
                 for k, n in state.items()}
    return _block_ffn(params, cfg, x + mixed.to(x.dtype)), state


def _block_prefill(params, cfg: ModelConfig, btype: str, x, max_len: int):
    """One block's whole-prompt forward and its state: attention through
    ``prefill_kv_cache`` (blockwise for long prompts; ``max_len`` sizes the
    cache), every other mixer as the fresh case of the chunk prefill."""
    if btype not in _ATTN_BLOCKS:
        return _block_prefill_chunk(params, cfg, btype, x, None)
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    mixed, state = attn_lib.prefill_kv_cache(params["attn"], _attn_cfg(cfg, btype), h,
                                             max_len)
    return _block_ffn(params, cfg, x + mixed.to(x.dtype)), state


def prefill(params: dict, cfg: ModelConfig, inputs, max_len: int):
    """Parallel prefill over the whole prompt: (last-token logits [B, V],
    decode state)."""
    x = _with_pe(cfg, _embed(params, cfg, inputs))
    B, N = x.shape[0], x.shape[1]
    states = []
    for btype, p in zip(cfg.block_types(), params["layers"]):
        x, st = _block_prefill(p, cfg, btype, x, max_len)
        states.append(st)
    pos = torch.full((B,), N, dtype=torch.int32, device=x.device)
    return _head(params, cfg, x[:, -1]), {"layers": states, "pos": pos}


def _logits_at(params, cfg: ModelConfig, x, idx):
    """Logits at per-row position ``idx`` [B] of x [B, N, d] -> [B, V]."""
    rows = torch.arange(x.shape[0], device=x.device)
    return _head(params, cfg, x[rows, idx.long()])


def prefill_chunk(params: dict, cfg: ModelConfig, inputs, state: dict,
                  valid_len: Optional[torch.Tensor] = None):
    """Resumable chunked prefill: advance every layer's state by one prompt
    chunk. ``state["pos"]`` is per row, so the PE is evaluated per row.

    ``valid_len`` [B] (0 <= valid_len <= N) treats positions past
    valid_len[b] as padding: the carry stops at valid_len[b], logits are read
    at the last valid position, pos advances by valid_len, and valid_len == 0
    rows are exact no-ops. Returns (logits [B, V], new state)."""
    pos = state["pos"]
    x = _embed(params, cfg, inputs)
    B, N = x.shape[0], x.shape[1]
    valid = None if valid_len is None else torch.as_tensor(
        valid_len, dtype=torch.int32, device=x.device)
    x = _with_pe(cfg, x, offset=pos)
    new_states = []
    for btype, p, st in zip(cfg.block_types(), params["layers"], state["layers"]):
        x, st = _block_prefill_chunk(p, cfg, btype, x, st, valid=valid)
        new_states.append(st)
    if valid is None:
        return _head(params, cfg, x[:, -1]), {"layers": new_states, "pos": pos + N}
    logits = _logits_at(params, cfg, x, torch.clamp(valid - 1, min=0))
    return logits, {"layers": new_states, "pos": pos + valid}


def _block_state_at(params, cfg: ModelConfig, btype: str, x, state, q):
    """One block's state after the first ``q[b]`` tokens of its input window
    x [B, L, d], the rollback half of ``spec_verify``, no outputs: the STLT's
    closed-form carry snapshot (``stlt.stlt_state_at``), every other
    mixer's masked chunk prefill (``valid=q``: only the accepted tokens
    enter). ``q == 0`` rows keep their old state exactly (a per-row
    select)."""
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    if btype in _STLT_BLOCKS:
        new = stlt_lib.stlt_state_at(params["stlt"], cfg.stlt_config(), h, state, q)
    else:
        _, new = _mixer_prefill(params, cfg, btype, h, state, valid=q)
    keep = q > 0
    return {k: torch.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)),
                           n.to(state[k].dtype), state[k])
            for k, n in new.items()}


def spec_verify(params: dict, cfg: ModelConfig, inputs, state: dict, valid_len,
                node_cap: Optional[torch.Tensor] = None):
    """Speculative verify, accept and rollback in one dispatch.

    ``inputs`` [B, L] is, per live row, [last emitted token, d_1 .. d_k]
    (L = k + 1); ``valid_len`` [B] is 1 + the draft tokens to consider, 0
    for rows that must stay exact no-ops. Returns (greedy [B, L], commit
    [B], new state): ``greedy[b, j]`` is the argmax after
    ``inputs[b, :j+1]``; ``commit[b]`` = 1 + the longest run of draft tokens
    equal to the greedy continuation, clamped to ``valid_len[b]`` (0 for
    no-op rows); the new state has consumed exactly ``commit[b]`` tokens.

    Pass 1 scores all L positions through every block (one scan call per
    layer, resumed from the carried state, under ``node_cap``) and keeps no
    state; pass 2 reads each layer's carry at ``commit`` from the block
    inputs pass 1 saw (``_block_state_at``). The result is new tensors: the
    input state is only read."""
    pos = state["pos"]
    x = _embed(params, cfg, inputs)
    valid = torch.as_tensor(valid_len, dtype=torch.int32, device=x.device)
    x = _with_pe(cfg, x, offset=pos)
    xs_saved = []
    for btype, p, st in zip(cfg.block_types(), params["layers"], state["layers"]):
        xs_saved.append(x)
        x, _ = _block_prefill_chunk(p, cfg, btype, x, st, node_cap=node_cap)
    greedy = torch.argmax(_head(params, cfg, x), dim=-1).to(torch.int32)
    toks = torch.as_tensor(inputs, device=x.device)
    match = (toks[:, 1:] == greedy[:, :-1]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    commit = torch.where(valid > 0, torch.minimum(accepted + 1, valid),
                         torch.zeros_like(valid))
    new_states = [_block_state_at(p, cfg, btype, xs, st, commit)
                  for btype, p, st, xs in zip(cfg.block_types(), params["layers"],
                                              state["layers"], xs_saved)]
    return greedy, commit, {"layers": new_states, "pos": pos + commit}


def _block_step(params, cfg: ModelConfig, btype: str, x_t, state, node_cap=None):
    h = L.apply_norm(cfg.norm, params["norm1"], x_t)
    if btype in _ATTN_BLOCKS:
        mixed, state = attn_lib.apply_attention_step(params["attn"],
                                                     _attn_cfg(cfg, btype), h, state)
    elif btype in _STLT_BLOCKS:
        mixed, state = stlt_lib.apply_stlt_step(params["stlt"], cfg.stlt_config(),
                                                h, state, node_cap=node_cap)
    elif btype == "rglru":
        mixed, state = rglru_lib.apply_rglru_step(params["rec"], cfg, h, state)
    elif btype == "mlstm":
        mixed, state = xlstm_lib.apply_mlstm_step(params["cell"], cfg, h, state)
    elif btype == "slstm":
        mixed, state = xlstm_lib.apply_slstm_step(params["cell"], cfg, h, state)
    else:
        raise ValueError(btype)
    # the MoE sees the B tokens as [B, 1, d]
    x_t = _block_ffn(params, cfg, (x_t + mixed.to(x_t.dtype))[:, None])[:, 0]
    return x_t, state


def decode_step(params: dict, cfg: ModelConfig, token_t, state: dict,
                node_cap: Optional[torch.Tensor] = None):
    """One token for the whole stack. token_t [B] ints (or embeddings
    [B, d]). ``node_cap`` [B] is the per-row node budget of the STLT blocks
    (cap == S rows run unmasked); other blocks ignore it."""
    pos = state["pos"]
    x_t = _embed(params, cfg, token_t)
    if _has_pe(cfg):
        x_t = x_t + L.sinusoidal_pe(1, cfg.d_model, offset=pos, dtype=x_t.dtype,
                                    device=x_t.device)[:, 0]
    new_states = []
    for btype, p, st in zip(cfg.block_types(), params["layers"], state["layers"]):
        x_t, st = _block_step(p, cfg, btype, x_t, st, node_cap=node_cap)
        new_states.append(st)
    return _head(params, cfg, x_t), {"layers": new_states, "pos": pos + 1}


# ---------------------------------------------------------------------------
# slot pool (continuous-batching serving)
# ---------------------------------------------------------------------------
#
# A decode state built by init_decode_state(cfg, batch=n_slots, ...) is a
# POOL: every leaf has the slot on axis 0 (the port keeps one state per
# layer, never a stacked run). prefill_chunk and decode_step return new
# tensors and never write their input state, so the pool is the one object
# written in place, by insert_slot and reset_slot.


def insert_slot(pool: dict, state: dict, slot: int, cfg: ModelConfig) -> dict:
    """Copy a batch-1 decode state into row ``slot`` of ``pool``, in place;
    returns ``pool``. ``state`` is only read."""
    del cfg
    for pl, sl in zip(pool["layers"], state["layers"]):
        for k, t in pl.items():
            t[slot].copy_(sl[k][0])
    pool["pos"][slot].copy_(state["pos"][0])
    return pool


def extract_slot(pool: dict, slot: int, cfg: ModelConfig) -> dict:
    """The batch-1 decode state of row ``slot``: a COPY, so a later write into
    the pool (an insert, a reset) never changes what the caller holds (a
    prefix-cache entry, a state about to be promoted)."""
    del cfg
    return {"layers": [{k: t[slot:slot + 1].clone() for k, t in pl.items()}
                       for pl in pool["layers"]],
            "pos": pool["pos"][slot:slot + 1].clone()}


def reset_slot(pool: dict, slot: int, cfg: ModelConfig, max_len: int,
               template: Optional[dict] = None) -> dict:
    """Return row ``slot`` to the pristine init state, in place: a copy of
    ``template`` (a batch-1 ``init_decode_state``, made here when None),
    which is only read."""
    if template is None:
        template = init_decode_state(cfg, 1, max_len, device=pool["pos"].device)
    return insert_slot(pool, template, slot, cfg)
