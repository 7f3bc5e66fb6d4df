"""Decoder-only LM with STLT token mixers: forward, loss and serving.

Parameters mirror the JAX pytree keys (``embed/embed``, ``layers``,
``final_norm``; per block ``norm1``, ``stlt``, ``norm2``, ``ffn``) with one
difference: ``params["layers"]`` always holds one dict per layer. The JAX
package stacks runs of equal blocks on a leading axis when
``scan_layers=True``; ``convert.from_jax_params`` unstacks them along
``execution_plan``. Decode states follow suit: ``{"layers": [one state per
layer], "pos": [B] int32}``.

Only STLT blocks are ported: ``stlt`` (factorized) and ``stlt_rel`` (the
relevance readout, ``mixer="stlt_relevance"``). Other block types raise
NotImplementedError. A relevance block has no streaming state, so
``init_decode_state``, ``prefill``, ``prefill_chunk`` and ``decode_step``
raise ValueError on such a model, as the JAX package asserts.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import stlt as stlt_lib
from repro_torch.models import layers as L
from repro_torch.utils import default_generator, resolve_device, trunc_normal

AUX_KEYS = ("reg", "aux_loss", "router_z", "s_eff")
_PORTED_BLOCKS = ("stlt", "stlt_rel")


def _check_block(btype: str):
    if btype not in _PORTED_BLOCKS:
        raise NotImplementedError(f"block type {btype!r} is not ported yet")


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
    _check_block(block_type)
    d = cfg.d_model
    return {
        "norm1": L.init_norm(cfg.norm, d, cfg.p_dtype, device),
        "stlt": stlt_lib.init_stlt(generator, cfg.stlt_config(), device=device),
        "norm2": L.init_norm(cfg.norm, d, cfg.p_dtype, device),
        "ffn": L.init_ffn(generator, d, cfg.d_ff, act=cfg.act,
                          dtype=cfg.p_dtype, device=device),
    }


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device=None) -> dict:
    """Random parameters drawn from ``generator`` (seed 0 when None), on
    ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    gen = generator if generator is not None else default_generator(device)
    if cfg.input_mode != "tokens" or not cfg.tie_embeddings:
        raise NotImplementedError("only tied token embeddings are ported")
    params = {"embed": {"embed": trunc_normal(gen, (cfg.vocab, cfg.d_model),
                                              stddev=0.02, dtype=cfg.p_dtype,
                                              device=device)}}
    params["layers"] = [init_block(gen, cfg, bt, device) for bt in cfg.block_types()]
    params["final_norm"] = L.init_norm(cfg.norm, cfg.d_model, cfg.p_dtype, device)
    return params


def _embed(params, cfg: ModelConfig, inputs):
    if inputs.dtype.is_floating_point:
        return inputs.to(cfg.act_dtype)
    return L.embed(params["embed"], inputs).to(cfg.act_dtype)


def _with_pe(cfg: ModelConfig, x, offset=0):
    """STLT paths carry no RoPE -> absolute sinusoidal PE (paper: X + P)."""
    if cfg.mixer == "attention":
        return x
    return x + L.sinusoidal_pe(x.shape[1], cfg.d_model, offset=offset,
                               dtype=x.dtype, device=x.device)


def _head(params, cfg: ModelConfig, x):
    return L.unembed(params["embed"], L.apply_norm(cfg.norm, params["final_norm"], x))


def _block_ffn(params, cfg: ModelConfig, x):
    h2 = L.apply_norm(cfg.norm, params["norm2"], x)
    return x + L.ffn(params["ffn"], h2, act=cfg.act).to(x.dtype)


def apply_block(params: dict, cfg: ModelConfig, block_type: str, x, *,
                deterministic: bool = True, draws=None, tau=None):
    _check_block(block_type)
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    mixed, sa = stlt_lib.apply_stlt(params["stlt"], cfg.stlt_config(), h,
                                    deterministic=deterministic, draws=draws,
                                    tau=tau)
    zero = torch.zeros((), device=x.device)
    aux = {"reg": sa["reg"].float(), "aux_loss": zero, "router_z": zero,
           "s_eff": sa["s_eff"].mean().float()}
    return _block_ffn(params, cfg, x + mixed.to(x.dtype)), aux


def apply_lm(params: dict, cfg: ModelConfig, inputs, *,
             deterministic: bool = True,
             draws: Optional[Sequence[torch.Tensor]] = None, tau=None):
    """Forward pass. inputs: int tokens [B, N] (or embeddings [B, N, d]).
    Returns (logits [B, N, V], aux).

    The stochastic adaptive masks (``deterministic=False``) take layer i's
    uniform draws [B, H, S] from ``draws[i]`` when given (one per layer, in
    layer order); without draws their noise is 0."""
    x = _with_pe(cfg, _embed(params, cfg, inputs))
    btypes = cfg.block_types()
    if draws is not None and len(draws) != len(btypes):
        raise ValueError(f"expected {len(btypes)} layers of draws, got {len(draws)}")
    total = {k: torch.zeros((), device=x.device) for k in AUX_KEYS}
    for li, (btype, p) in enumerate(zip(btypes, params["layers"])):
        x, aux = apply_block(p, cfg, btype, x, deterministic=deterministic,
                             draws=None if draws is None else draws[li], tau=tau)
        total = {k: total[k] + aux[k] for k in AUX_KEYS}
    n_stlt = sum(bt in ("stlt", "stlt_rel") for bt in cfg.block_types())
    total["s_eff"] = total["s_eff"] / max(1, n_stlt)
    return _head(params, cfg, x), total


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, *,
            deterministic: bool = False,
            draws: Optional[Sequence[torch.Tensor]] = None, tau=None):
    """batch: {"inputs": [B, N], "labels": [B, N], optional "mask"}.
    Differentiable on both devices: factorized blocks through the scan's
    autograd Function (K1 forward and anti-causal on the card), relevance
    blocks through K2's. ``aux_loss`` and ``router_z`` are 0 for STLT blocks
    and enter the loss as in the JAX package."""
    logits, aux = apply_lm(params, cfg, batch["inputs"],
                           deterministic=deterministic, draws=draws, tau=tau)
    ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + aux["reg"] + aux["aux_loss"] + aux["router_z"]
    return loss, {"loss": loss, "ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Per-layer streaming states and per-row positions [batch]. ``max_len``
    sizes attention caches in the JAX package; STLT states are O(S*d)."""
    del max_len
    device = resolve_device(device)
    layers = []
    for bt in cfg.block_types():
        _check_block(bt)
        layers.append(stlt_lib.init_stlt_state(cfg.stlt_config(), batch,
                                               device=device))
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _block_prefill_chunk(params, cfg: ModelConfig, btype: str, x, state,
                         valid=None, node_cap=None):
    """Advance one block's state by one prompt chunk (state=None: a fresh
    prefill). With ``valid``, rows whose valid length is 0 keep their old
    state exactly (a per-row select)."""
    _check_block(btype)
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    old_state = state
    mixed, state = stlt_lib.stlt_prefill(params["stlt"], cfg.stlt_config(), h,
                                         state, valid=valid, node_cap=node_cap)
    if valid is not None and old_state is not None:
        keep = valid > 0
        state = {k: torch.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)),
                                n, old_state[k])
                 for k, n in state.items()}
    return _block_ffn(params, cfg, x + mixed.to(x.dtype)), state


def prefill(params: dict, cfg: ModelConfig, inputs, max_len: int):
    """Parallel prefill over the whole prompt: (last-token logits [B, V],
    decode state)."""
    del max_len
    x = _with_pe(cfg, _embed(params, cfg, inputs))
    B, N = x.shape[0], x.shape[1]
    states = []
    for btype, p in zip(cfg.block_types(), params["layers"]):
        x, st = _block_prefill_chunk(p, cfg, btype, x, None)
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


def _block_step(params, cfg: ModelConfig, btype: str, x_t, state, node_cap=None):
    _check_block(btype)
    h = L.apply_norm(cfg.norm, params["norm1"], x_t)
    mixed, state = stlt_lib.apply_stlt_step(params["stlt"], cfg.stlt_config(),
                                            h, state, node_cap=node_cap)
    return _block_ffn(params, cfg, x_t + mixed.to(x_t.dtype)), state


def decode_step(params: dict, cfg: ModelConfig, token_t, state: dict,
                node_cap: Optional[torch.Tensor] = None):
    """One token for the whole stack. token_t [B] ints. ``node_cap`` [B] is
    the per-row node budget (cap == S rows run unmasked)."""
    pos = state["pos"]
    x_t = _embed(params, cfg, token_t)
    if cfg.mixer != "attention":
        x_t = x_t + L.sinusoidal_pe(1, cfg.d_model, offset=pos, dtype=x_t.dtype,
                                    device=x_t.device)[:, 0]
    new_states = []
    for btype, p, st in zip(cfg.block_types(), params["layers"], state["layers"]):
        x_t, st = _block_step(p, cfg, btype, x_t, st, node_cap=node_cap)
        new_states.append(st)
    return _head(params, cfg, x_t), {"layers": new_states, "pos": pos + 1}
