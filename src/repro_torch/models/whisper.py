"""Encoder-decoder backbone (Whisper-style; also the WMT proxy's model).

The audio conv frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings [B, M, d] (``cfg.input_mode == "embeddings"``),
or embeds source tokens (``"tokens"``, the paper's WMT'14 experiment).

Mixers, as in the JAX package (the paper's hybrid scheme, §3.5):
``mixer="attention"`` (native whisper) runs a bidirectional attention
encoder, a causal attention decoder with a KV cache and softmax
cross-attention over the encoder's keys and values (``xk``/``xv``,
computed once per decode); ``mixer="stlt"`` a bilateral STLT encoder (each
layer a causal and an anti-causal K1 call on the card), a unilateral STLT
decoder, and the cross-STLT between them. Attention and the cross-STLT are
plain torch, as the JAX package computes them in plain ``jnp``. Attention
here carries no RoPE (``rope_fraction=0``): both sides add the sinusoidal
PE, in either form.

Parameters mirror the JAX pytree keys (``enc_embed`` for token inputs,
``dec_embed``, ``enc_norm``, ``dec_norm``, ``lm_head``; per encoder layer
``norm1``, ``stlt`` or ``attn``, ``norm2``, ``ffn``; per decoder layer also
``norm_x`` and ``cross``), with one difference: ``enc_layers`` and ``dec_layers``
always hold one dict per layer. The JAX package stacks each side on a
leading axis (``enc_layers``/``dec_layers``) when ``scan_layers`` is set
and the side has more than one layer, and keeps a list (``enc_list``/
``dec_list``) otherwise; ``convert.from_jax_encdec_params`` unstacks.
Remat follows that layout, as the JAX package applies it only to a stacked
side. Decode states: ``{"dec": [one state per decoder layer], "pos": []
int32}``, one position for the whole batch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import stlt as stlt_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.utils import default_generator, resolve_device, trunc_normal


def _use_stlt(cfg: ModelConfig) -> bool:
    return cfg.mixer.startswith("stlt")


def _attn_cfg(cfg: ModelConfig, causal: bool) -> attn_lib.AttentionConfig:
    return attn_lib.AttentionConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_fraction=0.0,  # whisper uses the absolute sinusoidal PE
        causal=causal, blockwise_threshold=cfg.blockwise_threshold,
        param_dtype=cfg.p_dtype)


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


def apply_cross_attention(params, cfg: ModelConfig, x_dec, enc_kv):
    """Softmax attention of x_dec [B, N, d] over the encoder's precomputed
    (k, v) [B, M, Hkv, dh], every key readable; no bias, no RoPE on q, as
    in the JAX package."""
    acfg = _attn_cfg(cfg, causal=False)
    B, N, _ = x_dec.shape
    q = L.matmul(x_dec, params["wq"]).reshape(B, N, acfg.num_heads, acfg.dh)
    k, v = enc_kv
    out = attn_lib._sdpa_dense(q, k, v, acfg)
    return L.matmul(out.reshape(B, N, -1), params["wo"])


def encode_cross_kv(params, cfg: ModelConfig, enc_out):
    """The cross-attention's keys and values of the encoder output."""
    acfg = _attn_cfg(cfg, causal=False)
    B, M, _ = enc_out.shape
    k = L.matmul(enc_out, params["wk"]).reshape(B, M, acfg.num_kv_heads, acfg.dh)
    v = L.matmul(enc_out, params["wv"]).reshape(B, M, acfg.num_kv_heads, acfg.dh)
    return k, v


def _stacked(cfg: ModelConfig, n_layers: int) -> bool:
    """Whether the JAX package stacks a side of ``n_layers`` layers."""
    return cfg.scan_layers and n_layers > 1


def _remat(fn, on: bool):
    """``fn`` recomputed in backward when ``on`` (the JAX package's
    ``jax.checkpoint`` of a whole layer, whatever ``cfg.remat_policy``)."""
    if not (on and torch.is_grad_enabled()):
        return fn
    from torch.utils.checkpoint import checkpoint

    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_encdec(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` (seed 0 when None), on
    ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    gen = generator if generator is not None else default_generator(device)
    d, dt = cfg.d_model, cfg.p_dtype

    def embedding():
        return {"embed": trunc_normal(gen, (cfg.vocab, d), stddev=0.02, dtype=dt,
                                      device=device)}

    def norm():
        return L.init_norm(cfg.norm, d, dt, device)

    def ffn():
        return L.init_ffn(gen, d, cfg.d_ff, act=cfg.act, dtype=dt, device=device)

    params: dict = {}
    if cfg.input_mode == "tokens":
        params["enc_embed"] = embedding()
    params["dec_embed"] = embedding()

    def attention(causal):
        return attn_lib.init_attention(gen, _attn_cfg(cfg, causal), device)

    def enc_mixer():
        if _use_stlt(cfg):
            return {"stlt": stlt_lib.init_stlt(gen, cfg.stlt_config(bidirectional=True),
                                               device)}
        return {"attn": attention(False)}

    def dec_mixer():
        if _use_stlt(cfg):
            return {"stlt": stlt_lib.init_stlt(gen, cfg.stlt_config(), device),
                    "cross": stlt_lib.init_cross_stlt(gen, cfg.stlt_config(), device)}
        return {"attn": attention(True), "cross": attention(False)}

    params["enc_layers"] = [{"norm1": norm(), "norm2": norm(), "ffn": ffn(), **enc_mixer()}
                            for _ in range(cfg.num_layers)]
    params["dec_layers"] = [{"norm1": norm(), "norm_x": norm(), "norm2": norm(),
                             "ffn": ffn(), **dec_mixer()}
                            for _ in range(cfg.num_decoder_layers)]
    params["enc_norm"] = norm()
    params["dec_norm"] = norm()
    params["lm_head"] = {"kernel": trunc_normal(gen, (d, cfg.vocab), stddev=0.02,
                                                dtype=dt, device=device)}
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ffn_residual(p, cfg: ModelConfig, x):
    h2 = L.apply_norm(cfg.norm, p["norm2"], x)
    return x + L.ffn(p["ffn"], h2, act=cfg.act).to(x.dtype)


def _apply_enc_layer(p, cfg: ModelConfig, x):
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    if _use_stlt(cfg):
        mixed, _ = stlt_lib.apply_stlt(p["stlt"], cfg.stlt_config(bidirectional=True), h)
    else:
        mixed = attn_lib.apply_attention(p["attn"], _attn_cfg(cfg, causal=False), h)
    return _ffn_residual(p, cfg, x + mixed.to(x.dtype))


def _apply_dec_layer(p, cfg: ModelConfig, x, enc_out):
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    if _use_stlt(cfg):
        mixed, _ = stlt_lib.apply_stlt(p["stlt"], cfg.stlt_config(), h)
    else:
        mixed = attn_lib.apply_attention(p["attn"], _attn_cfg(cfg, causal=True), h)
    x = x + mixed.to(x.dtype)
    hx = L.apply_norm(cfg.norm, p["norm_x"], x)
    if _use_stlt(cfg):
        cross = stlt_lib.apply_cross_stlt(p["cross"], cfg.stlt_config(), hx, enc_out)
    else:
        cross = apply_cross_attention(p["cross"], cfg, hx,
                                      encode_cross_kv(p["cross"], cfg, enc_out))
    return _ffn_residual(p, cfg, x + cross.to(x.dtype))


def _with_pe(x):
    return x + L.sinusoidal_pe(x.shape[1], x.shape[2], dtype=x.dtype, device=x.device)[None]


def encode(params: dict, cfg: ModelConfig, enc_inputs):
    """enc_inputs: tokens [B, M] or frame embeddings [B, M, d] (the stub
    frontend) -> the normed encoder output [B, M, d] in ``cfg.dtype``."""
    if cfg.input_mode == "tokens":
        x = L.embed(params["enc_embed"], enc_inputs).to(cfg.act_dtype)
    else:
        x = enc_inputs.to(cfg.act_dtype)
    x = _with_pe(x)
    layer = _remat(_apply_enc_layer, cfg.remat and _stacked(cfg, cfg.num_layers))
    for p in params["enc_layers"]:
        x = layer(p, cfg, x)
    return L.apply_norm(cfg.norm, params["enc_norm"], x)


def apply_encdec(params: dict, cfg: ModelConfig, enc_inputs, dec_tokens):
    """Teacher-forced forward: logits [B, N, V]."""
    enc_out = encode(params, cfg, enc_inputs)
    y = _with_pe(L.embed(params["dec_embed"], dec_tokens).to(cfg.act_dtype))
    layer = _remat(_apply_dec_layer, cfg.remat and _stacked(cfg, cfg.num_decoder_layers))
    for p in params["dec_layers"]:
        y = layer(p, cfg, y, enc_out)
    y = L.apply_norm(cfg.norm, params["dec_norm"], y)
    return L.matmul(y, params["lm_head"]["kernel"])


def encdec_loss(params: dict, cfg: ModelConfig, batch: dict, **_):
    """batch: {"enc_inputs", "dec_inputs", "labels"[, "mask"]} -> (ce,
    {"loss", "ce"}). Mask draws and temperature are ignored, as in the JAX
    package: the encoder's adaptive masks (if any) stay deterministic."""
    logits = apply_encdec(params, cfg, batch["enc_inputs"], batch["dec_inputs"])
    ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce, {"loss": ce, "ce": ce}


# ---------------------------------------------------------------------------
# decode (text generation against a fixed encoder context)
# ---------------------------------------------------------------------------


def init_encdec_decode_state(params: dict, cfg: ModelConfig, enc_inputs, batch: int,
                             max_len: int) -> dict:
    """Encode once; per decoder layer, in the STLT form, the self-STLT's
    O(S*d) state, the cross-STLT's streaming decoder-side coefficients and
    its encoder context (``stlt.cross_stlt_context``); in the attention form
    a KV cache of ``max_len`` slots (activation dtype) and the
    cross-attention's encoder keys and values ``xk``/``xv``."""
    enc_out = encode(params, cfg, enc_inputs)
    scfg = cfg.stlt_config()
    dev = enc_out.device

    def one_state(p):
        if _use_stlt(cfg):
            return {"self": stlt_lib.init_stlt_state(scfg, batch, device=dev),
                    "xstate": stlt_lib.init_cross_stlt_state(scfg, batch, device=dev),
                    "xctx": stlt_lib.cross_stlt_context(p["cross"], scfg, enc_out)}
        k, v = encode_cross_kv(p["cross"], cfg, enc_out)
        return {"self": attn_lib.init_kv_cache(_attn_cfg(cfg, True), batch, max_len,
                                               dtype=cfg.act_dtype, device=dev),
                "xk": k, "xv": v}

    states = [one_state(p) for p in params["dec_layers"]]
    return {"dec": states, "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def encdec_decode_step(params: dict, cfg: ModelConfig, token_t, state: dict):
    """One decoder token [B] against the fixed encoder context -> (logits
    [B, V], new state)."""
    scfg = cfg.stlt_config()
    pos = state["pos"]
    y = L.embed(params["dec_embed"], token_t).to(cfg.act_dtype)
    y = y + L.sinusoidal_pe(1, cfg.d_model, offset=pos, dtype=y.dtype, device=y.device)[0]

    def norm(p, t):
        return L.apply_norm(cfg.norm, p, t[:, None, :])[:, 0]

    new_states = []
    for p, st in zip(params["dec_layers"], state["dec"]):
        h = norm(p["norm1"], y)
        if _use_stlt(cfg):
            mixed, new_self = stlt_lib.apply_stlt_step(p["stlt"], scfg, h, st["self"])
        else:
            mixed, new_self = attn_lib.apply_attention_step(
                p["attn"], _attn_cfg(cfg, True), h, st["self"])
        y = y + mixed.to(y.dtype)
        hx = norm(p["norm_x"], y)
        if _use_stlt(cfg):
            cross, new_x = stlt_lib.cross_stlt_step(p["cross"], scfg, hx, st["xstate"],
                                                    st["xctx"])
            new_st = {"self": new_self, "xstate": new_x, "xctx": st["xctx"]}
        else:
            cross = apply_cross_attention(p["cross"], cfg, hx[:, None, :],
                                          (st["xk"], st["xv"]))[:, 0]
            new_st = {"self": new_self, "xk": st["xk"], "xv": st["xv"]}
        y = y + cross.to(y.dtype)
        y = y + L.ffn(p["ffn"], norm(p["norm2"], y), act=cfg.act).to(y.dtype)
        new_states.append(new_st)
    y = norm(params["dec_norm"], y)
    return L.matmul(y, params["lm_head"]["kernel"]), {"dec": new_states, "pos": pos + 1}
