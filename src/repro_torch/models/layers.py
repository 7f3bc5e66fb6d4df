"""Shared layers: norms, embeddings, sinusoidal PE, FFN, cross entropy.

Numerics follow the JAX package, where the two frameworks' defaults differ:
``jax.nn.gelu`` is the tanh approximation, ``jnp.var`` is the population
variance, and the sinusoidal PE puts sin in even and cos in odd columns.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.utils import lecun_normal


def init_layernorm(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def init_norm(kind: str, d: int, dtype=torch.float32, device=None):
    if kind == "layernorm":
        return init_layernorm(d, dtype, device)
    return init_rmsnorm(d, dtype, device)


def rms_norm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * params["scale"]).to(dtype)


def layer_norm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def apply_norm(kind: str, params, x):
    return layer_norm(params, x) if kind == "layernorm" else rms_norm(params, x)


def embed(params, tokens):
    return params["embed"][tokens]


def unembed(params, x):
    """Tied read-out: logits = x @ embed.T."""
    return x @ params["embed"].T


def sinusoidal_pe(n: int, d: int, offset=0, dtype=torch.float32, device=None):
    """[n, d] for a scalar ``offset``; [B, n, d] for a per-row offset [B]."""
    off = torch.as_tensor(offset, device=device)
    pos = (torch.arange(n, device=off.device)[:, None] + off[..., None, None]
           ).to(torch.float32)                                    # [..., n, 1]
    dim = torch.arange(0, d, 2, device=off.device, dtype=torch.float32)
    angle = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros(angle.shape[:-1] + (d,), device=off.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle[..., : d // 2])
    return pe.to(dtype)


def init_ffn(generator, d: int, d_ff: int, act: str = "swiglu",
             dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    if act == "swiglu":
        return {"w1": lecun_normal(generator, (d, d_ff), **kw),
                "w3": lecun_normal(generator, (d, d_ff), **kw),
                "w2": lecun_normal(generator, (d_ff, d), fan_in=d_ff, **kw)}
    return {"w1": lecun_normal(generator, (d, d_ff), **kw),
            "w2": lecun_normal(generator, (d_ff, d), fan_in=d_ff, **kw),
            "b1": torch.zeros((d_ff,), **kw),
            "b2": torch.zeros((d,), **kw)}


def ffn(params, x, act: str = "swiglu"):
    if act == "swiglu":
        return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="tanh")
    return h @ params["w2"] + params["b2"]


def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """Token-mean cross entropy. logits [..., V] float, labels int."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
