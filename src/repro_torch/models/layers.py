"""Shared layers: norms, embeddings, sinusoidal PE, RoPE, FFN, cross entropy.

Numerics follow the JAX package, where the two frameworks' defaults differ:
``jax.nn.gelu`` is the tanh approximation, ``jnp.var`` is the population
variance, the sinusoidal PE puts sin in even and cos in odd columns, RoPE
rotates interleaved pairs (columns 2i and 2i + 1), and a
product of a bf16 activation and an fp32 parameter runs in fp32 (JAX
promotes it; ``torch.matmul`` refuses mixed types), see ``matmul``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.utils import lecun_normal


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``torch.promote_types`` of the two, as JAX types it: a
    bf16 activation times an fp32 parameter is an fp32 product."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


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
    return matmul(x, params["embed"].T)


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


def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float = 10000.0):
    """positions [..., N] -> (sin, cos), each [..., N, rot_dim // 2], in fp32."""
    dim = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=positions.device)
    freq = 1.0 / (theta ** (dim / rot_dim))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding of the leading ``fraction`` of the head dims, by
    interleaved pairs (x[..., 0::2], x[..., 1::2]), cast back to x's dtype.
    x [B, N, H, dh]; sin/cos [N, rot // 2] or [B, N, rot // 2]. ``fraction``
    0.5 is ChatGLM's 2d-RoPE; a rotated width of 0 returns x."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    s, c = sin[..., :, None, :], cos[..., :, None, :]   # over the head axis
    y = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(
        x_rot.shape[:-1] + (rot,))
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


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
        return matmul(F.silu(matmul(x, params["w1"])) * matmul(x, params["w3"]),
                      params["w2"])
    h = F.gelu(matmul(x, params["w1"]) + params["b1"], approximate="tanh")
    return matmul(h, params["w2"]) + params["b2"]


def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """Token-mean cross entropy. logits [..., V] float, labels int."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
