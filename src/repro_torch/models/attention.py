"""Softmax attention (the paper's baseline), the port of the JAX package's
``models/attention.py`` function for function: GQA/MQA, RoPE, local
windows, the blockwise online-softmax path for long sequences, and a KV
cache for decode, chunked prefill and slot pools.

Plain PyTorch, as the JAX package computes it in plain ``jnp`` (it wrote no
kernel for attention). Dtypes follow JAX's: products are promoted as JAX
promotes them (a bf16 activation against an fp32 matrix runs in fp32), the
scores are summed in the inputs' dtype, masked in fp32 with an additive
-1e30 (so a row whose keys are all masked gets uniform weights, not NaN),
the softmax runs in fp32 and the probabilities are cast back to the
queries' dtype before their product with the values. GQA groups query
heads by the reshape [B, N, Hkv, G, dh]: query head h reads KV head h // G.

Functions return new tensors and never write their inputs: a KV cache
passed to ``apply_attention_step`` or ``prefill_chunk`` is only read.
Where the JAX package scatters with ``mode="drop"`` (or its default
out-of-bounds scatter, which drops), the port writes into a buffer one
slot longer and slices it off.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.utils import lecun_normal

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0  # 0.0 disables RoPE; 0.5 = ChatGLM 2d-RoPE
    rope_theta: float = 10000.0
    causal: bool = True
    window: int = 0  # > 0: local sliding-window attention
    block_q: int = 512
    block_kv: int = 1024
    blockwise_threshold: int = 8192  # the blockwise path for N >= this
    param_dtype: torch.dtype = torch.float32

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


def init_attention(generator, cfg: AttentionConfig, device=None) -> dict:
    d, dh = cfg.d_model, cfg.dh
    kw = dict(dtype=cfg.param_dtype, device=device)
    p = {"wq": lecun_normal(generator, (d, cfg.num_heads * dh), **kw),
         "wk": lecun_normal(generator, (d, cfg.num_kv_heads * dh), **kw),
         "wv": lecun_normal(generator, (d, cfg.num_kv_heads * dh), **kw),
         "wo": lecun_normal(generator, (cfg.num_heads * dh, d),
                            fan_in=cfg.num_heads * dh, **kw)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * dh,), **kw)
        p["bk"] = torch.zeros((cfg.num_kv_heads * dh,), **kw)
        p["bv"] = torch.zeros((cfg.num_kv_heads * dh,), **kw)
    return p


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of its operands, as JAX types it."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _qkv(params, cfg: AttentionConfig, x, positions):
    """q [B, N, H, dh], k and v [B, N, Hkv, dh]; RoPE at ``positions`` ([N]
    or per row [B, N]). With ``qkv_bias`` the (fp32) biases are added and the
    result cast to x's dtype; without, q/k/v keep the promoted dtype."""
    B, N, _ = x.shape
    dh = cfg.dh
    q = L.matmul(x, params["wq"])
    k = L.matmul(x, params["wk"])
    v = L.matmul(x, params["wv"])
    if cfg.qkv_bias:
        q = (q + params["bq"]).to(x.dtype)
        k = (k + params["bk"]).to(x.dtype)
        v = (v + params["bv"]).to(x.dtype)
    q = q.reshape(B, N, cfg.num_heads, dh)
    k = k.reshape(B, N, cfg.num_kv_heads, dh)
    v = v.reshape(B, N, cfg.num_kv_heads, dh)
    if cfg.rope_fraction > 0:
        rot = int(dh * cfg.rope_fraction)
        rot -= rot % 2
        sin, cos = L.rope_angles(positions, rot, cfg.rope_theta)
        q = L.apply_rope(q, sin, cos, cfg.rope_fraction)
        k = L.apply_rope(k, sin, cos, cfg.rope_fraction)
    return q, k, v


def _mask_ok(qpos, kpos, cfg: AttentionConfig):
    """Which keys at ``kpos`` each query at ``qpos`` may read (broadcast)."""
    ok = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape), dtype=torch.bool,
                    device=qpos.device)
    if cfg.causal:
        ok = ok & (kpos <= qpos)
    if cfg.window > 0:
        ok = ok & (kpos > qpos - cfg.window)
    return ok


def _mask_bias(nq: int, nk: int, q_off: int, cfg: AttentionConfig, device=None):
    """Additive fp32 mask [nq, nk] for query rows [q_off, q_off + nq) against
    keys [0, nk): 0 where a key may be read, -1e30 where not."""
    qi = torch.arange(nq, device=device)[:, None] + q_off
    kj = torch.arange(nk, device=device)[None, :]
    return torch.where(_mask_ok(qi, kj, cfg), 0.0, NEG_INF).to(torch.float32)


def _softmax_pv(s, ok, v, out_dtype):
    """Masked fp32 softmax of scores s [B, Hkv, G, Nq, Nk] (``ok``
    broadcastable to it), cast to ``out_dtype``, times v [B, Nk, Hkv, dh]
    -> [B, Nq, Hkv, G, dh]. ``where`` gives the same fp32 values as adding
    the -1e30 mask: |s| is far below the ulp of 1e30."""
    s = torch.where(ok, s.to(torch.float32), NEG_INF)
    p = torch.softmax(s, dim=-1).to(out_dtype)
    return _einsum("bkgnm,bmkd->bnkgd", p, v)


def _sdpa_dense(q, k, v, cfg: AttentionConfig, q_off: int = 0):
    """Reference einsum attention. q [B, Nq, H, dh], k/v [B, Nk, Hkv, dh]."""
    B, Nq, H, dh = q.shape
    Nk = k.shape[1]
    G = H // cfg.num_kv_heads
    qg = q.reshape(B, Nq, cfg.num_kv_heads, G, dh)
    s = _einsum("bnkgd,bmkd->bkgnm", qg, k) / math.sqrt(dh)
    s = s + _mask_bias(Nq, Nk, q_off, cfg, q.device)      # promotes to fp32
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return _einsum("bkgnm,bmkd->bnkgd", p, v).reshape(B, Nq, H, dh)


def _sdpa_blockwise(q, k, v, cfg: AttentionConfig):
    """Flash-style online-softmax attention over KV blocks (O(N) memory),
    the counterpart of the JAX package's ``lax.map`` over query blocks and
    ``lax.scan`` over KV blocks, padded tails masked. A KV block that every
    query of a block must skip (causal or windowed) is not visited: in the
    JAX loop it adds exact zeros (p = 0, correction 1) after a row's first
    readable key, and is erased (correction 0) before it, and every row
    reads at least its own key, so skipping it changes no value."""
    B, N, H, dh = q.shape
    Hkv = cfg.num_kv_heads
    G = H // Hkv
    bq, bkv = min(cfg.block_q, N), min(cfg.block_kv, N)
    nq, nkv = -(-N // bq), -(-N // bkv)
    pad_q, pad_kv = nq * bq - N, nkv * bkv - N
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    dev = q.device
    scale = math.sqrt(dh)
    outs = []
    for qi in range(nq):
        q_blk = qp[:, qi * bq:(qi + 1) * bq].reshape(B, bq, Hkv, G, dh)
        qpos = qi * bq + torch.arange(bq, device=dev)[:, None]
        m = torch.full((B, Hkv, G, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, bq, Hkv, G, dh), dtype=torch.float32, device=dev)
        q_lo, q_hi = qi * bq, qi * bq + bq - 1
        for kj in range(nkv):
            k_lo, k_hi = kj * bkv, kj * bkv + bkv - 1
            if cfg.causal and k_lo > q_hi:
                continue
            if cfg.window > 0 and k_hi <= q_lo - cfg.window:
                continue
            k_blk = kp[:, k_lo:k_hi + 1]
            v_blk = vp[:, k_lo:k_hi + 1]
            s = _einsum("bnkgd,bmkd->bkgnm", q_blk, k_blk) / scale
            kpos = k_lo + torch.arange(bkv, device=dev)[None, :]
            ok = _mask_ok(qpos, kpos, cfg) & (kpos < N)
            s = torch.where(ok, s.to(torch.float32), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _einsum(
                "bkgnm,bmkd->bnkgd", p, v_blk)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(B, nq * bq, H, dh)
    return out[:, :N]


def _sdpa(q, k, v, cfg: AttentionConfig, force_dense: bool = False):
    if q.shape[1] >= cfg.blockwise_threshold and not force_dense:
        return _sdpa_blockwise(q, k, v, cfg)
    return _sdpa_dense(q, k, v, cfg)


def apply_attention(params, cfg: AttentionConfig, x, *,
                    positions: Optional[torch.Tensor] = None,
                    force_dense: bool = False):
    """Full-sequence attention. x [B, N, d] -> [B, N, d]."""
    B, N, _ = x.shape
    if positions is None:
        positions = torch.arange(N, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    out = _sdpa(q, k, v, cfg, force_dense)
    return L.matmul(out.reshape(B, N, -1), params["wo"])


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: AttentionConfig, batch: int, max_len: int,
                  dtype=torch.float32, device=None) -> dict:
    """A ring buffer of ``min(max_len, window)`` slots when windowed, a
    linear buffer of ``max_len`` otherwise; ``pos`` is per row [batch], so
    rows at different depths share one batched cache (slot pools)."""
    size = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _write(buf, slot, vals, write=None):
    """A copy of ``buf`` [B, size, ...] with ``vals`` [B, n, ...] written at
    per-row slots ``slot`` [B, n]; writes that are masked off (``write``
    False) or out of bounds are dropped, as JAX's scatter drops them."""
    B, size = buf.shape[0], buf.shape[1]
    ok = (slot >= 0) & (slot < size)
    if write is not None:
        ok = ok & write
    slot = torch.where(ok, slot, size).long()
    out = torch.cat([buf, buf.new_zeros((B, 1) + buf.shape[2:])], dim=1)
    out[torch.arange(B, device=buf.device)[:, None], slot] = vals.to(buf.dtype)
    return out[:, :size]


def _roll_rows(a, shift):
    """``jnp.roll(a[b], shift[b], axis=0)`` for every row b of a [B, n, ...]."""
    n = a.shape[1]
    idx = (torch.arange(n, device=a.device)[None, :] - shift[:, None].long()) % n
    return torch.gather(a, 1, idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(a.shape))


def apply_attention_step(params, cfg: AttentionConfig, x_t, cache: dict):
    """One decode step. x_t [B, d] -> (y_t [B, d], new cache). RoPE angles,
    write slots and validity masks are per row (``cache["pos"]`` [B])."""
    B, _ = x_t.shape
    pos = cache["pos"]
    q, k, v = _qkv(params, cfg, x_t[:, None, :], pos[:, None])
    size = cache["k"].shape[1]
    slot = pos % size if cfg.window > 0 else pos                     # [B]
    ck = _write(cache["k"], slot[:, None], k)
    cv = _write(cache["v"], slot[:, None], v)
    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, 1, cfg.num_kv_heads, G, cfg.dh)
    s = _einsum("bnkgd,bmkd->bkgnm", qg, ck) / math.sqrt(cfg.dh)
    idx = torch.arange(size, device=x_t.device)[None, :]
    if cfg.window > 0:   # a ring: every slot valid once it has wrapped
        ok = (idx <= slot[:, None]) | (pos[:, None] >= size)
    else:
        ok = idx <= pos[:, None]
    o = _softmax_pv(s, ok[:, None, None, None, :], cv, x_t.dtype).reshape(B, 1, -1)
    y = L.matmul(o, params["wo"])[:, 0]
    return y, {"k": ck, "v": cv, "pos": pos + 1}


def prefill_chunk(params, cfg: AttentionConfig, x, cache: dict, valid=None):
    """Resumable prefill: append one prompt chunk x [B, N, d] to a KV cache
    whose rows sit at per-row depths ``cache["pos"]`` [B]. One softmax over
    [old cache || chunk]; the old cache's scores are taken before the chunk
    is written (a ring write may overwrite slots the chunk's early queries
    still read). ``valid`` [B]: positions >= valid[b] of row b are padding;
    they are never written, and ``pos`` advances by valid[b]. Pad queries
    need no mask: causality keeps valid queries off pad keys."""
    B, N, _ = x.shape
    dev = x.device
    pos = cache["pos"]
    positions = pos[:, None] + torch.arange(N, device=dev)[None, :]   # [B, N]
    q, k, v = _qkv(params, cfg, x, positions)
    size = cache["k"].shape[1]
    total = pos + (N if valid is None else valid.to(pos.dtype))

    # the absolute position old slot j holds: the largest p < pos with
    # p % size == j (a ring; negative: never written), or j (linear)
    j = torch.arange(size, device=dev)[None, :]
    if cfg.window > 0:
        p_old = (pos[:, None] - 1) - torch.remainder(pos[:, None] - 1 - j, size)
        ok_old = (p_old[:, None, :] >= 0) & (
            p_old[:, None, :] > positions[:, :, None] - cfg.window)
    else:
        ok_old = (j[:, None, :] < pos[:, None, None]).expand(B, N, size)
    ti = torch.arange(N, device=dev)
    ok_new = (ti[None, :] <= ti[:, None])[None].expand(B, N, N)
    if cfg.window > 0:
        ok_new = ok_new & (positions[:, None, :] > positions[:, :, None] - cfg.window)
    ok = torch.cat([ok_old, ok_new], dim=-1)                          # [B, N, size+N]

    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, N, cfg.num_kv_heads, G, cfg.dh)
    keys = torch.cat([cache["k"].to(k.dtype), k], dim=1)
    vals = torch.cat([cache["v"].to(v.dtype), v], dim=1)
    s = _einsum("bnkgd,bmkd->bkgnm", qg, keys) / math.sqrt(cfg.dh)
    o = _softmax_pv(s, ok[:, None, None], vals, x.dtype).reshape(B, N, -1)
    y = L.matmul(o, params["wo"])

    # append the chunk to the cache
    if valid is not None:
        # only positions n < valid[b] are written, and for a ring only the
        # last ``size`` of them: one writer per slot at any N
        n_idx = torch.arange(N, device=dev)[None, :]
        write = n_idx < valid[:, None]
        if cfg.window > 0:
            write = write & (n_idx >= valid[:, None] - size)
            slot = positions % size
        else:
            slot = positions
        ck = _write(cache["k"], slot, k, write)
        cv = _write(cache["v"], slot, v, write)
    elif cfg.window > 0 and N >= size:
        # the chunk alone overwrites the whole ring: keep its last ``size``
        # tokens, rotated so slot (total % size) is the next write position
        shift = total % size
        ck = _roll_rows(k[:, -size:], shift).to(cache["k"].dtype)
        cv = _roll_rows(v[:, -size:], shift).to(cache["v"].dtype)
    else:
        slot = positions % size if cfg.window > 0 else positions
        ck = _write(cache["k"], slot, k)
        cv = _write(cache["v"], slot, v)
    return y, {"k": ck, "v": cv, "pos": total}


def prefill_kv_cache(params, cfg: AttentionConfig, x, max_len: int):
    """Full attention over x [B, N, d] (blockwise for N >= the threshold)
    and the KV cache for the decode that follows."""
    B, N, _ = x.shape
    positions = torch.arange(N, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    y = L.matmul(_sdpa(q, k, v, cfg).reshape(B, N, -1), params["wo"])
    return y, cache_from_kv(cfg, k, v, max_len, x.dtype)


def cache_from_kv(cfg: AttentionConfig, k, v, max_len: int, dtype) -> dict:
    """The KV cache (in ``dtype``) a whole-prompt prefill leaves from the
    prompt's keys and values k, v [B, N, Hkv, dh] (any number of KV heads:
    a tensor-parallel rank's, or all of them)."""
    B, N = k.shape[0], k.shape[1]
    size = min(max_len, cfg.window) if cfg.window > 0 else max_len
    cache = {name: torch.zeros((B, size) + tuple(t.shape[2:]), dtype=dtype, device=t.device)
             for name, t in (("k", k), ("v", v))}
    if cfg.window > 0 and N > size:
        # ring layout: slot i holds position N - size + i, rotated so that
        # slot (N mod size) is the next write position
        shift = N % size
        cache["k"] = torch.roll(k[:, -size:], shift, dims=1).to(dtype)
        cache["v"] = torch.roll(v[:, -size:], shift, dims=1).to(dtype)
    else:
        cache["k"][:, :N] = k
        cache["v"][:, :N] = v
    cache["pos"] = torch.full((B,), N, dtype=torch.int32, device=k.device)
    return cache
