"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch and the
optional dense residual branch (Arctic); the port's counterpart of the JAX
package's ``models/moe.py``, function for function.

Dispatch is the scatter/gather formulation: each (token, expert) choice
gets a slot ``(expert, position in expert)`` from a masked cumulative sum,
the tokens are gathered into ``[E, C, d]`` expert batches, the stacked
expert FFNs run as batched products (``torch.matmul`` over the expert axis,
``aten.bmm``, so ``remat_policy="dots"`` recomputes them as the JAX
package's ``dots_with_no_batch_dims_saveable`` does), and the outputs are
combined back with their gate weights. Choices beyond an expert's capacity
C are dropped (GShard/Switch semantics: the residual stream carries the
token on). C depends on the number of tokens T of the whole call, so
padded tokens and idle rows route too and take capacity, as in JAX.

Three places where the frameworks differ and the port follows JAX:

- top-k: ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities and ``torch.topk`` does not, so the K experts are the
  first K of a stable descending sort;
- the combine adds each token's K contributions one after another in the
  activation dtype, in slot order, as JAX's scatter-add does, never by an
  atomic ``index_add_`` (unordered on the card in bf16);
- ``dispatch="shard_map"`` is the JAX package's explicit expert-parallel
  path; without a mesh it runs the gather path, which is all the port has
  (multi-device serving, ROADMAP Queue 1 item 7).

``DROPS`` counts the dropped (token, expert) choices of every call since its
last ``reset``, on each device without a host sync (tests and
``chip_smoke.py`` read it; a remat recompute counts its forward again).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils import lecun_normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden dim
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # Arctic: parallel dense FFN branch
    dense_ff: int = 0             # hidden dim of the residual branch
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    act: str = "swiglu"
    param_dtype: Any = torch.float32
    dispatch: str = "gather"      # gather | shard_map (the gather path here)


class DropCounter:
    """Dropped (token, expert) choices over the ``apply_moe`` calls since the
    last ``reset``: one running sum per device, kept there until ``read``
    adds them up."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls, self._dropped = 0, {}

    def add(self, dropped: torch.Tensor):
        prev = self._dropped.get(dropped.device)
        self._dropped[dropped.device] = dropped if prev is None else prev + dropped
        self.calls += 1

    def read(self) -> dict:
        return {"calls": self.calls, "dropped": sum(int(v) for v in self._dropped.values())}


DROPS = DropCounter()


def init_moe(generator, cfg: MoEConfig, device=None) -> dict:
    """The router, the stacked experts (``w3`` drawn for every ``act``, as
    JAX draws it) and Arctic's dense branch, in the JAX package's key
    order."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    kw = dict(dtype=cfg.param_dtype, device=device)
    p = {"router": lecun_normal(generator, (d, E), **kw),
         "w1": lecun_normal(generator, (E, d, f), fan_in=d, **kw),
         "w3": lecun_normal(generator, (E, d, f), fan_in=d, **kw),
         "w2": lecun_normal(generator, (E, f, d), fan_in=f, **kw)}
    if cfg.dense_residual:
        p["dense"] = L.init_ffn(generator, d, cfg.dense_ff or f, act=cfg.act, **kw)
    return p


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane alignment


def apply_moe(params, cfg: MoEConfig, x: torch.Tensor):
    """x [B, N, d] -> (y [B, N, d], aux {aux_loss, router_z}). Every
    ``dispatch`` runs the gather path (one device, no mesh)."""
    return _apply_moe_gather(params, cfg, x)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` over the expert axis in the promoted dtype, as JAX's
    einsum types it."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _apply_moe_gather(params, cfg: MoEConfig, x: torch.Tensor):
    B, N, d = x.shape
    T = B * N
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(T, d)

    logits = L.matmul(xt, params["router"]).float()       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, exp_idx = _top_k(probs, K)                 # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # --- load-balancing aux losses (Switch/GShard) --------------------------
    me = probs.mean(0)                                    # mean router prob per expert
    ce = F.one_hot(exp_idx[:, 0], E).float().mean(0)      # fraction routed (top-1)
    aux_loss = cfg.aux_loss_weight * E * torch.sum(me * ce)
    router_z = cfg.router_z_weight * torch.mean(torch.square(torch.logsumexp(logits, -1)))

    # --- slot assignment -----------------------------------------------------
    C = _capacity(T, cfg)
    flat_e = exp_idx.reshape(-1)                          # [T*K], K fastest
    onehot = F.one_hot(flat_e, E)                         # [T*K, E]
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot       # position BEFORE this choice
    pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = pos < C
    DROPS.add((~keep).sum())
    # the [E, C] slot table (sentinel T: the zero row); a dropped choice
    # writes to the extra column C, which is cut away
    src_tok = torch.arange(T, device=x.device).repeat_interleave(K)
    slot_tok = torch.full((E, C + 1), T, dtype=torch.long, device=x.device)
    slot_tok[flat_e, torch.where(keep, pos, C)] = src_tok
    slot_tok = slot_tok[:, :C]
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    x_e = xt_pad[slot_tok]                                # [E, C, d]

    # --- expert computation -------------------------------------------------
    h1 = _bmm(x_e, params["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h1) * _bmm(x_e, params["w3"])
    else:
        h = F.gelu(h1, approximate="tanh")
    y_e = _bmm(h, params["w2"])                           # [E, C, d]

    # --- combine: each token's K contributions summed in slot order, in x's
    # dtype ------------------------------------------------------------------
    gate_flat = (gate_vals.reshape(-1) * keep).to(x.dtype)
    y_slots = y_e[flat_e, torch.clamp(pos, max=C - 1)]   # [T*K, d]
    contrib = (y_slots * gate_flat[:, None]).to(x.dtype).reshape(T, K, d)
    y = contrib[:, 0]
    for j in range(1, K):
        y = y + contrib[:, j]

    if cfg.dense_residual:
        y = y + L.ffn(params["dense"], xt, act=cfg.act)

    return y.reshape(B, N, d), {"aux_loss": aux_loss, "router_z": router_z}
