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
- without a mesh ``apply_moe`` runs the gather path whatever ``dispatch``
  says, as the JAX package's does outside a mesh.

``route`` (the router over every expert, each choice's slot among the
experts a call holds) and ``experts_combine`` (the slot table, the stacked
products, the combine and the dense branch) are the local steps that
``apply_moe`` and the expert-parallel form on a (``data``, ``model``) mesh,
``distributed/tensor_parallel.apply_moe_ep``, share; the mesh's capacity,
slot offsets and balance sums are that module's.

``DROPS`` counts the dropped (token, expert) choices of every call since its
last ``reset``, on each device without a host sync (tests and
``chip_smoke.py`` read it; a remat recompute counts its forward again).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

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
    dispatch: str = "gather"      # gather | shard_map (on a mesh: tensor_parallel.apply_moe_ep)


class DropCounter:
    """Dropped (token, expert) choices over the ``apply_moe`` calls since the
    last ``reset``: one running sum per device, kept there until ``read``
    adds them up."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls, self._dropped = 0, {}

    def add(self, dropped: torch.Tensor):
        if dropped.device.type == "meta":   # a shape-only step has no count to keep
            return
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
    """x [B, N, d] -> (y [B, N, d], aux {aux_loss, router_z}) on one device:
    every ``dispatch`` runs the gather path (``tensor_parallel.apply_moe_ep``
    is the mesh's form, over the same ``route`` and ``experts_combine``)."""
    B, N, d = x.shape
    T = B * N
    xt = x.reshape(T, d)
    r = route(params, cfg, xt)
    aux_loss, router_z = balance_losses(cfg, r.probs, r.top1, r.lse2)
    C = _capacity(T, cfg)
    keep = r.pos < C
    DROPS.add((~keep).sum())
    y = experts_combine(params, cfg, xt, r.local, r.pos, keep, r.gates, C, x.dtype)
    return y.reshape(B, N, d), {"aux_loss": aux_loss, "router_z": router_z}


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


class Routing(NamedTuple):
    """``route``'s result for T tokens and K choices each (K fastest)."""
    probs: torch.Tensor      # [T, E] fp32, every expert
    top1: torch.Tensor       # [T, E] the top-1 one-hots
    lse2: torch.Tensor       # [T] the logits' squared log-sum-exp
    gates: torch.Tensor      # [T, K] the top-K probs renormalized
    local: torch.Tensor      # [T*K] the choice's expert among the held ones; n: none
    pos: torch.Tensor        # [T*K] its position among this call's choices of it
    counts: torch.Tensor     # [n] int32: this call's choices of each held expert


def route(params, cfg: MoEConfig, xt: torch.Tensor, first: int = 0) -> Routing:
    """The router over every expert for xt [T, d], and the slots of the
    choices of the n experts ``params`` hold, [first, first + n): each
    choice's expert among them (the others go to the drop bin n) and its
    position among this call's choices of that expert, in token order."""
    n = params["w1"].shape[0]
    logits = L.matmul(xt, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, exp_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = exp_idx.reshape(-1) - first                  # [T*K], K fastest
    local = torch.where((flat_e >= 0) & (flat_e < n), flat_e, n)
    onehot = F.one_hot(local, n + 1)                      # [T*K, n + 1]
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1, local[:, None])[:, 0]
    return Routing(probs, F.one_hot(exp_idx[:, 0], cfg.num_experts).float(),
                   torch.square(torch.logsumexp(logits, -1)), gate_vals, local, pos,
                   onehot[:, :n].sum(0, dtype=torch.int32))


def balance_losses(cfg: MoEConfig, probs, top1, lse2):
    """aux_loss and router_z (Switch/GShard) from the mean router prob per
    expert, the top-1 one-hots and the logits' squared log-sum-exp."""
    aux_loss = cfg.aux_loss_weight * cfg.num_experts * torch.sum(probs.mean(0) * top1.mean(0))
    return aux_loss, cfg.router_z_weight * torch.mean(lse2)


def experts_combine(params, cfg: MoEConfig, xt, rows, pos, keep, gate_vals, C: int, dtype):
    """The slot table [n, C] of the kept choices (expert ``rows``, position
    ``pos``; sentinel T: the zero row; the others write to an extra row and
    column, which are cut away), the n stacked expert FFNs on it, and each
    token's K contributions summed in slot order in ``dtype``, never by an
    atomic ``index_add_``; plus Arctic's dense branch on ``params["dense"]``:
    y [T, d]."""
    T, d = xt.shape
    K, n = cfg.top_k, params["w1"].shape[0]
    src_tok = torch.arange(T, device=xt.device).repeat_interleave(K)
    slot_tok = torch.full((n + 1, C + 1), T, dtype=torch.long, device=xt.device)
    slot_tok[torch.where(keep, rows, n), torch.where(keep, pos, C)] = src_tok
    x_e = torch.cat([xt, xt.new_zeros((1, d))], dim=0)[slot_tok[:n, :C]]   # [n, C, d]

    h1 = _bmm(x_e, params["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h1) * _bmm(x_e, params["w3"])
    else:
        h = F.gelu(h1, approximate="tanh")
    y_e = _bmm(h, params["w2"])                           # [n, C, d]

    gate_flat = (gate_vals.reshape(-1) * keep).to(dtype)
    y_slots = y_e[torch.clamp(rows, max=n - 1), torch.clamp(pos, max=C - 1)]   # [T*K, d]
    contrib = (y_slots * gate_flat[:, None]).to(dtype).reshape(T, K, d)
    y = contrib[:, 0]
    for j in range(1, K):
        y = y + contrib[:, j]
    if cfg.dense_residual:
        y = y + L.ffn(params["dense"], xt, act=cfg.act)
    return y
