"""Adaptive Laplace-node allocation (paper §3.6).

Importance scores from a pooled summary of the layer input,
``alpha = sigmoid(W_alpha pool(X) + b_alpha)``, relaxed to masks
``m_k = sigmoid((logit_k + g_k) / tau)`` with logistic noise ``g`` in
training and ``g = 0`` at eval/serve (optionally hard-thresholded). The
trainer anneals tau (``anneal_tau``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils import trunc_normal


class AdaptiveConfig(NamedTuple):
    enabled: bool = False
    tau: float = 1.0
    lambda_omega: float = 1e-4
    lambda_sigma: float = 1e-4
    lambda_mask: float = 1e-3
    hard_eval: bool = False
    threshold: float = 0.5


def init_adaptive(generator: torch.Generator, d_model: int, num_heads: int,
                  num_nodes: int, dtype=torch.float32, device=None) -> dict:
    """W_alpha: pooled features -> per-(head, node) logits."""
    return {
        "w_alpha": trunc_normal(generator, (d_model, num_heads, num_nodes),
                                stddev=0.02, dtype=dtype, device=device),
        "b_alpha": 2.0 * torch.ones((num_heads, num_nodes), dtype=dtype,
                                    device=device),
    }


def _logits(params: dict, pooled: torch.Tensor) -> torch.Tensor:
    return (torch.einsum("...d,dhk->...hk", pooled, params["w_alpha"])
            + params["b_alpha"])


def masks_from_pooled(params: dict, pooled: torch.Tensor, cfg: AdaptiveConfig,
                      dtype=torch.float32) -> torch.Tensor:
    """Deterministic (eval/serve) masks from an already-pooled summary
    ``pooled`` [..., d] -> m [..., H, S]."""
    logits = _logits(params, pooled)
    if cfg.hard_eval:
        return (torch.sigmoid(logits) > cfg.threshold).to(dtype)
    return torch.sigmoid(logits / cfg.tau).to(dtype)


def node_masks(params: dict, x: torch.Tensor, cfg: AdaptiveConfig, *,
               deterministic: bool = True,
               draws: Optional[torch.Tensor] = None,
               pad_mask: Optional[torch.Tensor] = None):
    """Masks m [B, H, S] and S_eff [B] for layer input x [B, N, d].

    The stochastic path (``deterministic=False``) turns uniform draws u in
    (1e-6, 1 - 1e-6), ``draws`` [B, H, S], into logistic noise
    log(u) - log1p(-u) (the trainer draws them; the tests feed the JAX
    package's ``jax.random.uniform`` bits in, so the masks are held to its
    own). Without draws the noise is 0, as the JAX package does without a
    key."""
    if pad_mask is not None:
        pm = pad_mask.to(x.dtype)
        pooled = (x * pm[..., None]).sum(-2) / pm.sum(-1, keepdim=True).clamp_min(1.0)
    else:
        pooled = x.mean(dim=-2)
    if deterministic:
        m = masks_from_pooled(params, pooled, cfg, dtype=x.dtype)
    else:
        logits = _logits(params, pooled)
        noise = 0.0 if draws is None else torch.log(draws) - torch.log1p(-draws)
        m = torch.sigmoid((logits + noise) / cfg.tau)
    s_eff = m.sum(dim=(-1, -2)) / m.shape[-2]
    return m, s_eff


def node_importance(u_re: torch.Tensor, u_im: torch.Tensor,
                    log_mag: torch.Tensor) -> torch.Tensor:
    """Static per-node importance |u| * 1/(1-|lambda|), all args [..., S]."""
    gain = torch.sqrt(u_re.float() ** 2 + u_im.float() ** 2)
    mass = 1.0 / torch.clamp(1.0 - torch.exp(log_mag.float()), min=1e-6)
    return gain * mass


def node_rank(imp: torch.Tensor) -> torch.Tensor:
    """Dense descending rank over the last axis, ties broken by index (lower
    index wins): rank 0 = most important, ``rank < m`` keeps exactly m."""
    idx = torch.arange(imp.shape[-1], device=imp.device)
    gt = (imp[..., None, :] > imp[..., :, None]).to(torch.int32)
    tie = (imp[..., None, :] == imp[..., :, None]) & (idx[None, :] < idx[:, None])
    return (gt + tie.to(torch.int32)).sum(-1)


def top_m_mask(imp: torch.Tensor, m: int, dtype=torch.float32) -> torch.Tensor:
    """One-hot keep-mask of the m most important nodes (index-tie-broken):
    exactly m survivors per row even under full ties."""
    return (node_rank(imp) < m).to(dtype)


def node_cap_mask(imp: torch.Tensor, cap: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """imp [H, S] static importance, cap [B] per-row node budget ->
    [B, H, S] keep-mask (cap == S keeps every node)."""
    rank = node_rank(imp)
    return (rank[None, :, :] < cap[:, None, None]).to(dtype)


def regularization(sigma: torch.Tensor, omega: torch.Tensor,
                   masks: Optional[torch.Tensor],
                   cfg: AdaptiveConfig) -> torch.Tensor:
    """The paper's (Reg) loss (scalar):

    R = lambda_omega * sum |omega_k| m_k
      + lambda_sigma * sum (sigma_k - sigma_{k-1})^2 m_k m_{k-1}  (sorted sigma)
      + lambda_mask  * sum m_k
    """
    m = torch.ones_like(sigma)[None] if masks is None else masks
    m_mean = m.mean(dim=0)
    r_omega = cfg.lambda_omega * torch.sum(torch.abs(omega) * m_mean)
    # ascending rank with index tie-break == a stable sort of sigma
    order = torch.argsort(sigma.detach(), dim=-1, stable=True)
    sig_sorted = torch.gather(sigma, -1, order)
    m_sorted = torch.gather(m_mean, -1, order)
    dsig = torch.diff(sig_sorted, dim=-1)
    r_sigma = cfg.lambda_sigma * torch.sum(
        dsig ** 2 * m_sorted[..., 1:] * m_sorted[..., :-1])
    r_mask = cfg.lambda_mask * torch.sum(m_mean)
    return r_omega + r_sigma + r_mask


def anneal_tau(step: int, total_steps: int, tau_start: float = 1.0,
               tau_end: float = 0.1) -> float:
    """Paper §4: anneal the temperature from 1.0 to 0.1 over the first 40% of
    training. In float32, as the JAX package computes it, so the two give
    the same value."""
    f32 = np.float32
    t = np.clip(f32(step) / f32(max(1, int(total_steps * 0.4))), f32(0), f32(1))
    return float(f32(tau_start) + f32(tau_end - tau_start) * t)
