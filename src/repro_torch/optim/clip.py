"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves, tree_map


def clip_by_norm(grads, gnorm: torch.Tensor, max_norm: float):
    """grads scaled so that ``gnorm``, their global L2 norm, is at most
    ``max_norm`` (a sharded step computes ``gnorm`` over its shards)."""
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the norm
    before clipping as a float32 tensor). No host sync."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    return clip_by_norm(grads, gnorm, max_norm), gnorm
