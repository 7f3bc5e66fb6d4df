"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the norm
    before clipping as a float32 tensor). No host sync."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm
