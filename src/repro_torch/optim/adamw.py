"""AdamW with decoupled weight decay (paper §4: AdamW, lr 3e-4, betas
(0.9, 0.98)), over a params tree of tensors.

The interface mirrors the JAX package's (itself optax-like):
``opt = adamw(...)``; ``state = opt.init(params)``;
``updates, state = opt.update(grads, state, params, lr, wd_mask)`` with
``wd_mask = default_wd_mask(params, cfg)``;
``params = apply_updates(params, updates)``. The update is functional (new
tensors, nothing modified in place), as there. The moments are stored in
``moment_dtype`` (bf16 halves the optimizer's memory) and the arithmetic is
fp32 whatever it is, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import execution_plan
from repro_torch.utils import (tree_flatten_with_paths, tree_leaves, tree_map,
                               tree_unflatten)


class Optimizer(NamedTuple):
    init: Any
    update: Any


def adamw(b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9,
          weight_decay: float = 0.1,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    def update(grads, state, params, lr: float, wd_mask):
        count = state["count"] + 1
        # bias corrections in float32, as the JAX package computes them
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))

        def upd(g, m, v, p, wm):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if wm:
                step = step + wm * weight_decay * p.float()
            return (-lr * step).to(p.dtype), m_new.to(moment_dtype), v_new.to(moment_dtype)

        out = [upd(*leaves) for leaves in zip(*map(tree_leaves, (
            grads, state["mu"], state["nu"], params, wd_mask)))]
        updates, mu, nu = (tree_unflatten(params, part) for part in zip(*out))
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def default_wd_mask(params, cfg: ModelConfig):
    """Decoupled weight decay applies to MATRICES only: norm scales, biases,
    ``b_alpha`` and the STLT node parameters (sigma_hat/omega/T_hat/u, the
    paper's interpretable Laplace nodes) get none, by parameter path as in
    the JAX package. (Decaying sigma_hat drags every half-life toward
    ln2/softplus(0); decaying the mixers u kills the mixer.)

    "Matrix" is judged by ``ndim`` on the JAX package's layout, as there:
    with ``cfg.scan_layers`` it stacks each run of equal blocks
    (``execution_plan``) on a leading axis, so a 1-D leaf of such a layer
    (the FFN biases) is 2-D there and IS decayed. The port's layers are
    unstacked; it counts that axis back in to follow the reference."""
    stacked, li = set(), 0
    for _, count in execution_plan(cfg):
        if count > 1:
            stacked.update(range(li, li + count))
        li += count
    mask = []
    for path, leaf in tree_flatten_with_paths(params):
        parts = path.split("/")
        in_run = parts[0] == "layers" and int(parts[1]) in stacked
        exclude = (leaf.ndim + in_run <= 1
                   or "/nodes/" in path
                   or path.endswith(("sigma_hat", "omega", "T_hat", "u_re", "u_im"))
                   or "norm" in path
                   or path.endswith(("b_alpha", "conv", "lam")))
        mask.append(0.0 if exclude else 1.0)
    return tree_unflatten(params, mask)
