"""Gradient compression for a data-parallel all-reduce, the port of the
JAX package's ``optim/compression.py``: pure tree transforms.

* ``bf16``    -- gradients cast to bf16 (half the bytes on the wire);
* ``bf16_ef`` -- bf16 with error feedback: the rounding residual is kept in
                 an fp32 accumulator and added back at the next step, so the
                 compression is unbiased over time.

On one device nothing calls them, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def compress_gradients(grads, mode: str, error_state: Optional[dict] = None):
    """(grads', new_error_state)."""
    if mode == "none":
        return grads, error_state
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), error_state
    if mode == "bf16_ef":
        if error_state is None:
            raise ValueError("bf16_ef needs an error accumulator (init_error_state)")
        q, e = [], []
        for g, err in zip(tree_leaves(grads), tree_leaves(error_state)):
            g32 = g.float() + err
            q.append(g32.to(torch.bfloat16))
            e.append(g32 - q[-1].float())
        return tree_unflatten(grads, q), tree_unflatten(grads, e)
    raise ValueError(mode)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
