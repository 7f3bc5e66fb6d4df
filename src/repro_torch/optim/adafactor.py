"""Adafactor (Shazeer & Stern, 2018) with factored second moments, the
port of the JAX package's ``optim/adafactor.py``.

The second moment of an [n, m] matrix is stored as a row vector [n] and a
column vector [m] instead of [n, m]; beta1 = 0 (no first moment). Leaves
with fewer than 2 dims, or a trailing dim under 8, keep a full second
moment. Update clipping at d = 1 and beta2 = 1 - t^-0.8, as in the paper.
The state's ``count`` is a Python int, as the port's AdamW keeps it.
Whether a leaf is factored is read from its state (``init`` decides by the
whole shape), so ``update`` runs on a rank's shards too, given each
leaf's ``mean`` over the whole leaf (``launch.steps``' sharded step).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import Optimizer
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

EPS1 = 1e-30
EPS2 = 1e-3
CLIP_D = 1.0


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def _whole_mean(x, dims):
    return x.mean(dims, keepdim=True)


def _leaf_states(params, v_tree) -> list:
    """The per-leaf state dicts of ``v_tree`` in ``params``' leaf order."""
    out = []
    tree_map(lambda _, v: out.append(v), params, v_tree)
    return out


def adafactor(learning_rate=None, weight_decay: float = 0.0,
              decay_rate: float = 0.8) -> Optimizer:
    """``learning_rate`` is unused, as in the JAX package: ``update`` takes
    the step's rate."""
    del learning_rate

    def init(params):
        def per_leaf(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            if _factored(p.shape):
                return {"vr": zeros(p.shape[:-1]),           # row (mean over columns)
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return {"v": tree_map(per_leaf, params), "count": 0}

    def update(grads, state, params, lr: float, wd_mask=None, means=None):
        """``means`` (None: the leaves are whole) gives each leaf, in the
        params' leaf order, its ``mean(x, dims)``: the mean over ``dims``
        (kept) of the whole leaf, of which x is the caller's shard."""
        del wd_mask                      # decay, if any, applies to every leaf
        count = state["count"] + 1
        # in float32, as the JAX package computes them
        beta2 = np.float32(1) - np.float32(count) ** np.float32(-decay_rate)
        b2, one_minus_b2 = float(beta2), float(np.float32(1) - beta2)

        def upd(g, v, p, mean):
            g = g.float()
            g2 = g * g + EPS1
            if "vr" in v:
                vr = b2 * v["vr"] + one_minus_b2 * mean(g2, (-1,))[..., 0]
                vc = b2 * v["vc"] + one_minus_b2 * mean(g2, (-2,))[..., 0, :]
                denom = mean(vr[..., None], (-2,))
                vhat = (vr[..., None] * vc[..., None, :]) / torch.clamp(denom, min=EPS1)
                new_v = {"vr": vr, "vc": vc}
            else:
                vhat = b2 * v["v"] + one_minus_b2 * g2
                new_v = {"v": vhat}
            u = g / torch.sqrt(torch.clamp(vhat, min=EPS1))
            # update clipping: RMS(u) <= d
            rms_u = torch.sqrt(mean(u * u, tuple(range(u.ndim))).reshape(()) + EPS1)
            u = u / torch.clamp(rms_u / CLIP_D, min=1.0)
            step = u + weight_decay * p.float()
            return (-lr * step).to(p.dtype), new_v

        leaves = tree_leaves(params)
        means = means or [_whole_mean] * len(leaves)
        out = [upd(g, v, p, m) for g, v, p, m in zip(tree_leaves(grads),
                                                      _leaf_states(params, state["v"]),
                                                      leaves, means)]
        updates = tree_unflatten(params, [o[0] for o in out])
        new_v = tree_unflatten(params, [o[1] for o in out])
        return updates, {"v": new_v, "count": count}

    return Optimizer(init=init, update=update)
