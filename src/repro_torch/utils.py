"""Shared helpers: device selection, initializers, softplus.

Parameters are nested dicts of tensors whose keys follow the JAX package's
pytree keys, so ``convert.from_jax_params`` is a walk, not a renaming.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. There is no silent CPU fallback: asking for CUDA (explicitly or
    by default) on a machine without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def default_generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of nested dicts/lists/tuples, and to the
    matching leaves of ``rest`` (trees of the same structure) beside it;
    lists and tuples come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_flatten_with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in ``tree_map``'s order, paths joined by "/" as the
    JAX package names them (``layers/0/stlt/nodes/u_re``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pair for k, v in items
            for pair in tree_flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def jax_order(tree):
    """``tree`` with each dict's keys sorted: the order in which JAX flattens
    a dict (the port's trees keep insertion order), so that leaves fall as
    the JAX package's do."""
    if isinstance(tree, dict):
        return {k: jax_order(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [jax_order(v) for v in tree]
    return tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in ``tree_map``'s
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def casts_for_compute(shape, min_size: int = 65536) -> bool:
    """Whether a floating param of ``shape`` computes in the activation
    dtype under the JAX package's mixed-precision policy: the FLOP-carrying
    matrices (ndim >= 2, more than ``min_size`` elements) do; small and 1-D
    params (norm scales, biases, the Laplace nodes) stay fp32, since the
    poles' precision sets long half-lives."""
    return len(shape) >= 2 and math.prod(shape) > min_size


def cast_params_for_compute(tree, dtype: torch.dtype, min_size: int = 65536):
    """The tree with every floating leaf that ``casts_for_compute`` names in
    ``dtype``, the rest as they are. Returns a new tree."""
    def cast(x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and casts_for_compute(tuple(x.shape), min_size)):
            return x.to(dtype)
        return x
    return tree_map(cast, tree)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def inv_softplus(y: float) -> float:
    """x such that softplus(x) = y (for parameter initialization)."""
    return float(np.log(np.expm1(y)))


def trunc_normal(generator: torch.Generator, shape, stddev: float = 0.02,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2]."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(stddev).to(dtype)     # in place: one fp32 copy of a large leaf


def lecun_normal(generator: torch.Generator, shape, fan_in: Optional[int] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(generator, shape, stddev=1.0 / math.sqrt(max(1, fan_in)),
                        dtype=dtype, device=device)
