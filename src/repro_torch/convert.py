"""Carry parameters and decode states from the JAX package into the port.

The port cannot import JAX, so both converters take the JAX pytree as nested
dicts/lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``).
Runs of equal blocks that the JAX package stacks on a leading axis
(``scan_layers=True``, see ``transformer.execution_plan``) are unstacked
into one entry per layer, the port's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import execution_plan
from repro_torch.utils import resolve_device, tree_map


def _tensor(a, device):
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's are read-only


def _unstack(runs, cfg: ModelConfig, device):
    plan = execution_plan(cfg)
    if len(runs) != len(plan):
        raise ValueError(f"expected {len(plan)} layer runs for {cfg.name!r}, "
                         f"got {len(runs)}")
    layers = []
    for (_, count), run in zip(plan, runs):
        if count == 1:
            layers.append(tree_map(lambda a: _tensor(a, device), run))
        else:
            layers.extend(tree_map(lambda a, j=j: _tensor(np.asarray(a)[j], device), run)
                          for j in range(count))
    return layers


def from_jax_params(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """JAX ``transformer.init_lm`` params (numpy leaves) -> port params on
    ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = _unstack(tree["layers"], cfg, device)
    return out


def from_jax_state(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A JAX decode state (``init_decode_state`` / ``prefill`` /
    ``prefill_chunk``, numpy leaves) -> the port's decode state."""
    device = resolve_device(device)
    return {"layers": _unstack(tree["layers"], cfg, device),
            "pos": _tensor(tree["pos"], device).to(torch.int32)}
