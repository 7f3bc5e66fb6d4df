"""Carry parameters, decode states and training checkpoints from the JAX
package into the port (the LM's, and the enc-dec family's with
``from_jax_encdec_params``/``from_jax_encdec_state``).

The port cannot import JAX, so the converters take the JAX pytree as nested
dicts/lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``),
or read a checkpoint's files with numpy. Runs of equal blocks that the JAX
package stacks on a leading axis (``scan_layers=True``, see
``transformer.execution_plan``) are unstacked into one entry per layer, the
port's layout.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import read_leaves, read_manifest, to_tensor
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import execution_plan
from repro_torch.utils import resolve_device, tree_leaves, tree_map


def _tensor(a, device):
    return to_tensor(a).to(device)  # a copy: JAX's arrays are read-only


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


def _per_layer(side, device) -> list:
    """One side of an enc-dec tree as one entry per layer: a stacked run
    (a dict whose leaves carry the layer on a leading axis, as the JAX
    package's ``scan_layers`` and ``jax.vmap`` make them) is unstacked, a
    list is taken as it is."""
    if isinstance(side, dict):
        count = len(np.asarray(tree_leaves(side)[0]))
        return [tree_map(lambda a, j=j: _tensor(np.asarray(a)[j], device), side)
                for j in range(count)]
    return [tree_map(lambda a: _tensor(a, device), p) for p in side]


def from_jax_encdec_params(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """JAX ``whisper.init_encdec`` params (numpy leaves) -> the port's
    (``models/whisper.py``) on ``device`` (CUDA unless the caller names
    another): ``enc_layers``/``dec_layers`` one dict per layer, from the JAX
    package's stacked ``enc_layers``/``dec_layers`` or its ``enc_list``/
    ``dec_list``."""
    device = resolve_device(device)
    out = {}
    for key in ("enc_embed", "dec_embed", "enc_layers", "dec_layers", "enc_norm",
                "dec_norm", "lm_head"):
        if key in ("enc_layers", "dec_layers"):
            side = tree[key] if key in tree else tree[key[:3] + "_list"]
            out[key] = _per_layer(side, device)
            want = cfg.num_layers if key == "enc_layers" else cfg.num_decoder_layers
            if len(out[key]) != want:
                raise ValueError(f"{key}: {len(out[key])} layers, {cfg.name!r} has {want}")
        elif key in tree:
            out[key] = tree_map(lambda a: _tensor(a, device), tree[key])
    return out


def from_jax_encdec_state(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A JAX enc-dec decode state (``init_encdec_decode_state`` /
    ``encdec_decode_step``, numpy leaves; a stacked decoder's states come
    stacked, as ``jax.vmap`` makes them) -> the port's: one state per
    decoder layer and the scalar position."""
    device = resolve_device(device)
    layers = _per_layer(tree["dec"], device)
    if len(layers) != cfg.num_decoder_layers:
        raise ValueError(f"{len(layers)} decoder states, {cfg.name!r} has "
                         f"{cfg.num_decoder_layers} decoder layers")
    return {"dec": layers, "pos": _tensor(tree["pos"], device).to(torch.int32)}


def _nest(pairs) -> dict:
    """A nested tree from ("a/b/0/c", leaf) pairs: a level whose keys are all
    numbers is a list (JAX's ``SequenceKey``), in index order."""
    root: dict = {}
    for name, leaf in pairs:
        *parents, last = name.split("/")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            if sorted(map(int, node)) != list(range(len(node))):
                raise ValueError(f"list indices {sorted(node)} are not 0..{len(node) - 1}")
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def from_jax_checkpoint(directory: str, cfg: ModelConfig, device=None,
                        step: Optional[int] = None):
    """A training checkpoint that the JAX package's ``CheckpointManager``
    wrote (``{"params", "opt": {"mu", "nu", "count"}}``, AdamW's state) ->
    (the port's ``{"params", "opt"}`` tree on ``device``, step); the latest
    step when ``step`` is None. The files are read with numpy; the tree is
    rebuilt from the manifest's names (JAX flattens dicts in sorted-key
    order, the port in insertion order), and the stacked runs of ``params``,
    ``mu`` and ``nu`` are unstacked as ``from_jax_params`` does."""
    device = resolve_device(device)
    path, manifest, step = read_manifest(directory, step)
    metas = manifest["leaves"]
    tree = _nest(zip((m["name"] for m in metas), read_leaves(path, metas)))
    opt = tree["opt"]
    return {"params": from_jax_params(tree["params"], cfg, device),
            "opt": {"mu": from_jax_params(opt["mu"], cfg, device),
                    "nu": from_jax_params(opt["nu"], cfg, device),
                    "count": int(opt["count"])}}, step
