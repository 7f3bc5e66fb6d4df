"""Sharded npz checkpoints with an atomic rename, in the JAX package's
on-disk format (``repro/checkpoint/checkpointer.py``):

  <dir>/step_<N:08d>/shard_<i:04d>.npz  +  <dir>/step_<N:08d>/MANIFEST.json

The manifest holds ``step``, ``num_shards`` and one entry per leaf
(``name``: its "/"-joined path, ``key`` in its shard, ``shard``, ``shape``,
``dtype``), 256 leaves a shard, in JAX's leaf order (dict keys sorted), so
each package reads the other's checkpoints of the same tree. Writes go to ``step_<N>.tmp`` and are
renamed once every shard and the manifest are fsynced, so a writer stopped
midway never leaves a checkpoint that restore would pick up. Restore
checks the leaf count, each name and each shape before it reads an array.

Leaves are tensors (copied to the host) or Python ints (the optimizers'
``count``, written as a 0-d int32 as the JAX state holds it, and read back
as an int). bf16 is written as numpy writes JAX's bfloat16: 2-byte raw
values (``V2``) under the dtype name ``bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import jax_order, tree_flatten_with_paths, tree_unflatten

MANIFEST = "MANIFEST.json"
SHARD_LEAVES = 256  # leaves per npz shard file


def host_array(leaf) -> tuple:
    """(numpy array, dtype name) of a leaf as it is written."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def to_tensor(arr) -> torch.Tensor:
    """A numpy array as a new tensor; 2-byte raw values (``V2``, as numpy
    holds JAX's bfloat16) as bf16."""
    arr = np.array(arr)          # a copy: arrays read from an npz are read-only
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    final = step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "num_shards": 0}
    shard, shard_idx = {}, 0
    for i, (name, leaf) in enumerate(tree_flatten_with_paths(jax_order(tree))):
        arr, dtype = host_array(leaf)
        key = f"leaf_{i:06d}"
        shard[key] = arr
        manifest["leaves"].append({"name": name, "key": key, "shard": shard_idx,
                                   "shape": list(arr.shape), "dtype": dtype})
        if len(shard) >= SHARD_LEAVES:
            _write_shard(tmp, shard_idx, shard)
            shard, shard_idx = {}, shard_idx + 1
    if shard:
        _write_shard(tmp, shard_idx, shard)
        shard_idx += 1
    manifest["num_shards"] = shard_idx
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _write_shard(tmp: str, idx: int, shard: dict):
    with open(os.path.join(tmp, f"shard_{idx:04d}.npz"), "wb") as f:
        np.savez(f, **shard)
        f.flush()
        os.fsync(f.fileno())


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d[len("step_"):]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, MANIFEST))]
    return max(steps) if steps else None


def read_manifest(directory: str, step: Optional[int] = None) -> tuple:
    """(the step's directory, its manifest, step); the latest step when
    ``step`` is None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = step_dir(directory, step)
    with open(os.path.join(path, MANIFEST)) as f:
        return path, json.load(f), step


def read_leaves(path: str, metas: list) -> list:
    """The arrays of the manifest entries ``metas`` (numpy, as written)."""
    shards, out = {}, []
    try:
        for meta in metas:
            sid = meta["shard"]
            if sid not in shards:
                shards[sid] = np.load(os.path.join(path, f"shard_{sid:04d}.npz"))
            out.append(shards[sid][meta["key"]])
    finally:
        for s in shards.values():
            s.close()
    return out


def load_checkpoint(directory: str, tree_like: Any, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` -> (tree, step). Leaves are
    matched by name; tensors come back on their ``tree_like`` leaf's device
    in the dtype they were written in, ints as ints."""
    path, manifest, step = read_manifest(directory, step)
    flat_like = tree_flatten_with_paths(tree_like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target structure has {len(flat_like)}")
    by_name = {meta["name"]: meta for meta in manifest["leaves"]}
    metas = []
    for name, like in flat_like:
        meta = by_name.get(name)
        if meta is None:
            raise ValueError(f"leaf mismatch: {name} is not in the checkpoint")
        shape = list(like.shape) if isinstance(like, torch.Tensor) else []
        if shape != meta["shape"]:
            raise ValueError(f"shape mismatch at {name}: {shape} vs {meta['shape']}")
        metas.append(meta)
    leaves = [to_tensor(arr).to(like.device) if isinstance(like, torch.Tensor)
              else int(arr)
              for (_, like), arr in zip(flat_like, read_leaves(path, metas))]
    return tree_unflatten(tree_like, leaves), step
