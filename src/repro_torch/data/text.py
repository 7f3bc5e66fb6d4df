"""Byte-level text corpus: packing + deterministic batch slicing, the port's
copy of the JAX package's ``data/text.py`` (plain numpy there too).

The corpus is this repository's own text files (no dataset ships with it).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

VOCAB = 256  # bytes


def repo_corpus(root: Optional[str] = None, max_bytes: int = 4 << 20) -> bytes:
    """Concatenate this repo's text files into a corpus."""
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    buf = bytearray()
    for dirpath, _, files in sorted(os.walk(root)):
        if any(part.startswith(".") or part in ("results", "__pycache__")
               for part in dirpath.split(os.sep)):
            continue
        for fn in sorted(files):
            if fn.endswith((".py", ".md", ".toml", ".txt")):
                try:
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        buf += f.read()
                except OSError:
                    continue
            if len(buf) >= max_bytes:
                return bytes(buf[:max_bytes])
    return bytes(buf)


class ByteCorpus:
    """Deterministic (seed, step) -> batch slicing over a packed byte array."""

    def __init__(self, data: Optional[bytes] = None, seed: int = 0):
        data = data if data is not None else repo_corpus()
        if len(data) < 1 << 16:
            data = data * ((1 << 16) // max(1, len(data)) + 1)
        self.arr = np.frombuffer(data, np.uint8).astype(np.int32)
        self.seed = seed

    def batch(self, step: int, batch: int, seq_len: int, split: str = "train"):
        """{"inputs", "labels"} int32 [batch, seq_len]. As in the JAX package,
        the split's salt is ``hash(split)``, so batches are the same within a
        process (and across processes only with a fixed PYTHONHASHSEED)."""
        n = len(self.arr) - seq_len - 1
        train_cut = int(n * 0.9)
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, step, hash(split) % (2**31)]))
        if split == "train":
            starts = rng.integers(0, train_cut, batch)
        else:
            starts = rng.integers(train_cut, n, batch)
        idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
        chunk = self.arr[idx]
        return {"inputs": chunk[:, :-1], "labels": chunk[:, 1:]}
