"""Deterministic synthetic LM data, the port's copy of the JAX package's
``data/synthetic.py`` (plain numpy there too): a batch is a pure function of
(seed, step), so the two packages see the same batches."""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_batch_stream(seed: int, step: int, batch: int, seq_len: int, vocab: int):
    """Sparse first-order Markov stream: each token has 4 fixed successors
    with weights (0.6, 0.2, 0.15, 0.05). Optimal CE ~= 1.2 nats vs ln(V)
    uniform, and the transition table is a pure function of ``seed``.
    Returns {"inputs", "labels"} int32 [batch, seq_len]."""
    table_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBEEF]))
    succ = table_rng.integers(0, vocab, (vocab, 4))   # successor table
    w = np.array([0.6, 0.2, 0.15, 0.05])
    rng = _rng(seed, step)
    x = np.zeros((batch, seq_len + 1), np.int32)
    x[:, 0] = rng.integers(0, vocab, batch)
    choice = rng.choice(4, size=(batch, seq_len + 1), p=w)
    for t in range(1, seq_len + 1):
        x[:, t] = succ[x[:, t - 1], choice[:, t]]
    return {"inputs": x[:, :-1], "labels": x[:, 1:]}
