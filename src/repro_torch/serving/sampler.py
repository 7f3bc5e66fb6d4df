"""Token sampling: greedy, temperature and top-k, plus the per-slot batched
variants used by the continuous-batching engine (each decode slot has its
own temperature and noise stream, and EOS/budget bookkeeping is a single
vectorized update over the slot pool).

Sampling is the Gumbel-max trick, as ``jax.random.categorical`` does it:
``argmax(logits / T + g)`` with ``g`` standard Gumbel noise that the caller
passes in. So sampled serve streams match the JAX package's token for token
when the JAX package's own draws are fed in; by default ``GumbelStreams``
makes them from a seeded generator, and ``gumbel`` draws ``generate``'s from
the caller's ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sample_slot_tokens(logits: torch.Tensor, noise: Optional[torch.Tensor],
                       temperatures: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Per-slot sampling: each row has its own temperature and noise.

    logits [B, V]; noise [B, V] standard Gumbel draws (None when no row
    samples); temperatures [B] (<= 0 -> greedy for that row). Returns
    tokens [B] int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if noise is None:
        return greedy
    hot = temperatures > 0
    safe_t = torch.where(hot, temperatures, torch.ones_like(temperatures))[:, None]
    scaled = logits.float() / safe_t
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30), scaled)
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    return torch.where(hot, sampled, greedy)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


class GumbelStreams:
    """Per-request Gumbel noise: ``draws(rid, step)`` is the [vocab] noise of
    request ``rid``'s ``step``-th token (0 = the first, sampled from the
    prefill's logits). It depends only on ``(seed, rid, step)``, so a
    request's stream is the same whatever the scheduling (continuous or
    wave, any slot, any co-residents), as the JAX package's per-request
    ``fold_in(id)`` key chains are."""

    def __init__(self, seed: int, vocab: int, device):
        self.seed, self.vocab, self.device = seed, vocab, torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def __call__(self, rid: int, step: int) -> torch.Tensor:
        mixed = np.random.SeedSequence(
            [self.seed % 2**64, rid % 2**64, step]).generate_state(1, np.uint64)[0]
        self._gen.manual_seed(int(mixed))
        return gumbel(self.vocab, self._gen, self.device)


def advance_slots(tokens, live, n_emitted, budgets, eos_id: int):
    """Batched EOS/budget masking over the slot pool.

    tokens [B] just emitted; live [B] bool; n_emitted [B] tokens emitted so
    far (BEFORE this step); budgets [B]. Returns (new_live, new_n_emitted):
    dead slots are unchanged; a live slot dies when it hits its budget or
    emits ``eos_id``. Operators only: numpy in -> numpy out."""
    n_new = n_emitted + live.astype(n_emitted.dtype)
    done = (n_new >= budgets) | (tokens == eos_id)
    return live & ~done, n_new
