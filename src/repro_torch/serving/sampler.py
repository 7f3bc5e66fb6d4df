"""Token sampling: greedy, temperature and top-k.

Sampled tokens are drawn from a ``torch.Generator``; they cannot reproduce
``jax.random``'s draws, so only greedy decoding is held token for token to
the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
