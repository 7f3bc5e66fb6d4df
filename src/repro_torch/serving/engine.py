"""``ServeEngine.generate``: prefill a batch of prompts, then decode.

The prefill runs K1 once per layer (``transformer.prefill``); each decode
step is plain torch (``transformer.decode_step``), as in the JAX package.
Continuous ``serve``, the prefix cache, speculative decoding and SLO
degradation are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.sampler import sample_token
from repro_torch.utils import default_generator, resolve_device, tree_map


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, max_len: int = 4096,
                 temperature: float = 0.0, top_k: int = 0,
                 serve_nodes: Optional[int] = None, device=None):
        """``params`` from ``transformer.init_lm`` or
        ``convert.from_jax_params``; they are moved to ``device`` (CUDA
        unless the caller names another). ``serve_nodes`` caps every
        decode step's STLT node budget (None -> full S)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        S = cfg.stlt_nodes
        if serve_nodes is not None and not 1 <= serve_nodes <= S:
            raise ValueError(f"serve_nodes must be in [1, {S}] (got {serve_nodes})")
        self.serve_nodes = serve_nodes
        self.params = tree_map(lambda t: t.to(self.device), params)

    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 serve_nodes: Optional[int] = None) -> np.ndarray:
        """prompts [B, L] -> generated tokens [B, max_new_tokens] (numpy).

        Sampling (temperature > 0) draws from ``generator`` (seed 0 when
        None). ``serve_nodes`` caps decode steps' node budget for this call;
        the prefill always runs at full S."""
        level = serve_nodes if serve_nodes is not None else self.serve_nodes
        S = self.cfg.stlt_nodes
        if level is not None and not 1 <= level <= S:
            raise ValueError(f"serve_nodes must be in [1, {S}] (got {level})")
        if generator is None:
            generator = default_generator(self.device)
        tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
        caps = torch.full((tokens.shape[0],), level if level is not None else S,
                          dtype=torch.int32, device=self.device)
        logits, state = T.prefill(self.params, self.cfg, tokens, self.max_len)
        tok = sample_token(logits, generator, self.temperature, self.top_k)
        outs = [tok]
        for _ in range(max_new_tokens - 1):
            logits, state = T.decode_step(self.params, self.cfg, tok, state,
                                          node_cap=caps)
            tok = sample_token(logits, generator, self.temperature, self.top_k)
            outs.append(tok)
        return torch.stack(outs, dim=1).cpu().numpy()

