"""Model and training configuration for the PyTorch port: the
``ModelConfig`` fields the STLT paths read, ``stlt_config()``, the
``TrainConfig`` of the trainer, and the dtype-string map.

This is the port's own copy of ``repro/configs/base.py`` (the port imports
nothing of the JAX package). Field names and defaults match the JAX
``ModelConfig`` so a config can be carried across field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.stlt import STLTConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dt(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # lm (the only family ported so far)
    vocab: int
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    mixer: str = "attention"         # attention | stlt | stlt_relevance
    layer_types: Tuple[str, ...] = ()
    act: str = "swiglu"
    norm: str = "rmsnorm"
    input_mode: str = "tokens"
    tie_embeddings: bool = True
    # --- STLT (the paper) ---------------------------------------------------
    stlt_nodes: int = 32
    stlt_window: str = "exponential"
    stlt_mode: str = "factorized"
    stlt_adaptive: bool = False
    stlt_gate: bool = False
    stlt_engine: str = "chunked"
    stlt_chunk: int = 128
    stlt_init_T: float = 32.0
    stlt_learnable_sigma: bool = True     # Table-4 ablation switches
    stlt_learnable_omega: bool = True
    stlt_learnable_T: bool = True
    stlt_zero_omega: bool = False
    stlt_mask_reg: float = 1e-3
    stlt_hard_eval: bool = False
    # --- execution ------------------------------------------------------------
    scan_layers: bool = True         # JAX param layout only (see convert.py)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"         # adamw (adafactor is not ported)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _dt(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return _dt(self.param_dtype)

    def block_types(self) -> Tuple[str, ...]:
        """Resolve the per-layer block list."""
        if self.layer_types:
            assert len(self.layer_types) == self.num_layers, self.name
            return self.layer_types
        base = {"attention": "attn", "stlt": "stlt",
                "stlt_relevance": "stlt_rel"}[self.mixer]
        return (base,) * self.num_layers

    def stlt_config(self, bidirectional: bool = False) -> STLTConfig:
        return STLTConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_nodes=self.stlt_nodes,
            mode="relevance" if self.mixer == "stlt_relevance" else self.stlt_mode,
            bidirectional=bidirectional,
            window=self.stlt_window,
            chunk=self.stlt_chunk,
            engine=self.stlt_engine,
            gate=self.stlt_gate,
            init_T=self.stlt_init_T,
            learnable_sigma=self.stlt_learnable_sigma,
            learnable_omega=self.stlt_learnable_omega,
            learnable_T=self.stlt_learnable_T,
            zero_omega=self.stlt_zero_omega,
            adaptive=AdaptiveConfig(enabled=self.stlt_adaptive,
                                    lambda_mask=self.stlt_mask_reg,
                                    hard_eval=self.stlt_hard_eval),
            param_dtype=self.p_dtype,
        )

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same block structure, tiny sizes (the same
        sizes as the JAX ``ModelConfig.reduced``)."""
        small = dict(
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            head_dim=0,
            vocab=256,
            stlt_nodes=8,
            stlt_chunk=16,
            layer_types=(),
            scan_layers=False,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and mask-temperature settings of the trainer
    (``launch/train.py``), with the JAX package's field names and defaults
    (its gradient accumulation, label smoothing and gradient compression are
    not ported)."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.98
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | linear | constant
    seed: int = 0
    adaptive_tau_start: float = 1.0   # paper: anneal 1.0 -> 0.1 over 40%
    adaptive_tau_end: float = 0.1
