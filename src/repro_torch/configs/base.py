"""Model and training configuration for the PyTorch port: the
``ModelConfig`` fields the STLT, attention, rg-LRU, xLSTM and MoE paths
read, ``stlt_config()``, ``moe_config()``, the assigned shape set (``ShapeConfig``, ``SHAPES``), the
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
from repro_torch.models.moe import MoEConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dt(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # lm | encdec | xlstm | hybrid
    vocab: int
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    mixer: str = "attention"         # attention | stlt | stlt_relevance
    layer_types: Tuple[str, ...] = ()
    local_window: int = 0            # sliding window for "local_attn" layers
    act: str = "swiglu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_fraction: float = 1.0       # 0.0 disables RoPE; 0.5 rotates half
    rope_theta: float = 10000.0
    input_mode: str = "tokens"       # tokens | embeddings | both (vlm/audio stubs)
    tie_embeddings: bool = True
    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False
    dense_ff: int = 0
    moe_dispatch: str = "gather"     # gather | shard_map (gather without a mesh)
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
    # --- enc-dec (whisper) ------------------------------------------------------
    num_decoder_layers: int = 0
    # --- xlstm ------------------------------------------------------------------
    slstm_every: int = 8             # every k-th layer is sLSTM (rest mLSTM)
    # --- execution ------------------------------------------------------------
    scan_layers: bool = True         # JAX param layout only (see convert.py)
    remat: bool = True               # recompute each block in backward
    remat_policy: str = "full"       # full | dots (save un-batched products)
    opt_moment_dtype: str = "float32"  # AdamW's moments (bfloat16 halves them)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    blockwise_threshold: int = 8192  # attention: online softmax for N >= this
    # sharding hints (distributed/sharding.py)
    fsdp: bool = False               # shard params over the data axis (ZeRO-3)
    dp_only: bool = False            # small arch: replicate params, DP over all axes
    optimizer: str = "adamw"         # adamw | adafactor

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _dt(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return _dt(self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def block_types(self) -> Tuple[str, ...]:
        """Resolve the per-layer block list."""
        if self.layer_types:
            assert len(self.layer_types) == self.num_layers, self.name
            return self.layer_types
        if self.family == "xlstm":
            return tuple("slstm" if (i + 1) % self.slstm_every == 0 else "mlstm"
                         for i in range(self.num_layers))
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

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model,
            d_ff=self.d_ff,
            num_experts=self.num_experts,
            top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            dense_residual=self.dense_residual,
            dense_ff=self.dense_ff,
            act=self.act,
            param_dtype=self.p_dtype,
            dispatch=self.moe_dispatch,
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
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            dense_ff=64 if self.dense_residual else 0,
            stlt_nodes=8,
            stlt_chunk=16,
            num_decoder_layers=min(self.num_decoder_layers, 2),
            local_window=min(self.local_window, 8) if self.local_window else 0,
            slstm_every=min(self.slstm_every, 2),
            layer_types=(),
            scan_layers=False,
            remat=False,
            dtype="float32",
            blockwise_threshold=64,
            fsdp=False,
        )
        if self.layer_types:
            # keep the heterogeneous pattern at the reduced depth
            small["layer_types"] = tuple(self.layer_types[:small["num_layers"]])
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The assigned LM-transformer shape set (applies to every arch; per-arch skip
# rules live in configs/__init__.py::cells_for).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and mask-temperature settings of the trainer
    (``launch/train.py``), with the JAX package's field names and defaults.
    Its ``microbatch``, ``label_smoothing`` and ``grad_compression`` fields
    are left out: nothing in the JAX package reads them."""
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
