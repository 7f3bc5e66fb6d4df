"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; assigned config].
94L d_model=4096 64H (GQA kv=4) expert-d_ff=1536 vocab=151936, MoE 128
experts top-8, untied head, adafactor.

The JAX package's config field by field.
``get_config("qwen3-moe-235b-a22b", "stlt")`` swaps every attention block
for the STLT; the experts stay."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="lm",
    vocab=151936,
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,                # per-expert hidden dim
    num_experts=128,
    top_k=8,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
    dtype="bfloat16",
)
