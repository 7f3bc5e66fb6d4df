"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base; assigned
config]. 35L d_model=7168 56H (GQA kv=8) expert-d_ff=4864 vocab=32000, MoE
128 experts top-2 plus a parallel dense residual FFN branch, untied head,
adafactor.

The JAX package's config field by field."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="lm",
    vocab=32000,
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    num_experts=128,
    top_k=2,
    dense_residual=True,
    dense_ff=4864,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
    dtype="bfloat16",
)
