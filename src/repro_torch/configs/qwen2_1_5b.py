"""Qwen2-1.5B [arXiv:2407.10671]. 28L d=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; QKV bias; tied embeddings.

The JAX package's config field by field. ``get_config("qwen2-1.5b",
"stlt")`` swaps every attention block for the STLT."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="lm",
    vocab=151936,
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    dtype="bfloat16",
)
