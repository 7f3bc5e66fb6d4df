"""Granite-20B code model [arXiv:2405.04324]. 52L d=6144 48H (MQA kv=1)
d_ff=24576 vocab=49152; llama-style blocks.

The JAX package's config field by field, less its sharding hint ``fsdp``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="lm",
    vocab=49152,
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    dtype="bfloat16",
)
