"""ChatGLM3-6B [arXiv:2406.12793]. 28L d=4096 32H (GQA kv=2) d_ff=13696
vocab=65024; 2d-RoPE = rotary on half the head dims (rope_fraction=0.5).

The JAX package's config field by field, less its sharding hint ``fsdp``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="lm",
    vocab=65024,
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    rope_fraction=0.5,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    dtype="bfloat16",
)
