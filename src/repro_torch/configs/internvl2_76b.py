"""InternVL2-76B [arXiv:2404.16821] — transformer BACKBONE only (InternLM2-
76B side); the InternViT frontend is a STUB (input_specs provides patch
embeddings). 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

The JAX package's config field by field."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="lm",
    vocab=128256,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    act="swiglu",
    norm="rmsnorm",
    input_mode="both",         # train on stub patch+text embeddings, decode tokens
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
    dtype="bfloat16",
)
