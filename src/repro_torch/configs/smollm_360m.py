"""SmolLM-360M [hf:HuggingFaceTB/SmolLM family]. 32L d=960 15H (GQA kv=5)
d_ff=2560 vocab=49152; llama-arch small.

The JAX package's config field by field, less ``dp_only`` (a sharding hint;
the port runs on one device). ``get_config("smollm-360m", "stlt")`` swaps
every attention block for the STLT."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="lm",
    vocab=49152,
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    dtype="bfloat16",
)
