"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]. 38L d=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000; RG-LRU recurrent blocks + local attention (window
2048) in a 2:1 pattern (layers i with i % 3 == 2 are local attention).

The JAX package's config field by field.
``get_config("recurrentgemma-9b", "stlt")`` swaps only the local-attention
third for the STLT; the rg-LRU blocks stay."""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(
    "local_attn" if i % 3 == 2 else "rglru" for i in range(38)
)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    vocab=256000,
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    layer_types=_PATTERN,
    local_window=2048,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    fsdp=True,
    dtype="bfloat16",
)
