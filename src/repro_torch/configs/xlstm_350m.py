"""xLSTM-350M [arXiv:2405.04517]. 24L d=1024 4H d_ff=0 vocab=50304;
sLSTM + mLSTM blocks (every 8th layer sLSTM, rest mLSTM: the paper's
sparse-sLSTM ratio), no FFN.

The JAX package's config field by field. Attention-free: its STLT variant is
undefined (``get_config`` raises ValueError, as the JAX package's does)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    vocab=50304,
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    slstm_every=8,
    norm="rmsnorm",
    tie_embeddings=True,
    dtype="bfloat16",
    dp_only=True,
)
