"""The paper's own model (§4): transformer-base backbone, 6 layers, 8 heads,
hidden 512, every self-attention block replaced by the learnable STLT
operator with S_max = 64 adaptive nodes and initial window T = 32*Delta."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stlt-base",
    family="lm",
    vocab=32000,
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    mixer="stlt",
    stlt_nodes=64,
    stlt_adaptive=True,
    stlt_init_T=32.0,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    dtype="float32",
)
