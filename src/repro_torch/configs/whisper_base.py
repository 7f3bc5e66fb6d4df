"""Whisper-base [arXiv:2212.04356]. 6L enc + 6L dec, d=512 8H d_ff=2048
vocab=51865; enc-dec with conv frontend STUB (callers feed precomputed
frame embeddings [B, 1500, d] to the encoder).

The JAX package's config field by field, less ``cross_attention`` (read by no code: the
cross side is always present). The native form is a bidirectional
attention encoder, a causal attention decoder and softmax cross-attention;
``get_config("whisper-base", "stlt")`` gives the paper's hybrid: a
bilateral STLT encoder, a unilateral STLT decoder and the cross-STLT
between them."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    vocab=51865,
    num_layers=6,
    num_decoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    act="gelu",
    norm="layernorm",
    rope_fraction=0.0,
    input_mode="embeddings",   # conv frontend stub: frames arrive embedded
    tie_embeddings=False,
    dtype="bfloat16",
    dp_only=True,
)
