"""Architecture registry of the port: ``get_config(arch, variant=...)``.

Variants, as in the JAX package:
  native -- the architecture as published (softmax attention);
  stlt   -- every attention block replaced by the learnable STLT (defined
            for the archs in ``STLT_APPLICABLE``).
An architecture that is not ported raises NotImplementedError.
"""
import dataclasses

from repro_torch.configs import qwen2_1_5b, smollm_360m, stlt_base, whisper_base
from repro_torch.configs.base import DTYPES, ModelConfig, TrainConfig

ARCHS = {"stlt-base": stlt_base.CONFIG, "smollm-360m": smollm_360m.CONFIG,
         "whisper-base": whisper_base.CONFIG, "qwen2-1.5b": qwen2_1_5b.CONFIG}

# the ported archs whose attention the paper's STLT can replace
STLT_APPLICABLE = {"smollm-360m", "whisper-base", "qwen2-1.5b"}


def get_config(arch: str, variant: str = "native") -> ModelConfig:
    """A ported architecture's config by its id (the JAX package's ids)."""
    if arch not in ARCHS:
        raise NotImplementedError(f"arch {arch!r} is not ported (ported: {sorted(ARCHS)})")
    cfg = ARCHS[arch]
    if variant == "native":
        return cfg
    if variant != "stlt":
        raise ValueError(f"unknown variant {variant!r}")
    if arch not in STLT_APPLICABLE:
        raise ValueError(f"STLT variant undefined for {arch}")
    if cfg.layer_types:  # hybrid: replace only the attention layers
        return dataclasses.replace(cfg, mixer="stlt", layer_types=tuple(
            "stlt" if t in ("attn", "local_attn") else t for t in cfg.layer_types))
    return dataclasses.replace(cfg, mixer="stlt")


__all__ = ["ARCHS", "DTYPES", "ModelConfig", "STLT_APPLICABLE", "TrainConfig",
           "get_config"]
