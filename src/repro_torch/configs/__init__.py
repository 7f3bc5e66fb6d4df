"""Architecture registry of the port: ``get_config(arch, variant=...)``.

Variants, as in the JAX package:
  native -- the architecture as published;
  stlt   -- every attention block replaced by the learnable STLT (defined
            for the archs in ``STLT_APPLICABLE``).
A config whose mixer the port does not run (attention) raises
NotImplementedError.
"""
import dataclasses

from repro_torch.configs import smollm_360m, stlt_base, whisper_base
from repro_torch.configs.base import DTYPES, ModelConfig, TrainConfig

ARCHS = {"stlt-base": stlt_base.CONFIG, "smollm-360m": smollm_360m.CONFIG,
         "whisper-base": whisper_base.CONFIG}

# the ported archs whose attention the paper's STLT can replace
STLT_APPLICABLE = {"smollm-360m", "whisper-base"}

_PORTED_MIXERS = ("stlt", "stlt_relevance")


def get_config(arch: str, variant: str = "native") -> ModelConfig:
    """A ported architecture's config by its id (the JAX package's ids)."""
    if arch not in ARCHS:
        raise NotImplementedError(f"arch {arch!r} is not ported (ported: {sorted(ARCHS)})")
    cfg = ARCHS[arch]
    if variant == "stlt":
        if arch not in STLT_APPLICABLE:
            raise ValueError(f"STLT variant undefined for {arch}")
        cfg = dataclasses.replace(cfg, mixer="stlt")
    elif variant != "native":
        raise ValueError(f"unknown variant {variant!r}")
    if cfg.mixer not in _PORTED_MIXERS:
        raise NotImplementedError(
            f"{arch} ({variant}) uses the {cfg.mixer!r} mixer, which is not ported "
            "(variant='stlt' replaces it)")
    return cfg


__all__ = ["ARCHS", "DTYPES", "ModelConfig", "STLT_APPLICABLE", "TrainConfig",
           "get_config"]
