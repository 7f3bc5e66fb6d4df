from repro_torch.configs import stlt_base
from repro_torch.configs.base import DTYPES, ModelConfig, TrainConfig

ARCHS = {"stlt-base": stlt_base.CONFIG}


def get_config(arch: str) -> ModelConfig:
    """A ported architecture's config by its id (the JAX package's ids)."""
    if arch not in ARCHS:
        raise NotImplementedError(f"arch {arch!r} is not ported (ported: {sorted(ARCHS)})")
    return ARCHS[arch]


__all__ = ["ARCHS", "DTYPES", "ModelConfig", "TrainConfig", "get_config"]
