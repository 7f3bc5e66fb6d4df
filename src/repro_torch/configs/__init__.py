from repro_torch.configs.base import DTYPES, ModelConfig

__all__ = ["DTYPES", "ModelConfig"]
