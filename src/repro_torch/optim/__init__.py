"""Optimizers, schedules and gradient compression of the port."""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw, apply_updates, default_wd_mask
from repro_torch.optim.clip import clip_by_global_norm, clip_by_norm
from repro_torch.optim.compression import compress_gradients, init_error_state
from repro_torch.optim.schedules import make_schedule


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**{k: v for k, v in kw.items()
                            if k in ("learning_rate", "weight_decay")})
    raise ValueError(name)


__all__ = ["adafactor", "adamw", "apply_updates", "clip_by_global_norm", "clip_by_norm",
           "compress_gradients", "default_wd_mask", "init_error_state",
           "make_optimizer", "make_schedule"]
