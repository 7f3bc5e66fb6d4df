"""Optimizers and schedules of the port: AdamW only (adafactor is not
ported)."""
from repro_torch.optim.adamw import adamw, apply_updates, default_wd_mask
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import make_schedule


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        raise NotImplementedError("adafactor is not ported yet")
    raise ValueError(name)


__all__ = ["adamw", "apply_updates", "clip_by_global_norm", "default_wd_mask",
           "make_optimizer", "make_schedule"]
