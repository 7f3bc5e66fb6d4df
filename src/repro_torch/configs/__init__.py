"""Architecture registry of the port: ``get_config(arch, variant=...)``, the
assigned shape set, and the cell enumeration with its per-cell skip rules.

Variants, as in the JAX package:
  native -- the architecture as published (softmax attention, rg-LRU,
            xLSTM, experts);
  stlt   -- every attention block replaced by the learnable STLT (defined
            for the archs in ``STLT_APPLICABLE``; recurrentgemma keeps its
            rg-LRU blocks and replaces only its local-attention third; the
            MoE archs keep their experts; undefined for the attention-free
            xlstm-350m).
The arch ids, their order and the refusals are the JAX package's, so
``all_cells()`` names the same cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import (arctic_480b, chatglm3_6b, granite_20b, internvl2_76b,
                                 qwen2_1_5b, qwen3_moe_235b_a22b, recurrentgemma_9b,
                                 smollm_360m, stlt_base, whisper_base, xlstm_350m)
from repro_torch.configs.base import DTYPES, SHAPES, ModelConfig, ShapeConfig, TrainConfig

# every arch of the JAX package, in its order
ARCHS = {"qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG, "arctic-480b": arctic_480b.CONFIG,
         "chatglm3-6b": chatglm3_6b.CONFIG, "qwen2-1.5b": qwen2_1_5b.CONFIG,
         "granite-20b": granite_20b.CONFIG, "smollm-360m": smollm_360m.CONFIG,
         "xlstm-350m": xlstm_350m.CONFIG, "whisper-base": whisper_base.CONFIG,
         "internvl2-76b": internvl2_76b.CONFIG,
         "recurrentgemma-9b": recurrentgemma_9b.CONFIG, "stlt-base": stlt_base.CONFIG}
ARCH_IDS = tuple(ARCHS)

# archs whose mixer the paper's STLT can replace
STLT_APPLICABLE = {
    "qwen3-moe-235b-a22b", "arctic-480b", "chatglm3-6b", "qwen2-1.5b",
    "granite-20b", "smollm-360m", "internvl2-76b", "whisper-base",
    "recurrentgemma-9b",  # local-attention layers only
}

# archs that are intrinsically sub-quadratic in their native form
NATIVE_SUBQUADRATIC = {"xlstm-350m", "recurrentgemma-9b"}


def list_archs():
    return [a for a in ARCH_IDS if a != "stlt-base"]


def get_config(arch: str, variant: str = "native") -> ModelConfig:
    """An architecture's config by its id (the JAX package's ids)."""
    cfg = ARCHS[arch]
    if variant == "native":
        return cfg
    if variant != "stlt":
        raise ValueError(f"unknown variant {variant!r}")
    if arch not in STLT_APPLICABLE:
        raise ValueError(
            f"STLT variant undefined for {arch} (attention-free arch; "
            "see DESIGN.md section Arch-applicability)"
        )
    if cfg.layer_types:  # hybrid: replace only the attention layers
        return dataclasses.replace(cfg, mixer="stlt", layer_types=tuple(
            "stlt" if t in ("attn", "local_attn") else t for t in cfg.layer_types))
    return dataclasses.replace(cfg, mixer="stlt")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeConfig
    variant: str           # which variant the canonical roofline table uses
    skip: Optional[str] = None  # reason, if this cell is skipped

    @property
    def key(self) -> str:
        return f"{self.arch}__{self.shape.name}__{self.variant}"


def cells_for(arch: str) -> list:
    """The four assigned shapes for one arch id, with the JAX package's
    skip rules.

    long_500k policy: runs with the paper's STLT variant for attention-based
    archs (that's the point of the paper), natively for sub-quadratic archs;
    the only skip is whisper (bounded enc-dec audio context).
    """
    cells = []
    for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape = SHAPES[sname]
        variant, skip = "native", None
        if sname == "long_500k":
            if arch == "whisper-base":
                skip = ("enc-dec audio model: decoder context is bounded by the "
                        "task (<=448 tokens vs 30s audio); 512k-token decode is "
                        "undefined for this arch (DESIGN.md skip rule)")
            elif arch in NATIVE_SUBQUADRATIC:
                variant = "native"
            elif arch in STLT_APPLICABLE:
                variant = "stlt"   # full attention at 512k is the pathology the paper removes
            else:
                skip = "pure full-attention arch at 512k context"
        cells.append(Cell(arch=arch, shape=shape, variant=variant, skip=skip))
    return cells


def all_cells() -> list:
    return [c for a in list_archs() for c in cells_for(a)]


__all__ = ["ARCHS", "ARCH_IDS", "Cell", "DTYPES", "ModelConfig", "NATIVE_SUBQUADRATIC",
           "SHAPES", "STLT_APPLICABLE", "ShapeConfig", "TrainConfig", "all_cells",
           "cells_for", "get_config", "list_archs"]
