"""The step functions of both model families on one device, the
counterpart of the JAX package's ``launch/steps.py``: where the model
family meets the train / prefill / decode step.

``init_fn``, ``loss_fn`` and ``serving_params`` pick the family's init,
loss and inference dtypes; ``prefill_fn`` and ``decode_fn`` its serving
steps (an LM's ``prefill``/``decode_step``; an enc-dec model's prefill is
the encode plus its decode state, ``init_encdec_decode_state``, and its
decode ``encdec_decode_step``). The train step is ``launch/train.make_step``.
``input_specs`` gives allocation-free stand-ins (tensors on the ``meta``
device) for every model input of an assigned (arch, shape) cell, with the
JAX package's shapes and dtypes. The JAX module's meshes and sharding specs
(``train_batch_specs``' specs, ``decode_state_specs``, ``lower_cell``) wait
for multi-device serving (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import configs as configs_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.utils import cast_params_for_compute

WHISPER_ENC_FRAMES = 1500  # fixed encoder context for whisper decode shapes


def init_fn(cfg: ModelConfig) -> Callable:
    """fn(generator=None, device=None) -> the family's random params."""
    if cfg.family == "encdec":
        return lambda generator=None, device=None: W.init_encdec(cfg, generator, device)
    return lambda generator=None, device=None: T.init_lm(cfg, generator, device)


def loss_fn(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        return W.encdec_loss
    return T.lm_loss


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """Params in inference dtype: the matrices of more than 65,536 elements
    in ``cfg.act_dtype``, the rest as they are."""
    return cast_params_for_compute(params, cfg.act_dtype)


def prefill_fn(cfg: ModelConfig, max_len: int) -> Callable:
    """fn(params, inputs) -> an enc-dec model's decode state (encode once;
    inputs [B, M, d] frames or [B, M] tokens), or an LM's (last logits,
    decode state)."""
    if cfg.family == "encdec":
        return lambda params, inputs: W.init_encdec_decode_state(
            params, cfg, inputs, inputs.shape[0], max_len)
    return lambda params, inputs: T.prefill(params, cfg, inputs, max_len=max_len)


def decode_fn(cfg: ModelConfig) -> Callable:
    """fn(params, token_t [B], state) -> (logits [B, V], new state)."""
    if cfg.family == "encdec":
        return lambda params, token_t, state: W.encdec_decode_step(params, cfg, token_t,
                                                                   state)
    return lambda params, token_t, state: T.decode_step(params, cfg, token_t, state)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_batch(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A train step's batch: frame or patch stubs [B, N, d] in the
    activation dtype for the enc-dec and for embedding inputs, tokens
    otherwise."""
    B, N = shape.global_batch, shape.seq_len
    labels = _meta((B, N), torch.int32)
    if cfg.family == "encdec":
        return {"enc_inputs": _meta((B, N, cfg.d_model), cfg.act_dtype),
                "dec_inputs": _meta((B, N), torch.int32), "labels": labels}
    if cfg.input_mode in ("embeddings", "both"):
        return {"inputs": _meta((B, N, cfg.d_model), cfg.act_dtype), "labels": labels}
    return {"inputs": _meta((B, N), torch.int32), "labels": labels}


def _prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    B, N = shape.global_batch, shape.seq_len
    if cfg.family == "encdec" or cfg.input_mode in ("embeddings", "both"):
        return _meta((B, N, cfg.d_model), cfg.act_dtype)
    return _meta((B, N), torch.int32)


def input_specs(arch: str, shape_name: str, variant: str = "native") -> dict:
    """Stand-ins for every model input of a cell: tensors on the ``meta``
    device (shape and dtype, no storage), as the JAX package's
    ``input_specs`` gives ``ShapeDtypeStruct``s."""
    cfg = configs_lib.get_config(arch, variant)
    shape = configs_lib.SHAPES[shape_name]
    if shape.kind == "train":
        return _train_batch(cfg, shape)
    if shape.kind == "prefill":
        return {"inputs": _prefill_inputs(cfg, shape)}
    return {"token_t": _meta((shape.global_batch,), torch.int32)}
