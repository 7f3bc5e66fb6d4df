"""Single-GPU trainer of the port.

One step: anneal the mask temperature, draw the adaptive node masks'
noise, ``lm_loss`` forward, backward (the factorized scan's VJP: K1 causal
in the forward, K1 anti-causal for dx, analytic pole/mixer grads), clip by
global norm, AdamW at ``sched(step)``, as the JAX package's
``launch/train.py::make_step``. No checkpointing and no remat: activations
of ``stlt-base`` at 4 x 1000 tokens fit the card as they are.

  python -m repro_torch.launch.train --arch stlt-base --steps 5 --batch 4 --seq 1000
  python -m repro_torch.launch.train --arch stlt-base --reduced --device cpu \
      --steps 5 --batch 2 --seq 64

(with ``src`` on ``PYTHONPATH``). Runs on CUDA unless ``--device`` names
another device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs as configs_lib
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.adaptive import anneal_tau
from repro_torch.data import ByteCorpus, lm_batch_stream
from repro_torch.models import transformer as T
from repro_torch.optim import (apply_updates, clip_by_global_norm, default_wd_mask,
                               make_optimizer, make_schedule)
from repro_torch.utils import resolve_device, tree_leaves, tree_map, tree_unflatten


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict, *, tau: float,
                   draws: Optional[Sequence[torch.Tensor]] = None):
    """(loss, metrics, grads) of ``lm_loss`` with stochastic masks; ``grads``
    has params' structure. A leaf the loss does not reach gets a zero grad,
    as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss, metrics = T.lm_loss(p, cfg, batch, deterministic=False, tau=tau,
                              draws=draws)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def step_draws(seed: int, step: int, cfg: ModelConfig, batch_size: int,
               device) -> list:
    """The adaptive masks' uniform draws of one step, [B, H, S] per layer
    in (1e-6, 1 - 1e-6): a pure function of (seed, step), as the JAX package
    folds the step into its key."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(mixed)
    shape = (batch_size, cfg.num_heads, cfg.stlt_nodes)
    return [torch.rand(shape, generator=gen, device=device) * (1 - 2e-6) + 1e-6
            for _ in cfg.block_types()]


def make_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(opt, step_fn) with step_fn(params, opt_state, batch, step, draws=None)
    -> (params, opt_state, metrics). ``draws`` (per layer [B, H, S] uniform
    draws) replaces the step's own (``step_draws``), so a test can feed in
    the JAX package's."""
    if cfg.act_dtype != cfg.p_dtype:
        raise NotImplementedError("mixed-precision training is not ported")
    opt = make_optimizer(cfg.optimizer, b1=tcfg.beta1, b2=tcfg.beta2,
                         weight_decay=tcfg.weight_decay)
    sched = make_schedule(tcfg.schedule, tcfg.learning_rate, tcfg.warmup_steps,
                          tcfg.total_steps)

    def step_fn(params, opt_state, batch, step: int, draws=None):
        tau = anneal_tau(step, tcfg.total_steps, tcfg.adaptive_tau_start,
                         tcfg.adaptive_tau_end)
        if draws is None:
            draws = step_draws(tcfg.seed, step, cfg, batch["inputs"].shape[0],
                               batch["inputs"].device)
        _, metrics, grads = loss_and_grads(params, cfg, batch, tau=tau, draws=draws)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params, sched(step),
                                            default_wd_mask(params, cfg))
            params = apply_updates(params, updates)
        return params, opt_state, {**metrics, "grad_norm": gnorm}

    return opt, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stlt-base", help="ported arch id")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default="bytes", choices=["bytes", "synthetic"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs_lib.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 10))
    corpus = ByteCorpus() if args.data == "bytes" else None

    def batch_fn(step: int):
        if corpus is not None and cfg.vocab >= 256:
            raw = corpus.batch(step, args.batch, args.seq)
        else:
            raw = lm_batch_stream(0, step, args.batch, args.seq, cfg.vocab)
        return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}

    opt, step_fn = make_step(cfg, tcfg)
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(tcfg.seed),
                       device=device)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {device}")

    t_last, tok_per_step = time.time(), args.batch * args.seq
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, batch_fn(step), step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = tree_map(float, metrics)
            dt = time.time() - t_last
            t_last = time.time()
            print(f"[train] step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"gnorm {m['grad_norm']:.2f} s_eff {m['s_eff']:.1f} "
                  f"({tok_per_step * args.log_every / max(dt, 1e-9):.0f} tok/s)")
    print("[train] done")
    return params, opt_state


if __name__ == "__main__":
    main()
