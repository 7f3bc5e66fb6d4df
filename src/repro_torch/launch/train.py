"""Single-GPU trainer of the port, the counterpart of the JAX package's
``launch/train.py``.

One step: anneal the mask temperature, draw the adaptive node masks'
noise (an adaptive LM's), cast the matrices to the activation dtype
(``cast_params_for_compute``: fp32 masters, bf16 compute for a bf16
config), the family's loss forward (``lm_loss``, or ``encdec_loss`` for the
enc-dec family) with each block recomputed in backward (``cfg.remat``),
backward (the factorized
scan's VJP: K1 causal in the forward and again in the recompute, K1
anti-causal for dx, analytic pole/mixer grads; attention blocks through
autograd of plain torch), clip by global norm, AdamW
or adafactor at ``sched(step)``. With ``--ckpt-dir`` the run saves every
``--save-every`` steps and at the end, and resumes from the latest
checkpoint there. Without ``--arch`` it trains the ``paper-small`` preset.
The CLI refuses enc-dec configs, as the JAX package's does; ``make_step``
takes them.

  python -m repro_torch.launch.train --preset paper-small --steps 200 --ckpt-dir ckpt
  python -m repro_torch.launch.train --arch smollm-360m --variant stlt --steps 5 \
      --batch 8 --seq 1024
  python -m repro_torch.launch.train --arch smollm-360m --reduced --device cpu \
      --steps 5 --batch 2 --seq 64
  python -m repro_torch.launch.train --arch stlt-base --reduced --device cpu \
      --steps 5 --batch 2 --seq 64
  python -m repro_torch.launch.train --arch recurrentgemma-9b --reduced --device cpu \
      --steps 5 --batch 2 --seq 64
  python -m repro_torch.launch.train --arch xlstm-350m --reduced --device cpu \
      --steps 5 --batch 2 --seq 64
  python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b --variant stlt --reduced \
      --device cpu --steps 5 --batch 2 --seq 64

(with ``src`` on ``PYTHONPATH``). Runs on CUDA unless ``--device`` names
another device. The optimizer is the config's (``cfg.optimizer``: adafactor
for the MoE archs); a MoE model's log lines add its ``aux_loss`` and
``router_z``, which its loss includes.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs as configs_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import ByteCorpus, lm_batch_stream
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim import apply_updates, clip_by_global_norm, default_wd_mask
from repro_torch.utils import (cast_params_for_compute, resolve_device, tree_leaves,
                               tree_map, tree_unflatten)


def paper_small(vocab: int = 256) -> ModelConfig:
    """A small slice of the paper's base model, the JAX CLI's default."""
    return ModelConfig(
        name="stlt-paper-small", family="lm", vocab=vocab, num_layers=4,
        d_model=256, num_heads=8, num_kv_heads=8, d_ff=1024, mixer="stlt",
        stlt_nodes=32, stlt_adaptive=True, act="gelu", norm="layernorm",
        dtype="float32", scan_layers=False, remat=False,
    )


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict, *, tau: float,
                   draws: Optional[Sequence[torch.Tensor]] = None):
    """(loss, metrics, grads) of the family's loss (``steps.loss_fn``: the
    LM's ``lm_loss`` with stochastic masks, or ``encdec_loss``, which takes
    no draws); ``grads`` has params' structure and dtype. The matrices
    enter the loss cast to ``cfg.act_dtype`` (``cast_params_for_compute``,
    as the JAX trainer casts them), so a bf16 config computes in bf16 and
    its fp32 masters get fp32 grads. A leaf the loss does not reach gets a zero grad, as ``jax.grad``
    gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    p = cast_params_for_compute(tree_unflatten(params, leaves), cfg.act_dtype)
    loss, metrics = steps.loss_fn(cfg)(p, cfg, batch, deterministic=False, tau=tau,
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
    draws) replaces the step's own (``step_draws``, made only for an
    adaptive LM), so a test can feed in the JAX package's. An enc-dec batch
    is {"enc_inputs", "dec_inputs", "labels"}. The optimizer is
    ``steps.train_optimizer``'s, the JAX package's choice."""
    opt = steps.train_optimizer(cfg, tcfg)
    schedules = steps.train_schedules(tcfg)

    def step_fn(params, opt_state, batch, step: int, draws=None):
        tau, lr = schedules(step)
        if draws is None and cfg.family == "lm" and cfg.stlt_adaptive:
            draws = step_draws(tcfg.seed, step, cfg, batch["inputs"].shape[0],
                               batch["inputs"].device)
        _, metrics, grads = loss_and_grads(params, cfg, batch, tau=tau, draws=draws)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params, lr,
                                            default_wd_mask(params, cfg))
            params = apply_updates(params, updates)
        return params, opt_state, {**metrics, "grad_norm": gnorm}

    return opt, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="ported arch id (default: the paper-small preset)")
    ap.add_argument("--preset", default=None, choices=[None, "paper-small"])
    ap.add_argument("--variant", default="native")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default="bytes", choices=["bytes", "synthetic"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.preset == "paper-small" or args.arch is None:
        cfg = paper_small()
    else:
        cfg = configs_lib.get_config(args.arch, args.variant)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise SystemExit("use benchmarks/translation.py for enc-dec training")
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

    def init_state():
        params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(tcfg.seed),
                           device=device)
        return {"params": params, "opt": opt.init(params)}

    start = -1
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        state, start = mgr.restore_or_init(init_state)
    else:
        mgr, state = None, init_state()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {device}, "
          f"resume from step {start}")

    t_last, tok_per_step = time.time(), args.batch * args.seq
    for step in range(start + 1, args.steps):
        params, opt_state, metrics = step_fn(state["params"], state["opt"],
                                             batch_fn(step), step)
        state = {"params": params, "opt": opt_state}
        if step % args.log_every == 0 or step == args.steps - 1:
            m = tree_map(float, metrics)
            dt = time.time() - t_last
            t_last = time.time()
            moe = (f"aux_loss {m['aux_loss']:.4f} router_z {m['router_z']:.4f} "
                   if cfg.is_moe else "")
            print(f"[train] step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"gnorm {m['grad_norm']:.2f} s_eff {m['s_eff']:.1f} {moe}"
                  f"({tok_per_step * args.log_every / max(dt, 1e-9):.0f} tok/s)")
        if mgr and step % args.save_every == 0 and step > 0:
            mgr.save(step, state)
    if mgr:
        mgr.save(args.steps - 1, state)
        mgr.wait()
    print("[train] done")
    return state


if __name__ == "__main__":
    main()
