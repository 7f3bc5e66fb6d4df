"""Pipeline parallelism (GPipe-style microbatching over a mesh axis), the
port of the JAX package's ``distributed/pipeline.py``.

The JAX package's skewed loop runs M + D - 1 ticks under ``shard_map``:
stage 0 takes microbatch t, the last stage writes microbatch t - (D - 1),
and activations hop one stage right with ``ppermute``; the outputs are then
sent from the last stage to every rank. Here each rank is one stage and
holds only its own stage's params (the torch form of JAX's leading pipe
dim); the hops are ``comm.exchange`` (``dist.batch_isend_irecv``).

The backward is JAX's autodiff through the loop, the reverse pipeline: an
autograd Function whose forward runs the skewed schedule, keeping each
tick's stage graph, and whose backward runs it in reverse, each tick the
stage's VJP and then a hop of the input grads one stage left. A hop per
autograd node cannot do it in torch: a rank's own loss graph does not reach
its stage (its outputs reach the loss through the next rank's), so the
backward is driven by the schedule, the same on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import comm
from repro_torch.utils import tree_leaves, tree_unflatten


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x_micro, *leaves):
        stage_fn, params, group, D, idx = run
        M = x_micro.shape[0]
        ticks = M + D - 1
        params = tree_unflatten(params, [p.detach().requires_grad_(p.requires_grad)
                                         for p in leaves])
        buf = torch.zeros_like(x_micro[0])
        saved, outs = [], [None] * M
        for t in range(ticks):
            x_in = (x_micro[min(t, M - 1)] if idx == 0 else buf).detach().requires_grad_(True)
            active = 0 <= t - idx < M
            if active:
                with torch.enable_grad():
                    y = stage_fn(params, x_in)
                saved.append((t, x_in, y))
                if idx == D - 1:
                    outs[t - (D - 1)] = y.detach()
            out = y.detach() if active else torch.zeros_like(buf)
            # hop right: stage idx sends to idx + 1 and receives from idx - 1
            got = comm.exchange(out if idx < D - 1 else None, idx + 1,
                                buf if idx > 0 else None, idx - 1, group)
            buf = got if got is not None else buf
        last = torch.stack(outs) if idx == D - 1 else torch.zeros_like(x_micro)
        ctx.run, ctx.saved, ctx.params, ctx.M = run, saved, params, M
        return comm.broadcast(last, D - 1, group)

    @staticmethod
    def backward(ctx, g_out):
        stage_fn, _, group, D, idx = ctx.run
        M, params = ctx.M, ctx.params
        leaves = tree_leaves(params)
        need = [p.requires_grad for p in leaves]
        g_params = [torch.zeros_like(p) for p in leaves]
        g_x = torch.zeros_like(g_out)
        by_tick = {t: (x_in, y) for t, x_in, y in ctx.saved}
        ticks = M + D - 1
        # the last stage holds the grads of the outputs it wrote; every other
        # stage gets its y's grad from the next stage, one hop per tick
        g_y = g_out[ticks - 1 - (D - 1)] if idx == D - 1 else torch.zeros_like(g_out[0])
        for t in reversed(range(ticks)):
            g_in = torch.zeros_like(g_out[0])
            if t in by_tick:
                x_in, y = by_tick[t]
                wrt = [x_in] + [p for p, n in zip(leaves, need) if n]
                grads = torch.autograd.grad(y, wrt, g_y, allow_unused=True,
                                            materialize_grads=True)
                g_in = grads[0]
                it = iter(grads[1:])
                g_params = [gp + next(it) if n else gp for gp, n in zip(g_params, need)]
                if idx == 0:
                    g_x[min(t, M - 1)] += g_in
            # hop left: send the input grad to idx - 1, receive from idx + 1
            got = comm.exchange(g_in if idx > 0 else None, idx - 1,
                                g_y if idx < D - 1 else None, idx + 1, group)
            if idx < D - 1:
                g_y = got
            elif t - 1 - (D - 1) >= 0:
                g_y = g_out[t - 1 - (D - 1)]
            else:
                g_y = torch.zeros_like(g_out[0])
        return (None, g_x, *[g if n else None for g, n in zip(g_params, need)])


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run M microbatches x_micro [M, mb, ...] (the same on every rank)
    through the D stages of ``axis``: ``stage_fn(stage_params, x)`` is this
    rank's stage. Returns [M, mb, ...] on every rank. Differentiable in the
    stage params and x_micro: every rank computes the same loss of the
    outputs and calls backward; the grads flow back through the hops to
    each stage's params, and x_micro's grad arrives on stage 0."""
    group, D, idx = mesh.group(axis), mesh.shape[axis], mesh.coord(axis)
    leaves = tree_leaves(stage_params)
    return _GPipe.apply((stage_fn, stage_params, group, D, idx), x_micro, *leaves)
