#!/usr/bin/env python3
"""Phases DT, DS, DA and DM: the port's multi-device training and serving
layers at full width.

    python3 tools/phase_dt.py                            # 4 ranks, NCCL, one card each
    python3 tools/phase_dt.py --backend gloo --cards 1   # 4 ranks sharing one card

``chip_smoke.py`` runs the second form (``launch``): it needs one card, and
NCCL refuses two ranks on one device, so its ranks share the card over a
gloo group (every product and every K1 launch runs on the
card; only the exchange goes through the host). The first form runs the same
code over NVLink on four cards. Each rank is a process of this script
(``--rank``); they meet through a file store under the gitignored ``build/``
and write their numbers there as JSON. Four checks:

* DT1, the sharded step: stlt-base (6 layers, d_model 512, 8 heads, S = 64,
  adaptive, fp32) on a 2 x 2 (``data``, ``model``) mesh at 4 x 1000 tokens,
  3 AdamW steps (``launch.steps.build_train_step``), against the
  single-device ``make_step`` on rank 0's card with the same draws: step 0's
  loss within 1e-4, the grad norm, ce, reg and s_eff of every step within
  1e-4 relative (the grads' scale, which AdamW's update does not show),
  every param within 1e-4 (1 + max |p|) after each step,
  18 K1 launches per rank per step (forward, remat recompute, dx; on 2 rows
  x 4 heads = 8 rows). Step ms by CUDA events per rank, the bytes each rank
  hands to each collective per step.
* DT2, the context-parallel STLT: 8 rows x 131,072 tokens over the 4 ranks
  (32,768 each; d = 64, S = 64), held to the serial K1 call over all 131,072
  tokens within K1's gate 2e-4 (1 + max |ref|); ms per rank and the bytes
  exchanged (2 x 8 x 64 x 64 x 4 = 262,144 per rank). Then its backward
  from a seeded cotangent: dx per rank and each pole and mixer grad (whole
  on every rank) against the serial training call's (K1 forward, K1
  anti-causal, the analytic grads; run once, on rank 0, which hands each
  rank its slices) within K1's gate, 2 K1 launches per rank (the stateful
  forward, the anti-causal dx pass) and the bytes ``DT2_BWD_BYTES``.
* DT3, the pipeline: stlt-base's 6 blocks as 2 stages of 3 on 2-rank
  ``pipe`` groups (the 4 ranks as 2 x 2 (``data``, ``pipe``)), 4 microbatches
  of 1 x 1000: outputs and every stage param's grad against the 6 blocks run
  in turn on the same card.
* DT4, the resilient loop: DT1's step under ``run_resilient_loop`` with a
  ``SimulatedHardwareFailure`` at step 2, restored from the step-1
  checkpoint; the final params bit for bit DT1's.

Phase DS, the sharded serving layer, runs in the same rank job:

* DS1, the sharded cells: stlt-base (DT1's params) on the 2 x 2 mesh,
  ``launch.steps.build_prefill_step`` at 4 x 1000 tokens, then 32 greedy
  steps of ``build_decode_step`` from its state, against the single-device
  ``prefill``/``decode_step`` on the rank's card: the logits of the rank's
  rows within 1e-3 (phases 4-5's gate), its rows and heads of ``h_re``/
  ``h_im`` within K1's gate of the single-device state's slice after the
  prefill and after the last step, the streams equal under the near-tie
  rule; 6 K1 launches per rank per prefill (2 rows x 4 heads = 8 rows a
  layer), 0 per decode step. Prefill and decode-step ms by CUDA events
  (beside the single-device functions' on the same card) and the bytes each
  rank hands to each collective (``comm.STATS``).
* DS2, the process form of ``ShardedServeEngine``: phase SH's requests
  and arrivals (``chip_smoke.serve_requests``) on ranks 0 and 1 as 2 hosts
  x 2 slots (a ``comm.sub_mesh`` of the job), each warming the system
  prompt into its own ``PrefixCache``; against the one-process engine of
  phase SH (both hosts on rank 0's card) on the same requests: every
  request's host and ticks equal, streams equal under the near-tie rule, K1
  = 6 x each rank's admission dispatches. TTFT, gaps, wall and the bytes
  exchanged a tick.

Phases DA (tensor parallelism beyond the STLT block: chatglm3-6b,
recurrentgemma-9b) and DM (expert parallelism: qwen3-moe-235b-a22b at 1
layer, its experts on ``model``; DM1 the 1 x 4 train, prefill and decode
cells of both forms, DM2 the native form's 2 x 2 prefill and decode cells,
whose capacity and slot positions span two data shards) run the same rank
job's last, at full width in fp32, against the single-device functions,
each reference alone on the card (``_in_turns``): DT1's train gates, DS1's
serving gates, K1 per rank, and for DM the drops summed over the ranks
equal to the single-device call's.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "dt"
WORLD = 4
DT1_B, DT1_N, DT1_STEPS = 4, 1000, 3
DT1_LOSS_TOL = 1e-4
DT1_PARAM_TOL = 1e-4          # x (1 + max |p|) per leaf
DT1_METRIC_RTOL = 1e-4
DT1_METRICS = ("grad_norm", "ce", "reg", "s_eff")
DT2_B, DT2_N, DT2_D, DT2_S = 8, 131072, 64, 64
K1_TOL = 2e-4                 # x (1 + max |ref|): K1's gate (chip_smoke.K1_TOL)
# what a rank hands to each collective in DT2's forward + backward: the end
# states' all-gather [1, 2, B, S, d] fp32, the reduce-scatter of their
# cotangent [4, 2, B, S, d], and the 4 pole and mixer grads' all-reduces [S]
DT2_BWD_BYTES = {"all_gather": 2 * DT2_B * DT2_S * DT2_D * 4,
                 "reduce_scatter": WORLD * 2 * DT2_B * DT2_S * DT2_D * 4,
                 "all_reduce": 4 * DT2_S * 4}
DT3_M, DT3_N = 4, 1000
DT3_OUT_TOL = 1e-4            # x (1 + max |ref|)
DT3_GRAD_TOL = 1e-3           # x max |ref grad| per leaf (chip_smoke.TRAIN_GRAD_TOL)
DT4_FAIL_AT = 2
DS1_B, DS1_N, DS1_NEW = 4, 1000, 32
DS_LOGIT_TOL = 1e-3           # fp32 logits (chip_smoke.LOGIT_TOL, phases 4-5)
# Phase DA: full-width attention and hybrid archs, fp32, DA_B x DA_N tokens
# a cell; a train cell takes the steps DA_TRAIN_STEPS from the init (lr is
# 0 at step 0, so step 1 moves the params: AdamW's first update is about
# lr x sign(grad), which a grad at rounding noise could flip), a serve cell
# DA_NEW greedy decode steps; DT1's and DS1's gates. The FSDP layout
# re-gathers every leaf over ``data`` on each call of a cell (940.9 MB per
# rank for DA1 on 2 x 2: 4.0 s a decode step through gloo on one card), so
# DA1's 2 x 2 serve cell takes DA_FSDP_NEW steps.
DA1_ARCH, DA1_LAYERS = "chatglm3-6b", 2
DA2_ARCH, DA2_LAYERS = "recurrentgemma-9b", 3       # one period: rg-LRU, rg-LRU, attn/STLT
DA_B, DA_N, DA_NEW, DA_FSDP_NEW, DA_TRAIN_STEPS = 4, 1024, 16, 1, (0, 1)
# DA2's train cell runs on 1 x 4 at 4 x 512. On 2 x 2 its FSDP layout moves
# 2.9 GB of all-gather and 5.6-5.9 GB of reduction per rank per step
# through gloo (24-42 s a step on one card: 69-104 s of the script's time
# limit), and at 4 x 1024 its four ranks held ~19.5 GB each, over the card;
# DA1's train cell keeps the FSDP x TP layout on 2 x 2.
DA2_TRAIN_MESH, DA2_TRAIN_N = (1, 4), 512
DA_PARAM_TOL = DT1_PARAM_TOL
DA_LOGIT_TOL = DS_LOGIT_TOL
# K1 launches per rank: the STLT layer of recurrentgemma-9b-stlt's period
# makes 3 a train step (forward, remat recompute, dx), 1 a prefill (the
# stateful call), none a decode step; the native forms make none.
DA_K1 = {"train": 3, "prefill": 1, "decode": 0}
# Phase DM: expert parallelism, qwen3-moe-235b-a22b at full width (d_model
# 4096, 64 heads, 4 KV heads, 128 experts of 1,536, top-8, vocab 151,936)
# cut to 1 of 94 layers, fp32, random weights from seed 0 (3.7B params,
# 14.9 GB). DM1 on 1 x 4 (EP 4: 32 experts a rank; ``data`` has size 1, so
# FSDP moves nothing), both forms: the train cell at M3's 2 x 1024 (2
# adafactor steps), the prefill cell at 4 x 1024 and DM_NEW decode-cell
# steps (a step routes its 4 tokens alone, far under capacity: more steps
# add time, not routing cases). DM2 the native form's 2 x 2 prefill and decode cells with
# ``fsdp=False`` (FSDP over gloo on one card would move ~2.4 GB of expert
# shards per rank per call): the global view's capacity and slot offsets
# across two data shards. DA's gates; the drops summed over the ranks equal
# the single-device call's, and DM2's prefill must drop; K1 per rank equals
# the single-device count (3 a train step, 1 a prefill, 0 a decode step in
# the STLT form, on 2 x 16 and 4 x 16 rows), 0 in the native form.
DM_ARCH, DM_LAYERS = "qwen3-moe-235b-a22b", 1
DM_TRAIN_B, DM_TRAIN_N, DM_NEW = 2, 1024, 4


def _timed(fn):
    """(fn(), its ms by CUDA events)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


_SEEN_PEAK = [0]   # the allocator's peak before the last reset by _grown


def _grown(fn, dev):
    """(fn(), its ms by CUDA events, how far the rank's allocated bytes rose
    above their level at the call's start): the allocator's peak is reset
    before the call (``_peak_gib`` keeps the peak before it)."""
    import torch

    torch.cuda.synchronize(dev)
    _SEEN_PEAK[0] = max(_SEEN_PEAK[0], torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out, ms = _timed(fn)
    return out, ms, torch.cuda.max_memory_allocated(dev) - base


def _peak_gib(dev) -> float:
    import torch

    return max(_SEEN_PEAK[0], torch.cuda.max_memory_allocated(dev)) / 2**30


def _reset_peak(dev):
    import torch

    _SEEN_PEAK[0] = 0
    torch.cuda.reset_peak_memory_stats(dev)


def _held(*trees) -> int:
    """The bytes of the distinct storages under ``trees`` (what a step is
    handed)."""
    import torch

    from repro_torch.utils import tree_leaves

    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tree_leaves(list(trees)) if isinstance(t, torch.Tensor)}.values())


def _batch(step, dev, vocab, B=DT1_B, N=DT1_N):
    import torch

    from repro_torch.data import lm_batch_stream

    return {k: torch.from_numpy(v).to(dev)
            for k, v in lm_batch_stream(0, step, B, N, vocab).items()}


def dt1(T, cfg, dev, rank, out):
    """The sharded step against the single-device one; returns what DT4
    needs (the program, the final params)."""
    import torch

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, train
    from repro_torch.utils import tree_flatten_with_paths

    tcfg = TrainConfig(total_steps=100, warmup_steps=2)
    mesh = mesh_lib.make_host_mesh(2, 2, device=dev)
    prog = steps.build_train_step(cfg, ShapeConfig("dt", DT1_N, DT1_B, "train"), mesh, tcfg)
    pspecs, _, bspec, _ = prog.in_shardings
    full = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = sh.local_slices(full, pspecs, mesh)
    state = prog.opt_init(params)
    ref = ref_state = ref_step = None
    if rank == 0:
        opt, ref_step = train.make_step(cfg, tcfg)
        ref, ref_state = full, opt.init(full)
    rows = []
    for step in range(DT1_STEPS):
        batch = _batch(step, dev, cfg.vocab)
        local = sh.local_slices(batch, bspec, mesh)
        given = _held(params, state, local)
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        (params, state, m), ms, grown = _grown(
            lambda: prog.fn(params, state, local, step), dev)
        row = {"step": step, "ms": ms, "k1": k1.stlt_scan_kernel.launches,
               "bytes": dict(comm.STATS), "calls": dict(comm.CALLS), "held": given,
               "grown": grown, "loss": float(m["loss"]),
               "metrics": {k: float(m[k]) for k in DT1_METRICS}}
        gathered = sh.gather_full(params, pspecs, mesh)
        if rank == 0:
            k1.stlt_scan_kernel.launches = 0
            (ref, ref_state, mr), row["ref_ms"] = _timed(
                lambda: ref_step(ref, ref_state, batch, step))
            row["ref_k1"] = k1.stlt_scan_kernel.launches
            row["ref_loss"] = float(mr["loss"])
            row["ref_metrics"] = {k: float(mr[k]) for k in DT1_METRICS}
            worst, over = 0.0, []
            want = dict(tree_flatten_with_paths(ref))
            for path, got in tree_flatten_with_paths(gathered):
                gap = float((got - want[path]).abs().max())
                tol = DT1_PARAM_TOL * (1 + float(want[path].abs().max()))
                worst = max(worst, gap / tol)
                if gap > tol:
                    over.append((path, gap, tol))
            row["param_gap_over_tol"] = worst
            row["over"] = over[:8]
        rows.append(row)
        del gathered
    out["DT1"] = rows
    return prog, mesh, params, full


def dt2(dev, rank, out):
    """The context-parallel STLT, forward and backward, against the serial
    training call over all DT2_N tokens (run once, on rank 0, which hands
    each rank its slices)."""
    import torch

    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context_parallel import stlt_context_parallel
    from repro_torch.kernels import ops
    from repro_torch.kernels import stlt_scan as k1

    mesh = comm.make_mesh((WORLD,), ("data",), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    B, N, d, S = DT2_B, DT2_N, DT2_D, DT2_S
    x = torch.randn(B, N, d, generator=g, device=dev)
    lm = -(0.0005 + 0.05 * torch.rand(S, generator=g, device=dev))
    th = (torch.pi / 4) * (2 * torch.rand(S, generator=g, device=dev) - 1)
    ur, ui = (torch.randn(S, generator=g, device=dev) / S for _ in range(2))
    w = torch.randn(B, N, d, generator=g, device=dev)      # the backward's cotangent
    n_loc = N // WORLD
    x_loc = x[:, rank * n_loc:(rank + 1) * n_loc].contiguous()
    w_loc = w[:, rank * n_loc:(rank + 1) * n_loc].contiguous()
    run = lambda: stlt_context_parallel(x_loc, lm, th, ur, ui, mesh)  # noqa: E731
    with torch.no_grad():
        run()                                       # warm
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        z, ms = _timed(run)
    row = {"ms": ms, "k1": k1.stlt_scan_kernel.launches, "bytes": dict(comm.STATS)}
    leaves = [t.clone().requires_grad_(True) for t in (x_loc, lm, th, ur, ui)]

    def fwd_bwd():
        zl = stlt_context_parallel(*leaves, mesh)
        return torch.autograd.grad((zl * w_loc).sum(), leaves)

    fwd_bwd()                                       # warm
    comm.reset_stats()
    k1.stlt_scan_kernel.launches = 0
    grads, row["bwd_ms"] = _timed(fwd_bwd)
    row["bwd_k1"] = k1.stlt_scan_kernel.launches
    row["bwd_bytes"] = dict(comm.STATS)
    del x_loc, leaves
    # the serial reference: the training call over all N tokens, z and its
    # grads (K1 forward, K1 anti-causal, the analytic param grads), rank 0 only
    full = None
    if rank == 0:
        ref = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
        rows = [t[None].expand(B, S).contiguous() for t in ref[1:]]
        with torch.no_grad():
            _, row["serial_ms"] = _timed(lambda: ops.stlt_scan(x, *rows))

        def serial():
            zs = ops.stlt_scan(ref[0], *rows)
            return zs, torch.autograd.grad((zs * w).sum(), ref)

        (zs, sg), row["serial_bwd_ms"] = _timed(serial)
        full = {"z": zs.detach(), "dx": sg[0], "poles": torch.stack(sg[1:])}
        del ref, rows, zs, sg
    del x, w
    shards = {"z": z, "dx": grads[0], "poles": torch.stack(grads[1:])}
    specs = {"z": sh.P(None, "data", None), "dx": sh.P(None, "data", None),
             "poles": sh.P(None, None)}
    want = _hand_out(full, shards, specs, mesh, rank)
    del full
    torch.cuda.empty_cache()
    for name, key in (("z", ""), ("dx", "dx_")):
        ref = want[name].to(dev)
        row[f"{key}err"] = float((shards[name] - ref).abs().max())
        row[f"{key}scale"] = 1.0 + float(ref.abs().max())
    # each pole and mixer grad against its own scale
    ref = want["poles"].to(dev)
    row["pole_gaps_over_tol"] = [
        float((a - b).abs().max()) / (K1_TOL * (1.0 + float(b.abs().max())))
        for a, b in zip(shards["poles"], ref)]
    out["DT2"] = row


def dt3(T, cfg, dev, rank, full, out):
    import torch

    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.utils import tree_flatten_with_paths, tree_map

    mesh = comm.make_mesh((2, 2), ("data", "pipe"), device=dev)
    stage, per = mesh.coord("pipe"), cfg.num_layers // 2
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(DT3_M, 1, DT3_N, cfg.d_model, generator=g, device=dev)
    cot = torch.randn(DT3_M, 1, DT3_N, cfg.d_model, generator=g, device=dev)

    def stage_fn(p, h):
        for blk in p["layers"]:
            h = T.apply_block(blk, cfg, "stlt", h, deterministic=True)[0]
        return h

    def fresh(layers):
        """A copy of ``layers`` whose leaves take grads."""
        return {"layers": tree_map(lambda t: t.detach().clone().requires_grad_(True), layers)}

    mine = fresh(full["layers"][stage * per:(stage + 1) * per])
    k1.stlt_scan_kernel.launches = 0

    def run():
        y = pipeline_apply(stage_fn, mine, x, mesh)
        (y * cot).sum().backward()
        return y

    y, ms = _timed(run)
    row = {"ms": ms, "k1": k1.stlt_scan_kernel.launches}
    # the 6 blocks in turn, microbatch by microbatch, on this card
    serial = fresh(full["layers"])

    def run_serial():
        ys = []
        for m in range(DT3_M):
            h = x[m]
            for blk in serial["layers"]:
                h = T.apply_block(blk, cfg, "stlt", h, deterministic=True)[0]
            ys.append(h)
        ys = torch.stack(ys)
        (ys * cot).sum().backward()
        return ys

    want, row["serial_ms"] = _timed(run_serial)
    row["out_err"] = float((y - want).detach().abs().max())
    row["out_scale"] = 1.0 + float(want.detach().abs().max())
    worst = 0.0
    ref = serial["layers"][stage * per:(stage + 1) * per]
    for (path, a), (_, b) in zip(tree_flatten_with_paths(mine["layers"]),
                                 tree_flatten_with_paths(ref)):
        gap = float((a.grad - b.grad).abs().max())
        worst = max(worst, gap / (DT3_GRAD_TOL * max(float(b.grad.abs().max()), 1e-30)))
    row["grad_gap_over_tol"] = worst
    out["DT3"] = row


def dt4(prog, mesh, dt1_params, full, dev, rank, out):
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.fault_tolerance import (SimulatedHardwareFailure,
                                                         run_resilient_loop)
    from repro_torch.utils import tree_flatten_with_paths, tree_leaves

    pspecs, _, bspec, _ = prog.in_shardings
    ckpt_dir = OUT / f"ckpt{rank}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    vocab = int(full["embed"]["embed"].shape[0])

    def init_fn():
        params = sh.local_slices(full, pspecs, mesh)
        return {"params": params, "opt": prog.opt_init(params)}

    def step_fn(state, step):
        batch = sh.local_slices(_batch(step, dev, vocab), bspec, mesh)
        params, opt_state, _ = prog.fn(state["params"], state["opt"], batch, step)
        return {"params": params, "opt": opt_state}

    failed = []

    def inject(step):
        if step == DT4_FAIL_AT and not failed:
            failed.append(step)
            raise SimulatedHardwareFailure(f"card lost at step {step}")

    mgr = CheckpointManager(str(ckpt_dir), async_saves=False)
    t0 = time.time()
    stats = run_resilient_loop(step_fn=step_fn, init_fn=init_fn, ckpt=mgr,
                               total_steps=DT1_STEPS, save_every=1, fail_injector=inject)
    final, _ = mgr.restore_or_init(init_fn)
    differ = [(path, float((a.to(b.device) - b).abs().max()))
              for (path, a), b in zip(tree_flatten_with_paths(final["params"]),
                                      tree_leaves(dt1_params))
              if not torch.equal(a.to(b.device), b)]
    out["DT4"] = {"stats": stats, "bitwise": not differ, "differ": differ[:8],
                  "wall_s": time.time() - t0}
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def ds1(T, cfg, full, dev, rank, out):
    """The sharded prefill and decode cells against the single-device
    functions on this rank's card."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps

    B, N, new = DS1_B, DS1_N, DS1_NEW
    mesh = mesh_lib.make_host_mesh(2, 2, device=dev)
    pre = steps.build_prefill_step(cfg, ShapeConfig("ds", N, B, "prefill"), mesh)
    dec = steps.build_decode_step(cfg, ShapeConfig("ds", N + new, B, "decode"), mesh)
    sparams = steps.serving_params(full, cfg)
    params = sh.local_slices(sparams, pre.in_shardings[0], mesh)
    toks = torch.randint(0, cfg.vocab, (B, N), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    x = sh.local_slices(toks, pre.in_shardings[1], mesh)
    pre.fn(params, x)                                   # warm
    comm.reset_stats()
    k1.stlt_scan_kernel.launches = 0
    given = _held(params, x)
    (logits, pre_state), ms, grown = _grown(lambda: pre.fn(params, x), dev)
    row = {"prefill_ms": ms, "prefill_k1": k1.stlt_scan_kernel.launches,
           "prefill_bytes": dict(comm.STATS), "prefill_calls": dict(comm.CALLS),
           "prefill_held": given, "prefill_grown": grown, "decode_ms": [], "decode_k1": [],
           "decode_bytes": None}
    got_logits, state = [logits], pre_state
    for _ in range(new):
        tok = got_logits[-1].argmax(-1).to(torch.int32)
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        given = _held(params, tok, state)
        (logits, state), ms, grown = _grown(lambda: dec.fn(params, tok, state), dev)
        row["decode_ms"].append(ms)
        row["decode_k1"].append(k1.stlt_scan_kernel.launches)
        row.update(decode_bytes=dict(comm.STATS), decode_calls=dict(comm.CALLS),
                   decode_held=given, decode_grown=grown)
        got_logits.append(logits)
    torch.distributed.barrier()
    # the single-device functions on this card, held on the rank's rows
    # and heads; a row whose stream leaves the reference's at a near tie is
    # compared no further
    b0, b_loc = mesh.coord("data") * (B // 2), B // 2
    h_loc = cfg.num_heads // 2
    h0 = mesh.coord("model") * h_loc

    def state_gap(got, want):
        worst = 0.0
        for g, w in zip(got["layers"], want["layers"]):
            for k in ("h_re", "h_im"):
                ws = w[k][b0:b0 + b_loc, h0:h0 + h_loc]
                worst = max(worst, float((g[k] - ws).abs().max())
                            / (K1_TOL * (1 + float(ws.abs().max()))))
        return worst

    with torch.no_grad():
        T.prefill(sparams, cfg, toks, max_len=N + new)            # warm
        (ref_logits, ref_state), row["ref_prefill_ms"] = _timed(
            lambda: T.prefill(sparams, cfg, toks, max_len=N + new))
        row["ref_decode_ms"] = []
        row["prefill_state_gap_over_tol"] = state_gap(pre_state, ref_state)
        live = [True] * b_loc
        row["logit_gap"], row["near_ties"], row["same_tokens"] = 0.0, 0, 0
        for step, got in enumerate(got_logits):
            want = ref_logits[b0:b0 + b_loc]
            for r in range(b_loc):
                if not live[r]:
                    continue
                row["logit_gap"] = max(row["logit_gap"],
                                       float((got[r] - want[r]).abs().max()))
                g_tok, w_tok = int(got[r].argmax()), int(want[r].argmax())
                if g_tok == w_tok:
                    row["same_tokens"] += 1
                    continue
                gap = float(want[r, w_tok] - want[r, g_tok])
                if not gap < DS_LOGIT_TOL:
                    raise AssertionError(f"DS1 rank {rank} step {step} row {b0 + r}: token "
                                         f"{g_tok}, single-device {w_tok}, gap {gap}")
                row["near_ties"] += 1
                live[r] = False
            if step < new:
                ref_tok = ref_logits.argmax(-1).to(torch.int32)
                (ref_logits, ref_state), ms = _timed(
                    lambda: T.decode_step(sparams, cfg, ref_tok, ref_state))
                row["ref_decode_ms"].append(ms)
        row["streams_equal"] = all(live)
        row["final_state_gap_over_tol"] = state_gap(state, ref_state) if all(live) else None
    out["DS1"] = row


def ds2(T, cfg, full, dev, rank, out):
    """The process form of the sharded engine (ranks 0 and 1) against the
    one-process engine (rank 0's card) on phase SH's requests."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.distributed import comm
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.serving import (PrefixCache, ReplicatedPrefixCache, Request,
                                     ShardedServeEngine)

    mesh = comm.sub_mesh(np.arange(cs.SH_HOSTS), ("data",), device=dev)
    sys_prompt, reqs = cs.serve_requests(cfg, Request)
    arrivals = [spec[4] for spec in cs.SERVE_SPEC]
    row = {"member": mesh.member}
    if mesh.member:
        eng = ShardedServeEngine(full, cfg, mesh=mesh, slots_per_host=cs.SH_SLOTS,
                                 prefill_chunk=cs.SERVE_CHUNK, prefix_cache=PrefixCache(),
                                 device=dev)
        eng.warm_prefix(sys_prompt)
        torch.cuda.synchronize()
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        res, stats = eng.serve(reqs, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        row.update(k1=k1.stlt_scan_kernel.launches, dispatches=dict(eng.serve_stats),
                   bytes=dict(comm.STATS), metrics=cs.serve_metrics(res, stats, reqs, wall),
                   cache_hits=eng.prefix_cache.stats()["hits"],
                   pinned=eng.prefix_cache.stats()["pinned"])
    torch.distributed.barrier()
    if rank == 0:
        one = ShardedServeEngine(full, cfg, n_hosts=cs.SH_HOSTS, slots_per_host=cs.SH_SLOTS,
                                 prefill_chunk=cs.SERVE_CHUNK,
                                 prefix_cache=ReplicatedPrefixCache(cs.SH_HOSTS), device=dev)
        one.warm_prefix(sys_prompt)
        torch.cuda.synchronize()
        t0 = time.time()
        one_res, one_stats = one.serve(reqs, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        keys = ("host", "arrival", "admit", "live", "finish", "n_tokens", "cached_tokens")
        row["ticks_equal"] = all(tuple(stats[r.id][k] for k in keys)
                                 == tuple(one_stats[r.id][k] for k in keys) for r in reqs)
        row["hosts"] = {r.id: stats[r.id]["host"] for r in reqs}
        row["one_metrics"] = cs.serve_metrics(one_res, one_stats, reqs, wall)
        row["one_dispatches"] = dict(one.serve_stats)
        same, ties = cs.near_tie_streams(T, cfg, full, dev, reqs, res, one_res, "DS2")
        row.update(same=same, ties=ties, requests=len(reqs))
    torch.distributed.barrier()
    out["DS2"] = row


def _in_turns(rank: int, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier: a
    single-device reference at full width holds the whole model (and its
    step's grads and moments), which four ranks at once would not fit on
    one card. Each turn frees what it made before the next begins."""
    import torch

    for turn in range(WORLD):
        if turn == rank:
            fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        torch.distributed.barrier()


def da_config(arch: str, variant: str, layers: int, **kw):
    """``arch`` at full width, cut to ``layers`` layers (its layer pattern's
    first ones), fp32 activations (the gates read fp32)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch, variant)
    if cfg.layer_types:
        kw["layer_types"] = cfg.layer_types[:layers]
    return dataclasses.replace(cfg, num_layers=layers, dtype="float32", **kw)


def _gap_over(got, want, tol) -> float:
    """max |got - want| over tol x (1 + max |want|)."""
    want = want.to(got.device)
    return float((got.float() - want.float()).abs().max()) / (
        tol * (1 + float(want.float().abs().max())))


class _RankView:
    """``mesh`` seen from global rank ``r`` (its coordinates, row-major over
    the axis names), as ``sharding.local_slice`` reads a mesh."""

    def __init__(self, mesh, r: int):
        self.mesh, self._coords = mesh, {}
        for a in reversed(mesh.axis_names):
            self._coords[a], r = r % mesh.shape[a], r // mesh.shape[a]

    def axis_size(self, axes) -> int:
        return self.mesh.axis_size(axes)

    def coord(self, axes) -> int:
        idx = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx = idx * self.mesh.shape[a] + self._coords[a]
        return idx


def _hand_out(full, shards, specs, mesh, rank) -> dict:
    """Each rank's slices of rank 0's whole tree ``full`` (None elsewhere),
    shaped as the rank's ``shards``, on the host: rank 0 sends the other
    ranks their slices of each leaf at once (point to point over the job's
    group, host copies), which keeps one leaf on the host at a time."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.utils import tree_flatten_with_paths

    want = dict(tree_flatten_with_paths(full)) if rank == 0 else None
    out = {}
    for path, shard in tree_flatten_with_paths(shards):
        if rank == 0:
            parts = [sh.local_slice(want[path], specs[path], _RankView(mesh, r)).to("cpu")
                     .contiguous() for r in range(1, WORLD)]
            for req in [torch.distributed.isend(t, r) for r, t in enumerate(parts, 1)]:
                req.wait()
            out[path] = sh.local_slice(want[path], specs[path], mesh).to("cpu", copy=True)
        else:
            out[path] = torch.empty(shard.shape, dtype=shard.dtype)
            torch.distributed.recv(out[path], 0)
    return out


def da_train(T, cfg, dev, rank, mesh_shape, tag, out, N=None, B=DA_B):
    """The train cell on ``mesh_shape`` against the single-device
    ``make_step`` (rank 0 runs it alone on the card, then hands each rank
    its slices of the final params, ``_hand_out``): the steps
    DA_TRAIN_STEPS of B x N (DA_N) tokens from the init;
    each call's K1 launches and MoE drops beside the reference's."""
    import torch

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import steps, train
    from repro_torch.models import moe
    from repro_torch.utils import tree_flatten_with_paths

    t0, N = time.time(), N or DA_N
    tcfg = TrainConfig(total_steps=100, warmup_steps=2)
    mesh = comm.make_mesh(mesh_shape, ("data", "model"), device=dev)
    prog = steps.build_train_step(cfg, ShapeConfig(tag, N, B, "train"), mesh, tcfg)
    pspecs, _, bspec, _ = prog.in_shardings
    specs = dict(tree_flatten_with_paths(pspecs))
    batches = [_batch(step, dev, cfg.vocab, B, N) for step in DA_TRAIN_STEPS]
    held, row = {}, {"mesh": list(mesh_shape), "tokens": [B, N], "ref": []}

    def draw():
        full = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        held["params"] = sh.local_slices(full, pspecs, mesh)

    _in_turns(rank, draw)
    ref = None
    if rank == 0:       # alone on the card: the other ranks wait at the barrier
        opt, ref_step = train.make_step(cfg, tcfg)
        ref = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        state = opt.init(ref)
        for step, batch in zip(DA_TRAIN_STEPS, batches):
            k1.stlt_scan_kernel.launches = 0
            moe.DROPS.reset()
            (ref, state, m), ms = _timed(lambda: ref_step(ref, state, batch, step))
            row["ref"].append({"ms": ms, "k1": k1.stlt_scan_kernel.launches,
                               "drops": moe.DROPS.read()["dropped"],
                               "loss": float(m["loss"]),
                               "metrics": {k: float(m[k]) for k in DT1_METRICS}})
        del state
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    box = [row["ref"]]
    torch.distributed.broadcast_object_list(box, src=0)
    row["ref"] = box[0]
    held["ref"] = _hand_out(ref, held["params"], specs, mesh, rank)
    del ref
    torch.cuda.empty_cache()
    row["ref_s"] = time.time() - t0
    params = held.pop("params")
    state = prog.opt_init(params)
    row["steps"] = []
    for step, batch in zip(DA_TRAIN_STEPS, batches):
        local = sh.local_slices(batch, bspec, mesh)
        given = _held(params, state, local)
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        moe.DROPS.reset()
        (params, state, m), ms, grown = _grown(
            lambda: prog.fn(params, state, local, step), dev)
        row["steps"].append({"ms": ms, "k1": k1.stlt_scan_kernel.launches,
                             "drops": moe.DROPS.read()["dropped"],
                             "bytes": dict(comm.STATS), "calls": dict(comm.CALLS),
                             "held": given, "grown": grown, "loss": float(m["loss"]),
                             "metrics": {k: float(m[k]) for k in DT1_METRICS}})
    worst, over = 0.0, []
    for path, got in tree_flatten_with_paths(params):
        gap = _gap_over(got, held["ref"][path], DA_PARAM_TOL)
        worst = max(worst, gap)
        if gap > 1.0:
            over.append((path, gap))
    row["param_gap_over_tol"], row["over"] = worst, over[:8]
    row["peak_gib"] = _peak_gib(dev)
    del params, state, held
    torch.distributed.barrier()
    torch.cuda.empty_cache()
    _reset_peak(dev)
    row["s"] = time.time() - t0
    print(f"[{tag}] {row['s']:.1f} s (references {row['ref_s']:.1f} s), peak "
          f"{row['peak_gib']:.2f} GiB", flush=True)
    out[tag] = row


def da_serve(T, cfg, dev, rank, mesh_shape, tag, out, new=DA_NEW):
    """The prefill cell (DA_B x DA_N) and ``new`` greedy decode-cell steps on
    ``mesh_shape`` against the single-device ``prefill``/``decode_step``
    (each rank in its turn draws the params and keeps its shards; rank 0
    runs the reference in its turn, then hands the others its results):
    the decode starts from the single-device prefill's state at DA_N +
    ``new`` positions, as the decode cell sizes its caches; the rank's rows
    of the logits within DA_LOGIT_TOL, its state shards within K1's gate of
    the reference's slices, the streams equal under the near-tie rule. K1
    launches and MoE drops per call beside the reference's."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.utils import tree_flatten_with_paths, tree_map

    t0, (B, N) = time.time(), (DA_B, DA_N)
    mesh = comm.make_mesh(mesh_shape, ("data", "model"), device=dev)
    pre = steps.build_prefill_step(cfg, ShapeConfig(tag, N, B, "prefill"), mesh)
    dec = steps.build_decode_step(cfg, ShapeConfig(tag, N + new, B, "decode"), mesh)
    toks = torch.randint(0, cfg.vocab, (B, N), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    row = {"mesh": list(mesh_shape), "new": new, "fsdp": cfg.fsdp,
           "dispatch": cfg.moe_dispatch}
    host = lambda tree: tree_map(lambda t: t.to("cpu"), tree)  # noqa: E731
    ref, held = {}, {}

    def draw():
        full = steps.serving_params(
            T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev), cfg)
        held["params"] = sh.local_slices(full, pre.in_shardings[0], mesh)
        if rank == 0:
            with torch.no_grad():
                T.prefill(full, cfg, toks, max_len=N)                 # warm
                k1.stlt_scan_kernel.launches = 0
                moe.DROPS.reset()
                (logits, state), ref["prefill_ms"] = _timed(
                    lambda: T.prefill(full, cfg, toks, max_len=N))
                ref["prefill_k1"] = k1.stlt_scan_kernel.launches
                ref["prefill_drops"] = moe.DROPS.read()["dropped"]
                ref["prefill"] = host((logits, state))
                logits, state = T.prefill(full, cfg, toks, max_len=N + new)
                tok = logits.argmax(-1).to(torch.int32)
                ref["start"], ref["decode_ms"], ref["logits"] = host((state, tok)), [], []
                ref["decode_k1"], ref["decode_drops"] = [], []
                for _ in range(new):
                    k1.stlt_scan_kernel.launches = 0
                    moe.DROPS.reset()
                    (logits, state), ms = _timed(lambda: T.decode_step(full, cfg, tok, state))
                    ref["decode_k1"].append(k1.stlt_scan_kernel.launches)
                    ref["decode_drops"].append(moe.DROPS.read()["dropped"])
                    ref["decode_ms"].append(ms)
                    ref["logits"].append(logits.to("cpu"))
                    tok = logits.argmax(-1).to(torch.int32)
                ref["final"] = host(state)

    _in_turns(rank, draw)
    params = held.pop("params")
    box = [ref]
    torch.distributed.broadcast_object_list(box, src=0)
    ref = box[0]
    for k in ("prefill_ms", "decode_ms", "prefill_k1", "decode_k1", "prefill_drops",
              "decode_drops"):
        row[f"ref_{k}"] = ref[k]
    rows_of = lambda t: sh.local_slices(t, pre.out_shardings[0], mesh, "cpu")  # noqa: E731
    held = {"prefill": (rows_of(ref["prefill"][0]),
                        sh.local_slices(ref["prefill"][1], pre.out_shardings[1], mesh, "cpu")),
            "start": sh.local_slices(ref["start"][0], dec.in_shardings[2], mesh),
            "tok0": sh.local_slices(ref["start"][1], dec.in_shardings[1], mesh),
            "decode": ([rows_of(t) for t in ref["logits"]],
                       sh.local_slices(ref["final"], dec.out_shardings[1], mesh, "cpu"))}
    del ref, box
    row["ref_s"] = time.time() - t0
    x = sh.local_slices(toks, pre.in_shardings[1], mesh)
    pre.fn(params, x)                                   # warm
    comm.reset_stats()
    k1.stlt_scan_kernel.launches = 0
    moe.DROPS.reset()
    row["prefill_held"] = _held(params, x)
    (logits, pstate), row["prefill_ms"], row["prefill_grown"] = _grown(
        lambda: pre.fn(params, x), dev)
    row.update(prefill_k1=k1.stlt_scan_kernel.launches, prefill_bytes=dict(comm.STATS),
               prefill_calls=dict(comm.CALLS), prefill_drops=moe.DROPS.read()["dropped"])
    want_logits, want_state = held["prefill"]
    row["prefill_logit_gap"] = float((logits - want_logits.to(dev)).abs().max())

    def state_gap(got, want):
        worst = 0.0
        for (path, g), (_, w) in zip(tree_flatten_with_paths(got), tree_flatten_with_paths(want)):
            if g.is_floating_point():
                worst = max(worst, _gap_over(g, w, K1_TOL))
            elif not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{tag} rank {rank}: {path} differs")
        return worst

    row["prefill_state_gap_over_tol"] = state_gap(pstate, want_state)
    del pstate
    state, tok = held["start"], held["tok0"]
    row.update(decode_ms=[], decode_k1=[], decode_drops=[], decode_bytes=None)
    ref_logits, ref_final = held["decode"]
    live = [True] * tok.shape[0]
    row["logit_gap"], row["near_ties"], row["same_tokens"] = row["prefill_logit_gap"], 0, 0
    for step in range(new):
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        moe.DROPS.reset()
        given = _held(params, tok, state)
        (logits, state), ms, grown = _grown(lambda: dec.fn(params, tok, state), dev)
        row["decode_ms"].append(ms)
        row["decode_k1"].append(k1.stlt_scan_kernel.launches)
        row["decode_drops"].append(moe.DROPS.read()["dropped"])
        row.update(decode_bytes=dict(comm.STATS), decode_calls=dict(comm.CALLS),
                   decode_held=given, decode_grown=grown)
        want = ref_logits[step].to(dev)
        for r in range(len(live)):
            if not live[r]:
                continue
            row["logit_gap"] = max(row["logit_gap"], float((logits[r] - want[r]).abs().max()))
            g_tok, w_tok = int(logits[r].argmax()), int(want[r].argmax())
            if g_tok == w_tok:
                row["same_tokens"] += 1
                continue
            gap = float(want[r, w_tok] - want[r, g_tok])
            if not gap < DA_LOGIT_TOL:
                raise AssertionError(f"{tag} rank {rank} step {step} row {r}: token {g_tok}, "
                                     f"single-device {w_tok}, gap {gap}")
            row["near_ties"] += 1
            live[r] = False
        tok = logits.argmax(-1).to(torch.int32)
    row["streams_equal"] = all(live)
    row["final_state_gap_over_tol"] = state_gap(state, ref_final) if all(live) else None
    row["peak_gib"] = _peak_gib(dev)
    del params, state, held
    torch.distributed.barrier()
    torch.cuda.empty_cache()
    _reset_peak(dev)
    row["s"] = time.time() - t0
    print(f"[{tag}] {row['s']:.1f} s (references {row['ref_s']:.1f} s), peak "
          f"{row['peak_gib']:.2f} GiB", flush=True)
    out[tag] = row


def da(T, dev, rank, out):
    """Phase DA: tensor parallelism beyond the STLT block at full width.
    DA1 chatglm3-6b native (2 layers): the 2 x 2 train cell, the prefill and
    decode cells on 2 x 2 (KV heads on ``model``; DA_FSDP_NEW decode steps)
    and 1 x 4 (the cache's time axis on ``model``). DA2 recurrentgemma-9b at
    one period: the prefill and decode cells of both forms and the STLT
    form's train cell on 1 x 4 (AdamW's moments in bf16, as phase H4 keeps
    them: the single-device reference step's old and new moments would not
    fit on the card in fp32)."""
    import torch

    t0 = time.time()
    glm = da_config(DA1_ARCH, "native", DA1_LAYERS)
    da_train(T, glm, dev, rank, (2, 2), "DA1 train 2x2", out)
    da_serve(T, glm, dev, rank, (2, 2), "DA1 serve 2x2", out, new=DA_FSDP_NEW)
    da_serve(T, glm, dev, rank, (1, 4), "DA1 serve 1x4", out)
    out["t_DA1"] = time.time() - t0
    for variant in ("native", "stlt"):
        cfg = da_config(DA2_ARCH, variant, DA2_LAYERS)
        da_serve(T, cfg, dev, rank, (1, 4), f"DA2 {variant} serve 1x4", out)
    rg = da_config(DA2_ARCH, "stlt", DA2_LAYERS, opt_moment_dtype="bfloat16")
    da_train(T, rg, dev, rank, DA2_TRAIN_MESH, "DA2 stlt train 1x4", out, N=DA2_TRAIN_N)
    out["t_DA2"] = time.time() - t0
    torch.cuda.empty_cache()


def dm(T, dev, rank, out):
    """Phase DM: expert parallelism at full width (DM_ARCH at DM_LAYERS
    layers, fp32). DM1 on 1 x 4, both forms: the train cell at DM_TRAIN_B x
    DM_TRAIN_N (adafactor), the prefill cell at DA_B x DA_N and DM_NEW
    decode-cell steps; DM2 the native form's 2 x 2 prefill and decode cells
    without FSDP (the config's ``fsdp`` replaced: the log says so)."""
    import torch

    t0 = time.time()
    for variant in ("native", "stlt"):
        cfg = da_config(DM_ARCH, variant, DM_LAYERS)
        da_train(T, cfg, dev, rank, (1, 4), f"DM1 {variant} train 1x4", out, N=DM_TRAIN_N,
                 B=DM_TRAIN_B)
        da_serve(T, cfg, dev, rank, (1, 4), f"DM1 {variant} serve 1x4", out, new=DM_NEW)
    out["t_DM1"] = time.time() - t0
    cfg = da_config(DM_ARCH, "native", DM_LAYERS, fsdp=False)
    da_serve(T, cfg, dev, rank, (2, 2), "DM2 native serve 2x2", out, new=DM_NEW)
    out["t_DM2"] = time.time() - t0
    torch.cuda.empty_cache()


def rank_main(rank: int, backend: str, cards: int, store: str):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.stlt_base import CONFIG as cfg
    from repro_torch.distributed import comm
    from repro_torch.models import transformer as T

    dev = torch.device("cuda", rank % cards)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.init_process_group(f"file://{store}", WORLD, rank, backend)
    out = {"rank": rank, "backend": backend, "device": str(dev)}
    t0 = time.time()
    prog, mesh, params, full = dt1(T, cfg, dev, rank, out)
    out["t_DT1"] = time.time() - t0
    dt2(dev, rank, out)
    out["t_DT2"] = time.time() - t0
    dt3(T, cfg, dev, rank, full, out)
    out["t_DT3"] = time.time() - t0
    dt4(prog, mesh, params, full, dev, rank, out)
    out["t_DT4"] = time.time() - t0
    ds1(T, cfg, full, dev, rank, out)
    out["t_DS1"] = time.time() - t0
    ds2(T, cfg, full, dev, rank, out)
    out["t_DS2"] = time.time() - t0
    out["peak_gib"] = _peak_gib(dev)
    del prog, mesh, params, full
    torch.cuda.empty_cache()
    _reset_peak(dev)
    da(T, dev, rank, out)
    out["t_DA"] = time.time() - t0
    dm(T, dev, rank, out)
    out["t_DM"] = time.time() - t0
    (OUT / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def launch(backend: str = "nccl", cards: int = WORLD, timeout: float = 600.0) -> list:
    """Build the kernels, start the 4 ranks, wait for them (killing every
    one if any fails or the time runs out) and return their JSON results."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild

    kbuild.build_kernels()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    store = OUT / "store"
    procs = []
    for r in range(WORLD):
        log = open(OUT / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--backend",
             backend, "--cards", str(cards), "--store", str(store)],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
            # four ranks' caching allocators share one card: grow segments
            # rather than strand them (phase DA's full-width cells)
            env={**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}), log))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [p for p, _ in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                          + (OUT / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes) if c)
        raise RuntimeError(f"phase DT: ranks exited {codes}\n{tails}")
    return [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(WORLD)]


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _da_k1(tag: str, kind: str) -> int:
    return DA_K1[kind] if "stlt" in tag else 0


def check_da(res: list, phase: str = "DA") -> dict:
    """Raise unless every gate of phase DA (or DM) holds; returns its
    summary, cell by cell: ms per rank beside the single-device call's,
    bytes per collective per rank, K1 launches per rank, MoE drops, the
    gaps. A cell's K1 launches per rank equal the single-device call's and
    DA_K1's count (its one STLT layer); its drops summed over the ranks
    equal the single-device call's."""
    summary = {"laps": {k: v for k, v in res[0].items() if k.startswith(f"t_{phase}")
                        and k != f"t_{phase}"}}
    for tag in [k for k in res[0] if k.startswith(phase) and "train" in k]:
        ref = res[0][tag]["ref"]
        for step, want in enumerate(ref):
            drops = sum(r[tag]["steps"][step]["drops"] for r in res)
            if drops != want["drops"]:
                raise AssertionError(f"{tag} step {step}: {drops} drops over the ranks, "
                                     f"single-device {want['drops']}")
        for r in res:
            row = r[tag]
            for step, (got, want) in enumerate(zip(row["steps"], ref)):
                if step == 0 and abs(got["loss"] - want["loss"]) > DT1_LOSS_TOL:
                    raise AssertionError(f"{tag} rank {r['rank']}: step-0 loss {got['loss']} "
                                         f"vs {want['loss']}")
                for k in DT1_METRICS:
                    if not abs(got["metrics"][k] - want["metrics"][k]) \
                            <= DT1_METRIC_RTOL * abs(want["metrics"][k]):
                        raise AssertionError(f"{tag} rank {r['rank']} step {step}: {k} "
                                             f"{got['metrics'][k]} vs {want['metrics'][k]}")
                if not got["k1"] == want["k1"] == _da_k1(tag, "train"):
                    raise AssertionError(f"{tag} rank {r['rank']} step {step}: {got['k1']} K1 "
                                         f"launches (single-device {want['k1']}), expected "
                                         f"{_da_k1(tag, 'train')}")
            if row["param_gap_over_tol"] > 1.0:
                raise AssertionError(f"{tag} rank {r['rank']}: params off the single-device "
                                     f"step: {row['over']}")
        summary[tag] = {
            "tokens": res[0][tag]["tokens"], "s": res[0][tag]["s"],
            "ref_s": res[0][tag]["ref_s"],
            "step_ms": [[s["ms"] for s in r[tag]["steps"]] for r in res],
            "ref_step_ms": [[s["ms"] for s in r[tag]["ref"]] for r in res],
            "bytes_per_step": [r[tag]["steps"][-1]["bytes"] for r in res],
            "k1_per_step": [r[tag]["steps"][-1]["k1"] for r in res],
            "ref_k1": ref[-1]["k1"],
            "drops": [[s["drops"] for s in r[tag]["steps"]] for r in res],
            "ref_drops": [s["drops"] for s in ref],
            "loss_gap": max(abs(r[tag]["steps"][0]["loss"] - ref[0]["loss"]) for r in res),
            "metric_rel_gap": {k: max(abs(s["metrics"][k] - w["metrics"][k])
                                      / max(abs(w["metrics"][k]), 1e-30)
                                      for r in res for s, w in zip(r[tag]["steps"], ref))
                               for k in DT1_METRICS},
            "param_gap_over_tol": max(r[tag]["param_gap_over_tol"] for r in res),
            "peak_gib": [r[tag]["peak_gib"] for r in res]}
    for tag in [k for k in res[0] if k.startswith(phase) and "serve" in k]:
        d0 = res[0][tag]
        drops = [sum(r[tag]["prefill_drops"] for r in res)]
        want_drops = [d0["ref_prefill_drops"]]
        if all(r[tag]["streams_equal"] for r in res):    # the same tokens route
            drops += [sum(r[tag]["decode_drops"][i] for r in res) for i in range(d0["new"])]
            want_drops += d0["ref_decode_drops"]
        if drops != want_drops:
            raise AssertionError(f"{tag}: drops over the ranks {drops} (prefill, then each "
                                 f"decode step), single-device {want_drops}")
        for r in res:
            d = r[tag]
            want_pre, want_dec = _da_k1(tag, "prefill"), _da_k1(tag, "decode")
            if not (d["prefill_k1"] == d["ref_prefill_k1"] == want_pre
                    and set(d["decode_k1"]) == set(d["ref_decode_k1"]) == {want_dec}
                    and d["logit_gap"] <= DA_LOGIT_TOL
                    and d["prefill_state_gap_over_tol"] <= 1.0
                    and (d["final_state_gap_over_tol"] is None
                         or d["final_state_gap_over_tol"] <= 1.0)):
                raise AssertionError(
                    f"{tag} rank {r['rank']}: K1 {d['prefill_k1']} per prefill (expected "
                    f"{want_pre}), {set(d['decode_k1'])} per decode step (expected "
                    f"{want_dec}), logit gap {d['logit_gap']}, state gaps over K1's gate "
                    f"{d['prefill_state_gap_over_tol']}, {d['final_state_gap_over_tol']}")
        summary[tag] = {
            "new": res[0][tag]["new"], "s": res[0][tag]["s"], "ref_s": res[0][tag]["ref_s"],
            "prefill_ms": [r[tag]["prefill_ms"] for r in res],
            "ref_prefill_ms": [r[tag]["ref_prefill_ms"] for r in res],
            "decode_ms_median": [_median(r[tag]["decode_ms"]) for r in res],
            "ref_decode_ms_median": [_median(r[tag]["ref_decode_ms"]) for r in res],
            "prefill_bytes": [r[tag]["prefill_bytes"] for r in res],
            "decode_bytes": [r[tag]["decode_bytes"] for r in res],
            "k1": [[r[tag]["prefill_k1"], max(r[tag]["decode_k1"])] for r in res],
            "ref_k1": [d0["ref_prefill_k1"], max(d0["ref_decode_k1"])],
            "prefill_drops": [r[tag]["prefill_drops"] for r in res],
            "ref_prefill_drops": d0["ref_prefill_drops"],
            "decode_drops": sum(sum(r[tag]["decode_drops"]) for r in res),
            "fsdp": d0["fsdp"], "dispatch": d0["dispatch"],
            "logit_gap": max(r[tag]["logit_gap"] for r in res),
            "state_gap_over_tol": max(max(r[tag]["prefill_state_gap_over_tol"],
                                          r[tag]["final_state_gap_over_tol"] or 0.0)
                                      for r in res),
            "streams_equal": [r[tag]["streams_equal"] for r in res],
            "near_ties": sum(r[tag]["near_ties"] for r in res),
            "peak_gib": [r[tag]["peak_gib"] for r in res]}
    return summary


def check(res: list) -> dict:
    """Raise unless every DT check holds; returns the summary."""
    r0 = res[0]
    dt1 = r0["DT1"]
    if abs(dt1[0]["loss"] - dt1[0]["ref_loss"]) > DT1_LOSS_TOL:
        raise AssertionError(f"DT1 step-0 loss {dt1[0]['loss']} vs {dt1[0]['ref_loss']}")
    for row in dt1:
        for k in DT1_METRICS:
            got, want = row["metrics"][k], row["ref_metrics"][k]
            if not abs(got - want) <= DT1_METRIC_RTOL * abs(want):
                raise AssertionError(f"DT1 step {row['step']}: {k} {got} vs the "
                                     f"single-device step's {want}")
        if row["param_gap_over_tol"] > 1.0:
            raise AssertionError(f"DT1 step {row['step']}: params off the single-device "
                                 f"step: {row['over']}")
    for r in res:
        for row in r["DT1"]:
            if row["k1"] != 18:      # 6 layers x (forward, remat recompute, dx)
                raise AssertionError(f"DT1 rank {r['rank']} step {row['step']}: "
                                     f"{row['k1']} K1 launches, expected 18")
        d2 = r["DT2"]
        if not (d2["err"] <= K1_TOL * d2["scale"] and d2["k1"] == 1):
            raise AssertionError(f"DT2 rank {r['rank']}: {d2}")
        if not (d2["dx_err"] <= K1_TOL * d2["dx_scale"]
                and max(d2["pole_gaps_over_tol"]) <= 1.0 and d2["bwd_k1"] == 2
                and d2["bwd_bytes"] == DT2_BWD_BYTES):
            raise AssertionError(f"DT2 backward rank {r['rank']}: dx err {d2['dx_err']} "
                                 f"(scale {d2['dx_scale']}), pole and mixer grads "
                                 f"{d2['pole_gaps_over_tol']} of K1's gate, K1 "
                                 f"{d2['bwd_k1']} (expected 2), bytes {d2['bwd_bytes']} "
                                 f"(expected {DT2_BWD_BYTES})")
        d3 = r["DT3"]
        if not (d3["out_err"] <= DT3_OUT_TOL * d3["out_scale"] and d3["grad_gap_over_tol"] <= 1.0):
            raise AssertionError(f"DT3 rank {r['rank']}: {d3}")
        d4 = r["DT4"]
        if not (d4["bitwise"] and d4["stats"]["restarts"] == 1 and d4["stats"]["completed"]):
            raise AssertionError(f"DT4 rank {r['rank']}: {d4}")
    for r in res:
        d = r["DS1"]
        if not (d["prefill_k1"] == 6 and set(d["decode_k1"]) == {0}
                and d["logit_gap"] <= DS_LOGIT_TOL and d["prefill_state_gap_over_tol"] <= 1.0
                and (d["final_state_gap_over_tol"] is None
                     or d["final_state_gap_over_tol"] <= 1.0)):
            raise AssertionError(f"DS1 rank {r['rank']}: K1 {d['prefill_k1']} per prefill, "
                                 f"{set(d['decode_k1'])} per decode step, logit gap "
                                 f"{d['logit_gap']}, state gaps over K1's gate "
                                 f"{d['prefill_state_gap_over_tol']}, "
                                 f"{d['final_state_gap_over_tol']}")
        d = r["DS2"]
        if d["member"] and not (d["k1"] == 6 * d["dispatches"]["admission_dispatches"]
                                and d["k1"] > 0 and d["pinned"] > 0 and d["cache_hits"] > 0):
            raise AssertionError(f"DS2 rank {r['rank']}: {d}")
    d2 = r0["DS2"]
    if not (d2["ticks_equal"] and set(d2["hosts"].values()) == {0, 1}):
        raise AssertionError(f"DS2: ticks equal {d2['ticks_equal']}, hosts {d2['hosts']}")
    da = check_da(res)
    dm = check_da(res, "DM")
    if not dm["DM2 native serve 2x2"]["ref_prefill_drops"] > 0:
        raise AssertionError("DM2: the prefill dropped no choice, so the global slot "
                             "offsets went unchecked")
    hosts = [r["DS2"] for r in res if r["DS2"]["member"]]
    return {
        "ds1_prefill_ms": [r["DS1"]["prefill_ms"] for r in res],
        "ds1_decode_ms_median": [_median(r["DS1"]["decode_ms"]) for r in res],
        "ds1_ref_prefill_ms": [r["DS1"]["ref_prefill_ms"] for r in res],
        "ds1_ref_decode_ms_median": [_median(r["DS1"]["ref_decode_ms"]) for r in res],
        "ds1_prefill_bytes": [r["DS1"]["prefill_bytes"] for r in res],
        "ds1_decode_bytes": [r["DS1"]["decode_bytes"] for r in res],
        "ds1_k1": [[r["DS1"]["prefill_k1"], max(r["DS1"]["decode_k1"])] for r in res],
        "ds1_logit_gap": max(r["DS1"]["logit_gap"] for r in res),
        "ds1_state_gap_over_tol": max(max(r["DS1"]["prefill_state_gap_over_tol"],
                                          r["DS1"]["final_state_gap_over_tol"] or 0.0)
                                      for r in res),
        "ds1_streams_equal": [r["DS1"]["streams_equal"] for r in res],
        "ds1_near_ties": sum(r["DS1"]["near_ties"] for r in res),
        "ds2_metrics": [h["metrics"] for h in hosts],
        "ds2_one_metrics": d2["one_metrics"],
        "ds2_k1": [h["k1"] for h in hosts],
        "ds2_dispatches": [h["dispatches"] for h in hosts],
        "ds2_one_dispatches": d2["one_dispatches"],
        "ds2_bytes": [h["bytes"] for h in hosts],
        "ds2_same": d2["same"], "ds2_ties": d2["ties"], "ds2_requests": d2["requests"],
        "ds2_hosts": d2["hosts"],
        "step_ms": [[row["ms"] for row in r["DT1"]] for r in res],
        "ref_step_ms": [row["ref_ms"] for row in dt1],
        "bytes_per_step": [r["DT1"][-1]["bytes"] for r in res],
        "k1_per_step": [r["DT1"][-1]["k1"] for r in res],
        "loss_gap": abs(dt1[0]["loss"] - dt1[0]["ref_loss"]),
        "param_gap_over_tol": max(row["param_gap_over_tol"] for row in dt1),
        "metric_rel_gap": {k: max(abs(row["metrics"][k] - row["ref_metrics"][k])
                                  / abs(row["ref_metrics"][k]) for row in dt1)
                           for k in DT1_METRICS},
        "cp_ms": [r["DT2"]["ms"] for r in res], "cp_serial_ms": r0["DT2"]["serial_ms"],
        "cp_bytes": [r["DT2"]["bytes"] for r in res],
        "cp_k1": [r["DT2"]["k1"] for r in res],
        "cp_err_over_scale": max(r["DT2"]["err"] / r["DT2"]["scale"] for r in res),
        "cp_bwd_ms": [r["DT2"]["bwd_ms"] for r in res],
        "cp_serial_bwd_ms": r0["DT2"]["serial_bwd_ms"],
        "cp_bwd_k1": [r["DT2"]["bwd_k1"] for r in res],
        "cp_bwd_bytes": [r["DT2"]["bwd_bytes"] for r in res],
        "cp_dx_err_over_scale": max(r["DT2"]["dx_err"] / r["DT2"]["dx_scale"] for r in res),
        "cp_pole_gaps_over_tol": [r["DT2"]["pole_gaps_over_tol"] for r in res],
        "pipe_ms": [r["DT3"]["ms"] for r in res],
        "pipe_serial_ms": [r["DT3"]["serial_ms"] for r in res],
        "pipe_k1": [r["DT3"]["k1"] for r in res],
        "pipe_out_err_over_scale": max(r["DT3"]["out_err"] / r["DT3"]["out_scale"]
                                       for r in res),
        "pipe_grad_gap_over_tol": max(r["DT3"]["grad_gap_over_tol"] for r in res),
        "resilient": res[0]["DT4"]["stats"], "resilient_wall_s": res[0]["DT4"]["wall_s"],
        "phase_s": {k: res[0][k] for k in ("t_DT1", "t_DT2", "t_DT3", "t_DT4", "t_DS1",
                                           "t_DS2", "t_DA", "t_DM")},
        "peak_gib": [r["peak_gib"] for r in res],
        "da": da, "dm": dm,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--cards", type=int, default=WORLD, help="cards the 4 ranks share")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.backend, args.cards, args.store)
        return 0
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"phase_dt: needs {args.cards} CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.time()
    summary = check(launch(args.backend, args.cards))
    summary["wall_s"] = time.time() - t0
    print(smi.strip())
    print(json.dumps({"phase_dt": summary, "backend": args.backend, "cards": args.cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
