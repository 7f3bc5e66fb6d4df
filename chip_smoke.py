#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
holds each against its plain PyTorch version on the card: K1 (the STLT
scan, at batch 4, at batch 1, over a 131,072-token row, at serve's two
admission shapes, 1 and 4 rows of 512 tokens, and at SmolLM-360M-stlt's
S = 32 admission and verify shapes and its 8 x 15 x 1024 train shape) and K2 (the
flash relevance readout, both modes, with masked nodes, a padded key tail
and an all-masked row, at the real score scale and with x scaled so the
largest score is 1 or 30, also against the plain version run in float64),
and reads how the tensor cores round K2's 3xTF32 score sums. Phase T1
holds the scan's VJP on the card (K1 forward, K1 anti-causal for dx, the
analytic pole/mixer grads) against float64 autograd through the plain
version, both directions, at N = 1000 and 1037 and at SmolLM-360M-stlt's
train shape. Then it drives the main
paths with random weights from a seeded generator and checks that each ran
through its kernel: ``ServeEngine.generate`` on the full-width
``stlt_base`` model (K1), ``lm_loss`` forward and backward on the same
model with ``mixer="stlt_relevance"`` (K2), and (phase T2) training of
``stlt_base``: step 0 on the card against the CPU (loss and every grad
leaf), then 5 AdamW steps (18 K1 launches a step: forward, remat recompute
and dx in each of 6 layers), timed and profiled.
Phase S serves 12 requests of 100-3000 prompt tokens through
``ServeEngine.serve`` (4 slots, chunked admission at 512 tokens through K1,
a warmed 512-token system prompt in the prefix cache): each stream against
its request run alone, K1 launches against the admission dispatches, the
cache hits, wave mode; timed and profiled. Phase P serves full-width
SmolLM-360M-stlt in bf16 (8 requests, 4 slots): plain, speculative with
the n-gram and the node-subset draft and the adaptive window, and the SLO
node ladder; each stream against its request run alone under the near-tie
rule at a bf16 tolerance it measures, verify against plain decode
dispatches, K1 launches against the dispatches that call it, the ladder's
steps; timed, one serve profiled. Phase T3 trains full-width
SmolLM-360M-stlt in bf16 (fp32 masters, remat) at 8 x 1024 tokens a step:
step 0 with remat against remat off and against fp32 compute (loss and
every grad leaf), 5 AdamW steps (96 K1 launches each), timed, the peak
memory with remat full, dots and off, one step profiled; then the
paper-small preset through the training CLI with a checkpoint directory,
a run stopped after its checkpoint and resumed, against two straight runs.
It
checks chunked prefill and card-vs-CPU agreement on both models, then
times the kernels (each also
without its host work; K1 at each of its phase 2 shapes, K2 at
batch 1 and at N = 8192; each beside its fp32 and 3xTF32 tensor-core
bounds), their plain versions and the library yardstick, times a batch-1
prefill of a 131,072-token prompt, and profiles it, one ``generate`` and
one relevance forward. ``tools/ab_port.py`` compares two trees of the
port on one card.

Output ends with three lines: the card's name and power limit (from
``nvidia-smi``), a JSON ``{"kernels": [...]}`` line, and the JSON result
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result; so it does without a CUDA device, and
outside a checkout of the repository (it imports ``repro_torch`` from
``src/``). Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, dense TF32 on the tensor cores, and HBM3 bandwidth. K1 and K2
# run their products as 3xTF32 on the tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# K1 vs its plain version on the card: the kernel's products are 3xTF32
# (about fp32's rounding, but the tensor cores truncate as they sum, over
# 3 (C + 2S)/8 = 96 k-steps an output), the plain version's fp32, summed in
# different orders over up to C + 2S terms per output and nc carry steps.
K1_TOL = 2e-4         # max abs error / (1 + max |reference|)
# K1's shapes (rows, tokens, nodes): stlt-base's rows (8 heads, S = 64) at
# batch 4 and batch 1 over the main path's 1000 tokens, batch 1 over a
# 131,072-token prompt, serve's two admission shapes, [1, chunk] and
# [slots, chunk] at chunk 512, 4 slots, and the largest of phase S's wave
# prefills, 4 prompts padded to 3000 tokens; then phase P's SmolLM-360M-stlt
# rows (15 heads, S = 32): [1, 512] (admission, the node draft's prompt
# prefill) and [4, 512] (admission), and [4, k + 1] = 60 x 5, the verify
# window resumed from h0 and the node draft's commit with per-row valid.
# Last, phase T3's training rows: SmolLM-360M-stlt at batch 8 x 1024 tokens
# (8 x 15 heads, S = 32), forward, remat recompute and the anti-causal dx.
K1_SHAPES = ((32, 1000, 64), (8, 1000, 64), (8, 131072, 64), (8, 512, 64),
             (32, 512, 64), (32, 3000, 64), (15, 512, 32), (60, 512, 32), (60, 5, 32),
             (120, 1024, 32))
K1_VERIFY = (60, 5, 32)
K1_TRAIN = (120, 1024, 32)
LONG_N = 131072
# logits through 6 full-width layers: chunked vs monolithic prefill and
# card vs CPU differ only by fp32 summation order (logit scale ~0.5).
LOGIT_TOL = 1e-3
# K2 vs its plain version (and vs the plain version in float64). The kernel
# builds the pole powers by repeated multiplication, the plain version in
# closed form (exp(p log|lambda|), cos(p theta)), so scores differ by ~1e-7
# of their size; its 3xTF32 products are close to fp32's, but the tensor
# cores truncate as they accumulate, so its scores err by 25-31x fp32's
# rounding (phase 2c), ~2e-5 of |z| at O(1) scores. At the real scale
# (unit-variance x, |lambda| up to e^(-1/32)) the scores reach the thousands
# and the softmax is near one-hot, so z moves by up to ~1e-3 |v|: elementwise
# 2e-3 + 2e-3 |z|, the JAX package's own tiled-vs-materialized tolerance.
K2_TOL = 2e-3
# With x scaled so the largest score is O(1), or 30 (mid scale: neither
# one-hot nor flat), the softmax is smooth and the error is the scores'
# rounding times |v|: 2e-4 of (1 + max |z|). One TF32 product per pair
# misses this at the mid scale (tests/test_torch_k2_precision.py).
K2_UNIT_TOL = 2e-4
# relevance logits, card vs CPU. At random init the relevance scores reach
# the thousands, so the model amplifies fp32 rounding: a relative change e
# in a score moves it by e|R|, and the near-one-hot softmax passes that on.
# K2 builds L by the one-step recurrence, the plain version by closed-form
# powers inside tiles: both are fp32-exact to a few ulps, but not the same
# ulps. So: logits within 5e-2 at a logit scale of ~2, and at least 99% of
# positions with the same argmax. A CPU rerun at another tile (summation
# order only) is printed beside it as the floor of the spread.
REL_LOGIT_TOL = 5e-2
# full-width training, step 0, card vs CPU from the same weights, batch and
# mask draws: fp32 everywhere but K1's 3xTF32 products (~1e-6 of the scale,
# phase 2) and summation order; loss and ce relative, each grad leaf
# ||g_card - g_cpu|| / ||g_cpu||.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# Phase T3 (SmolLM-360M-stlt, bf16, 8 x 1024). Remat on vs off, step 0 on
# the card: remat reruns the same kernels on the same inputs, so only the
# param grads' atomic sums (scatter_add_) may come out in another order:
# TRAIN_LOSS_TOL and TRAIN_GRAD_TOL again. bf16 compute vs fp32 compute from
# the same fp32 masters: loss relative, each grad leaf ||g_bf16 - g_fp32|| /
# ||g_fp32||. Set from tools/phase_t3_gaps.py's reading on an H100 (PERF.md,
# phase T3): loss 3.0e-6 (an average over 8192 tokens), worst leaf 0.043
# (layers/0/stlt/nodes/u_re); the loss gate is a quarter of a bf16 ulp
# (2^-8), the grad gate 3.5x the reading.
T3_B, T3_N = 8, 1024
T3_BF16_LOSS_TOL = 1e-3
T3_BF16_GRAD_TOL = 0.15
# paper-small through the CLI: a run resumed at step 3 of 6 against an
# uninterrupted one, as far apart as two uninterrupted runs (max abs over
# params and moments) twice over, plus this (absolute; weights are O(1))
RESUME_ATOL = 1e-6

def log(msg: str):
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int, launches: int = 0) -> dict:
    """Kernel time on the device per call of ``fn``, by kernel name: the
    profiler's device time over ``calls`` calls (gaps between kernels
    excluded), over ``calls``. A profile is whole when it recorded each of
    its kernels a multiple of ``calls`` times and, with ``launches``,
    ``launches`` kernels a call. The profiler can miss kernels (its first
    session in a process may record none, a later one only some of the
    calls), so a profile that is not whole is taken again, up to three
    takes; if none is whole, the result is empty."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = [e.count for e in events]
        if (events and all(c % calls == 0 for c in counts)
                and (not launches or sum(counts) == launches * calls)):
            return {e.key: e.self_device_time_total / 1e3 / calls for e in events}
    return {}


def kernel_name(key: str) -> str:
    """A kernel's name without its namespace and arguments."""
    found = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
    return found.group(1) if found else key[:40]


def k1_bound(BH, N, d, C, S, valid):
    """(bound_ms, bound_fp32_ms, bound_by, flops, bytes) of one K1 call on
    this call's data. ``bound_ms`` is the least time for the work as the
    kernel does it: its products as 3xTF32 on the tensor cores (three TF32
    products for each fp32 one, at the TF32 peak) and the carries' decay at
    the fp32 rate, or the bytes it must move (inputs read once, outputs
    written once) over HBM if they take longer; ``bound_by`` names which.
    ``bound_fp32_ms`` is the same with every flop as fp32 FMA."""
    nc = -(-N // C)
    n_local = np.arange(N) % C
    # z row n: the lower-triangular Toeplitz row (n mod C + 1 taps) plus the
    # carry injection A h_re + B h_im (2S taps), d columns, 2 flops a tap
    prods = BH * d * 2.0 * float((n_local + 1 + 2 * S).sum())
    # carry into chunks 1..nc-1: [Pre; Pim] X_c (2S x C) and the decay
    prods += BH * (nc - 1) * d * 2.0 * 2 * S * C
    decay = BH * (nc - 1) * d * 8.0 * S
    # the gated snapshot: 2S x r taps with r the live in-chunk offset
    q = valid.astype(np.int64)
    r = np.where(q > 0, q - np.maximum(q - 1, 0) // C * C, 0)
    prods += float((d * 2.0 * 2 * S * r).sum())
    decay += float((d * 8.0 * S * (q > 0)).sum())
    flops = prods + decay
    # operators: M [C, C], A, B [C, S], Pre, Pim, Spre, Spim [S, C], decays;
    # a window shorter than a chunk (verify, commit) needs only their first
    # c = min(C, N) rows or columns
    c = min(C, N)
    nbytes = 4 * BH * (2 * N * d + 4 * S * d) + 4 * BH * (c * c + 6 * c * S + 4 * S) \
        + 4 * BH * nc
    t_tc = 3 * prods / PEAK_TF32_FLOPS + decay / PEAK_FP32_FLOPS
    t_fp32, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_tc, t_bytes), 1e3 * max(t_fp32, t_bytes),
            "operations" if t_tc >= t_bytes else "bytes", flops, nbytes)


def k1_case(k1, ops, dev, BH, N, C, S, d, seed):
    """K1's inputs at random poles (|lambda| in [e^-0.502, e^-0.002], angles in
    [-pi/4, pi/4]), h0 != 0 and per-row valid cycling 0, 1, min(C, N), N: returns
    (the kernel's arguments, valid as numpy, the raw inputs of
    ``ops.stlt_scan``: x, log_mag, theta, u_re, u_im, h0_re, h0_im, valid)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(BH, N, d, generator=g, device=dev)
    lm = -(0.002 + 0.5 * torch.rand(BH, S, generator=g, device=dev))
    th = (torch.pi / 2) * torch.rand(BH, S, generator=g, device=dev) - torch.pi / 4
    ur, ui = (torch.randn(BH, S, generator=g, device=dev) / S for _ in range(2))
    h0r, h0i = (torch.randn(BH, S, d, generator=g, device=dev) for _ in range(2))
    valid_np = np.array([(0, 1, min(C, N), N)[i % 4] for i in range(BH)], np.int32)
    valid = torch.from_numpy(valid_np).to(dev)
    gf, A, Bm, pre, pim, dec = ops._filter_ops(lm, th, ur, ui, C)
    nc = -(-N // C)
    spre, spim, sdec, gate = ops._snapshot_ops(lm, th, valid, N, C, nc)
    args = [gate] + [t.contiguous() for t in (x, ops._toeplitz(gf), A, Bm, pre, pim,
                                              dec, h0r, h0i, spre, spim, sdec)]
    return args, valid_np, (x, lm, th, ur, ui, h0r, h0i, valid)


def k1_kernel_alone(k1, args, C):
    """A closure that launches K1's kernels on ``args`` with the wrapper's
    host work (input checks, allocations) done once up front: the kernel's
    own time. Not counted as a launch of the wrapper."""
    tensors, sizes = k1._kernel_args(*args, chunk=C)
    return lambda: k1._launch(tensors, sizes)


def k1_timings(k1, ops, dev, C, d):
    """K1 at each of ``K1_SHAPES``: the kernel alone, the wrapper's call and
    the whole ``ops.stlt_scan`` call (host operators included), by CUDA
    events, and the kernel's device time (profiler, launch gaps excluded),
    beside its bounds. Returns {(BH, N, S): row}."""
    out = {}
    for BH, N, S in K1_SHAPES:
        args, valid_np, raw = k1_case(k1, ops, dev, BH, N, C, S, d, seed=5)
        iters = 50 if N <= 1000 else 5
        x, lm, th, ur, ui, h0r, h0i, valid = raw
        alone = k1_kernel_alone(k1, args, C)
        kernels = device_ms(alone, 10, launches=4)   # pack, carry_in, carry_scan, readout
        row = {
            "alone": time_cuda(alone, iters),
            "device": sum(kernels.values()) if kernels else None,
            "call": time_cuda(lambda: k1.stlt_scan_kernel(*args, chunk=C), iters),
            "scan": time_cuda(lambda: ops.stlt_scan(
                x, lm, th, ur, ui, chunk=C, h0_re=h0r, h0_im=h0i, valid=valid,
                return_state=True), iters)}
        bound_ms, fp32_ms, bound_by, flops, nbytes = k1_bound(BH, N, d, C, S, valid_np)
        row.update(bound=bound_ms, bound_fp32=fp32_ms, bound_by=bound_by)
        device = "not measured" if kernels == {} else f"{row['device']:.4f} ms"
        log(f"[6 timing] K1 at BH={BH} N={N} S={S}: kernel alone {row['alone']:.4f} ms "
            f"(device time {device}), call {row['call']:.4f} ms, "
            f"ops.stlt_scan {row['scan']:.4f} ms; bound {bound_ms:.4f} ms 3xTF32 "
            f"tensor cores ({bound_by}) / {fp32_ms:.4f} ms fp32 FMA "
            f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        log("[6 timing]   device time by kernel: " + ", ".join(
            f"{kernel_name(k)} {v:.4f} ms" for k, v in kernels.items()))
        out[(BH, N, S)] = row
        del args, raw
    return out


def long_prefill(T, cfg, params, dev, scan_ms, k1_counter):
    """A batch-1 prefill of a LONG_N-token prompt by CUDA events, 6 x K1's
    ``ops.stlt_scan`` time at that shape (``scan_ms``) as a share of it, and
    one profile of it. Checks one K1 launch per layer and finite logits."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(1, LONG_N))).to(dev)
    with torch.no_grad():
        k1_counter.launches = 0
        logits, _ = T.prefill(params, cfg, toks, LONG_N)
        torch.cuda.synchronize()
        if k1_counter.launches != cfg.num_layers or not torch.isfinite(logits).all():
            raise AssertionError(f"long prefill: {k1_counter.launches} K1 launches, "
                                 f"finite logits {bool(torch.isfinite(logits).all())}")
        ms = time_cuda(lambda: T.prefill(params, cfg, toks, LONG_N), iters=3, warmup=1)
        log(f"[6 timing] prefill 1 x {LONG_N} tokens: {ms:.3f} ms (events); "
            f"{cfg.num_layers} x K1 ({scan_ms:.4f} ms an ops.stlt_scan call) = "
            f"{100 * cfg.num_layers * scan_ms / ms:.1f}% of it")
        profile(lambda: T.prefill(params, cfg, toks, LONG_N), f"prefill 1 x {LONG_N}")


def k2_inputs(dev, BH, N, dh, S, seed, adversarial: bool, x_scale: float = 1.0):
    """K2's inputs at stlt-base's poles (sigma log-spaced over [1e-3, 1] plus
    the 1/32 window, omega in [0, pi/4]). ``adversarial`` zeroes every fifth
    node mask, pads the last 37 keys of row 1 and masks all keys of row 2;
    otherwise the masks are soft and every key is valid, as on the main
    path."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = x_scale * torch.randn(BH, N, dh, generator=g, device=dev)
    v = torch.randn(BH, N, dh, generator=g, device=dev)
    sig = torch.logspace(-3, 0, S, device=dev)
    lm = -(sig + 1 / 32.0).repeat(BH, 1) * (1 + 0.01 * torch.randn(
        BH, S, generator=g, device=dev))
    th = -(np.pi / 4) * torch.rand(BH, S, generator=g, device=dev)
    mk = 0.2 + 0.8 * torch.rand(BH, S, generator=g, device=dev)
    km = torch.ones(BH, N, device=dev)
    if adversarial:
        mk[:, ::5] = 0.0
        km[1, N - 37:] = 0.0
        km[2] = 0.0
    return x, v, lm, th, mk, km


def k2_coefficients(k2, x, lm, th, km, causal):
    """L re/im [BH, N, S, dh] through the plain version's tile operators."""
    T = 128
    BH, N, dh = x.shape
    xp, _, _ = k2._pad_tiles(x, x, km, T)
    ops = k2._flash_ops(xp, lm, th, T, bidirectional=not causal)
    zero = torch.zeros_like(ops["hc_re"][:, 0])
    tiles = [k2._reconstruct(xp[:, c * T:(c + 1) * T], ops, ops["hc_re"][:, c],
                             ops["hc_im"][:, c],
                             zero if causal else ops["gc_re"][:, c],
                             zero if causal else ops["gc_im"][:, c], not causal)
             for c in range(xp.shape[1] // T)]
    return (torch.cat([t[0] for t in tiles], 1)[:, :N],
            torch.cat([t[1] for t in tiles], 1)[:, :N])


def k2_max_score(k2, x, lm, th, mk, km, causal):
    """max_n R[n, n] = sum_k mk_k |L[n, k]|^2 / sqrt(S), the largest score
    (R[n, m] <= sqrt(R[n, n] R[m, m]) for mk >= 0)."""
    l_re, l_im = k2_coefficients(k2, x, lm, th, km, causal)
    S = lm.shape[-1]
    diag = (mk[:, None, :, None] * (l_re ** 2 + l_im ** 2)).sum((-1, -2))
    return float(diag.max()) / S ** 0.5


def k2_bound(mk, km, dh, causal):
    """(bound_ms, fp32_bound_ms, bound_by, flops, bytes) of one K2 call on
    these inputs: per (query, valid key) pair, 2 * 2 * dh flops for each node
    whose mask is not 0 (the kernel skips the others) and 2 * dh for P.v;
    bytes: x, v read, z written, and the [BH, S] / [BH, N] side inputs.
    ``bound_ms`` is the least time for the work as the kernel does it: the
    score contraction and P.v both as 3xTF32 on the tensor cores (three TF32
    products for each fp32 one, at the TF32 peak), or the bytes if they take
    longer; ``fp32_bound_ms`` the same with every flop as fp32 FMA."""
    BH, N = km.shape
    S = mk.shape[-1]
    valid = (km > 0).double()
    if causal:   # keys m <= n: sum_n (valid keys in [0, n])
        pairs = valid.cumsum(-1).sum(-1)
    else:
        pairs = valid.sum(-1) * N
    active = (mk != 0).double().sum(-1)
    score = float((pairs * 4.0 * dh * active).sum())
    pv = float((pairs * 2.0 * dh).sum())
    nbytes = 4 * (3 * BH * N * dh + 3 * BH * S + BH * N)
    t_tc = 3 * (score + pv) / PEAK_TF32_FLOPS
    t_fp32 = (score + pv) / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_tc, t_bytes), 1e3 * max(t_fp32, t_bytes),
            "operations" if t_tc >= t_bytes else "bytes", score + pv, nbytes)


def tc_accumulation(k2, a, scale_name):
    """Scores of row 0 of K2's inputs ``a`` (causal coefficients, the
    operands K2 contracts) against float64: fp32 FMA, and K2's 3xTF32 split
    summed once in IEEE fp32 (CUDA cores) and once on the tensor cores (a
    TF32 GEMM of the same TF32-exact operands and products). Their
    difference is the tensor cores' own accumulation; the share of scores
    whose magnitude shrank shows its rounding direction (a half under
    round-to-nearest)."""
    x, _, lm, th, mk, km = (t[:1] for t in a)
    l_re, l_im = k2_coefficients(k2, x, lm, th, km, causal=True)
    k = torch.cat([l_re, l_im], -1)[0].flatten(1)                # [N, 2 S dh]
    q = (mk[0][:, None] * torch.cat([l_re, l_im], -1)[0]).flatten(1)
    exact = q.double() @ k.double().T

    def bits(t):
        return t.contiguous().view(torch.int32)

    def split(t):
        hi = ((bits(t) + 0x1000) & -0x2000).view(torch.float32)   # nearest (add, mask)
        return hi, (bits(t - hi) & -0x2000).view(torch.float32)  # lo as the cores read it

    (qh, ql), (kh, kl) = split(q), split(k)
    a3, b3 = torch.cat([ql, qh, qh], -1), torch.cat([kh, kl, kh], -1)
    out = {"fp32 FMA": q @ k.T, "3xTF32 in IEEE fp32": a3 @ b3.T}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["3xTF32 on the tensor cores"] = a3 @ b3.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    parts = []
    for name, r in out.items():
        err = (r.double() - exact).abs().max()
        shrank = ((r.double().abs() < exact.abs()).double().mean())
        parts.append(f"{name} {float(err):.3e} ({100 * float(shrank):.1f}% shrank)")
    log(f"[2c score accumulation] {scale_name} scale, row 0, scores to "
        f"{float(exact.abs().max()) / lm.shape[-1] ** 0.5:.4g}: max abs err of "
        f"the unscaled scores against float64: " + ", ".join(parts))


def k2_kernel_alone(k2, a, causal):
    """A closure that launches K2's kernel on inputs ``a`` with the wrapper's
    host work (input checks, carries) done once up front: the kernel's own
    time. Not counted as a launch of the wrapper."""
    tensors, sizes = k2._kernel_args(*a, causal=causal)
    return lambda: k2._launch(tensors, sizes)


def vjp_case(dev, B, H, N, S, d, C, seed):
    """The training scan's inputs at stlt-base's poles: nodes from
    ``init_nodes`` (H heads, repeated over B rows, H fastest), mixers u
    masked per row by random masks in (0, 1), x and dz normal. Returns
    (x, log_mag, theta, u_re, u_im, dz) with B*H rows."""
    from repro_torch.core import nodes as nodes_lib

    g = torch.Generator(device=dev).manual_seed(seed)
    nodes = nodes_lib.init_nodes(g, H, S, device=dev)
    lm, th, _, _ = nodes_lib.node_poles(nodes)
    masks = torch.rand(B, H, S, generator=g, device=dev)
    ur = (nodes["u_re"][None] * masks).reshape(B * H, S)
    ui = (nodes["u_im"][None] * masks).reshape(B * H, S)
    x = torch.randn(B * H, N, d, generator=g, device=dev)
    dz = torch.randn(B * H, N, d, generator=g, device=dev)
    return x, lm.repeat(B, 1), th.repeat(B, 1), ur, ui, dz


def scan_vjp_check(k1, ops, dev, B, H, N, S, d, C, reverse) -> float:
    """Phase T1: ``ops._StltScan`` on the card (K1 forward, K1 anti-causal
    for dx, analytic pole/mixer grads) against torch autograd through the
    plain version in float64 on the card. Asserts two K1 launches and each
    grad within K1_TOL of (1 + its largest entry); returns the largest
    error over the scale."""
    x, lm, th, ur, ui, dz = vjp_case(dev, B, H, N, S, d, C, seed=11)
    ins = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    k1.stlt_scan_kernel.launches = 0
    z = ops.stlt_scan(*ins, chunk=C, reverse=reverse)
    got = torch.autograd.grad(z, ins, dz)
    torch.cuda.synchronize()
    if k1.stlt_scan_kernel.launches != 2:
        raise AssertionError(f"T1: {k1.stlt_scan_kernel.launches} K1 launches per "
                             f"forward + backward, expected 2")
    ref = [t.double().requires_grad_(True) for t in (x, lm, th, ur, ui)]
    z64 = ops._pass(ref[0], ops._operators(*ref[1:], C), C, reverse,
                    k1.stlt_scan_reference)[0]
    want = torch.autograd.grad(z64, ref, dz.double())
    worst = 0.0
    parts = []
    for name, a, b in zip(("z", "dx", "dlog_mag", "dtheta", "du_re", "du_im"),
                          (z.detach(), *got), (z64.detach(), *want)):
        err = float((a.double() - b).abs().max())
        scale = 1.0 + float(b.abs().max())
        worst = max(worst, err / scale)
        parts.append(f"{name} {err:.3e} (scale {scale:.3e})")
        if not err <= K1_TOL * scale:
            raise AssertionError(f"T1: {name} at N={N}, reverse={reverse}: {err} > "
                                 f"{K1_TOL} * {scale}")
    log(f"[T1 scan VJP] BH={B * H} N={N} reverse={reverse}: " + ", ".join(parts)
        + f"; worst {worst:.3e} of the scale (gate {K1_TOL})")
    return worst


ANNOTATIONS = ("stlt_scan.param_grads",)   # ops._StltScan's record_function
K1_KERNEL = re.compile(r"\bk1_(pack|carry_in|carry_scan|readout)\b")


GEMM_KERNELS = ("gemm", "nvjet")   # cuBLAS's fp32 (xmma gemm) and bf16 (nvjet) kernels


def k1_calls_per_step(cfg) -> int:
    """K1 calls in one forward + backward: each layer's forward, its remat
    recompute in backward when ``cfg.remat`` is set, and its dx."""
    return (3 if cfg.remat else 2) * cfg.num_layers


def train_profile(fn, cfg, tag: str) -> dict:
    """One profiled train step: the device's busy share of the wall (kernel
    time summed; the ``ops`` annotations' GPU spans excluded), K1's device
    time split into its forward, remat recompute and dx calls by launch
    order (the first L calls are the forward's; then each layer's backward
    makes its recompute and its dx call, last layer first), the analytic
    param grads' device time and host time (its annotation), and the
    GEMMs' device time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if e.device_type == cuda and e.name not in ANNOTATIONS]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1_events = sorted((e for e in kernels if K1_KERNEL.search(e.name)),
                       key=lambda e: e.time_range.start)
    L, per = cfg.num_layers, 4                       # 4 kernels a K1 call
    if len(k1_events) != per * k1_calls_per_step(cfg):
        raise AssertionError(f"{tag} profile: {len(k1_events)} K1 kernels, expected "
                             f"{per * k1_calls_per_step(cfg)}")
    ms = [e.time_range.elapsed_us() / 1e3 for e in k1_events]
    k1_fwd, bwd = sum(ms[:per * L]), ms[per * L:]
    if cfg.remat:     # per layer: [recompute: 4 kernels][dx: 4 kernels]
        k1_re = sum(t for i, t in enumerate(bwd) if i % (2 * per) < per)
        k1_dx = sum(bwd) - k1_re
    else:
        k1_re, k1_dx = 0.0, sum(bwd)
    grads = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name == "stlt_scan.param_grads"]
    pg_dev = sum(e.device_time_total for e in grads) / 1e3
    pg_host = sum(e.cpu_time_total for e in grads) / 1e3
    gemm = sum(e.time_range.elapsed_us() for e in kernels
               if any(k in e.name.lower() for k in GEMM_KERNELS)) / 1e3
    k1_all = k1_fwd + k1_re + k1_dx
    out = {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms,
           "k1_fwd_ms": k1_fwd, "k1_recompute_ms": k1_re, "k1_dx_ms": k1_dx,
           "k1_share": k1_all / busy, "param_grads_ms": pg_dev,
           "param_grads_host_ms": pg_host, "gemm_ms": gemm, "launches": len(kernels)}
    log(f"[{tag} profile] one step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms = {100 * busy / wall_ms:.1f}% of wall, {len(kernels)} kernel "
        f"launches; K1 forward {k1_fwd:.4f} ms ({L} calls, {k1_fwd / L:.4f} ms each), "
        f"remat recompute {k1_re:.4f} ms, dx {k1_dx:.4f} ms ({k1_dx / L:.4f} ms each), "
        f"together {100 * k1_all / busy:.1f}% of device time; analytic param grads "
        f"{pg_dev:.3f} ms of device time ({100 * pg_dev / busy:.1f}%), {pg_host:.2f} ms "
        f"of host time ({100 * pg_host / wall_ms:.1f}% of the wall); GEMMs {gemm:.3f} ms "
        f"({100 * gemm / busy:.1f}%)")
    rows = {}
    for e in kernels:
        r = rows.setdefault(kernel_name(e.name), [0.0, 0])
        r[0] += e.time_range.elapsed_us() / 1e3
        r[1] += 1
    for name, (t, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag} profile]   {t:9.3f} ms  {count:6d}x  {100 * t / busy:5.1f}%  {name[:70]}")
    return out


def train_phase(T, train, k1, cfg, dev, B, N) -> dict:
    """Phase T2: full-width training. Step 0 on the card against the port on
    the CPU from the same weights, batch and mask draws (loss, ce, every
    grad leaf; every leaf's grad finite and non-zero), then 5 AdamW steps on
    the card (18 K1 launches a step: stlt-base keeps remat on), timed by
    CUDA events, and one more step profiled."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.adaptive import anneal_tau
    from repro_torch.data import lm_batch_stream
    from repro_torch.utils import tree_map

    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=5, seed=0)
    H, S = cfg.num_heads, cfg.stlt_nodes
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def batch(step, where):
        return {k: torch.from_numpy(v).to(where)
                for k, v in lm_batch_stream(0, step, B, N, cfg.vocab).items()}

    g = torch.Generator().manual_seed(1)
    draws = [torch.rand(B, H, S, generator=g) * (1 - 2e-6) + 1e-6
             for _ in range(cfg.num_layers)]
    tau = anneal_tau(0, tcfg.total_steps)
    k1.stlt_scan_kernel.launches = 0
    t0 = time.time()
    loss_g, m_g, g_card = train.loss_and_grads(params, cfg, batch(0, dev), tau=tau,
                                               draws=[u.to(dev) for u in draws])
    torch.cuda.synchronize()
    first = time.time() - t0
    if k1.stlt_scan_kernel.launches != k1_calls_per_step(cfg):
        raise AssertionError(f"T2: {k1.stlt_scan_kernel.launches} K1 launches in a "
                             f"forward + backward, expected {k1_calls_per_step(cfg)}")
    t0 = time.time()
    loss_c, m_c, g_cpu = train.loss_and_grads(tree_map(torch.Tensor.cpu, params), cfg,
                                              batch(0, "cpu"), tau=tau, draws=draws)
    cpu_s = time.time() - t0
    rel = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k])) for k in ("loss", "ce")}
    log(f"[T2 step 0] card {first:.2f} s (first call), CPU {cpu_s:.2f} s: loss "
        f"{float(loss_g):.6f} vs {float(loss_c):.6f}, ce {float(m_g['ce']):.6f} vs "
        f"{float(m_c['ce']):.6f} (relative {rel['loss']:.2e}, {rel['ce']:.2e}; gate "
        f"{TRAIN_LOSS_TOL})")
    if not max(rel.values()) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"T2: card and CPU loss disagree: {rel}")
    path, worst, n_leaves = grad_gaps(tree_map(torch.Tensor.cpu, g_card), g_cpu,
                                      "T2 card vs CPU")
    log(f"[T2 step 0] {n_leaves} grad leaves, all finite and non-zero on both; worst "
        f"||g_card - g_cpu|| / ||g_cpu|| {worst:.3e} ({path}; gate {TRAIN_GRAD_TOL})")
    if not worst <= TRAIN_GRAD_TOL:
        raise AssertionError(f"T2: grad of {path}: card vs CPU relative {worst} > "
                             f"{TRAIN_GRAD_TOL}")
    del g_card, g_cpu

    opt, step_fn = train.make_step(cfg, tcfg)
    opt_state = opt.init(params)
    ev_ms, walls, losses, counts = [], [], [], []
    for step in range(tcfg.total_steps):
        b = batch(step, dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = k1.stlt_scan_kernel.launches
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        params, opt_state, metrics = step_fn(params, opt_state, b, step)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t0))
        ev_ms.append(start.elapsed_time(end))
        n = k1.stlt_scan_kernel.launches - before
        counts.append(n)
        losses.append(float(metrics["loss"]))
        log(f"[T2 train] step {step}: loss {losses[-1]:.6f} ce {float(metrics['ce']):.6f} "
            f"grad_norm {float(metrics['grad_norm']):.4f} s_eff "
            f"{float(metrics['s_eff']):.2f}; {ev_ms[-1]:.3f} ms (events), "
            f"{walls[-1]:.3f} ms (wall), {n} K1 launches")
        if n != k1_calls_per_step(cfg) or not np.isfinite(losses[-1]):
            raise AssertionError(f"T2 step {step}: {n} K1 launches, loss {losses[-1]}")
    med = float(np.median(ev_ms[1:]))
    log(f"[T2 train] {B} x {N} tokens a step: median step {med:.3f} ms by CUDA events "
        f"over steps 1-4 ({[round(t, 3) for t in ev_ms[1:]]}), wall "
        f"{float(np.median(walls[1:])):.3f} ms; {B * N / (med / 1e3):.1f} training "
        f"tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    b = batch(tcfg.total_steps, dev)
    prof = train_profile(lambda: step_fn(params, opt_state, b, tcfg.total_steps),
                         cfg, "T2")
    # K1's launches in the last timed step, as counted (every step's count
    # was checked above)
    return {"step_ms": med, "tok_s": B * N / (med / 1e3), "losses": losses,
            "launches_per_step": counts[-1], **prof}


def grad_gaps(a: dict, b: dict, what: str) -> tuple:
    """(worst leaf, worst ||a - b|| / ||b||, leaves) over two grad trees;
    raises if a leaf of either is not finite or is zero."""
    from repro_torch.utils import tree_flatten_with_paths

    worst, n = ("", 0.0), 0
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a), tree_flatten_with_paths(b)):
        for t in (x, y):
            if not (bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0):
                raise AssertionError(f"{what}: grad of {path} is not finite or is zero")
        r = float(torch.linalg.vector_norm((x - y).double())
                  / torch.linalg.vector_norm(y.double()))
        n += 1
        if r >= worst[1]:
            worst = (path, r)
    return worst[0], worst[1], n


def smollm_train_phase(T, train, k1, cfg, dev, B, N) -> dict:
    """Phase T3: SmolLM-360M-stlt trained in bf16 (fp32 masters, the
    matrices cast inside the loss, remat on) at B x N tokens a step through
    K1. Step 0 with remat against remat off (K1 launches 3L and 2L), and
    against fp32 compute from the same masters: loss and every grad leaf,
    finite and non-zero, within the stated tolerances. Then 5 AdamW steps,
    timed by CUDA events (3L K1 launches each), one step's peak memory with
    remat full, dots and off, and one profiled step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch_stream

    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=5, seed=0)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def batch(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in lm_batch_stream(0, step, B, N, cfg.vocab).items()}

    b0 = batch(0)
    runs = {}
    # the first call pays one-time costs (and a CPU rehearsal's first bf16
    # products may round differently), so it is not compared
    for name, c in (("first call", cfg), ("remat", cfg),
                    ("no remat", dataclasses.replace(cfg, remat=False)),
                    ("fp32 compute", dataclasses.replace(cfg, dtype="float32"))):
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        loss, metrics, grads = train.loss_and_grads(params, c, b0, tau=1.0)
        torch.cuda.synchronize()
        n = k1.stlt_scan_kernel.launches
        log(f"[T3 step 0] {name}: loss {float(loss):.6f}, {time.time() - t0:.2f} s, "
            f"{n} K1 launches")
        if n != k1_calls_per_step(c) or not torch.isfinite(loss):
            raise AssertionError(f"T3 {name}: {n} K1 launches (expected "
                                 f"{k1_calls_per_step(c)}), loss {float(loss)}")
        runs[name] = (float(loss), grads)
    gaps = {}
    for name, ref, loss_tol, grad_tol in (
            ("no remat", "remat", TRAIN_LOSS_TOL, TRAIN_GRAD_TOL),
            ("fp32 compute", "remat", T3_BF16_LOSS_TOL, T3_BF16_GRAD_TOL)):
        rel = abs(runs[ref][0] - runs[name][0]) / abs(runs[name][0])
        path, worst, n = grad_gaps(runs[ref][1], runs[name][1], f"T3 {ref} vs {name}")
        gaps[name] = {"loss": rel, "grad": worst, "leaf": path}
        log(f"[T3 step 0] bf16 remat vs {name}: loss relative {rel:.3e} (gate {loss_tol}), "
            f"{n} grad leaves all finite and non-zero, worst ||g - g_ref|| / ||g_ref|| "
            f"{worst:.3e} ({path}; gate {grad_tol})")
        if not (rel <= loss_tol and worst <= grad_tol):
            raise AssertionError(f"T3: bf16 remat vs {name}: loss {rel}, grad {worst} "
                                 f"at {path}")
    del runs

    opt, step_fn = train.make_step(cfg, tcfg)
    opt_state = opt.init(params)
    ev_ms, walls, counts = [], [], []
    for step in range(tcfg.total_steps):
        b = batch(step)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        k1.stlt_scan_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        params, opt_state, metrics = step_fn(params, opt_state, b, step)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t0))
        ev_ms.append(start.elapsed_time(end))
        counts.append(k1.stlt_scan_kernel.launches)
        loss = float(metrics["loss"])
        log(f"[T3 train] step {step}: loss {loss:.6f} grad_norm "
            f"{float(metrics['grad_norm']):.4f}; {ev_ms[-1]:.3f} ms (events), "
            f"{walls[-1]:.3f} ms (wall), {counts[-1]} K1 launches")
        if counts[-1] != k1_calls_per_step(cfg) or not np.isfinite(loss):
            raise AssertionError(f"T3 step {step}: {counts[-1]} K1 launches, loss {loss}")
    med = float(np.median(ev_ms[1:]))
    log(f"[T3 train] {B} x {N} tokens a step: median step {med:.3f} ms by CUDA events "
        f"over steps 1-4 ({[round(t, 3) for t in ev_ms[1:]]}), wall "
        f"{float(np.median(walls[1:])):.3f} ms; {B * N / (med / 1e3):.1f} training "
        f"tokens/s")

    b = batch(tcfg.total_steps)
    memory = {}
    for mode in ("full", "dots", "off"):
        c = dataclasses.replace(cfg, remat=mode != "off",
                                remat_policy="full" if mode == "off" else mode)
        _, fn = train.make_step(c, tcfg)
        fn(params, opt_state, b, tcfg.total_steps)            # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = time_cuda(lambda: fn(params, opt_state, b, tcfg.total_steps), iters=2,
                       warmup=0)
        peak = torch.cuda.max_memory_allocated()
        memory[mode] = {"peak_gib": peak / 2**30, "held_gib": held / 2**30, "step_ms": ms}
        log(f"[T3 memory] remat {mode}: peak {peak / 2**30:.2f} GiB over a step (params "
            f"and AdamW state held: {held / 2**30:.2f} GiB), step {ms:.3f} ms (events, "
            f"mean of 2)")
    prof = train_profile(lambda: step_fn(params, opt_state, b, tcfg.total_steps), cfg, "T3")
    return {"step_ms": med, "tok_s": B * N / (med / 1e3), "launches_per_step": counts[-1],
            "gaps": gaps, "memory": memory, **prof}


class Preempted(Exception):
    """Raised by ``preempting_manager``'s save: the run stops there."""


def preempting_manager(base, at_step: int):
    """A ``CheckpointManager`` class whose save of ``at_step`` finishes and
    then stops the run, as a preemption right after a checkpoint would."""
    class PreemptedAfterSave(base):
        def save(self, step, tree):
            super().save(step, tree)
            if step == at_step:
                self.wait()
                raise Preempted(f"stopped after the checkpoint of step {step}")
    return PreemptedAfterSave


def cli_resume_phase(train) -> dict:
    """The paper-small preset through ``launch.train.main`` on the card with
    ``--ckpt-dir`` in a temporary directory: 6 steps straight, twice (how far
    two uninterrupted runs are apart on this card), against a run of the
    same command stopped after its checkpoint of step 2 (3 steps) and the
    same command again, which resumes from there to 6. The resumed run's
    params and moments are within 2x the straight runs' distance plus
    RESUME_ATOL of the first."""
    import contextlib
    import io
    import tempfile

    from repro_torch.utils import tree_flatten_with_paths

    common = ["--preset", "paper-small", "--batch", "8", "--seq", "256", "--steps", "6",
              "--log-every", "1", "--save-every", "2"]

    def run(where, preempt_at=None):
        out, manager = io.StringIO(), train.CheckpointManager
        if preempt_at is not None:
            train.CheckpointManager = preempting_manager(manager, preempt_at)
        try:
            with contextlib.redirect_stdout(out):
                state = train.main(common + ["--ckpt-dir", where])
        except Preempted as stop:
            state = None
            out.write(f"{stop}\n")
        finally:
            train.CheckpointManager = manager
        torch.cuda.synchronize()
        for line in out.getvalue().splitlines():
            log(f"[T3 cli] {line}")
        return state, out.getvalue()

    def distance(a, b):
        pairs = [(x, y) for (_, x), (_, y) in zip(tree_flatten_with_paths(a),
                                                   tree_flatten_with_paths(b))
                 if isinstance(x, torch.Tensor)]
        return (max(float((x - y).abs().max()) for x, y in pairs),
                max(float(y.abs().max()) for _, y in pairs))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        straight, _ = run(f"{tmp}/a")
        again, _ = run(f"{tmp}/b")
        stopped, _ = run(f"{tmp}/r", preempt_at=2)
        resumed, text = run(f"{tmp}/r")
        wall = time.time() - t0
    if stopped is not None or "resume from step 2" not in text \
            or text.count("[train] step") != 3 or resumed["opt"]["count"] != 6:
        raise AssertionError("T3 cli: the run was not stopped at step 2 and resumed "
                             "there for steps 3-5")
    d_straight, scale = distance(again, straight)
    d_resumed, _ = distance(resumed, straight)
    log(f"[T3 cli] paper-small, 8 x 256 tokens: two straight 6-step runs max abs "
        f"{d_straight:.3e} apart, the run resumed at step 3 {d_resumed:.3e} from the "
        f"first (largest |value| {scale:.3e}; gate 2 x {d_straight:.3e} + {RESUME_ATOL}); "
        f"four runs {wall:.1f} s")
    if not d_resumed <= 2 * d_straight + RESUME_ATOL:
        raise AssertionError(f"T3 cli: resumed run {d_resumed} from the straight one, "
                             f"straight runs {d_straight} apart")
    return {"straight": d_straight, "resumed": d_resumed}


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


# Phase S's requests: (own prompt tokens, behind the shared 512-token system
# prompt?, max_new_tokens, serve_nodes, arrival tick). Prompts of 100-3000
# tokens, four of them one chunk or less; four co-pend at tick 0; one
# prefill-only request; two decode at 16 nodes; five share the system
# prompt, one of them is nothing else (a full-prompt cache hit).
SERVE_CHUNK, SERVE_SLOTS, SERVE_SYS = 512, 4, 512
SERVE_SPEC = ((2488, True, 48, None, 0), (300, False, 32, None, 0),
              (1500, False, 64, 16, 0), (100, False, 16, None, 0),
              (2000, False, 1, None, 2), (450, True, 24, None, 3),
              (900, True, 40, 16, 5), (2900, False, 8, None, 8),
              (180, False, 64, None, 12), (1200, True, 32, None, 20),
              (700, False, 16, None, 30), (0, True, 20, None, 40))


def serve_requests(cfg, Request):
    """Phase S's system prompt and requests, made from seed 2."""
    rng = np.random.default_rng(2)
    sys_prompt = rng.integers(0, cfg.vocab, SERVE_SYS).astype(np.int32)
    reqs = []
    for i, (n, shared, new, nodes, _) in enumerate(SERVE_SPEC):
        own = rng.integers(0, cfg.vocab, n).astype(np.int32)
        prompt = np.concatenate([sys_prompt, own]) if shared else own
        reqs.append(Request(prompt, new, id=i, serve_nodes=nodes))
    return sys_prompt, reqs


def near_tie(row, tok: int, what: str, tol: float = LOGIT_TOL) -> int:
    """1 when served token ``tok`` is not the argmax of the reference logits
    ``row`` but within ``tol`` of its max logit (a near tie that summation
    order may break either way), 0 when it is the argmax; raises otherwise."""
    best = int(row.argmax())
    if best == tok:
        return 0
    gap = float(row[best] - row[tok])
    if not gap < tol:
        raise AssertionError(f"{what}: served token {tok}, reference argmax {best}, "
                             f"logit gap {gap}")
    return 1


def prompt_alone(T, cfg, params, dev, prompt, chunk: int):
    """(last logits, state) of ``prompt`` run alone, folded at [1, chunk]
    (padded, per-row valid) from token 0, so its chunk boundaries are the
    engine's."""
    state = T.init_decode_state(cfg, 1, 0, device=dev)
    for off in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - off)
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :n] = prompt[off:off + n]
        logits, state = T.prefill_chunk(params, cfg, torch.from_numpy(buf).to(dev), state,
                                        valid_len=torch.tensor([n], device=dev))
    return logits, state


def alone_stream_check(T, cfg, params, dev, req, stream) -> int:
    """Request ``req`` run alone (``prompt_alone`` at SERVE_CHUNK), then
    ``decode_step`` at its node budget, fed the engine's own tokens, each
    held to the alone run's logits by ``near_tie``. Returns the number of
    near ties."""
    logits, state = prompt_alone(T, cfg, params, dev, req.prompt, SERVE_CHUNK)
    cap = torch.tensor([req.serve_nodes or cfg.stlt_nodes], dtype=torch.int32, device=dev)
    ties = 0
    for step, tok in enumerate(stream):
        ties += near_tie(logits[0], int(tok), f"S (a): request {req.id} step {step}")
        if step + 1 < len(stream):
            logits, state = T.decode_step(params, cfg, torch.tensor([int(tok)], device=dev),
                                          state, node_cap=cap)
    return ties


def wave_stream_check(T, cfg, params, dev, reqs, arrivals, served, stats):
    """Wave mode's streams against each wave run again as the engine runs it:
    ``prefill`` of the wave's prompts left-padded to its longest, then
    uncapped ``decode_step`` over the whole wave, each row fed its own served
    tokens and held to the rerun's logits by ``near_tie``. A wave is the
    requests admitted at one tick, at most SERVE_SLOTS of them in arrival
    order. Returns (the waves' padded lengths, the number of near ties)."""
    waves = []
    for i in sorted(range(len(reqs)), key=lambda i: arrivals[i]):
        r = reqs[i]
        if (waves and len(waves[-1]) < SERVE_SLOTS
                and stats[waves[-1][-1].id]["admit"] == stats[r.id]["admit"]):
            waves[-1].append(r)
        else:
            waves.append([r])
    ties = 0
    for wave in waves:
        plen = max(len(r.prompt) for r in wave)
        buf = np.zeros((len(wave), plen), np.int64)
        for b, r in enumerate(wave):
            buf[b, plen - len(r.prompt):] = r.prompt
        logits, state = T.prefill(params, cfg, torch.from_numpy(buf).to(dev), 0)
        steps = max(len(served[r.id]) for r in wave)
        for step in range(steps):
            tok = np.zeros(len(wave), np.int64)
            for b, r in enumerate(wave):
                stream = served[r.id]
                if step < len(stream):
                    ties += near_tie(logits[b], int(stream[step]),
                                     f"S (d): wave request {r.id} step {step}")
                tok[b] = stream[min(step, len(stream) - 1)]
            if step + 1 < steps:
                logits, state = T.decode_step(params, cfg, torch.from_numpy(tok).to(dev),
                                              state)
    return [max(len(r.prompt) for r in w) for w in waves], ties


def serve_profile(fn, ticks: int, k1_calls: int) -> dict:
    """One profiled call of ``fn`` (a serve, or a decode step): its wall,
    the device's busy share (kernel time summed over the wall), kernel
    launches per decode tick, and K1's share of device time. Only the
    device's kernels are recorded (host events would cost minutes to read
    back on a serve of hundreds of thousands of launches). The profiler
    can drop kernels, so a profile whose K1 kernels are not 4 x ``k1_calls``
    (or that recorded none) is taken again, up to three takes; None when no
    take is whole."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.time() - t0)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels and sum(bool(K1_KERNEL.search(e.name)) for e in kernels) == 4 * k1_calls:
            break
    else:
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1_ms = sum(e.time_range.elapsed_us() for e in kernels if K1_KERNEL.search(e.name)) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms,
            "launches": len(kernels), "launches_per_tick": len(kernels) / max(ticks, 1),
            "k1_ms": k1_ms, "k1_share": k1_ms / busy if busy else 0.0}


def serve_phase(T, k1, cfg, params, dev) -> dict:
    """Phase S: continuous ``serve`` of full-width stlt-base with a slot
    pool, two-shape masked chunked admission through K1 and the prefix
    cache; checks (a) each stream against the request run alone, (b) K1
    launches == layers x admission dispatches, (c) cache hits, (d) wave
    mode: its streams against each wave rerun, its K1 launches == layers x
    its prefills; then times both modes and profiles one continuous serve."""
    from repro_torch.serving import PrefixCache, Request, ServeEngine

    smi = smi_line()
    sys_prompt, reqs = serve_requests(cfg, Request)
    arrivals = [s[4] for s in SERVE_SPEC]
    shared = [s[1] for s in SERVE_SPEC]
    eng = ServeEngine(params, cfg, prefill_chunk=SERVE_CHUNK, device=dev)

    def continuous():
        eng.prefix_cache = PrefixCache()
        eng.warm_prefix(sys_prompt)
        torch.cuda.synchronize()
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        out = eng.serve(reqs, slots=SERVE_SLOTS, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        return out, time.time() - t0

    continuous()   # first call: one-time costs
    (res, stats), wall = continuous()
    launches = k1.stlt_scan_kernel.launches
    dispatches = dict(eng.serve_stats)
    n_tok = sum(len(v) for v in res.values())
    if launches == 0 or launches != cfg.num_layers * dispatches["admission_dispatches"]:
        raise AssertionError(f"S (b): {launches} K1 launches for "
                             f"{dispatches['admission_dispatches']} admission dispatches")
    for r in reqs:
        if len(res[r.id]) != r.max_new_tokens or not ((res[r.id] >= 0)
                                                      & (res[r.id] < cfg.vocab)).all():
            raise AssertionError(f"S: request {r.id} gave {res[r.id]}")
    cached = [stats[r.id]["cached_tokens"] for r in reqs]
    if any((c != SERVE_SYS) if s else c for c, s in zip(cached, shared)):
        raise AssertionError(f"S (c): cached tokens {cached}, shared {shared}")
    with torch.no_grad():
        ties = sum(alone_stream_check(T, cfg, params, dev, r, res[r.id]) for r in reqs)
    ttft_ticks = [stats[r.id]["live"] - stats[r.id]["arrival"] for r in reqs]
    ttft_ms = [1e3 * (stats[r.id]["token_walls"][0] - stats[r.id]["arrival_wall"])
               for r in reqs]
    gaps = [1e3 * (b - a) for r in reqs
            for a, b in zip(stats[r.id]["token_walls"], stats[r.id]["token_walls"][1:])]
    out = {"wall_s": wall, "tok_s": n_tok / wall, "tokens": n_tok, "ties": ties,
           "k1_launches": launches, **dispatches,
           "ttft_ticks": np.percentile(ttft_ticks, [50, 99]).tolist(),
           "ttft_ms": np.percentile(ttft_ms, [50, 99]).tolist(),
           "gap_ms": np.percentile(gaps, [50, 99]).tolist()}
    log(f"[S serve] {len(reqs)} requests, prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {SERVE_SLOTS} slots, chunk "
        f"{SERVE_CHUNK}: (a) every stream equals its request run alone ({ties} near-tie "
        f"steps within {LOGIT_TOL}); (b) {launches} K1 launches = {cfg.num_layers} layers "
        f"x {dispatches['admission_dispatches']} admission dispatches; (c) cached tokens "
        f"{cached}; {dispatches['decode_dispatches']} decode ticks [{smi}]")
    log(f"[S serve] continuous: wall {wall:.3f} s, {n_tok} tokens, {out['tok_s']:.1f} "
        f"generated tok/s; TTFT p50/p99 {out['ttft_ticks'][0]:.1f}/{out['ttft_ticks'][1]:.1f} "
        f"ticks, {out['ttft_ms'][0]:.2f}/{out['ttft_ms'][1]:.2f} ms; inter-token gap "
        f"p50/p99 {out['gap_ms'][0]:.3f}/{out['gap_ms'][1]:.3f} ms [{smi}]")

    eng.prefix_cache = None
    torch.cuda.synchronize()
    k1.stlt_scan_kernel.launches = 0
    t0 = time.time()
    wave, wave_stats = eng.serve(reqs, slots=SERVE_SLOTS, arrivals=arrivals, mode="wave",
                                 return_stats=True)
    torch.cuda.synchronize()
    out["wave_wall_s"] = time.time() - t0
    wave_launches = k1.stlt_scan_kernel.launches
    wave_dispatches = dict(eng.serve_stats)
    if any(len(wave[r.id]) != r.max_new_tokens for r in reqs):
        raise AssertionError("S (d): wave mode did not serve every request in full")
    with torch.no_grad():
        wave_lens, wave_ties = wave_stream_check(T, cfg, params, dev, reqs, arrivals,
                                                 wave, wave_stats)
    if (len(wave_lens) != wave_dispatches["admission_dispatches"]
            or wave_launches != cfg.num_layers * len(wave_lens)):
        raise AssertionError(f"S (d): {wave_launches} K1 launches for "
                             f"{wave_dispatches['admission_dispatches']} wave prefills, "
                             f"{len(wave_lens)} waves")
    out.update(wave_tok_s=n_tok / out["wave_wall_s"], wave_k1_launches=wave_launches,
               wave_ties=wave_ties, wave_prompt_lens=wave_lens, wave_dispatches=wave_dispatches)
    log(f"[S serve] (d) wave mode: {len(wave_lens)} waves padded to {wave_lens} tokens, "
        f"every stream equals its wave run again ({wave_ties} near-tie steps within "
        f"{LOGIT_TOL}); {wave_launches} K1 launches = {cfg.num_layers} layers x "
        f"{len(wave_lens)} wave prefills; wall {out['wave_wall_s']:.3f} s, "
        f"{out['wave_tok_s']:.1f} generated tok/s, {wave_dispatches} [{smi}]")

    # K1 calls in the profiled serve: its admission dispatches and
    # warm_prefix's one chunk, a call per layer each
    prof = serve_profile(continuous, dispatches["decode_dispatches"],
                         cfg.num_layers * (dispatches["admission_dispatches"] + 1))
    out["profile"] = prof
    with torch.no_grad():
        st = T.init_decode_state(cfg, SERVE_SLOTS, 0, device=dev)
        caps = torch.full((SERVE_SLOTS,), cfg.stlt_nodes, dtype=torch.int32, device=dev)
        tok = torch.zeros(SERVE_SLOTS, dtype=torch.int64, device=dev)
        for key, cap in (("capped", caps), ("uncapped", None)):
            step = serve_profile(lambda: T.decode_step(params, cfg, tok, st, node_cap=cap),
                                 1, 0)
            out[f"{key}_step_launches"] = step and step["launches"]
    if prof is None:
        log(f"[S profile] one continuous serve: not measured (every profile dropped "
            f"kernels) [{smi}]")
    else:
        log(f"[S profile] one continuous serve (warm_prefix included): wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.2f} ms = "
            f"{100 * prof['busy']:.1f}% of wall, {prof['launches']} kernel launches = "
            f"{prof['launches_per_tick']:.1f} per decode tick (admission included); K1 "
            f"{prof['k1_ms']:.3f} ms = {100 * prof['k1_share']:.1f}% of device time [{smi}]")
    log(f"[S profile] one decode_step at batch {SERVE_SLOTS}: {out['capped_step_launches']} "
        f"launches with node caps (continuous mode), {out['uncapped_step_launches']} "
        f"without (wave mode) [{smi}]")
    return out


# Phase P: SmolLM-360M's STLT variant at full width (32 layers, d_model 960,
# 15 heads, S = 32 fixed nodes, bf16 activations; the matrices cast to bf16
# as the serve CLI casts them, the nodes and norms fp32) served with
# speculative decoding and the SLO node ladder. Requests: (prompt
# tokens, built by repeating a 16-token motif?, max_new_tokens, arrival
# tick); 8 greedy requests on 4 slots, admission chunk 512.
P_CHUNK, P_SLOTS, P_K, P_DRAFT_NODES = 512, 4, 4, 8
P_LADDER, P_QUEUE_DEPTH = (16, 8, 4), 2
P_SPEC = ((1024, True, 48, 0), (200, False, 32, 0), (64, True, 16, 0),
          (700, False, 24, 1), (512, True, 40, 3), (96, False, 16, 6),
          (900, True, 32, 9), (300, False, 48, 12))
# The largest chunk-form vs recurrent-form logit gap phase P accepts as
# bf16 rounding, and its near-tie tolerance, twice that (a token chosen by
# one form trails the other's argmax by at most twice their gap): a served
# token may trail the alone run's argmax only by less than P_TIE_TOL. Set
# from the H100's readings (PERF.md, phase P): the gap read 0.0309 with fp32
# matrices and 0.0391 with the bf16 matrices phase P serves, the largest
# served-vs-argmax gap 0.0313; the cap is 1.6 x the gap read.
P_GAP_CAP = 0.0625
P_TIE_TOL = 2 * P_GAP_CAP
P_RUNS = (("plain", {}),
          ("ngram", dict(spec_k=P_K, spec_draft="ngram")),
          ("nodes", dict(spec_k=P_K, spec_draft="nodes", spec_draft_nodes=P_DRAFT_NODES)),
          ("ngram_adaptive", dict(spec_k=P_K, spec_draft="ngram", spec_adaptive=True)),
          ("slo", dict(slo_degrade=P_LADDER, slo_queue_depth=P_QUEUE_DEPTH)))


def spec_requests(cfg, Request):
    """Phase P's requests, made from seed 3: half of the prompts repeat a
    motif (prompt lookup finds continuations there), half are random."""
    rng = np.random.default_rng(3)
    reqs = []
    for i, (n, motif, new, _) in enumerate(P_SPEC):
        if motif:
            prompt = np.tile(rng.integers(0, cfg.vocab, 16), -(-n // 16))[:n]
        else:
            prompt = rng.integers(0, cfg.vocab, n)
        reqs.append(Request(prompt.astype(np.int32), new, id=i))
    return reqs


def k1_dispatches(serve_stats: dict) -> int:
    """The dispatches of a serve that call K1 once per layer: admission,
    verify and the node draft's prompt prefills and commits."""
    return (serve_stats["admission_dispatches"] + serve_stats.get("verify_dispatches", 0)
            + serve_stats.get("draft_prefill_dispatches", 0))


def serve_metrics(res, stats, reqs, wall) -> dict:
    """Wall, generated tok/s, TTFT (first token's wall minus the arrival
    wall) and inter-token gap percentiles of one serve."""
    n_tok = sum(len(v) for v in res.values())
    ttft = [1e3 * (stats[r.id]["token_walls"][0] - stats[r.id]["arrival_wall"]) for r in reqs]
    gaps = [1e3 * (b - a) for r in reqs
            for a, b in zip(stats[r.id]["token_walls"], stats[r.id]["token_walls"][1:])]
    return {"wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
            "ttft_ms": np.percentile(ttft, [50, 99]).tolist(),
            "gap_ms": np.percentile(gaps, [50, 99]).tolist()}


def teacher_forced(T, cfg, params, dev, state, logits, stream, window=None, caps=None):
    """Stream ``stream`` fed to ``decode_step`` from a post-prompt ``state``
    whose last logits are ``logits``, step i at node budget ``caps[i]``
    (uncapped without ``caps``): per step (the reference argmax, the
    reference's max logit minus the served token's). With ``window``, every
    ``window`` steps the same window also goes through ``prefill_chunk``
    (the chunk form verify uses) from the state it started at; returns the
    largest logit gap between the two forms too."""
    rows, gap, start = [], 0.0, None
    for step, tok in enumerate(stream):
        rows.append((int(logits[0].argmax()), float(logits[0].max() - logits[0, int(tok)])))
        if step + 1 == len(stream):
            break
        if window and step % window == 0:
            start = (step, state)
        cap = None if caps is None else torch.tensor([caps[step]], dtype=torch.int32,
                                                     device=dev)
        logits, state = T.decode_step(params, cfg, torch.tensor([int(tok)], device=dev), state,
                                      node_cap=cap)
        if start is not None and step - start[0] == window - 1:
            toks = torch.tensor([[int(t) for t in stream[start[0]:step + 1]]], device=dev)
            chunk_lg, _ = T.prefill_chunk(params, cfg, toks, start[1])
            gap = max(gap, float((chunk_lg - logits).abs().max()))
            start = None
    return rows, gap


def spec_phase(T, k1, cfg, dev, k1_rows) -> dict:
    """Phase P: continuous serve of full-width SmolLM-360M-stlt (bf16) in
    five modes (plain, n-gram draft, node draft, adaptive n-gram, the SLO
    ladder), its matrices cast to bf16 as the serve CLI casts them. Checks
    (a) every stream against each request run alone, teacher-forced (the
    SLO run's at the node budget the ladder gave each of its decode ticks),
    under the near-tie rule at P_TIE_TOL, with the largest chunk-form vs
    recurrent-form logit gap along the plain streams, which it reads and
    prints, at most P_GAP_CAP; (b) spec runs make fewer target decode-phase
    dispatches (verify) than plain decode and the n-gram run accepts
    tokens; (c) K1 launches = layers x (admission + verify + draft
    prefill/commit dispatches) in every run; (d) the SLO run breaches its queue depth,
    steps down and all the way back up, and serves every budget. Times each
    run and profiles the n-gram serve (device kernels only)."""
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.utils import cast_params_for_compute

    smi = smi_line()
    params = cast_params_for_compute(
        T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev), cfg.act_dtype)
    reqs = spec_requests(cfg, Request)
    arrivals = [s[3] for s in P_SPEC]
    L = cfg.num_layers
    engines = {name: ServeEngine(params, cfg, prefill_chunk=P_CHUNK, device=dev, **kw)
               for name, kw in P_RUNS}
    # the node budget of each of a request's decode ticks in the SLO run
    slo_caps, row_caps = {}, engines["slo"]._row_caps

    def logged_caps(sched):
        caps = row_caps(sched)
        for local in np.flatnonzero(sched.live):
            slo_caps.setdefault(sched.req[local].id, []).append(int(caps[local]))
        return caps
    engines["slo"]._row_caps = logged_caps

    def serve(name):
        eng = engines[name]
        torch.cuda.synchronize()
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        res, stats = eng.serve(reqs, slots=P_SLOTS, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        return res, stats, time.time() - t0, k1.stlt_scan_kernel.launches

    t_phase = time.time()
    serve("plain")   # first call: one-time costs
    runs = {}
    for name, _ in P_RUNS:
        res, stats, wall, launches = serve(name)
        eng = engines[name]
        ss = dict(eng.serve_stats)
        if launches == 0 or launches != L * k1_dispatches(ss):
            raise AssertionError(f"P (c) {name}: {launches} K1 launches for {ss}")
        for r in reqs:
            if len(res[r.id]) != r.max_new_tokens or not ((res[r.id] >= 0)
                                                          & (res[r.id] < cfg.vocab)).all():
                raise AssertionError(f"P {name}: request {r.id} gave {res[r.id]}")
        runs[name] = {"res": res, "k1_launches": launches, "serve_stats": ss,
                      "spec_stats": dict(eng.spec_stats), "node_stats": dict(eng.node_stats),
                      **serve_metrics(res, stats, reqs, wall)}
        log(f"[P serve] {name}: wall {wall:.3f} s, {runs[name]['tokens']} tokens, "
            f"{runs[name]['tok_s']:.1f} generated tok/s; TTFT p50/p99 "
            f"{runs[name]['ttft_ms'][0]:.2f}/{runs[name]['ttft_ms'][1]:.2f} ms; inter-token "
            f"gap p50/p99 {runs[name]['gap_ms'][0]:.3f}/{runs[name]['gap_ms'][1]:.3f} ms; "
            f"{launches} K1 launches = {L} layers x {k1_dispatches(ss)} dispatches; {ss} "
            f"[{smi}]")
        if name != "plain" and name != "slo":
            log(f"[P serve] {name} spec_stats {runs[name]['spec_stats']}")
    log(f"[P serve] slo node_stats {runs['slo']['node_stats']}")

    # (b) fewer target decode-phase dispatches; the n-gram draft is accepted
    plain_ticks = runs["plain"]["serve_stats"]["decode_dispatches"]
    for name in ("ngram", "nodes", "ngram_adaptive"):
        ss = runs[name]["serve_stats"]
        if not (ss["decode_dispatches"] == 0 and 0 < ss["verify_dispatches"] < plain_ticks):
            raise AssertionError(f"P (b) {name}: {ss} against {plain_ticks} plain decode "
                                 "dispatches")
    if not runs["ngram"]["spec_stats"]["accepted"] > 0:
        raise AssertionError(f"P (b): the n-gram draft accepted nothing: "
                             f"{runs['ngram']['spec_stats']}")
    # (d) the SLO ladder
    ns = runs["slo"]["node_stats"]
    if not (ns["queue_breaches"] > 0 and ns["degrade_steps"] >= 1
            and ns["restore_steps"] == ns["degrade_steps"]
            and ns["min_nodes"] < cfg.stlt_nodes):
        raise AssertionError(f"P (d): node_stats {ns}")

    log(f"[P time] the serves: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    # (a) streams against each request run alone, teacher-forced
    window = P_K + 1
    checks, gap = {}, 0.0
    with torch.no_grad():
        for r in reqs:
            stream = runs["slo"]["res"][r.id]
            if len(slo_caps.get(r.id, [])) != len(stream) - 1:
                raise AssertionError(f"P (a) slo: request {r.id}: {len(stream)} tokens, "
                                     f"node budgets of {len(slo_caps.get(r.id, []))} "
                                     "decode ticks")
            logits, state = prompt_alone(T, cfg, params, dev, r.prompt, P_CHUNK)
            for name, _ in P_RUNS:
                rows, g = teacher_forced(
                    T, cfg, params, dev, state, logits, runs[name]["res"][r.id],
                    window if name == "plain" else None,
                    slo_caps[r.id] if name == "slo" else None)
                checks[(name, r.id)] = rows
                gap = max(gap, g)
    log(f"[P serve] (a) the largest chunk-form vs recurrent-form logit gap over every "
        f"{window}-token window of the plain streams: {gap:.6g} (cap {P_GAP_CAP}) [{smi}]")
    if not gap <= P_GAP_CAP:
        raise AssertionError(f"P (a): chunk-form vs recurrent-form logit gap {gap} "
                             f"> {P_GAP_CAP}")
    tol = P_TIE_TOL
    ties = {name: 0 for name, _ in P_RUNS}
    tie_gap = {name: 0.0 for name, _ in P_RUNS}
    for (name, rid), rows in checks.items():
        for step, ((best, d), tok) in enumerate(zip(rows, runs[name]["res"][rid])):
            if best != int(tok):
                if not d < tol:
                    raise AssertionError(f"P (a) {name}: request {rid} step {step}: served "
                                         f"{int(tok)}, alone argmax {best}, logit gap {d} "
                                         f">= {tol}")
                ties[name] += 1
                tie_gap[name] = max(tie_gap[name], d)
    same = {name: all(np.array_equal(runs[name]["res"][r.id], runs["plain"]["res"][r.id])
                      for r in reqs) for name in ties}
    log(f"[P serve] (a) every stream equals its request run alone (the SLO run's at "
        f"the ladder's node budgets) within the bf16 tolerance {tol:.4g}; near-tie "
        f"steps {ties}, the largest served-vs-argmax logit gap among them {tie_gap}; "
        f"stream equal to plain {same}; (b) target decode-phase dispatches: "
        f"plain {plain_ticks}, " + ", ".join(
            f"{n} {runs[n]['serve_stats']['verify_dispatches']}"
            for n in ("ngram", "nodes", "ngram_adaptive")) + f" [{smi}]")

    log(f"[P time] the alone checks: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    # the n-gram serve, profiled (kernels only); K1 at the verify shape
    ngram_ss = runs["ngram"]["serve_stats"]
    prof = serve_profile(lambda: serve("ngram"), ngram_ss["verify_dispatches"],
                         L * k1_dispatches(ngram_ss))
    log(f"[P time] the profile: {time.time() - t_phase:.1f} s")
    vrow = k1_rows[K1_VERIFY]
    from repro_torch.kernels import ops
    vargs, _, _ = k1_case(k1, ops, dev, K1_VERIFY[0], K1_VERIFY[1], cfg.stlt_chunk,
                          K1_VERIFY[2], cfg.dh, seed=5)
    vrow["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*vargs, chunk=cfg.stlt_chunk),
                              iters=20)
    if prof is None:
        log(f"[P profile] n-gram spec serve: not measured (every profile dropped kernels) "
            f"[{smi}]")
    else:
        log(f"[P profile] n-gram spec serve: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms = {100 * prof['busy']:.1f}% of wall, "
            f"{prof['launches']} kernel launches = {prof['launches_per_tick']:.1f} per "
            f"verify tick; K1 {prof['k1_ms']:.3f} ms = {100 * prof['k1_share']:.1f}% of "
            f"device time [{smi}]")
    device = "not measured" if vrow["device"] is None else f"{vrow['device']:.4f} ms"
    log(f"[P K1] at the verify shape {K1_VERIFY[0]} x {K1_VERIFY[1]} (S={K1_VERIFY[2]}): "
        f"ops.stlt_scan {vrow['scan']:.4f} ms (host operators + launch), K1 device time "
        f"{device}, kernel alone {vrow['alone']:.4f} ms, plain version "
        f"{vrow['plain']:.4f} ms, bound {vrow['bound']:.5f} ms ({vrow['bound_by']}) [{smi}]")
    for name in runs:
        del runs[name]["res"]
    return {"runs": runs, "profile": prof, "tol": tol, "gap": gap, "ties": ties,
            "tie_gap": tie_gap, "same": same}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import relevance_flash as k2
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine
    from repro_torch.utils import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = CONFIG
    H, S, C, dh = cfg.num_heads, cfg.stlt_nodes, cfg.stlt_chunk, cfg.dh
    B, N, NEW = 4, 1000, 32
    t_all = time.time()

    # 1. build -----------------------------------------------------------------
    t0 = time.time()
    build.build_kernels(echo=True)
    log(f"[1 build] kernels built in {time.time() - t0:.1f} s")

    # 2. K1 vs its plain version at the main path's shapes, at batch 1 and
    # over a long row -----------------------------------------------------------
    BH = B * H
    k1_err = 0.0
    for bh_t, n_t, s_t in K1_SHAPES:
        args, _, _ = k1_case(k1, ops, dev, bh_t, n_t, C, s_t, dh, seed=1)
        got = k1.stlt_scan_kernel(*args, chunk=C)
        want = k1.stlt_scan_reference(*args, chunk=C)
        torch.cuda.synchronize()
        for name, a, b in zip(("z", "h_re", "h_im"), got, want):
            err = float((a - b).abs().max())
            scale = 1.0 + float(b.abs().max())
            k1_err = max(k1_err, err)
            log(f"[2 K1 vs plain] BH={bh_t} N={n_t} S={s_t} {name}: max abs err {err:.3e} "
                f"(scale {scale:.3e})")
            if not err <= K1_TOL * scale:
                raise AssertionError(f"K1 {name} at BH={bh_t} N={n_t} disagrees with its "
                                     f"plain version: {err} > {K1_TOL} * {scale}")
        idle = torch.from_numpy(np.arange(bh_t) % 4 == 0).to(dev)   # valid == 0
        if not (torch.equal(got[1][idle], args[8][idle])
                and torch.equal(got[2][idle], args[9][idle])):
            raise AssertionError("K1: valid == 0 rows must return h0 exactly")
        del args, got, want

    # 2b. K2 vs its plain version at the relevance path's shapes ---------------
    k2_err = 0.0
    for scale_name, target in (("real", None), ("unit", 1.0), ("mid", 30.0)):
        for causal in (True, False):
            xs = 1.0
            if target is not None:   # x scaled so the largest score is ~target
                a = k2_inputs(dev, BH, N, dh, S, 2, adversarial=True)
                top = k2_max_score(k2, a[0], a[2], a[3], a[4], a[5], causal)
                xs = (target / top) ** 0.5
            a = k2_inputs(dev, BH, N, dh, S, 2, adversarial=True, x_scale=xs)
            got = k2.relevance_flash_kernel(*a, causal=causal)
            want = k2.relevance_flash_reference(*a, tile=C, causal=causal)
            # the plain version in float64: how far each fp32 version is
            # from the exact function
            exact = k2.relevance_flash_reference(*(t.double() for t in a[:5]), a[5],
                                                 tile=C, causal=causal,
                                                 dtype=torch.float64).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            top = k2_max_score(k2, a[0], a[2], a[3], a[4], a[5], causal)
            zmax = float(want.abs().max())

            def within(ref):
                if scale_name == "real":
                    return float(((got - ref).abs() - K2_TOL * ref.abs()).max()) <= K2_TOL
                return float((got - ref).abs().max()) <= K2_UNIT_TOL * (1.0 + zmax)
            if scale_name == "real":
                k2_err = max(k2_err, err)
                tol = f"|err| <= {K2_TOL} + {K2_TOL}|z|"
            else:
                tol = f"{K2_UNIT_TOL} * (1 + {zmax:.3f})"
            log(f"[2b K2 vs plain] {scale_name} scale, causal={causal}: max score "
                f"{top:.4g}, max abs err {err:.3e} (max |z| {zmax:.3f}; tol {tol}); "
                f"against float64: K2 {float((got - exact).abs().max()):.3e}, plain "
                f"version {float((want - exact).abs().max()):.3e}")
            if not (within(want) and within(exact)):
                raise AssertionError(f"K2 disagrees with its plain version or the "
                                     f"float64 one ({scale_name}, causal={causal}): {err}")
            if causal:
                tc_accumulation(k2, a, scale_name)
            if not torch.equal(got[2], torch.zeros_like(got[2])):
                raise AssertionError("K2: the all-masked row must return exactly 0")
            if not torch.isfinite(got).all():
                raise AssertionError("K2 returned non-finite values")

    # T1. the scan's VJP on the card: K1 forward and anti-causal (dx), the
    # analytic pole/mixer grads, against float64 autograd -----------------------
    vjp_err = max(scan_vjp_check(k1, ops, dev, B, H, n_t, S, dh, C, rev)
                  for n_t in (N, N + 37) for rev in (False, True))
    # and at phase T3's shape: SmolLM-360M-stlt, 8 x 15 heads x 1024, S = 32
    smollm = get_config("smollm-360m", "stlt")
    vjp_err = max([vjp_err] + [
        scan_vjp_check(k1, ops, dev, T3_B, smollm.num_heads, T3_N, smollm.stlt_nodes,
                       smollm.dh, smollm.stlt_chunk, rev) for rev in (False, True)])

    # 3. the main path: full-width stlt-base generate --------------------------
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(params, cfg, max_len=N + NEW, device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, N))
    k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
    t0 = time.time()
    tokens = engine.generate(prompts, NEW)
    torch.cuda.synchronize()
    first_wall = time.time() - t0
    launches = {"stlt_scan": k1.stlt_scan_kernel.launches,
                "relevance_flash": k2.relevance_flash_kernel.launches}
    log(f"[3 generate] {B} x {N} prompt tokens, {NEW} new: {first_wall:.3f} s "
        f"(first call), kernel launches {launches}")
    if launches["stlt_scan"] != cfg.num_layers:
        raise AssertionError(f"expected {cfg.num_layers} K1 launches per prefill, "
                             f"got {launches['stlt_scan']}")
    if tokens.shape != (B, NEW) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"bad generate output {tokens.shape}")
    log(f"[3 generate] first tokens {tokens[:, :8].tolist()}")

    # 4. chunked prefill with per-row valid lengths ------------------------------
    chunk = 256
    lens = np.array([N, 640, chunk, 900])          # rows go idle (valid 0)
    padded = np.zeros((B, -(-N // chunk) * chunk), np.int64)
    for b in range(B):
        padded[b, :lens[b]] = prompts[b, :lens[b]]

    def chunked(p, c):
        """Every row advances one padded [B, chunk] dispatch per step; a
        row's logits are taken in the step that holds its last token."""
        st = T.init_decode_state(c, B, N, device=dev)
        final = [None] * B
        for off in range(0, N, chunk):
            v = np.clip(lens - off, 0, chunk)
            lg, st = T.prefill_chunk(p, c, torch.from_numpy(padded[:, off:off + chunk]).to(dev),
                                     st, valid_len=torch.from_numpy(v).to(dev))
            for i in np.nonzero((v > 0) & (off + v == lens))[0]:
                final[i] = lg[i]
        return torch.stack(final)

    with torch.no_grad():
        # (a) the padded two-shape batch == each row folded alone at its
        # natural chunk lengths (holds with adaptive masks: one mask per chunk)
        batch = chunked(params, cfg)
        for b in range(B):
            st = T.init_decode_state(cfg, 1, N, device=dev)
            for off in range(0, lens[b], chunk):
                piece = prompts[b:b + 1, off:min(off + chunk, lens[b])]
                alone, st = T.prefill_chunk(params, cfg, torch.from_numpy(piece).to(dev), st)
            err = float((batch[b] - alone[0]).abs().max())
            log(f"[4 chunked] row {b} (len {lens[b]}): padded batch vs alone max abs err {err:.3e}")
            if not err <= LOGIT_TOL:
                raise AssertionError(f"padded chunked prefill row {b}: {err}")
        # (b) without adaptive masks (one mask per chunk vs one per prompt is
        # a streaming approximation), chunked == monolithic prefill
        plain_cfg = dataclasses.replace(cfg, stlt_adaptive=False)
        batch = chunked(params, plain_cfg)
        for b in range(B):
            mono, _ = T.prefill(params, plain_cfg,
                                torch.from_numpy(prompts[b:b + 1, :lens[b]]).to(dev), N)
            err = float((batch[b] - mono[0]).abs().max())
            same = int(batch[b].argmax()) == int(mono[0].argmax())
            log(f"[4 chunked] row {b}: chunked vs monolithic max abs err {err:.3e}, "
                f"first token equal {same}")
            if not (err <= LOGIT_TOL and same):
                raise AssertionError(f"chunked vs monolithic prefill row {b}: {err}, {same}")

    # 5. the card vs the CPU (plain version) -----------------------------------
    with torch.no_grad():
        n5 = 256
        toks = torch.from_numpy(prompts[:2, :n5])
        lg_gpu, _ = T.prefill(params, cfg, toks.to(dev), N)
        lg_cpu, _ = T.prefill(tree_map(torch.Tensor.cpu, engine.params), cfg, toks, N)
        err = float((lg_gpu.cpu() - lg_cpu).abs().max())
        log(f"[5 card vs cpu] prefill logits at N={n5}: max abs err {err:.3e}")
        if not (err <= LOGIT_TOL and torch.isfinite(lg_gpu).all()):
            raise AssertionError(f"card and CPU prefill disagree: {err}")

    # 7. the relevance path: full-width lm_loss forward and backward -------------
    rcfg = dataclasses.replace(cfg, mixer="stlt_relevance")
    rparams = T.init_lm(rcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.from_numpy(prompts).to(dev)
    rbatch = {"inputs": toks, "labels": torch.roll(toks, -1, dims=1)}
    k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
    t0 = time.time()
    with torch.no_grad():
        loss, _ = T.lm_loss(rparams, rcfg, rbatch, deterministic=True)
    torch.cuda.synchronize()
    rel_first = time.time() - t0
    rel_launches = {"stlt_scan": k1.stlt_scan_kernel.launches,
                    "relevance_flash": k2.relevance_flash_kernel.launches}
    log(f"[7 relevance lm_loss] {B} x {N} tokens, forward {rel_first:.3f} s (first "
        f"call), loss {float(loss):.4f}, kernel launches {rel_launches}")
    if rel_launches != {"stlt_scan": 0, "relevance_flash": rcfg.num_layers}:
        raise AssertionError(f"expected {rcfg.num_layers} K2 launches per forward, "
                             f"got {rel_launches}")
    if not torch.isfinite(loss):
        raise AssertionError(f"relevance loss is not finite: {loss}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.time()
    start.record()
    with torch.no_grad():
        T.lm_loss(rparams, rcfg, rbatch, deterministic=True)
    end.record()
    torch.cuda.synchronize()
    rel_wall_ms, rel_event_ms = 1e3 * (time.time() - t0), start.elapsed_time(end)
    log(f"[7 relevance lm_loss] one forward: wall {rel_wall_ms:.3f} ms, CUDA events "
        f"{rel_event_ms:.3f} ms")
    leaves = []
    for layer in rparams["layers"]:
        for sub in (layer["stlt"]["nodes"], layer["stlt"], layer["ffn"]):
            leaves += [t for t in sub.values() if isinstance(t, torch.Tensor)]
    leaves.append(rparams["embed"]["embed"])
    for t in leaves:
        t.requires_grad_(True)
    bwd_walls = []
    for _ in range(2):   # the first call pays one-time costs
        t0 = time.time()
        loss, _ = T.lm_loss(rparams, rcfg, rbatch, deterministic=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        bwd_walls.append(time.time() - t0)
    got = [g for g in grads if g is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"[7 relevance lm_loss] forward + backward {bwd_walls[0]:.3f} s (first call), "
        f"{bwd_walls[1]:.3f} s (second): {len(got)} of "
        f"{len(leaves)} grads (the node mixers u are unused in relevance mode), "
        f"all finite {finite}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not finite or len(got) < len(leaves) - 2 * rcfg.num_layers:
        raise AssertionError("relevance backward: missing or non-finite grads")
    for t in leaves:
        t.requires_grad_(False)
    del grads, got, loss

    # 8. relevance logits, the card vs the CPU (plain version) ------------------
    with torch.no_grad():
        n8 = 256
        toks8 = torch.from_numpy(prompts[:2, :n8])
        lg_gpu, _ = T.apply_lm(rparams, rcfg, toks8.to(dev))
        cpu_params = tree_map(torch.Tensor.cpu, rparams)
        lg_cpu, _ = T.apply_lm(cpu_params, rcfg, toks8)
        lg_cpu64, _ = T.apply_lm(cpu_params, dataclasses.replace(rcfg, stlt_chunk=64),
                                 toks8)
        for name, other in (("card vs cpu", lg_gpu.cpu()), ("cpu tile 64 vs 128", lg_cpu64)):
            diff = (other - lg_cpu).abs().amax(-1)                # [2, n8]
            agree = float((other.argmax(-1) == lg_cpu.argmax(-1)).double().mean())
            log(f"[8 relevance {name}] apply_lm logits at B=2, N={n8}: max abs err "
                f"{float(diff.max()):.3e}, median {float(diff.median()):.3e} (logit "
                f"scale {float(lg_cpu.abs().max()):.3f}), argmax agreement "
                f"{100 * agree:.2f}%")
        err = float((lg_gpu.cpu() - lg_cpu).abs().max())
        agree = float((lg_gpu.cpu().argmax(-1) == lg_cpu.argmax(-1)).double().mean())
        if not (err <= REL_LOGIT_TOL and agree >= 0.99 and torch.isfinite(lg_gpu).all()):
            raise AssertionError(f"card and CPU relevance logits disagree: max {err}, "
                                 f"argmax agreement {agree}")

    del cpu_params
    # T2. the training path: full-width stlt-base, AdamW steps on the card ----------
    tr = train_phase(T, train, k1, cfg, dev, B, N)

    # 6. timing -------------------------------------------------------------------
    k1_rows = k1_timings(k1, ops, dev, C, dh)
    # K1 in the training call (no carry, no snapshot): the forward pass and the
    # anti-causal dx pass (host flips included) at the step's shape
    x, lm, th, ur, ui, dz = vjp_case(dev, B, H, N, S, dh, C, seed=12)
    operators = ops._operators(lm, th, ur, ui, C)
    fwd_pass = lambda: ops._pass(x, operators, C, False, k1.stlt_scan_kernel)  # noqa: E731
    dx_pass = lambda: ops._pass(dz, operators, C, True, k1.stlt_scan_kernel)  # noqa: E731
    train_k1 = {"fwd_ms": time_cuda(fwd_pass, 50), "dx_ms": time_cuda(dx_pass, 50)}
    dx_kernels = device_ms(dx_pass, 10)
    train_k1["dx_device_ms"] = sum(v for k, v in dx_kernels.items()
                                   if K1_KERNEL.search(k)) if dx_kernels else None
    train_k1["bound"], _, train_k1["bound_by"] = k1_bound(
        BH, N, dh, C, S, np.zeros(BH, np.int32))[:3]
    log(f"[6 timing] K1 training passes at BH={BH} N={N}: forward {train_k1['fwd_ms']:.4f} "
        f"ms, dx (flip, K1, flip) {train_k1['dx_ms']:.4f} ms by events; dx K1 device "
        f"time {train_k1['dx_device_ms']} ms; bound {train_k1['bound']:.4f} ms "
        f"({train_k1['bound_by']}); device time by kernel: " + ", ".join(
            f"{kernel_name(k)} {v:.4f} ms" for k, v in dx_kernels.items()))
    del x, dz, operators
    main_args, _, _ = k1_case(k1, ops, dev, BH, N, C, S, dh, seed=5)
    main_row = k1_rows[(BH, N, S)]
    k1_ms = main_row["call"]
    plain_ms = time_cuda(lambda: k1.stlt_scan_reference(*main_args, chunk=C), iters=10)
    log(f"[6 timing] K1 plain version at BH={BH} N={N}: {plain_ms:.4f} ms")
    del main_args
    train_args, _, _ = k1_case(k1, ops, dev, *K1_TRAIN[:2], C, K1_TRAIN[2], dh, seed=5)
    train_row = k1_rows[K1_TRAIN]
    train_row["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*train_args, chunk=C),
                                   iters=10)
    log(f"[6 timing] K1 at phase T3's train shape BH={K1_TRAIN[0]} N={K1_TRAIN[1]} "
        f"S={K1_TRAIN[2]}: plain version {train_row['plain']:.4f} ms, the kernel alone "
        f"{train_row['alone']:.4f} ms, bound {train_row['bound']:.4f} ms "
        f"({train_row['bound_by']})")
    del train_args
    long_prefill(T, cfg, engine.params, dev, k1_rows[(8, LONG_N, S)]["scan"],
                 k1.stlt_scan_kernel)
    with torch.no_grad():
        tok = torch.from_numpy(prompts).to(dev)
        prefill_ms = time_cuda(lambda: T.prefill(engine.params, cfg, tok, N), iters=5)
        _, st = T.prefill(engine.params, cfg, tok, N)
        step_tok = tok[:, -1]
        caps = torch.full((B,), S, dtype=torch.int32, device=dev)
        step_ms = time_cuda(lambda: T.decode_step(engine.params, cfg, step_tok, st,
                                                  node_cap=caps), iters=20)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(prompts, NEW)
    torch.cuda.synchronize()
    wall = time.time() - t0
    log(f"[6 timing] generate {B} x ({N} prompt + {NEW} new): {wall:.4f} s, "
        f"{B * NEW / wall:.1f} new tok/s, {B * (N + NEW) / wall:.1f} tok/s in all; "
        f"prefill {prefill_ms:.3f} ms, decode step {step_ms:.3f} ms (batch {B})")
    profile(lambda: engine.generate(prompts, NEW), "generate")

    # K2 at the relevance path's shapes and data (soft node masks, no padding)
    a = k2_inputs(dev, BH, N, dh, S, 3, adversarial=False)
    k2_ms = time_cuda(lambda: k2.relevance_flash_kernel(*a, causal=True), iters=10)
    k2_plain_ms = time_cuda(lambda: k2.relevance_flash_reference(*a, tile=C, causal=True),
                            iters=3)
    k2_bound_ms, k2_fp32_ms, k2_bound_by, k2_flops, k2_bytes = k2_bound(a[4], a[5], dh,
                                                                        causal=True)
    # the library yardstick: one scaled_dot_product_attention call on the
    # materialized coefficients (Re(a conj b) = a_re b_re + a_im b_im), q =
    # [mk L_re | mk L_im], k = [L_re | L_im], [BH, N, 2 S dh]; building L is
    # not timed. The port never calls it.
    with torch.no_grad():
        l_re, l_im = k2_coefficients(k2, a[0], a[2], a[3], a[5], causal=True)
        mkb = a[4][:, None, :, None]
        q = torch.cat([(mkb * l_re).flatten(2), (mkb * l_im).flatten(2)], -1)
        kk = torch.cat([l_re.flatten(2), l_im.flatten(2)], -1)
        del l_re, l_im
        mask = torch.tril(torch.ones(N, N, dtype=torch.bool, device=dev))[None] \
            & (a[5] > 0)[:, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kk, a[1], attn_mask=mask, scale=S ** -0.5)
        lib_err = float((sdpa() - k2.relevance_flash_kernel(*a, causal=True)).abs().max())
        library_ms = time_cuda(sdpa, iters=5)
        del q, kk, mask
    log(f"[6 timing] K2 (causal) at BH={BH} N={N} dh={dh} S={S}: {k2_ms:.4f} ms, "
        f"plain {k2_plain_ms:.4f} ms, bound {k2_bound_ms:.4f} ms 3xTF32 tensor cores / "
        f"{k2_fp32_ms:.4f} ms fp32 FMA ({k2_bound_by}; {k2_flops / 1e9:.3f} GFLOP, "
        f"{k2_bytes / 1e6:.3f} MB), SDPA on materialized L {library_ms:.4f} ms (max abs "
        f"diff to K2 {lib_err:.3e})")
    k2_bidir_ms = time_cuda(lambda: k2.relevance_flash_kernel(*a, causal=False), iters=5)
    tc_ms, fp32_ms = k2_bound(a[4], a[5], dh, causal=False)[:2]
    log(f"[6 timing] K2 (bidirectional) on the same inputs: {k2_bidir_ms:.4f} ms, bound "
        f"{tc_ms:.4f} ms 3xTF32 tensor cores / {fp32_ms:.4f} ms fp32 FMA")
    alone = [time_cuda(k2_kernel_alone(k2, a, c), iters=10) for c in (True, False)]
    log(f"[6 timing] K2 kernel alone (the wrapper's host carries made up front) at "
        f"BH={BH}: causal {alone[0]:.4f} ms, bidirectional {alone[1]:.4f} ms")
    for bh_t, n_t in ((8, N), (8, 8192)):   # batch 1, and a long row
        b = k2_inputs(dev, bh_t, n_t, dh, S, 4, adversarial=False)
        ms = time_cuda(lambda: k2.relevance_flash_kernel(*b, causal=True), iters=3)
        alone = time_cuda(k2_kernel_alone(k2, b, True), iters=3)
        tc_ms, fp32_ms = k2_bound(b[4], b[5], dh, causal=True)[:2]
        log(f"[6 timing] K2 (causal) at BH={bh_t} N={n_t}: {ms:.4f} ms (kernel alone "
            f"{alone:.4f} ms), bound {tc_ms:.4f} ms 3xTF32 tensor cores / {fp32_ms:.4f} "
            f"ms fp32 FMA")
        del b
    log(f"[6 timing] relevance lm_loss forward {rel_event_ms:.3f} ms (events): "
        f"6 x K2 = {100 * 6 * k2_ms / rel_event_ms:.1f}% of it")
    with torch.no_grad():
        profile(lambda: T.lm_loss(rparams, rcfg, rbatch, deterministic=True),
                "relevance forward")
    ins = [t.clone().requires_grad_(True) for t in a[:5]]
    dz = torch.randn_like(a[0])
    profile(lambda: torch.autograd.grad(
        k2.relevance_flash(*ins[:4], masks=ins[4], kmask=a[5]), ins, dz),
        "one K2 forward + backward (backward: autograd through the plain version)")

    # S. the serving path: continuous serve with chunked admission through K1
    # and the prefix cache, against each request run alone; wave mode. Last,
    # so that its long profile cannot disturb the kernel timings' profiles.
    srv = serve_phase(T, k1, cfg, engine.params, dev)
    del engine, params, rparams
    torch.cuda.empty_cache()

    # P. SmolLM-360M's STLT variant in bf16: speculative decoding and the SLO
    # node ladder through K1 at S = 32
    spec = spec_phase(T, k1, smollm, dev, k1_rows)
    torch.cuda.empty_cache()

    # T3. SmolLM-360M-stlt trained in bf16 with remat through K1, and the
    # paper-small preset through the CLI with a checkpoint and a resume
    t3 = smollm_train_phase(T, train, k1, smollm, dev, T3_B, T3_N)
    cli = cli_resume_phase(train)
    log(f"[6 timing] whole script {time.time() - t_all:.1f} s")

    print(smi_line())
    print(json.dumps({"kernels": [{
        "name": "stlt_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stlt_scan.cu",
        "replaces": "src/repro/kernels/stlt_scan.py:67",
        "launches": launches["stlt_scan"], "max_abs_err": k1_err,
        "ms": k1_ms, "alone_ms": main_row["alone"],
        "device_ms": main_row["device"], "plain_ms": plain_ms,
        # bound_ms is the 3xTF32 tensor-core bound (bound_tc_ms names it
        # too), bound_fp32_ms the bound with every flop as fp32 FMA, as K2's
        "bound_ms": main_row["bound"], "bound_tc_ms": main_row["bound"],
        "bound_fp32_ms": main_row["bound_fp32"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        # the training path: K1 launches per train step (6 causal + 6
        # anti-causal), the dx pass's time and its bound (no snapshot), the
        # scan VJP's worst error over the scale (phase T1)
        "launches_per_train_step": tr["launches_per_step"],
        # phase T3 (SmolLM-360M-stlt, bf16, remat, 8 x 1024): K1 launches per
        # train step (32 forward + 32 recompute + 32 anti-causal), K1 at the
        # train shape: device time, the kernel alone, the wrapper's call, its
        # plain version's time and its bound
        "launches_per_smollm_train_step": t3["launches_per_step"],
        "train_shape": list(K1_TRAIN), "train_device_ms": k1_rows[K1_TRAIN]["device"],
        "train_alone_ms": k1_rows[K1_TRAIN]["alone"],
        "train_call_ms": k1_rows[K1_TRAIN]["call"],
        "train_plain_ms": k1_rows[K1_TRAIN]["plain"],
        "train_bound_ms": k1_rows[K1_TRAIN]["bound"],
        # phase S: K1 launches in one continuous serve (layers x admission
        # dispatches)
        "launches_per_serve": srv["k1_launches"],
        # and in the wave-mode serve of the same requests (layers x waves)
        "launches_per_wave_serve": srv["wave_k1_launches"],
        # phase P (SmolLM-360M-stlt, bf16, S = 32): K1 launches in the
        # node-draft spec serve and in the n-gram one (layers x (admission
        # + verify + draft prefill/commit dispatches)); K1 at the verify
        # shape: device time, ops.stlt_scan's time, its bound
        "launches_per_spec_serve": spec["runs"]["nodes"]["k1_launches"],
        "launches_per_ngram_spec_serve": spec["runs"]["ngram"]["k1_launches"],
        "verify_shape": list(K1_VERIFY), "verify_device_ms": k1_rows[K1_VERIFY]["device"],
        "verify_alone_ms": k1_rows[K1_VERIFY]["alone"],
        "verify_scan_ms": k1_rows[K1_VERIFY]["scan"],
        "verify_plain_ms": k1_rows[K1_VERIFY]["plain"],
        "verify_bound_ms": k1_rows[K1_VERIFY]["bound"],
        "train_fwd_ms": train_k1["fwd_ms"], "dx_ms": train_k1["dx_ms"],
        "dx_device_ms": train_k1["dx_device_ms"], "dx_bound_ms": train_k1["bound"],
        "vjp_max_err_over_scale": vjp_err}, {
        "name": "relevance_flash", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/relevance_flash.cu",
        "replaces": "src/repro/kernels/relevance_flash.py:207",
        "launches": rel_launches["relevance_flash"], "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
        "bound_fp32_ms": k2_fp32_ms, "bound_by": k2_bound_by,
        "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile(fn, label: str, top: int = 8):
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of the wall (kernel time summed, overlaps ignored)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    # kernel rows only: an aten op's row repeats the device time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[6 profile] {label} wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms = {100 * busy / wall_ms:.1f}% of wall, "
        f"{sum(r[2] for r in rows)} kernel launches")
    for key, ms, count in rows[:top]:
        log(f"[6 profile]   {ms:9.3f} ms  {count:6d}x  {100 * ms / busy:5.1f}%  {key[:80]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
