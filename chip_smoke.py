#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
holds each against its plain PyTorch version on the card: K1 (the STLT
scan, at batch 4, at batch 1 and over a 131,072-token row) and K2 (the
flash relevance readout, both modes, with masked nodes, a padded key tail
and an all-masked row, at the real score scale and with x scaled so the
largest score is 1 or 30, also against the plain version run in float64),
and reads how the tensor cores round K2's 3xTF32 score sums. Phase T1
holds the scan's VJP on the card (K1 forward, K1 anti-causal for dx, the
analytic pole/mixer grads) against float64 autograd through the plain
version, both directions, at N = 1000 and 1037. Then it drives the main
paths with random weights from a seeded generator and checks that each ran
through its kernel: ``ServeEngine.generate`` on the full-width
``stlt_base`` model (K1), ``lm_loss`` forward and backward on the same
model with ``mixer="stlt_relevance"`` (K2), and (phase T2) training of
``stlt_base``: step 0 on the card against the CPU (loss and every grad
leaf), then 5 AdamW steps (12 K1 launches a step), timed and profiled. It
checks chunked prefill and card-vs-CPU agreement on both models, then
times the kernels (each also
without its host work; K1 at batch 4, batch 1 and 1 x 131,072 tokens, K2 at
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
# K1's shapes: stlt-base's rows (8 heads) at batch 4 and batch 1 over the
# main path's 1000 tokens, and batch 1 over a 131,072-token prompt.
K1_SHAPES = ((32, 1000), (8, 1000), (8, 131072))
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
    nbytes = 4 * BH * (2 * N * d + 4 * S * d) + 4 * BH * (C * C + 6 * C * S + 4 * S) \
        + 4 * BH * nc
    t_tc = 3 * prods / PEAK_TF32_FLOPS + decay / PEAK_FP32_FLOPS
    t_fp32, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_tc, t_bytes), 1e3 * max(t_fp32, t_bytes),
            "operations" if t_tc >= t_bytes else "bytes", flops, nbytes)


def k1_case(k1, ops, dev, BH, N, C, S, d, seed):
    """K1's inputs at random poles (|lambda| in [e^-0.502, e^-0.002], angles in
    [-pi/4, pi/4]), h0 != 0 and per-row valid cycling 0, 1, C, N: returns
    (the kernel's arguments, valid as numpy, the raw inputs of
    ``ops.stlt_scan``: x, log_mag, theta, u_re, u_im, h0_re, h0_im, valid)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(BH, N, d, generator=g, device=dev)
    lm = -(0.002 + 0.5 * torch.rand(BH, S, generator=g, device=dev))
    th = (torch.pi / 2) * torch.rand(BH, S, generator=g, device=dev) - torch.pi / 4
    ur, ui = (torch.randn(BH, S, generator=g, device=dev) / S for _ in range(2))
    h0r, h0i = (torch.randn(BH, S, d, generator=g, device=dev) for _ in range(2))
    valid_np = np.array([(0, 1, C, N)[i % 4] for i in range(BH)], np.int32)
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


def k1_timings(k1, ops, dev, C, S, d):
    """K1 at each of ``K1_SHAPES``: the kernel alone, the wrapper's call and
    the whole ``ops.stlt_scan`` call (host operators included), by CUDA
    events, and the kernel's device time (profiler, launch gaps excluded),
    beside its bounds. Returns {(BH, N): row}."""
    out = {}
    for BH, N in K1_SHAPES:
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
        log(f"[6 timing] K1 at BH={BH} N={N}: kernel alone {row['alone']:.4f} ms "
            f"(device time {device}), call {row['call']:.4f} ms, "
            f"ops.stlt_scan {row['scan']:.4f} ms; bound {bound_ms:.4f} ms 3xTF32 "
            f"tensor cores ({bound_by}) / {fp32_ms:.4f} ms fp32 FMA "
            f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        log("[6 timing]   device time by kernel: " + ", ".join(
            f"{kernel_name(k)} {v:.4f} ms" for k, v in kernels.items()))
        out[(BH, N)] = row
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


def train_profile(fn, k1_calls: int) -> dict:
    """One profiled train step: the device's busy share of the wall (kernel
    time summed; the ``ops`` annotations' GPU spans excluded), K1's device
    time split into its forward and its dx calls (K1's kernels in launch
    order: the first ``k1_calls`` x 4 are the forward's), the analytic
    param grads' device time and host time (its annotation), and the fp32
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
    launches = 4 * k1_calls
    if len(k1_events) != 2 * launches:
        raise AssertionError(f"train profile: {len(k1_events)} K1 kernels, expected "
                             f"{2 * launches}")
    k1_fwd = sum(e.time_range.elapsed_us() for e in k1_events[:launches]) / 1e3
    k1_dx = sum(e.time_range.elapsed_us() for e in k1_events[launches:]) / 1e3
    grads = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name == "stlt_scan.param_grads"]
    pg_dev = sum(e.device_time_total for e in grads) / 1e3
    pg_host = sum(e.cpu_time_total for e in grads) / 1e3
    gemm = sum(e.time_range.elapsed_us() for e in kernels if "gemm" in e.name.lower()) / 1e3
    out = {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms,
           "k1_fwd_ms": k1_fwd, "k1_dx_ms": k1_dx, "param_grads_ms": pg_dev,
           "param_grads_host_ms": pg_host, "gemm_ms": gemm, "launches": len(kernels)}
    log(f"[T2 profile] one step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms = {100 * busy / wall_ms:.1f}% of wall, {len(kernels)} kernel "
        f"launches; K1 forward {k1_fwd:.4f} ms ({k1_calls} calls, "
        f"{k1_fwd / k1_calls:.4f} ms each), K1 dx {k1_dx:.4f} ms "
        f"({k1_dx / k1_calls:.4f} ms each), together {100 * (k1_fwd + k1_dx) / busy:.1f}% "
        f"of device time; analytic param grads {pg_dev:.3f} ms of device time "
        f"({100 * pg_dev / busy:.1f}%), {pg_host:.2f} ms of host time "
        f"({100 * pg_host / wall_ms:.1f}% of the wall); fp32 GEMMs {gemm:.3f} ms "
        f"({100 * gemm / busy:.1f}%)")
    rows = {}
    for e in kernels:
        r = rows.setdefault(kernel_name(e.name), [0.0, 0])
        r[0] += e.time_range.elapsed_us() / 1e3
        r[1] += 1
    for name, (ms, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[T2 profile]   {ms:9.3f} ms  {count:6d}x  {100 * ms / busy:5.1f}%  {name[:70]}")
    return out


def train_phase(T, train, k1, cfg, dev, B, N) -> dict:
    """Phase T2: full-width training. Step 0 on the card against the port on
    the CPU from the same weights, batch and mask draws (loss, ce, every
    grad leaf; every leaf's grad finite and non-zero), then 5 AdamW steps on
    the card (12 K1 launches a step), timed by CUDA events, and one more
    step profiled."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.adaptive import anneal_tau
    from repro_torch.data import lm_batch_stream
    from repro_torch.utils import tree_flatten_with_paths, tree_map

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
    if k1.stlt_scan_kernel.launches != 2 * cfg.num_layers:
        raise AssertionError(f"T2: {k1.stlt_scan_kernel.launches} K1 launches in a "
                             f"forward + backward, expected {2 * cfg.num_layers}")
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
    worst, n_leaves = ("", 0.0), 0
    for (path, a), (_, b) in zip(tree_flatten_with_paths(g_card),
                                 tree_flatten_with_paths(g_cpu)):
        a = a.cpu()
        nb = float(torch.linalg.vector_norm(b.double()))
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0 and nb > 0):
            raise AssertionError(f"T2: grad of {path} is not finite or is zero on the "
                                 f"card (or on the CPU)")
        r = float(torch.linalg.vector_norm((a - b).double())) / nb
        n_leaves += 1
        if r > worst[1]:
            worst = (path, r)
        if not r <= TRAIN_GRAD_TOL:
            raise AssertionError(f"T2: grad of {path}: card vs CPU relative {r} > "
                                 f"{TRAIN_GRAD_TOL}")
    log(f"[T2 step 0] {n_leaves} grad leaves, all finite and non-zero on both; worst "
        f"||g_card - g_cpu|| / ||g_cpu|| {worst[1]:.3e} ({worst[0]}; gate {TRAIN_GRAD_TOL})")
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
        if n != 2 * cfg.num_layers or not np.isfinite(losses[-1]):
            raise AssertionError(f"T2 step {step}: {n} K1 launches, loss {losses[-1]}")
    med = float(np.median(ev_ms[1:]))
    log(f"[T2 train] {B} x {N} tokens a step: median step {med:.3f} ms by CUDA events "
        f"over steps 1-4 ({[round(t, 3) for t in ev_ms[1:]]}), wall "
        f"{float(np.median(walls[1:])):.3f} ms; {B * N / (med / 1e3):.1f} training "
        f"tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    b = batch(tcfg.total_steps, dev)
    prof = train_profile(lambda: step_fn(params, opt_state, b, tcfg.total_steps),
                         cfg.num_layers)
    # K1's launches in the last timed step, as counted (every step's count
    # was checked above)
    return {"step_ms": med, "tok_s": B * N / (med / 1e3), "losses": losses,
            "launches_per_step": counts[-1], **prof}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    for bh_t, n_t in K1_SHAPES:
        args, _, _ = k1_case(k1, ops, dev, bh_t, n_t, C, S, dh, seed=1)
        got = k1.stlt_scan_kernel(*args, chunk=C)
        want = k1.stlt_scan_reference(*args, chunk=C)
        torch.cuda.synchronize()
        for name, a, b in zip(("z", "h_re", "h_im"), got, want):
            err = float((a - b).abs().max())
            scale = 1.0 + float(b.abs().max())
            k1_err = max(k1_err, err)
            log(f"[2 K1 vs plain] BH={bh_t} N={n_t} {name}: max abs err {err:.3e} "
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
    k1_rows = k1_timings(k1, ops, dev, C, S, dh)
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
    k1_ms = k1_rows[(BH, N)]["call"]
    plain_ms = time_cuda(lambda: k1.stlt_scan_reference(*main_args, chunk=C), iters=10)
    log(f"[6 timing] K1 plain version at BH={BH} N={N}: {plain_ms:.4f} ms")
    del main_args
    long_prefill(T, cfg, engine.params, dev, k1_rows[(8, LONG_N)]["scan"],
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
    log(f"[6 timing] whole script {time.time() - t_all:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "stlt_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stlt_scan.cu",
        "replaces": "src/repro/kernels/stlt_scan.py:67",
        "launches": launches["stlt_scan"], "max_abs_err": k1_err,
        "ms": k1_ms, "alone_ms": k1_rows[(BH, N)]["alone"],
        "device_ms": k1_rows[(BH, N)]["device"], "plain_ms": plain_ms,
        # bound_ms is the 3xTF32 tensor-core bound (bound_tc_ms names it
        # too), bound_fp32_ms the bound with every flop as fp32 FMA, as K2's
        "bound_ms": k1_rows[(BH, N)]["bound"], "bound_tc_ms": k1_rows[(BH, N)]["bound"],
        "bound_fp32_ms": k1_rows[(BH, N)]["bound_fp32"],
        "bound_by": k1_rows[(BH, N)]["bound_by"], "library_ms": None,
        # the training path: K1 launches per train step (6 causal + 6
        # anti-causal), the dx pass's time and its bound (no snapshot), the
        # scan VJP's worst error over the scale (phase T1)
        "launches_per_train_step": tr["launches_per_step"],
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
