#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card, drives the main path
(``ServeEngine.generate`` on the full-width ``stlt_base`` model with random
weights from a seeded generator) and checks that it ran through the kernels,
checks chunked prefill and card-vs-CPU agreement, then times the kernels.

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
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores and HBM3 bandwidth — K1 runs fp32 FMA by design (no TF32).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# K1 vs its plain version on the card: both fp32, summed in different
# orders over up to C + 2S terms per output and nc carry steps.
K1_TOL = 2e-4         # max abs error / (1 + max |reference|)
# logits through 6 full-width layers: chunked vs monolithic prefill and
# card vs CPU differ only by fp32 summation order (logit scale ~0.5).
LOGIT_TOL = 1e-3


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


def k1_bound(BH, N, d, C, S, valid):
    """(bound_ms, bound_by, flops, bytes) of one K1 call: the larger of the
    fp32 operations this call's data needs over the fp32 peak and the bytes
    it must move (inputs read once, outputs written once) over HBM."""
    nc = -(-N // C)
    n_local = np.arange(N) % C
    # z row n: the lower-triangular Toeplitz row (n mod C + 1 taps) plus the
    # carry injection A h_re + B h_im (2S taps), d columns, 2 flops a tap
    flops = BH * d * 2.0 * float((n_local + 1 + 2 * S).sum())
    # carry into chunks 1..nc-1: [Pre; Pim] X_c (2S x C) and the decay
    flops += BH * (nc - 1) * d * (2.0 * 2 * S * C + 8 * S)
    # the gated snapshot: 2S x r taps with r the live in-chunk offset
    q = valid.astype(np.int64)
    r = np.where(q > 0, q - np.maximum(q - 1, 0) // C * C, 0)
    flops += float((d * (2.0 * 2 * S * r + 8 * S)).sum())
    nbytes = 4 * BH * (2 * N * d + 4 * S * d) + 4 * BH * (C * C + 6 * C * S + 4 * S) \
        + 4 * BH * nc
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stlt_scan as k1
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

    # 2. K1 vs its plain version at the main path's shapes ----------------------
    g = torch.Generator(device=dev).manual_seed(1)
    BH = B * H
    x = torch.randn(BH, N, dh, generator=g, device=dev)
    lm = -(0.002 + 0.5 * torch.rand(BH, S, generator=g, device=dev))
    th = (torch.pi / 2) * torch.rand(BH, S, generator=g, device=dev) - torch.pi / 4
    ur, ui = (torch.randn(BH, S, generator=g, device=dev) / S for _ in range(2))
    h0r, h0i = (torch.randn(BH, S, dh, generator=g, device=dev) for _ in range(2))
    valid_np = np.array([(0, 1, C, N)[i % 4] for i in range(BH)], np.int32)
    valid = torch.from_numpy(valid_np).to(dev)
    gf, A, Bm, pre, pim, dec = ops._filter_ops(lm, th, ur, ui, C)
    nc = -(-N // C)
    spre, spim, sdec, gate = ops._snapshot_ops(lm, th, valid, N, C, nc)
    args = [gate] + [t.contiguous() for t in (x, ops._toeplitz(gf), A, Bm, pre, pim,
                                              dec, h0r, h0i, spre, spim, sdec)]
    got = k1.stlt_scan_kernel(*args, chunk=C)
    want = k1.stlt_scan_reference(*args, chunk=C)
    torch.cuda.synchronize()
    k1_err = 0.0
    for name, a, b in zip(("z", "h_re", "h_im"), got, want):
        err = float((a - b).abs().max())
        scale = 1.0 + float(b.abs().max())
        k1_err = max(k1_err, err)
        log(f"[2 K1 vs plain] {name}: max abs err {err:.3e} (scale {scale:.3e})")
        if not err <= K1_TOL * scale:
            raise AssertionError(f"K1 {name} disagrees with its plain version: "
                                 f"{err} > {K1_TOL} * {scale}")
    if not torch.equal(got[1][valid == 0], args[8][valid == 0]):
        raise AssertionError("K1: valid == 0 rows must return h0 exactly")

    # 3. the main path: full-width stlt-base generate --------------------------
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(params, cfg, max_len=N + NEW, device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, N))
    k1.stlt_scan_kernel.launches = 0
    t0 = time.time()
    tokens = engine.generate(prompts, NEW)
    torch.cuda.synchronize()
    first_wall = time.time() - t0
    launches = {"stlt_scan": k1.stlt_scan_kernel.launches}
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

    # 6. timing -------------------------------------------------------------------
    k1_ms = time_cuda(lambda: k1.stlt_scan_kernel(*args, chunk=C), iters=50)
    plain_ms = time_cuda(lambda: k1.stlt_scan_reference(*args, chunk=C), iters=10)
    bound_ms, bound_by, flops, nbytes = k1_bound(BH, N, dh, C, S, valid_np)
    log(f"[6 timing] K1 at BH={BH} N={N} d={dh} S={S} C={C}: {k1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
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
    profile_generate(engine, prompts, NEW)
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
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_generate(engine, prompts, new_tokens: int, top: int = 8):
    """Device time by kernel over one ``generate``, and the device's busy
    share of the wall (kernel time summed, overlaps ignored)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.time()
        engine.generate(prompts, new_tokens)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    # kernel rows only: an aten op's row repeats the device time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[6 profile] generate wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms = {100 * busy / wall_ms:.1f}% of wall, "
        f"{sum(r[2] for r in rows)} kernel launches")
    for key, ms, count in rows[:top]:
        log(f"[6 profile]   {ms:9.3f} ms  {count:6d}x  {key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
