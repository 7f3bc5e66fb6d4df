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
cache hits, wave mode; timed and profiled. Phase F runs stlt-base in its
hann form (the finite-support window: an FFT convolution, no kernel) on the
same weights: F1 card vs CPU (lm_loss and logits at 4 x 1000, the layer in
both directions), chunked vs monolithic prefill and decode vs the
teacher-forced forward; F2 serves phase S's requests (each stream against
its request run alone, 0 K1 and K2 launches, the per-slot state beside the
exponential one, both as predicted from the layout); F3 times the
131,072-token prefill. Phase SH serves phase S's requests through the
sharded engine (2 hosts x 2 slots, a replicated warmed prefix): streams
equal to S's under the near-tie rule, each request's host, the pinned
count per shard, K1 = 6 x the admission dispatches; an n-gram spec serve
sharded against single-host; the serve CLI with --mesh-data 2. Phase T1
also holds param_grads="recompute" against the analytic grads and times
both backwards. Phase P serves full-width
SmolLM-360M-stlt in bf16 (8 requests, 4 slots): plain, speculative with
the n-gram and the node-subset draft and the adaptive window, and the SLO
node ladder; each stream against its request run alone under the near-tie
rule at a bf16 tolerance it measures, verify against plain decode
dispatches, K1 launches against the dispatches that call it, the ladder's
steps; timed, a serve of one short request profiled. Phase D serves phase P's model and
requests through the disaggregated prefill and decode fleets
(``serving.disagg``; 2 prefill hosts, 2 decode hosts x 2 slots, K1 on the
prefill fleet only): D1 over the loopback transport (each stream against
P's plain one under the near-tie rule, K1 launches per fleet, handoff bytes
flat in prompt length, a shipped state unpacked bit for bit, the bf16 wire,
a compressed blob, TTFT and gaps on the fleet clocks), D2 under seeded
message faults with a prefill and a decode host killed, D3 through a prefill
worker process over a socket, D4 the native model's KV state's blob beside
the STLT state's. Phase T3 trains full-width
SmolLM-360M-stlt in bf16 (fp32 masters, remat) at 8 x 1024 tokens a step:
step 0 with remat against remat off and against fp32 compute (loss and
every grad leaf), 5 AdamW steps (96 K1 launches each), timed, the peak
memory with remat full, dots and off, one step profiled; then the
paper-small preset through the training CLI with a checkpoint directory,
a run stopped after its checkpoint and resumed, against two straight runs.
Phase W runs whisper-base's STLT variant at full width in bf16 (the
enc-dec family: a bilateral STLT encoder, each layer a causal and an
anti-causal K1 call, the cross-STLT and a causal STLT decoder): W1 encodes
4 x 1500 frame embeddings (12 K1 launches) and decodes 64 tokens greedily
(none), each step held to the teacher-forced forward on the produced tokens
under the near-tie rule (a bound on rounding noise at full depth), then at
2 + 2 layers in fp32 the card against the CPU (logits and step 0's grads)
and each decode step against the teacher-forced forward within what the
JAX package's own two forms meet, the encode and a decode step timed and
the step profiled beside its HBM bound; W2 trains at 8 x (1500 frames,
448 tokens): step 0 with remat against remat off and against fp32
compute, 5 AdamW steps (54 K1 launches each), the peak memory with remat
on and off, one step profiled. K1 is also checked and timed at phase W's
shapes, in both directions. Phase A runs the paper's baseline, native
softmax attention (plain torch, no kernel of the port: K1 must make no
launch): A1 serves native SmolLM-360M, its depth cut to 4 of 32 layers,
in bf16 (phase P's requests, plain and the n-gram draft; streams against
each request run alone, verify against decode dispatches, the per-slot KV
state at full depth beside the STLT variant's), A2 holds chunked against monolithic prefill and decode against
the teacher-forced forward in fp32, the blockwise path against the dense
one at 1 x 8192, the card against the CPU at 2 layers, and times one
layer's attention beside ``F.scaled_dot_product_attention`` (a yardstick;
the port never calls it), A3 trains it at 8 x 1024 in bf16 with remat (step
0 against remat off and, at 2 layers in fp32, against the CPU; 5 AdamW
steps; peak memory), A4 runs native whisper-base through phase W's checks.
Phase H runs the hybrid family and the untied head at full width in bf16:
H1 and H2 serve recurrentgemma-9b (d_model 4096, a 256,000-token untied
head; its depth cut from 38 layers to one period: 2 rg-LRU blocks and a
local-attention block) native and as its STLT variant (the
local-attention third through K1 at head dim 256) on phase P's requests,
plain and with the n-gram draft, each stream against its request run
alone under the near-tie rule, K1 launches 0 and 1 x the dispatches that
call it, the per-slot decode state of both at full depth; H3 checks both
forms in fp32 at one period of the pattern (chunked against monolithic
prefill, an idle row's state bit for bit, decode against the
teacher-forced forward, the card against the CPU); H4 trains that period
at 2 x 1024 (remat against off, 3 K1 launches a step in the STLT form, the
peak memory, step 0 against the CPU at reduced widths); H5 generates with
chatglm3-6b-stlt (28 K1 launches at head dim 128), held to the
teacher-forced forward. Phase X runs xlstm-350m (24 layers: 21 mLSTM, 3
sLSTM; d_model 1024; no K1 launch): X1 serves it at full width, one period
(7 mLSTM + 1 sLSTM) deep, in bf16 on phase P's requests, plain and n-gram,
each stream against its request run alone under the near-tie rule, the
per-slot state at full depth (88.8 MB); X2 checks that period in fp32 as
H3 does; X3 trains that period at 8 x 512 in bf16 with remat (against remat off and fp32 compute,
5 AdamW steps, their peak, a profile). Phase M runs the MoE family at full
width with its depth cut: M1 serves qwen3-moe-235b-a22b at 1 of 94 layers
native and STLT (K1 at head dim 64; the choices each admission drops), M2
holds 1 layer in fp32 to the CPU (apply_moe on a dispatch that drops, bit
for bit on two card calls), serves greedily on the card and runs H3's
checks at capacity E / K (nothing drops), M3 trains 1 layer at 2 x 1024 with
adafactor, M4 builds arctic-480b at 1 of 35 layers leaf by leaf (each
matrix cast as drawn) and generates 2 x (512 + 16) in both forms (K1 at
head dim 128), held to the teacher-forced forward at capacity E / K. It
checks chunked prefill and card-vs-CPU agreement on both models, then
times the kernels (each also
without its host work; K1 at each of its phase 2 shapes, K2 at
batch 1 and at N = 8192; each beside its fp32 and 3xTF32 tensor-core
bounds), their plain versions and the library yardstick, times a batch-1
prefill of a 131,072-token prompt, and profiles it, one ``generate`` and
one relevance forward. Phase E runs the port's examples on the card in
this process: the quickstart (3 K1 launches) and the long-context stream
over 2,000 tokens (decode only), whose decode state keeps its bytes from
report to report. Phase DT (last; ``tools/phase_dt.py``) runs the
multi-device training layer as 4 gloo ranks, processes sharing the card:
DT1 trains stlt-base on a 2 x 2 (data, model) mesh at 4 x 1000 tokens for 3
AdamW steps against the single-device step (loss, every param, 18 K1
launches per rank per step), DT2 runs the context-parallel STLT over 8 x
131,072 tokens against serial K1 (K1 is also checked and timed at its
8 x 32,768 shard), forward and backward (dx and the pole and mixer grads
against the serial training call's, 2 K1 launches per rank), DT3 pipelines
the 6 blocks as 2 stages against the serial blocks (outputs, grads), DT4
crashes and restores the sharded loop and gets DT1's params bit for bit.
Phase DS, in the same rank job, serves
sharded: DS1 runs the 2 x 2 prefill cell (4 x 1000 tokens, 6 K1 launches
per rank) and 32 greedy decode-cell steps (0 K1) against the single-device
``prefill``/``decode_step`` (logits, each rank's state slice, streams),
with the bytes each rank exchanges; DS2 serves phase SH's requests
through the process form of the sharded engine, one rank per host, against
the one-process engine (hosts, ticks, streams). Phase DA, in the same rank
job, runs tensor parallelism beyond the STLT block at full width in fp32:
DA1 chatglm3-6b (2 layers) trains on 2 x 2 at 4 x 1024 for 2 steps against
the single-device step and runs the prefill cell and greedy decode-cell
steps on 2 x 2 (KV heads on ``model``; 1 step) and 1 x 4 (the cache's time
axis on ``model``; 16 steps); DA2 recurrentgemma-9b at one period runs both
forms' prefill and 16 decode steps and the STLT form's train cell (4 x 512)
on 1 x 4 (K1 on each rank's heads: 3 launches per rank per step, 1 per
prefill, 0 per decode step; 0 in the native forms). Phase DM, last in the
same rank job, runs expert parallelism: qwen3-moe-235b-a22b at full width
cut to 1 layer, fp32, its 128 experts over ``model``: DM1 on 1 x 4 (32
experts a rank) trains both forms at 2 x 1024 (2 adafactor steps) and runs
their prefill cells (4 x 1024) and 4 greedy decode-cell steps; DM2 runs the
native form's 2 x 2 prefill and decode cells without FSDP, where capacity
and slot positions span two data shards; each against the single-device
functions (DA's gates, K1 per rank equal to the single-device count on the
rank's 16 heads, the drops summed over the ranks equal to the
single-device call's). ``tools/ab_port.py`` compares two trees of the port
on one card.

Output ends with three lines: the card's name and power limit (from
``nvidia-smi``), a JSON ``{"kernels": [...]}`` line, and the JSON result
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result; so it does without a CUDA device, and
outside a checkout of the repository (it imports ``repro_torch`` from
``src/``). Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import threading
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
# K1's shapes (rows, tokens, nodes, head dim): stlt-base's rows (8 heads,
# S = 64, d = 64) at
# batch 4 and batch 1 over the main path's 1000 tokens, batch 1 over a
# 131,072-token prompt, serve's two admission shapes, [1, chunk] and
# [slots, chunk] at chunk 512, 4 slots, and the largest of phase S's wave
# prefills, 4 prompts padded to 3000 tokens; then phase P's SmolLM-360M-stlt
# rows (15 heads, S = 32): [1, 512] (admission, the node draft's prompt
# prefill) and [4, 512] (admission), and [4, k + 1] = 60 x 5, the verify
# window resumed from h0 and the node draft's commit with per-row valid.
# Last, phase T3's training rows: SmolLM-360M-stlt at batch 8 x 1024 tokens
# (8 x 15 heads, S = 32), forward, remat recompute and the anti-causal dx.
# Then phase W's whisper-base-stlt rows (8 heads, S = 32): the encode's
# 4 x 1500 frames (a causal and an anti-causal call a layer), and the
# training step's 8 x 1500 frames and 8 x 448 decoder tokens (all d = 64).
# Last, phase H's rows: recurrentgemma-9b-stlt (16 heads, S = 32, d = 256)
# at [4, 512] and [1, 512] admission, the [4, k + 1] = 64 x 5 verify
# window and the 2 x 1024 training step, and chatglm3-6b-stlt (32 heads,
# d = 128) at its 2 x 512 prompt. Phase SH's n-gram serve of stlt-base adds
# its verify window, [4, k + 1] = 32 x 5 at S = 64.
K1_WHISPER = ((32, 1500, 32, 64), (64, 1500, 32, 64), (64, 448, 32, 64))
K1_HYBRID = ((64, 512, 32, 256), (16, 512, 32, 256), (64, 5, 32, 256),
             (32, 1024, 32, 256), (64, 512, 32, 128))
# Last, phase M's STLT variants: qwen3-moe-stlt (64 heads, S = 32, d = 64)
# at [4, 512] and [1, 512] admission, a [4, k + 1] = 256 x 5 verify window
# and the 2 x 1024 training step, and arctic-stlt (56 heads, d = 128) at its
# 2 x 512 prompt.
K1_MOE = ((256, 512, 32, 64), (64, 512, 32, 64), (256, 5, 32, 64), (128, 1024, 32, 64),
          (112, 512, 32, 128))
# Phase DT's context-parallel shard: 8 rows x 32,768 tokens with return_state
K1_CP = (8, 32768, 64, 64)
# Phase DS2's admission on one host rank of the process form: [2, 512] on
# 8 heads (DS1's prefill runs K1 at 8 x 1000, the sharded train step's)
K1_DS2 = (16, 512, 64, 64)
# Phase DA2's rank shape: recurrentgemma-9b-stlt's STLT layer on a rank's
# B_loc x H_loc rows at 1024 tokens (4 rows x 4 heads in the 1 x 4 prefill
# cell; its train cell runs the same rows at 512; S = 32, d = 256)
K1_DA2 = (16, 1024, 32, 256)
# Phase DM1's rank shapes: qwen3-moe-stlt's STLT layer on a rank's 16 of 64
# heads on the 1 x 4 mesh (S = 32, d = 64): 4 rows x 16 heads in the
# prefill cell (stateful), 2 rows x 16 heads in the 2 x 1024 train cell
K1_DM1 = ((64, 1024, 32, 64), (32, 1024, 32, 64))
K1_SHAPES = ((32, 1000, 64, 64), (8, 1000, 64, 64), (8, 131072, 64, 64),
             (8, 512, 64, 64), (32, 512, 64, 64), (32, 3000, 64, 64), (15, 512, 32, 64),
             (60, 512, 32, 64), (60, 5, 32, 64), (120, 1024, 32, 64),
             (32, 5, 64, 64), K1_DS2, K1_DA2, K1_CP) + K1_WHISPER \
    + K1_HYBRID + K1_MOE + K1_DM1
K1_VERIFY = (60, 5, 32, 64)
K1_TRAIN = (120, 1024, 32, 64)
H_K1_VERIFY = (64, 5, 32, 256)
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
# Phase W (whisper-base-stlt, bf16, matrices cast as serving_params casts
# them): encode W_B x steps.WHISPER_ENC_FRAMES frame embeddings, decode
# W_NEW tokens greedily; train at W_TRAIN_B x (the same frames, W_TRAIN_N
# tokens).
W_B, W_NEW = 4, 64
W_TRAIN_B, W_TRAIN_N = 8, 448
# The gates that can fail a wrong decoder or wrong grads are the fp32 ones
# at the model's widths cut to 2 + 2 layers, batch 1, 1500 frames
# (whisper_cpu_check): card against CPU (decode-step and teacher-forced
# logits, max abs, within W_CPU_TOL: fp32 but for K1's 3xTF32 products;
# step 0's loss and grad leaves within TRAIN_LOSS_TOL and TRAIN_GRAD_TOL),
# and on each side every decode step against the teacher-forced forward on
# the same tokens, within W_FP32_STEP_TOL. The two forms are one function,
# so their gap is rounding, which the cross-STLT's softmax amplifies at
# random init (its scores reach the hundreds). The JAX package's own forms
# part by 9.9e-5 to 2.08e-3 at this shape over 24 seeds
# (tests/jax_whisper_gaps.py on the CPU): the tolerance is ~2.4x the
# largest.
W_CPU_STEPS = 8
W_CPU_TOL = 1e-3
W_FP32_STEP_TOL = 5e-3
# Step 0's fp32 grads there, card against CPU: the loss is well conditioned
# (TRAIN_LOSS_TOL), the grads are not. Everything upstream of the
# cross-STLT's softmax moves far on a rounding-sized change: the CPU
# against itself with K1's chunk halved (summation order only) parts by
# 2.3e-3 over the whole grad and 5.5e-3 at the worst leaf, and the card
# (3xTF32 products in K1, 2^-22 relative against fp32's 2^-24, and cuBLAS's
# summation order) by 15x and 22x that, alike on every leaf upstream of the
# softmax (PERF.md, phase W). So the gate is a multiple of the floor read
# in the same run, ~3x those ratios: it fails a grad leaf that is wrong by
# more than about a third, not a subtle error; the CPU tests hold the port's
# grads to the JAX package's to 1e-3 at reduced widths.
W_GRAD_FLOOR_X = 64
# At full depth that amplification compounds from layer to layer: the JAX
# package's own fp32 forms part by up to 0.065 at 2 + 6 layers over 4 seeds
# (the same tool), and the H100 read 0.254 at 6 + 6 (fp32), 0.918 and 1.004
# (bf16, where the JAX package's step also casts the attention weights to
# bf16 before their product with the values, and its forward does not), at
# a logit scale of ~2.1 (PERF.md, phase W). So the full-depth gates below
# bound rounding noise only, ~1.6x the card's largest reading each: with
# the launch counts and the finiteness checks, they show that the
# full-width path runs; they cannot tell a wrong decoder from rounding.
# W_TIE_TOL is phase P's near-tie rule at twice the bf16 cap.
W_GAP_CAP = 1.6
W_TIE_TOL = 2 * W_GAP_CAP
W_FP32_GAP_CAP = 0.4
# W2 step 0, bf16 compute vs fp32 compute from the same fp32 masters: loss
# relative, each grad leaf ||g_bf16 - g_fp32|| / ||g_fp32||. Through the
# cross-STLT's sharp softmax the bf16 grads are rounding-dominated: the
# H100 read loss 3.1e-5 / 4.0e-5 and worst leaves 2.39 (an encoder T_hat)
# and 18.75 (dec_embed) before and after a change of the scan's summation
# order (PERF.md, phase W). At reduced widths on the CPU either package's
# bf16 grads part from its fp32 ones by 0.125 (whole grad) and 0.68 (worst
# leaf), while the port's bf16 grads follow the JAX package's op-by-op bf16
# ones within 0.025 and 0.126: tests/test_torch_encdec.py holds that. The
# loss gate is a quarter of a bf16 ulp; the grad gate, 1.6x the larger
# reading, only bounds that noise (every leaf is also checked finite and
# non-zero; the tight grad checks are the fp32 ones above).
W_BF16_LOSS_TOL = 1e-3
W_BF16_GRAD_TOL = 30.0

def log(msg: str):
    print(msg, flush=True)


def free_cuda():
    """Return the memory of a finished phase to the card: collect the
    reference cycles that hold its tensors (a serving engine's closures),
    then empty the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


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


def top_kernels(kernels, n: int = 10) -> list:
    """The ``n`` kernels of most device time among profiler events, by
    name: [name, ms, launches] each."""
    rows = {}
    for e in kernels:
        r = rows.setdefault(kernel_name(e.name), [0.0, 0])
        r[0] += e.time_range.elapsed_us() / 1e3
        r[1] += 1
    return [[name, t, c] for name, (t, c) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:n]]


def log_top_kernels(tag: str, top: list, busy_ms: float):
    for name, t, count in top:
        log(f"[{tag} profile]   {t:9.4f} ms  {count:6d}x  {100 * t / busy_ms:5.1f}%  {name[:70]}")


def k1_bound(BH, N, d, C, S, valid):
    """(bound_ms, bound_fp32_ms, bound_by, flops, bytes) of one K1 call on
    this call's data (its work: ``stlt_scan.work``). ``bound_ms`` is the
    least time for the work as the kernel does it: its products as 3xTF32 on
    the tensor cores (three TF32 products for each fp32 one, at the TF32
    peak) and the carries' decay at the fp32 rate, or the bytes it must move
    (inputs read once, outputs written once) over HBM if they take longer;
    ``bound_by`` names which. ``bound_fp32_ms`` is the same with every flop
    as fp32 FMA."""
    from repro_torch.kernels import stlt_scan

    prods, decay, nbytes = stlt_scan.work(BH, N, d, C, S, valid)
    flops = prods + decay
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


def k1_timings(k1, ops, dev, C):
    """K1 at each of ``K1_SHAPES``: the kernel alone, the wrapper's call and
    the whole ``ops.stlt_scan`` call (host operators included), by CUDA
    events, and the kernel's device time (profiler, launch gaps excluded),
    beside its bounds. Returns {(BH, N, S, d): row}."""
    out = {}
    for BH, N, S, d in K1_SHAPES:
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
        log(f"[6 timing] K1 at BH={BH} N={N} S={S} d={d}: kernel alone {row['alone']:.4f} ms "
            f"(device time {device}), call {row['call']:.4f} ms, "
            f"ops.stlt_scan {row['scan']:.4f} ms; bound {bound_ms:.4f} ms 3xTF32 "
            f"tensor cores ({bound_by}) / {fp32_ms:.4f} ms fp32 FMA "
            f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        log("[6 timing]   device time by kernel: " + ", ".join(
            f"{kernel_name(k)} {v:.4f} ms" for k, v in kernels.items()))
        out[(BH, N, S, d)] = row
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
    return ms


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
    these inputs (its work: ``relevance_flash.work``, which counts only the
    nodes whose mask is not 0 and the valid keys). ``bound_ms`` is the least
    time for the work as the kernel does it: the score contraction and P.v
    both as 3xTF32 on the tensor cores (three TF32 products for each fp32
    one, at the TF32 peak), or the bytes if they take longer;
    ``fp32_bound_ms`` the same with every flop as fp32 FMA."""
    from repro_torch.kernels import relevance_flash

    BH, N = km.shape
    score, pv, nbytes = relevance_flash.work(BH, N, mk.shape[-1], dh, causal, mk, km)
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


def recompute_check(k1, ops, dev, B, H, N, S, d, C, reverse) -> dict:
    """Phase T1, ``param_grads="recompute"`` (the legacy backward: K1
    forward and dx, the pole and mixer grads by autograd through the plain
    version) against ``"analytic"`` on the same inputs: dx bit for bit (the
    same K1 pass), the pole and mixer grads within K1_TOL of (1 + the
    analytic grad's largest entry); 2 K1 launches each; each mode's
    backward timed by CUDA events."""
    x, lm, th, ur, ui, dz = vjp_case(dev, B, H, N, S, d, C, seed=11)
    grads, ms = {}, {}
    for mode in ("analytic", "recompute"):
        ins = [t.clone().requires_grad_(True) for t in (x, lm, th, ur, ui)]
        k1.stlt_scan_kernel.launches = 0
        z = ops.stlt_scan(*ins, chunk=C, reverse=reverse, param_grads=mode)
        grads[mode] = torch.autograd.grad(z, ins, dz, retain_graph=True)
        torch.cuda.synchronize()
        if k1.stlt_scan_kernel.launches != 2:
            raise AssertionError(f"T1 {mode}: {k1.stlt_scan_kernel.launches} K1 launches")
        ms[mode] = time_cuda(lambda: torch.autograd.grad(z, ins, dz, retain_graph=True), 5)
        del z, ins
    if not torch.equal(grads["recompute"][0], grads["analytic"][0]):
        raise AssertionError("T1 recompute: dx differs from the analytic mode's")
    worst, parts = 0.0, []
    for name, a, b in zip(("dlog_mag", "dtheta", "du_re", "du_im"), grads["recompute"][1:],
                          grads["analytic"][1:]):
        err, scale = float((a - b).abs().max()), 1.0 + float(b.abs().max())
        worst = max(worst, err / scale)
        parts.append(f"{name} {err:.3e} (scale {scale:.3e})")
        if not err <= K1_TOL * scale:
            raise AssertionError(f"T1 recompute: {name} {err} > {K1_TOL} * {scale}")
    log(f"[T1 param_grads] BH={B * H} N={N} reverse={reverse}: recompute vs analytic "
        + ", ".join(parts) + f"; dx equal; backward {ms['analytic']:.3f} ms analytic, "
        f"{ms['recompute']:.3f} ms recompute (events) [{smi_line()}]")
    return {"worst": worst, "analytic_bwd_ms": ms["analytic"],
            "recompute_bwd_ms": ms["recompute"]}


ANNOTATIONS = ("stlt_scan.param_grads",)   # ops._StltScan's record_function
K1_KERNEL = re.compile(r"\bk1_(pack|carry_in|carry_scan|readout)\b")


GEMM_KERNELS = ("gemm", "nvjet")   # cuBLAS's fp32 (xmma gemm) and bf16 (nvjet) kernels


def stlt_layers(cfg) -> int:
    """The LM's STLT blocks: each makes K1 calls; attention blocks none."""
    return sum(bt in ("stlt", "stlt_rel") for bt in cfg.block_types())


def k1_calls_per_step(cfg) -> int:
    """K1 calls in one forward + backward: each STLT layer's forward, its
    remat recompute in backward when ``cfg.remat`` is set, and its dx."""
    return (3 if cfg.remat else 2) * stlt_layers(cfg)


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
    L, per = stlt_layers(cfg), 4                     # 4 kernels a K1 call
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
        f"launches; K1 forward {k1_fwd:.4f} ms ({L} calls, {k1_fwd / max(L, 1):.4f} ms "
        f"each), remat recompute {k1_re:.4f} ms, dx {k1_dx:.4f} ms "
        f"({k1_dx / max(L, 1):.4f} ms each), "
        f"together {100 * k1_all / busy:.1f}% of device time; analytic param grads "
        f"{pg_dev:.3f} ms of device time ({100 * pg_dev / busy:.1f}%), {pg_host:.2f} ms "
        f"of host time ({100 * pg_host / wall_ms:.1f}% of the wall); GEMMs {gemm:.3f} ms "
        f"({100 * gemm / busy:.1f}%)")
    log_top_kernels(tag, top_kernels(kernels), busy)
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


def grad_gaps(a: dict, b: dict, what: str, unread=lambda path: False) -> tuple:
    """(worst leaf, worst ||a - b|| / ||b||, leaves) over two grad trees;
    raises if a leaf of either is not finite or is zero. A leaf the loss
    does not read (``unread(path)``) must be exactly zero in both."""
    from repro_torch.utils import tree_flatten_with_paths

    worst, n = ("", 0.0), 0
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a), tree_flatten_with_paths(b)):
        if unread(path):
            if bool(x.any()) or bool(y.any()):
                raise AssertionError(f"{what}: {path} is not read, but has a grad")
            continue
        for t in (x, y):
            if not (bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0):
                raise AssertionError(f"{what}: grad of {path} is not finite or is zero")
        r = float(torch.linalg.vector_norm((x - y).double())
                  / torch.linalg.vector_norm(y.double()))
        n += 1
        if r >= worst[1]:
            worst = (path, r)
    return worst[0], worst[1], n


def whole_grad_gap(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every leaf of two grad trees at once."""
    from repro_torch.utils import tree_leaves

    num = sum(float(((x - y).double() ** 2).sum()) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return (num / sum(float((y.double() ** 2).sum()) for y in tree_leaves(b))) ** 0.5


def log_top_leaves(tag: str, a: dict, b: dict, n: int = 8):
    from repro_torch.utils import tree_flatten_with_paths

    rel = {p: float(torch.linalg.vector_norm((x - y).double())
                    / max(float(torch.linalg.vector_norm(y.double())), 1e-30))
           for (p, x), (_, y) in zip(tree_flatten_with_paths(a), tree_flatten_with_paths(b))}
    log(f"[{tag}] " + ", ".join(f"{p} {r:.2e}" for p, r in
                                sorted(rel.items(), key=lambda kv: -kv[1])[:n]))


T3_COMPARE = (("no remat", TRAIN_LOSS_TOL, TRAIN_GRAD_TOL),
              ("fp32 compute", T3_BF16_LOSS_TOL, T3_BF16_GRAD_TOL))


def smollm_train_phase(T, train, k1, cfg, dev, B, N, tag="T3", compare=T3_COMPARE,
                       remat_modes=("full", "dots", "off")) -> dict:
    """Phase T3 (and A3 with the native config): SmolLM-360M trained in
    bf16 (fp32 masters, the matrices cast inside the loss, remat on) at
    B x N tokens a step, its STLT blocks through K1. Step 0 with remat
    against the runs in ``compare`` (remat off: K1 launches 3L and 2L;
    fp32 compute from the same masters): loss and every grad leaf, finite
    and non-zero, within the stated tolerances. Then 5 AdamW steps, timed
    by CUDA events (3L K1 launches each; none for attention) and their
    peak memory, one step's peak memory in each of ``remat_modes``, and one
    profiled step (its device kernels only when no STLT layer calls K1)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch_stream

    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=5, seed=0)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def batch(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in lm_batch_stream(0, step, B, N, cfg.vocab).items()}

    b0 = batch(0)
    runs = {}
    variants = {"no remat": dataclasses.replace(cfg, remat=False),
                "fp32 compute": dataclasses.replace(cfg, dtype="float32")}
    # the first call pays one-time costs (and a CPU rehearsal's first bf16
    # products may round differently), so it is not compared
    for name, c in (("first call", cfg), ("remat", cfg),
                    *((n, variants[n]) for n, _, _ in compare)):
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        loss, metrics, grads = train.loss_and_grads(params, c, b0, tau=1.0)
        torch.cuda.synchronize()
        n = k1.stlt_scan_kernel.launches
        log(f"[{tag} step 0] {name}: loss {float(loss):.6f}, {time.time() - t0:.2f} s, "
            f"{n} K1 launches")
        if n != k1_calls_per_step(c) or not torch.isfinite(loss):
            raise AssertionError(f"{tag} {name}: {n} K1 launches (expected "
                                 f"{k1_calls_per_step(c)}), loss {float(loss)}")
        runs[name] = (float(loss), None if name == "first call" else grads)
        del grads
    gaps = {}
    for name, loss_tol, grad_tol in compare:
        ref = "remat"
        rel = abs(runs[ref][0] - runs[name][0]) / abs(runs[name][0])
        path, worst, n = grad_gaps(runs[ref][1], runs[name][1], f"{tag} {ref} vs {name}")
        gaps[name] = {"loss": rel, "grad": worst, "leaf": path}
        log(f"[{tag} step 0] bf16 remat vs {name}: loss relative {rel:.3e} (gate "
            f"{loss_tol}), {n} grad leaves all finite and non-zero, worst ||g - g_ref|| / "
            f"||g_ref|| {worst:.3e} ({path}; gate {grad_tol})")
        if not (rel <= loss_tol and worst <= grad_tol):
            raise AssertionError(f"{tag}: bf16 remat vs {name}: loss {rel}, grad {worst} "
                                 f"at {path}")
    del runs

    opt, step_fn = train.make_step(cfg, tcfg)
    opt_state = opt.init(params)
    ev_ms, walls, counts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
        log(f"[{tag} train] step {step}: loss {loss:.6f} grad_norm "
            f"{float(metrics['grad_norm']):.4f}; {ev_ms[-1]:.3f} ms (events), "
            f"{walls[-1]:.3f} ms (wall), {counts[-1]} K1 launches")
        if counts[-1] != k1_calls_per_step(cfg) or not np.isfinite(loss):
            raise AssertionError(f"{tag} step {step}: {counts[-1]} K1 launches, loss {loss}")
    med = float(np.median(ev_ms[1:]))
    steps_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag} train] {B} x {N} tokens a step: median step {med:.3f} ms by CUDA events "
        f"over steps 1-4 ({[round(t, 3) for t in ev_ms[1:]]}), wall "
        f"{float(np.median(walls[1:])):.3f} ms; {B * N / (med / 1e3):.1f} training "
        f"tokens/s; peak over the 5 steps {steps_peak:.2f} GiB (remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}) [{smi_line()}]")

    b = batch(tcfg.total_steps)
    memory = {}
    for mode in remat_modes:
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
        log(f"[{tag} memory] remat {mode}: peak {peak / 2**30:.2f} GiB over a step (params "
            f"and AdamW state held: {held / 2**30:.2f} GiB), step {ms:.3f} ms (events, "
            f"mean of 2) [{smi_line()}]")
    one_step = lambda: step_fn(params, opt_state, b, tcfg.total_steps)  # noqa: E731
    if stlt_layers(cfg):
        prof = train_profile(one_step, cfg, tag)
    else:
        # no K1 to split by launch order and no param-grads span: the
        # device's kernels only (a step's host events took over a minute to
        # read back for xLSTM's sLSTM loop)
        prof = serve_profile(one_step, 1, 0) or {}
        if prof:
            log(f"[{tag} profile] one step: wall {prof['wall_ms']:.2f} ms (profiled), device "
                f"busy {prof['busy_ms']:.2f} ms = {100 * prof['busy']:.1f}% of wall, "
                f"{prof['launches']} kernel launches (device kernels only)")
            log_top_kernels(tag, prof["top"], prof["busy_ms"])
        else:
            log(f"[{tag} profile] one step: not measured (every profile dropped kernels)")
    return {"step_ms": med, "tok_s": B * N / (med / 1e3), "launches_per_step": counts[-1],
            "gaps": gaps, "memory": memory, "steps_peak_gib": steps_peak, **prof}


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
    ``--ckpt-dir`` in a temporary directory: 6 steps straight, twice, against
    a run of the same command stopped after its checkpoint of step 2 (3
    steps) and the same command again, which resumes from there to 6. A
    train step on the card is deterministic (no atomics: the analytic param
    grads sum in a fixed order), so the second straight run and the resumed
    run equal the first bit for bit, params and moments."""
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
        f"first (largest |value| {scale:.3e}; gate: both bit for bit); four runs {wall:.1f} s")
    if not (d_straight == 0.0 and d_resumed == 0.0):
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


def prompt_alone(T, cfg, params, dev, prompt, chunk: int, max_len: int = 0):
    """(last logits, state) of ``prompt`` run alone, folded at [1, chunk]
    (padded, per-row valid) from token 0, so its chunk boundaries are the
    engine's; ``max_len`` sizes an attention model's KV cache as the
    engine's is sized."""
    state = T.init_decode_state(cfg, 1, max_len, device=dev)
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


def serve_profile(fn, ticks: int, k1_calls: int, annotations=()) -> dict:
    """One profiled call of ``fn`` (a serve, a decode step, a train step):
    its wall, the device's busy share (kernel time summed over the wall),
    kernel launches per decode tick, K1's share of device time, and the ten
    kernels of most device time. Only the device's kernels are recorded
    (host events would cost minutes to read back on a serve of hundreds of
    thousands of launches), unless ``annotations`` (``record_function``
    spans of the port) are asked for: then host events too, and the device
    time of the kernels under each span. The profiler can drop kernels, so
    a profile whose K1 kernels are not 4 x ``k1_calls`` (or that recorded
    none) is taken again, up to three takes; None when no take is whole."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if annotations else [])
    for _ in range(3):
        torch.cuda.synchronize()
        with torch_profile(activities=activities) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.time() - t0)
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in tuple(annotations) + ANNOTATIONS]
        if kernels and sum(bool(K1_KERNEL.search(e.name)) for e in kernels) == 4 * k1_calls:
            break
    else:
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1_ms = sum(e.time_range.elapsed_us() for e in kernels if K1_KERNEL.search(e.name)) / 1e3
    spans = {a: sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU and e.name == a) / 1e3
             for a in annotations}
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms,
            "launches": len(kernels), "launches_per_tick": len(kernels) / max(ticks, 1),
            "k1_ms": k1_ms, "k1_share": k1_ms / busy if busy else 0.0, "spans_ms": spans,
            "top": top_kernels(kernels)}


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
           "k1_launches": launches, **dispatches, "streams": res,
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


# Phase F: stlt-base in its hann form (the finite-support window, W = 128 =
# 2S: an FFT convolution over the last W values and a ring of them, no
# kernel of the port) at full width, on phase 3's weights (the parameter
# tree does not depend on the window). F1 checks it (card vs CPU, both
# directions, chunked vs monolithic, decode vs teacher-forced), F2 serves
# phase S's requests, F3 times the 131,072-token prefill.
F_STEPS = 16   # decode steps held to the teacher-forced forward


def hann_check_phase(T, k1, k2, cfg, params, dev, prompts) -> dict:
    """F1: ``lm_loss`` and ``apply_lm`` logits at B x N on the card against
    the CPU, ``apply_stlt`` of the first layer in both directions card vs
    CPU, and with the adaptive masks off (one mask per chunk or step is a
    streaming approximation of one per prompt, as phase 4 states) chunked
    prefill at SERVE_CHUNK (the ring carried as left context) against
    monolithic and F_STEPS decode steps against the teacher-forced forward,
    each within LOGIT_TOL. No K1 or K2 launch."""
    from repro_torch.core import stlt as stlt_lib
    from repro_torch.utils import tree_map

    B, N = prompts.shape
    toks = torch.from_numpy(prompts).to(dev)
    batch = {"inputs": toks, "labels": torch.roll(toks, -1, dims=1)}
    cpu_params = tree_map(torch.Tensor.cpu, params)
    out = {}
    k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
    with torch.no_grad():
        loss, _ = T.lm_loss(params, cfg, batch, deterministic=True)
        lg, _ = T.apply_lm(params, cfg, toks)
        loss_c, _ = T.lm_loss(cpu_params, cfg, tree_map(torch.Tensor.cpu, batch),
                              deterministic=True)
        lg_c, _ = T.apply_lm(cpu_params, cfg, toks.cpu())
        out["logit_err"] = float((lg.cpu() - lg_c).abs().max())
        out["loss_err"] = abs(float(loss) - float(loss_c))
        del lg, lg_c
        scfg = cfg.stlt_config()
        x = torch.randn(B, N, cfg.d_model, generator=torch.Generator().manual_seed(3))
        for bi in (False, True):
            c = dataclasses.replace(scfg, bidirectional=bi)
            y, _ = stlt_lib.apply_stlt(params["layers"][0]["stlt"], c, x.to(dev))
            y_c, _ = stlt_lib.apply_stlt(cpu_params["layers"][0]["stlt"], c, x)
            out[f"apply_{'bilateral' if bi else 'causal'}_err"] = float(
                (y.cpu() - y_c).abs().max())
        plain = dataclasses.replace(cfg, stlt_adaptive=False)
        mono, st_m = T.prefill(params, plain, toks, 0)
        st = T.init_decode_state(plain, B, 0, device=dev)
        for off in range(0, N, SERVE_CHUNK):
            lgc, st = T.prefill_chunk(params, plain, toks[:, off:off + SERVE_CHUNK], st)
        out["chunked_err"] = float((lgc - mono).abs().max())
        same = bool((lgc.argmax(-1) == mono.argmax(-1)).all())
        extra = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (B, F_STEPS))).to(dev)
        full, _ = T.apply_lm(params, plain, torch.cat([toks, extra], 1))
        step_err = float((mono - full[:, N - 1]).abs().max())
        for i in range(F_STEPS - 1):
            lgs, st_m = T.decode_step(params, plain, extra[:, i], st_m)
            step_err = max(step_err, float((lgs - full[:, N + i]).abs().max()))
        out["step_err"] = step_err
        torch.cuda.synchronize()
    launches = (k1.stlt_scan_kernel.launches, k2.relevance_flash_kernel.launches)
    errs = {k: v for k, v in out.items() if k.endswith("_err")}
    log(f"[F1 hann check] {B} x {N} at full width: lm_loss card {float(loss):.6f} vs CPU "
        f"{float(loss_c):.6f}; max abs errors " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                          errs.items())
        + f" (gate {LOGIT_TOL}); chunked first tokens equal {same}; K1/K2 launches "
        f"{launches}")
    if not (all(v <= LOGIT_TOL for v in errs.values()) and same and launches == (0, 0)
            and torch.isfinite(loss)):
        raise AssertionError(f"F1: {errs}, first tokens equal {same}, launches {launches}")
    return out


def slot_bytes(T, cfg, dev) -> int:
    """Bytes of one slot's decode state (every leaf of a batch-1 state)."""
    from repro_torch.serving.prefix_cache import pytree_nbytes

    return pytree_nbytes(T.init_decode_state(cfg, 1, 0, device=dev))


def predicted_slot_bytes(cfg) -> int:
    """One slot's state from the layout: per layer the exponential carry
    h_re, h_im (2 x H S dh fp32) or the hann ring buf (H W dh fp32) and its
    int32 pos, plus asum (d fp32) and acnt under adaptive masks; the model's
    int32 pos."""
    H, S, dh = cfg.num_heads, cfg.stlt_nodes, cfg.dh
    W = cfg.stlt_config().hann_support
    layer = 4 * H * W * dh + 4 if cfg.stlt_window == "hann" else 4 * 2 * H * S * dh
    if cfg.stlt_adaptive:
        layer += 4 * cfg.d_model + 4
    return cfg.num_layers * layer + 4


def hann_serve_phase(T, k1, k2, cfg, params, dev, exp_cfg) -> dict:
    """F2: phase S's requests (4 slots, chunk SERVE_CHUNK, the warmed
    system prompt) served in the hann form: each stream against its request
    run alone (near-tie rule), no K1 or K2 launch, cache hits as phase S's;
    TTFT, gaps, tok/s, the device's busy share; the per-slot state beside
    the exponential form's, both against their layout's prediction."""
    from repro_torch.serving import PrefixCache, Request, ServeEngine

    smi = smi_line()
    sys_prompt, reqs = serve_requests(cfg, Request)
    arrivals = [s[4] for s in SERVE_SPEC]
    eng = ServeEngine(params, cfg, prefill_chunk=SERVE_CHUNK, device=dev)

    def run():
        eng.prefix_cache = PrefixCache()
        eng.warm_prefix(sys_prompt)
        torch.cuda.synchronize()
        k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
        t0 = time.time()
        res = eng.serve(reqs, slots=SERVE_SLOTS, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        return res, time.time() - t0

    run()   # first call: one-time costs (FFT plans)
    (res, stats), wall = run()
    launches = (k1.stlt_scan_kernel.launches, k2.relevance_flash_kernel.launches)
    if launches != (0, 0):
        raise AssertionError(f"F2: the hann serve launched K1/K2 {launches} times")
    for r in reqs:
        if len(res[r.id]) != r.max_new_tokens:
            raise AssertionError(f"F2: request {r.id} gave {res[r.id]}")
    cached = [stats[r.id]["cached_tokens"] for r in reqs]
    if any((c != SERVE_SYS) if s[1] else c for c, s in zip(cached, SERVE_SPEC)):
        raise AssertionError(f"F2: cached tokens {cached}")
    with torch.no_grad():
        ties = sum(alone_stream_check(T, cfg, params, dev, r, res[r.id]) for r in reqs)
    out = serve_metrics(res, stats, reqs, wall)
    out.update(ties=ties, launches=launches, dispatches=dict(eng.serve_stats))
    prof = serve_profile(lambda: run(), eng.serve_stats["decode_dispatches"], 0)
    out["busy"] = None if prof is None else prof["busy"]
    out["slot_bytes"] = {"hann": slot_bytes(T, cfg, dev), "exponential": slot_bytes(T, exp_cfg, dev)}
    want = {"hann": predicted_slot_bytes(cfg), "exponential": predicted_slot_bytes(exp_cfg)}
    if out["slot_bytes"] != want:
        raise AssertionError(f"F2: slot bytes {out['slot_bytes']}, predicted {want}")
    busy = "not measured" if prof is None else f"{100 * prof['busy']:.1f}%"
    log(f"[F2 hann serve] {len(reqs)} requests, {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}: "
        f"every stream equals its request run alone ({ties} near-tie steps within "
        f"{LOGIT_TOL}); K1/K2 launches {launches}; cached tokens {cached}; "
        f"{out['dispatches']} [{smi}]")
    log(f"[F2 hann serve] wall {wall:.3f} s, {out['tokens']} tokens, {out['tok_s']:.1f} "
        f"generated tok/s; TTFT p50/p99 {out['ttft_ms'][0]:.2f}/{out['ttft_ms'][1]:.2f} ms; "
        f"inter-token gap p50/p99 {out['gap_ms'][0]:.3f}/{out['gap_ms'][1]:.3f} ms; device "
        f"busy {busy} of a profiled serve; per-slot state {out['slot_bytes']['hann']} bytes "
        f"(exponential {out['slot_bytes']['exponential']}; both as predicted from the "
        f"layout) [{smi}]")
    return out


def hann_long_prefill(T, k1, cfg, params, dev, exp_ms) -> float:
    """F3: one batch-1 prefill of LONG_N tokens in the hann form by CUDA
    events beside phase 6's exponential one (``exp_ms``); no K1 launch,
    finite logits."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(1, LONG_N))).to(dev)
    with torch.no_grad():
        k1.stlt_scan_kernel.launches = 0
        logits, _ = T.prefill(params, cfg, toks, LONG_N)
        torch.cuda.synchronize()
        if k1.stlt_scan_kernel.launches or not torch.isfinite(logits).all():
            raise AssertionError(f"F3: {k1.stlt_scan_kernel.launches} K1 launches, finite "
                                 f"logits {bool(torch.isfinite(logits).all())}")
        ms = time_cuda(lambda: T.prefill(params, cfg, toks, LONG_N), iters=3, warmup=1)
    log(f"[F3 hann prefill] 1 x {LONG_N} tokens: {ms:.3f} ms (events), the exponential "
        f"form's {exp_ms:.3f} ms (phase 6) [{smi_line()}]")
    return ms


def hann_phase(T, k1, k2, cfg, params, dev, prompts, exp_long_ms) -> dict:
    """Phase F: F1, F2 and F3 on stlt-base's hann form."""
    hcfg = dataclasses.replace(cfg, stlt_window="hann")
    t0 = time.time()
    out = {"F1": hann_check_phase(T, k1, k2, hcfg, params, dev, prompts)}
    t1 = time.time()
    out["F2"] = hann_serve_phase(T, k1, k2, hcfg, params, dev, cfg)
    t2 = time.time()
    out["F3_ms"] = hann_long_prefill(T, k1, hcfg, params, dev, exp_long_ms)
    log(f"[F time] F1 {t1 - t0:.1f} s, F2 {t2 - t1:.1f} s, F3 {time.time() - t2:.1f} s")
    return out


# Phase SH: stlt-base (exponential: K1 on every admission) served by the
# sharded engine, phase S's requests on SH_HOSTS x SH_SLOTS (S's 4 slots),
# chunk SERVE_CHUNK, a ReplicatedPrefixCache warmed with the system prompt;
# then an n-gram spec serve (spec_k SH_SPEC_K; spec refuses adaptive masks,
# so with them off) sharded against single-host; then the serve CLI with
# --mesh-data.
SH_HOSTS, SH_SLOTS, SH_SPEC_K = 2, 2, 4


def near_tie_streams(T, cfg, params, dev, reqs, got, want, tag) -> tuple:
    """(streams equal to ``want``, near-tie steps): a stream that differs
    from ``want`` must pass ``alone_stream_check`` (each token the alone
    run's argmax or within LOGIT_TOL of it)."""
    same, ties = 0, 0
    with torch.no_grad():
        for r in reqs:
            if np.array_equal(got[r.id], want[r.id]):
                same += 1
            else:
                log(f"[{tag}] request {r.id} differs from the reference stream: held to "
                    "its request run alone")
                ties += alone_stream_check(T, cfg, params, dev, r, got[r.id])
    return same, ties


def sharded_phase(T, k1, cfg, params, dev, s_streams) -> dict:
    """Phase SH: (a) each sharded stream equals phase S's single-host one
    under the near-tie rule; (b) every request's host, both hosts serving;
    (c) the replicated cache: the same pinned count on every shard, every
    request's cached tokens as phase S's; (d) K1 launches = layers x the
    [H*K, chunk] admission dispatches; (e) the n-gram spec serve sharded
    against single-host, K1 = layers x (admission + verify dispatches);
    (f) ``python -m repro_torch.launch.serve --mesh-data`` exits 0 with its
    per-host line."""
    from repro_torch.serving import ReplicatedPrefixCache, Request, ServeEngine, ShardedServeEngine

    smi = smi_line()
    sys_prompt, reqs = serve_requests(cfg, Request)
    arrivals = [s[4] for s in SERVE_SPEC]
    t0 = time.time()
    cache = ReplicatedPrefixCache(SH_HOSTS)
    eng = ShardedServeEngine(params, cfg, n_hosts=SH_HOSTS, slots_per_host=SH_SLOTS,
                             prefill_chunk=SERVE_CHUNK, prefix_cache=cache, device=dev)
    eng.warm_prefix(sys_prompt)
    torch.cuda.synchronize()
    k1.stlt_scan_kernel.launches = 0
    t1 = time.time()
    res, stats = eng.serve(reqs, arrivals=arrivals, return_stats=True)
    torch.cuda.synchronize()
    wall = time.time() - t1
    launches, dispatches = k1.stlt_scan_kernel.launches, dict(eng.serve_stats)
    predicted = cfg.num_layers * dispatches["admission_dispatches"]
    hosts = {r.id: stats[r.id]["host"] for r in reqs}
    per_host = {h: sum(v == h for v in hosts.values()) for h in range(SH_HOSTS)}
    cs = cache.stats()
    pinned = [sh["pinned"] for sh in cs["shards"]]
    cached = [stats[r.id]["cached_tokens"] for r in reqs]
    same, ties = near_tie_streams(T, cfg, params, dev, reqs, res, s_streams, "SH (a)")
    out = serve_metrics(res, stats, reqs, wall)
    out.update(k1_launches=launches, predicted_k1=predicted, dispatches=dispatches,
               per_host=per_host, pinned=pinned, same=same, ties=ties)
    log(f"[SH sharded serve] {SH_HOSTS} hosts x {SH_SLOTS} slots, chunk {SERVE_CHUNK}: (a) "
        f"{same} of {len(reqs)} streams equal phase S's, the rest equal their request run "
        f"alone ({ties} near-tie steps); (b) hosts {hosts}, per host {per_host}; (c) pinned "
        f"per shard {pinned}, cached tokens {cached}; (d) {launches} K1 launches, predicted "
        f"{cfg.num_layers} layers x {dispatches['admission_dispatches']} admission "
        f"dispatches = {predicted}; {dispatches}; wall {wall:.3f} s, {out['tok_s']:.1f} "
        f"generated tok/s, TTFT p50/p99 {out['ttft_ms'][0]:.2f}/{out['ttft_ms'][1]:.2f} ms "
        f"[{smi}]")
    if (launches != predicted or launches == 0 or set(per_host.values()) & {0}
            or len(set(pinned)) != 1 or pinned[0] == 0 or not cs["replication_ok"]
            or any((c != SERVE_SYS) if s[1] else c for c, s in zip(cached, SERVE_SPEC))
            or any(len(res[r.id]) != r.max_new_tokens for r in reqs)):
        raise AssertionError(f"SH: launches {launches}/{predicted}, per host {per_host}, "
                             f"pinned {pinned}, cached {cached}")

    # (e) n-gram spec, sharded against single-host (adaptive masks off)
    plain = dataclasses.replace(cfg, stlt_adaptive=False)
    t2 = time.time()
    spec = {}
    for name, make in (("single", lambda: ServeEngine(
            params, plain, prefill_chunk=SERVE_CHUNK, spec_k=SH_SPEC_K, spec_draft="ngram",
            device=dev)), ("sharded", lambda: ShardedServeEngine(
            params, plain, n_hosts=SH_HOSTS, slots_per_host=SH_SLOTS,
            prefill_chunk=SERVE_CHUNK, spec_k=SH_SPEC_K, spec_draft="ngram", device=dev))):
        e = make()
        k1.stlt_scan_kernel.launches = 0
        kw = {} if name == "sharded" else {"slots": SH_HOSTS * SH_SLOTS}
        got = e.serve(reqs, arrivals=arrivals, **kw)
        torch.cuda.synchronize()
        spec[name] = {"streams": got, "k1": k1.stlt_scan_kernel.launches,
                      "predicted": cfg.num_layers * k1_dispatches(e.serve_stats),
                      "dispatches": dict(e.serve_stats), "stats": dict(e.spec_stats)}
    spec_same, spec_ties = near_tie_streams(T, plain, params, dev, reqs,
                                            spec["sharded"]["streams"],
                                            spec["single"]["streams"], "SH (e)")
    log(f"[SH spec] n-gram k={SH_SPEC_K}, adaptive masks off: {spec_same} of {len(reqs)} "
        f"sharded streams equal the single-host spec serve's ({spec_ties} near-tie steps); "
        + "; ".join(f"{n}: K1 {v['k1']} (predicted {v['predicted']}), {v['dispatches']}, "
                    f"{v['stats']}" for n, v in spec.items()) + f" [{smi}]")
    if any(v["k1"] != v["predicted"] or v["k1"] == 0 or v["dispatches"]["decode_dispatches"]
           for v in spec.values()):
        raise AssertionError(f"SH (e): {[(v['k1'], v['predicted']) for v in spec.values()]}")
    out.update(spec_k1=spec["sharded"]["k1"], spec_same=spec_same, spec_ties=spec_ties)

    # (f) the CLI
    t3 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mesh-data", str(SH_HOSTS),
           "--slots-per-host", str(SH_SLOTS), "--prefill-chunk", str(SERVE_CHUNK)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in cli.stdout.splitlines() if ln.startswith("[serve]")]
    for ln in lines:
        log(f"[SH cli] {ln}")
    if cli.returncode or not any(ln.startswith("[serve] per-host requests: ") for ln in lines):
        raise AssertionError(f"SH (f): the CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    log(f"[SH time] serve and checks {t2 - t0:.1f} s, spec {t3 - t2:.1f} s, CLI "
        f"{time.time() - t3:.1f} s")
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
# Every spec_phase profiles a serve of phase P's requests SERVE_PROFILE_REQUESTS
# only (request 2: a 64-token prompt, one admission chunk, then 16 tokens of
# decode or verify): reading back a whole serve's ~280k kernel events took
# 65-70 s (phases P and A1 on an H100), a serve of request 0 (1024 + 48
# tokens, 149k events) 39 s (PERF.md, phase D), and the script must finish
# within its time limit.
SERVE_PROFILE_REQUESTS = (2,)
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


P_MAX_LEN = 4096   # the engine's default: bounds an attention model's requests


def spec_phase(T, k1, cfg, dev, k1_rows, runs=P_RUNS, tag="P", profiled="ngram",
               verify=K1_VERIFY, gap_cap=None, tie_tol=None, require_accept=True,
               profile_requests=SERVE_PROFILE_REQUESTS, keep=False) -> dict:
    """Phase P (and A1 with the native config and ``runs`` plain and
    n-gram): continuous serve of full-width SmolLM-360M (bf16) in the modes
    of ``runs`` (plain, n-gram draft, node draft, adaptive n-gram, the SLO
    ladder), its matrices cast to bf16 as the serve CLI casts them. Checks
    (a) every stream against each request run alone, teacher-forced (the
    SLO run's at the node budget the ladder gave each of its decode ticks),
    under the near-tie rule at P_TIE_TOL, with the largest chunk-form vs
    recurrent-form logit gap along the plain streams, which it reads and
    prints, at most P_GAP_CAP; (b) spec runs make fewer target decode-phase
    dispatches (verify) than plain decode and the n-gram run accepts
    tokens; (c) K1 launches = STLT layers x (admission + verify + draft
    prefill/commit dispatches) in every run (0 for attention); (d) the SLO
    run breaches its queue depth, steps down and all the way back up, and
    serves every budget. Times each run and profiles the ``profiled`` serve
    (device kernels only). ``verify`` is K1's verify shape in ``k1_rows``;
    ``gap_cap`` and ``tie_tol`` replace P_GAP_CAP and P_TIE_TOL (phase H's
    hybrid). With ``require_accept`` off (phase H: at random init the
    hybrid's greedy streams need not follow the prompts' motifs, and the
    H100 read 0 of 912 drafts accepted), (b) asks only that verify replace
    decode without taking more ticks, and the accept rate is logged.
    ``profile_requests`` (indices into phase P's requests) profiles a serve
    of only those requests (None: the whole serve). A stream equal to the plain run's is held to the plain
    run's teacher-forced rows (the same tokens give the same rows). The fp32
    masters are dropped once cast; their peak is logged. With ``keep`` the
    result also holds what phase D compares with: the cast params, the plain
    run's streams and their teacher-forced rows."""
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.prefix_cache import pytree_nbytes
    from repro_torch.utils import cast_params_for_compute

    smi = smi_line()
    gap_cap = P_GAP_CAP if gap_cap is None else gap_cap
    tie_tol = P_TIE_TOL if tie_tol is None else tie_tol
    torch.cuda.reset_peak_memory_stats()
    params = cast_params_for_compute(
        T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev), cfg.act_dtype)
    torch.cuda.synchronize()
    init_peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    log(f"[{tag} serve] {cfg.name}: fp32 init then the bf16 cast peaked at "
        f"{init_peak / 2**30:.2f} GiB; {held / 2**30:.2f} GiB held once the fp32 masters "
        f"are dropped [{smi}]")
    reqs = spec_requests(cfg, Request)
    arrivals = [s[3] for s in P_SPEC]
    L = stlt_layers(cfg)
    names = [name for name, _ in runs]
    engines = {name: ServeEngine(params, cfg, max_len=P_MAX_LEN, prefill_chunk=P_CHUNK,
                                 device=dev, **kw)
               for name, kw in runs}
    slot_bytes = pytree_nbytes(T.init_decode_state(cfg, 1, P_MAX_LEN, device=dev))
    kinds = {bt: cfg.block_types().count(bt) for bt in dict.fromkeys(cfg.block_types())}
    log(f"[{tag} serve] decode state of one slot at max_len {P_MAX_LEN}: {slot_bytes} bytes "
        f"({slot_bytes / 2**20:.2f} MiB; blocks {kinds}, {cfg.dtype} activations)")
    # the node budget of each of a request's decode ticks in the SLO run
    slo_caps = {}
    if "slo" in engines:
        row_caps = engines["slo"]._row_caps

        def logged_caps(hosts, K):
            caps = row_caps(hosts, K)
            for h, host in enumerate(hosts):
                for local in np.flatnonzero(host.sched.live):
                    slo_caps.setdefault(host.sched.req[local].id, []).append(
                        int(caps[h * K + local]))
            return caps
        engines["slo"]._row_caps = logged_caps

    def serve(name, picked=None):
        eng = engines[name]
        torch.cuda.synchronize()
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        sub = range(len(reqs)) if picked is None else picked
        res, stats = eng.serve([reqs[i] for i in sub], slots=P_SLOTS,
                               arrivals=[arrivals[i] for i in sub],
                               return_stats=True)
        torch.cuda.synchronize()
        return res, stats, time.time() - t0, k1.stlt_scan_kernel.launches

    t_phase = time.time()
    serve("plain")   # first call: one-time costs
    done = {}
    for name in names:
        res, stats, wall, launches = serve(name)
        eng = engines[name]
        ss = dict(eng.serve_stats)
        if (L and launches == 0) or launches != L * k1_dispatches(ss):
            raise AssertionError(f"{tag} (c) {name}: {launches} K1 launches for {ss}")
        for r in reqs:
            if len(res[r.id]) != r.max_new_tokens or not ((res[r.id] >= 0)
                                                          & (res[r.id] < cfg.vocab)).all():
                raise AssertionError(f"{tag} {name}: request {r.id} gave {res[r.id]}")
        done[name] = {"res": res, "k1_launches": launches, "serve_stats": ss,
                      "spec_stats": dict(eng.spec_stats), "node_stats": dict(eng.node_stats),
                      **serve_metrics(res, stats, reqs, wall)}
        log(f"[{tag} serve] {name}: wall {wall:.3f} s, {done[name]['tokens']} tokens, "
            f"{done[name]['tok_s']:.1f} generated tok/s; TTFT p50/p99 "
            f"{done[name]['ttft_ms'][0]:.2f}/{done[name]['ttft_ms'][1]:.2f} ms; inter-token "
            f"gap p50/p99 {done[name]['gap_ms'][0]:.3f}/{done[name]['gap_ms'][1]:.3f} ms; "
            f"{launches} K1 launches = {L} STLT layers x {k1_dispatches(ss)} dispatches; {ss} "
            f"[{smi}]")
        if name not in ("plain", "slo"):
            log(f"[{tag} serve] {name} spec_stats {done[name]['spec_stats']}")

    # (b) fewer target decode-phase dispatches; the n-gram draft is accepted
    plain_ticks = done["plain"]["serve_stats"]["decode_dispatches"]
    spec_names = [n for n in ("ngram", "nodes", "ngram_adaptive") if n in done]
    most = plain_ticks - 1 if require_accept else plain_ticks
    for name in spec_names:
        ss = done[name]["serve_stats"]
        if not (ss["decode_dispatches"] == 0 and 0 < ss["verify_dispatches"] <= most):
            raise AssertionError(f"{tag} (b) {name}: {ss} against {plain_ticks} plain decode "
                                 "dispatches")
    if "ngram" in done and require_accept and not done["ngram"]["spec_stats"]["accepted"] > 0:
        raise AssertionError(f"{tag} (b): the n-gram draft accepted nothing: "
                             f"{done['ngram']['spec_stats']}")
    # (d) the SLO ladder
    if "slo" in done:
        ns = done["slo"]["node_stats"]
        log(f"[{tag} serve] slo node_stats {ns}")
        if not (ns["queue_breaches"] > 0 and ns["degrade_steps"] >= 1
                and ns["restore_steps"] == ns["degrade_steps"]
                and ns["min_nodes"] < cfg.stlt_nodes):
            raise AssertionError(f"{tag} (d): node_stats {ns}")

    log(f"[{tag} time] the serves: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    # (a) streams against each request run alone, teacher-forced
    window = P_K + 1
    checks, gap = {}, 0.0
    with torch.no_grad():
        for r in reqs:
            if "slo" in done and len(slo_caps.get(r.id, [])) != len(done["slo"]["res"][r.id]) - 1:
                raise AssertionError(f"{tag} (a) slo: request {r.id}: "
                                     f"{len(done['slo']['res'][r.id])} tokens, node budgets "
                                     f"of {len(slo_caps.get(r.id, []))} decode ticks")
            logits, state = prompt_alone(T, cfg, params, dev, r.prompt, P_CHUNK, P_MAX_LEN)
            for name in names:
                if name not in ("plain", "slo") and np.array_equal(done[name]["res"][r.id],
                                                                   done["plain"]["res"][r.id]):
                    checks[(name, r.id)] = checks[("plain", r.id)]
                    continue
                rows, g = teacher_forced(
                    T, cfg, params, dev, state, logits, done[name]["res"][r.id],
                    window if name == "plain" else None,
                    slo_caps[r.id] if name == "slo" else None)
                checks[(name, r.id)] = rows
                gap = max(gap, g)
    log(f"[{tag} serve] (a) the largest chunk-form vs recurrent-form logit gap over every "
        f"{window}-token window of the plain streams: {gap:.6g} (cap {gap_cap}) [{smi}]")
    if not gap <= gap_cap:
        raise AssertionError(f"{tag} (a): chunk-form vs recurrent-form logit gap {gap} "
                             f"> {gap_cap}")
    tol = tie_tol
    ties = {name: 0 for name in names}
    tie_gap = {name: 0.0 for name in names}
    for (name, rid), rows in checks.items():
        for step, ((best, d), tok) in enumerate(zip(rows, done[name]["res"][rid])):
            if best != int(tok):
                if not d < tol:
                    raise AssertionError(f"{tag} (a) {name}: request {rid} step {step}: "
                                         f"served {int(tok)}, alone argmax {best}, logit gap "
                                         f"{d} >= {tol}")
                ties[name] += 1
                tie_gap[name] = max(tie_gap[name], d)
    same = {name: all(np.array_equal(done[name]["res"][r.id], done["plain"]["res"][r.id])
                      for r in reqs) for name in ties}
    log(f"[{tag} serve] (a) every stream equals its request run alone"
        f"{' (the SLO run at the ladder node budgets)' if 'slo' in done else ''} within the "
        f"bf16 tolerance {tol:.4g}; near-tie steps {ties}, the largest served-vs-argmax logit "
        f"gap among them {tie_gap}; stream equal to plain {same}; (b) target decode-phase "
        f"dispatches: plain {plain_ticks}, " + ", ".join(
            f"{n} {done[n]['serve_stats']['verify_dispatches']}" for n in spec_names)
        + f" [{smi}]")

    log(f"[{tag} time] the alone checks: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    # one serve, profiled (kernels only); K1 at the verify shape
    pss = done[profiled]["serve_stats"]
    what = f"{profiled} serve"
    if profile_requests is not None:
        serve(profiled, profile_requests)
        pss = dict(engines[profiled].serve_stats)
        what += f" of request(s) {list(profile_requests)}"
    ticks = pss.get("verify_dispatches", 0) + pss["decode_dispatches"]
    prof = serve_profile(lambda: serve(profiled, profile_requests), ticks,
                         L * k1_dispatches(pss))
    log(f"[{tag} time] the profile: {time.time() - t_phase:.1f} s")
    if prof is None:
        log(f"[{tag} profile] {what}: not measured (every profile dropped "
            f"kernels) [{smi}]")
    else:
        log(f"[{tag} profile] {what}: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms = {100 * prof['busy']:.1f}% of wall, "
            f"{prof['launches']} kernel launches = {prof['launches_per_tick']:.1f} per "
            f"decode or verify tick; K1 {prof['k1_ms']:.3f} ms = "
            f"{100 * prof['k1_share']:.1f}% of device time [{smi}]")
        log_top_kernels(tag, prof["top"], prof["busy_ms"])
    if L and k1_rows is not None:
        vrow = k1_rows[verify]
        from repro_torch.kernels import ops
        vargs, _, _ = k1_case(k1, ops, dev, *verify[:2], cfg.stlt_chunk, *verify[2:], seed=5)
        vrow["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*vargs, chunk=cfg.stlt_chunk),
                                  iters=20)
        device = "not measured" if vrow["device"] is None else f"{vrow['device']:.4f} ms"
        log(f"[{tag} K1] at the verify shape {verify[0]} x {verify[1]} "
            f"(S={verify[2]}, d={verify[3]}): ops.stlt_scan {vrow['scan']:.4f} ms (host "
            f"operators + launch), K1 device time {device}, kernel alone {vrow['alone']:.4f} ms, plain "
            f"version {vrow['plain']:.4f} ms, bound {vrow['bound']:.5f} ms "
            f"({vrow['bound_by']}) [{smi}]")
    kept = {}
    if keep:
        kept = {"params": params, "plain": done["plain"]["res"],
                "plain_rows": {r.id: checks[("plain", r.id)] for r in reqs}}
    for name in done:
        del done[name]["res"]
    return {"runs": done, "profile": prof, "tol": tol, "gap": gap, "ties": ties,
            "tie_gap": tie_gap, "same": same, "slot_bytes": slot_bytes,
            "init_peak_gib": init_peak / 2**30, "held_gib": held / 2**30, **kept}


# ---------------------------------------------------------------------------
# Phase D: disaggregated prefill/decode serving of phase P's model
# ---------------------------------------------------------------------------
# Phase P's SmolLM-360M-stlt (its cast params) and requests served by
# serving.disagg.DisaggController on the one card: 2 prefill hosts and 2
# decode hosts x 2 slots (phase P's 4 decode rows), chunk 512, over the
# loopback transport. D2's chaos: a seeded schedule of message faults
# (D_FAULTS, seed D_CHAOS_SEED) plus one prefill host and one decode host
# killed at the ticks of D_KILLS (mid-trace: prompts are still being
# admitted at tick 6, every request is decoding or queued at tick 12). D3:
# one prefill worker process on the same card over a 127.0.0.1 socket; its
# one host holds the prefill fleet's D_PREFILL x D_SLOTS rows, so its K1
# calls have the admission shapes phase 2 holds (60 and 15 x 512).
D_PREFILL, D_DECODE, D_SLOTS = 2, 2, 2
D_WORKER_SLOTS = D_PREFILL * D_SLOTS
D_FAULTS = dict(drop=0.05, dup=0.05, delay=0.05, corrupt=0.05)
D_CHAOS_SEED = 1
D_KILLS = {6: ("prefill/1",), 12: ("decode/0",)}
D_WORKER_WAIT_S = 180    # the worker's start (imports, params) and its serve


def fleet_k1(k1, engine) -> dict:
    """Counts the K1 launches made inside an engine's tick phases (its
    fleet's launches): wraps its ``_tick_admission`` and ``_tick_decode``."""
    counts = {"k1": 0}
    for name in ("_tick_admission", "_tick_decode"):
        real = getattr(engine, name)

        def counted(run, real=real):
            before = k1.stlt_scan_kernel.launches
            out = real(run)
            counts["k1"] += k1.stlt_scan_kernel.launches - before
            return out
        setattr(engine, name, counted)
    return counts


def fleet_metrics(res, stats, reqs, wall) -> dict:
    """Wall, tok/s, and TTFT and gap percentiles on the fleet clocks: a
    request's TTFT is its prefill-fleet span (``prefill_s``: admit queue to
    handoff, 0 when it was prefilled on the decode fleet) plus its
    decode-fleet span (first token's wall minus its ``arrival_wall``, both
    on the decode clock); gaps are between its decode-clock token walls."""
    n_tok = sum(len(v) for v in res.values())
    ttft = [1e3 * (stats[r.id].get("prefill_s", 0.0) + stats[r.id]["token_walls"][0]
                   - stats[r.id]["arrival_wall"]) for r in reqs]
    gaps = [1e3 * (b - a) for r in reqs
            for a, b in zip(stats[r.id]["token_walls"], stats[r.id]["token_walls"][1:])]
    return {"wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
            "ttft_ms": np.percentile(ttft, [50, 99]).tolist(),
            "gap_ms": np.percentile(gaps, [50, 99]).tolist()}


def disagg_stream_check(T, cfg, params, dev, reqs, res, plain, plain_rows, what) -> dict:
    """Every stream of ``res`` in full and held to phase P's plain colocated
    run under the near-tie rule: a stream equal to the plain one passes (P
    held it to each request run alone); another is fed to ``decode_step``
    from its request run alone (``teacher_forced``) and every served token
    must be the alone argmax or trail it by less than P_TIE_TOL. Returns the
    equal streams, the near-tie steps and their largest logit gap."""
    equal, ties, worst = 0, 0, 0.0
    for r in reqs:
        stream = res[r.id]
        if len(stream) != r.max_new_tokens or not ((stream >= 0) & (stream < cfg.vocab)).all():
            raise AssertionError(f"{what}: request {r.id} gave {stream}")
        if np.array_equal(stream, plain[r.id]):
            equal += 1
            continue
        logits, state = prompt_alone(T, cfg, params, dev, r.prompt, P_CHUNK, P_MAX_LEN)
        rows, _ = teacher_forced(T, cfg, params, dev, state, logits, stream)
        for step, ((best, d), tok) in enumerate(zip(rows, stream)):
            if best != int(tok):
                if not d < P_TIE_TOL:
                    raise AssertionError(f"{what}: request {r.id} step {step}: served "
                                         f"{int(tok)}, alone argmax {best}, logit gap {d} "
                                         f">= {P_TIE_TOL}")
                ties += 1
                worst = max(worst, d)
    return {"equal": equal, "ties": ties, "tie_gap": worst}


def disagg_phase(T, k1, cfg, dev, p_out, tag="D") -> dict:
    """Phase D: phase P's SmolLM-360M-stlt served by the disaggregated
    controller at full width, its plain run (``p_out``, ``spec_phase(...,
    keep=True)``) the reference. D1 (loopback, f32 wire): every stream
    against P's plain stream under the near-tie rule; the prefill fleet's
    K1 launches = STLT layers x its admission dispatches and the decode
    fleet's 0 (no admission dispatch there); handoff bytes equal across
    prompt lengths, beside the state's bytes; one shipped state unpacked bit
    for bit equal to the state the prefill engine packed; fleet-clock TTFT
    and gaps beside P's. Then the bf16 wire (byte ratio, streams) and a
    compressed blob (the codec that ran, the round trip). D2: chaos and two
    kills; every request completes under the near-tie rule, at least 2
    failures detected. D3: a socket prefill worker process; streams under
    the near-tie rule, no failure detected, the worker exits 0 after
    ``bye`` and reports K1 launches = STLT layers x its admission
    dispatches > 0 (none in this process). D4: the native SmolLM-360M decode state's blob beside D1's."""
    from repro_torch.serving import DisaggController, FaultSchedule, Request
    from repro_torch.serving.disagg import wire
    from repro_torch.serving.disagg import worker as worker_lib
    from repro_torch.serving.disagg.transport import Message, SocketTransport
    from repro_torch.serving.prefix_cache import pytree_nbytes
    from repro_torch.utils import tree_flatten_with_paths

    smi = smi_line()
    params, plain, plain_rows = p_out["params"], p_out["plain"], p_out["plain_rows"]
    reqs = spec_requests(cfg, Request)
    arrivals = [s[3] for s in P_SPEC]
    L = stlt_layers(cfg)
    state_bytes = pytree_nbytes(T.init_decode_state(cfg, 1, P_MAX_LEN, device=dev))
    out = {"state_bytes": state_bytes}

    def controller(**kw):
        return DisaggController(params, cfg, n_prefill=D_PREFILL, n_decode=D_DECODE,
                                slots=D_SLOTS, max_len=P_MAX_LEN, prefill_chunk=P_CHUNK,
                                device=dev, **kw)

    def serve(ctl, name):
        counts = {"prefill": fleet_k1(k1, ctl.prefill), "decode": fleet_k1(k1, ctl.decode)}
        torch.cuda.synchronize()
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        res, stats = ctl.serve(reqs, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = k1.stlt_scan_kernel.launches
        pe, de = ctl.prefill.serve_stats, ctl.decode.serve_stats
        p_k1, d_k1 = counts["prefill"]["k1"], counts["decode"]["k1"]
        if not (launches == p_k1 == L * pe["admission_dispatches"] > 0 and d_k1 == 0
                and de["admission_dispatches"] == 0):
            raise AssertionError(f"{tag} {name}: {launches} K1 launches, prefill fleet "
                                 f"{p_k1} for {pe}, decode fleet {d_k1} for {de}")
        rep = ctl.report()
        check = disagg_stream_check(T, cfg, params, dev, reqs, res, plain, plain_rows,
                                    f"{tag} {name}")
        row = {"k1_launches": launches, "prefill_k1": p_k1, "decode_k1": d_k1,
               "prefill_stats": dict(pe), "decode_stats": dict(de),
               "handoff_bytes": dict(ctl.handoff_bytes), "res": res,
               "prefill_clock_s": rep["prefill_clock_s"],
               "decode_clock_s": rep["decode_clock_s"], **check,
               **fleet_metrics(res, stats, reqs, wall)}
        log(f"[{tag} {name}] wall {wall:.3f} s, {row['tokens']} tokens, {row['tok_s']:.1f} "
            f"tok/s; fleet clocks prefill {row['prefill_clock_s']:.3f} s, decode "
            f"{row['decode_clock_s']:.3f} s; TTFT p50/p99 {row['ttft_ms'][0]:.2f}/"
            f"{row['ttft_ms'][1]:.2f} ms, gap p50/p99 {row['gap_ms'][0]:.3f}/"
            f"{row['gap_ms'][1]:.3f} ms on the fleet clocks (P plain colocated: TTFT "
            f"{p_plain['ttft_ms'][0]:.2f}/{p_plain['ttft_ms'][1]:.2f} ms, gap "
            f"{p_plain['gap_ms'][0]:.3f}/{p_plain['gap_ms'][1]:.3f} ms, wall "
            f"{p_plain['wall_s']:.3f} s); K1 launches {launches} = prefill fleet {p_k1} "
            f"= {L} layers x {pe['admission_dispatches']} admission dispatches, decode fleet "
            f"{d_k1} ({de['decode_dispatches']} decode dispatches); streams equal to P's "
            f"plain {check['equal']}/{len(reqs)}, near-tie steps {check['ties']} (largest gap "
            f"{check['tie_gap']:.4g} < {P_TIE_TOL}) [{smi}]")
        return row

    p_plain = p_out["runs"]["plain"]
    t_phase = time.time()
    controller().serve(reqs, arrivals=arrivals)   # first call: one-time costs
    # D1: loopback, f32 wire; capture one shipped state and its blob
    ctl = controller()
    shipped = {}
    real_promote, real_accept = ctl.prefill._handoff_promote, ctl._accept_handoff

    def capture_state(run, h, local, ent, logits1, st1):
        if "rid" not in shipped:
            shipped["rid"] = ent["req"].id
            shipped["state"] = [(k, t.clone()) for k, t in tree_flatten_with_paths(st1)]
        return real_promote(run, h, local, ent, logits1, st1)

    def capture_blob(msg, j, d_run, receiver):
        if msg.payload["req"].id == shipped.get("rid") and "blob" not in shipped:
            shipped["blob"] = msg.payload["blob"]
        return real_accept(msg, j, d_run, receiver)
    ctl.prefill._handoff_promote, ctl._accept_handoff = capture_state, capture_blob
    d1 = serve(ctl, "D1 loopback f32")
    hb = d1["handoff_bytes"]
    if sorted(hb) != [r.id for r in reqs] or len(set(hb.values())) != 1:
        raise AssertionError(f"{tag} D1: handoff bytes {hb}")
    blob_bytes = next(iter(hb.values()))
    got = dict(tree_flatten_with_paths(wire.unpack_state(shipped["blob"], device=dev)[0]))
    for k, t in shipped["state"]:
        if not (got[k].dtype == t.dtype and torch.equal(got[k], t)):
            raise AssertionError(f"{tag} D1: request {shipped['rid']}'s shipped {k} differs "
                                 "from the state the prefill engine packed")
    lens = sorted(len(r.prompt) for r in reqs)
    log(f"[{tag} D1] handoff bytes per request {blob_bytes} for every prompt of "
        f"{lens[0]}-{lens[-1]} tokens (the state: {state_bytes} bytes; header and meta "
        f"{blob_bytes - state_bytes}); request {shipped['rid']}'s shipped state unpacks bit "
        f"for bit to the state the prefill engine packed ({len(shipped['state'])} leaves) "
        f"[{smi}]")
    # the bf16 wire, and a compressed blob
    d1b = serve(controller(wire_store="bf16"), "D1 loopback bf16 wire")
    ratio = next(iter(d1b["handoff_bytes"].values())) / blob_bytes
    if len(set(d1b["handoff_bytes"].values())) != 1 or not ratio < 0.75:
        raise AssertionError(f"{tag} D1 bf16: handoff bytes {d1b['handoff_bytes']}")
    packed = wire.pack_state(wire.unpack_state(shipped["blob"])[0], compress="zstd")
    fixed = len(wire.MAGIC) + 12
    hlen = int.from_bytes(packed[len(wire.MAGIC) + 4:len(wire.MAGIC) + 8], "little")
    codec = json.loads(packed[fixed:fixed + hlen])["codec"]
    same = wire.unpack_state(packed)[1] == wire.unpack_state(shipped["blob"])[1]
    if codec != wire.wire_codec("zstd") or not same:
        raise AssertionError(f"{tag} D1: compressed blob codec {codec}, digest equal {same}")
    log(f"[{tag} D1] bf16 wire: {next(iter(d1b['handoff_bytes'].values()))} bytes per "
        f"request = {ratio:.4f} of the f32 wire's; compress='zstd' ran codec {codec!r}: "
        f"{len(packed)} bytes ({len(packed) / blob_bytes:.4f} of the plain blob), unpacks "
        f"to the same digest [{smi}]")
    log(f"[{tag} time] D1: {time.time() - t_phase:.1f} s")

    # D2: chaos, one prefill and one decode host killed mid-trace
    t_phase = time.time()
    ctl = controller(faults=FaultSchedule(D_CHAOS_SEED, kills=D_KILLS, **D_FAULTS))
    d2 = serve(ctl, "D2 chaos")
    fs = ctl.fault_stats()
    d2["equal_d1"] = sum(np.array_equal(d2["res"][r.id], d1["res"][r.id]) for r in reqs)
    if fs["detected_failures"] < 2 or fs["outbox_unacked"]:
        raise AssertionError(f"{tag} D2: fault_stats {fs}")
    d2["fault_stats"] = fs
    log(f"[{tag} D2] chaos seed {D_CHAOS_SEED} {D_FAULTS}, kills {D_KILLS}: every request "
        f"completed; streams bit-equal to D1's {d2['equal_d1']}/{len(reqs)}; fault_stats "
        f"{json.dumps(fs)} [{smi}]")
    log(f"[{tag} time] D2: {time.time() - t_phase:.1f} s")

    # D3: one prefill worker process on the same card, over a socket
    t_phase = time.time()
    tr = SocketTransport("controller", listen=("127.0.0.1", 0))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.serving.disagg.worker",
                             "--connect", f"127.0.0.1:{tr._server.getsockname()[1]}",
                             "--name", "prefill/0", "--max-idle-s", str(D_WORKER_WAIT_S)],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    timer = threading.Timer(D_WORKER_WAIT_S, lambda: proc.poll() is None and proc.kill())
    timer.daemon = True
    timer.start()
    try:
        hello = False
        while not hello and time.time() - t0 < D_WORKER_WAIT_S and proc.poll() is None:
            hello = any(m.kind == "hello" for m in tr.recv("controller", timeout=0.2))
        if not hello:
            raise AssertionError(f"{tag} D3: the worker never said hello: "
                                 f"{proc.stderr.read().decode()[-2000:] if proc.poll() is not None else ''}")
        hello_s = time.time() - t0
        tr.send(Message("config", "controller", "prefill/0", {
            "cfg": worker_lib.cfg_to_wire(cfg), "seed": 0, "max_len": P_MAX_LEN,
            "prefill_chunk": P_CHUNK, "slots": D_WORKER_SLOTS, "prompt_len": None,
            "wire_store": "f32"}))
        ctl = DisaggController(params, cfg, n_prefill=1, n_decode=D_DECODE, slots=D_SLOTS,
                               max_len=P_MAX_LEN, prefill_chunk=P_CHUNK, device=dev,
                               transport=tr, remote_prefill=["prefill/0"],
                               heartbeat_deadline_s=D_WORKER_WAIT_S / 2)
        counts = fleet_k1(k1, ctl.decode)
        k1.stlt_scan_kernel.launches = 0
        t1 = time.time()
        res, stats = ctl.serve(reqs, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        wall = time.time() - t1
        fs = ctl.fault_stats()
        if fs["detected_failures"] or k1.stlt_scan_kernel.launches or counts["k1"]:
            raise AssertionError(f"{tag} D3: {k1.stlt_scan_kernel.launches} K1 launches in "
                                 f"the controller's process; fault_stats {fs}")
        check = disagg_stream_check(T, cfg, params, dev, reqs, res, plain, plain_rows,
                                    f"{tag} D3")
        tr.send(Message("bye", "controller", "prefill/0", {}))
        err = proc.communicate(timeout=D_WORKER_WAIT_S)[1].decode()
        if proc.returncode != 0:
            raise AssertionError(f"{tag} D3: the worker exited {proc.returncode}: "
                                 f"{err[-2000:]}")
        # the worker's report after bye: its K1 launches and dispatches
        wk = next((json.loads(line) for line in reversed(err.splitlines())
                   if line.startswith('{"worker"')), None)
        if wk is None or not (wk["k1_launches"] == L * wk["admission_dispatches"] > 0):
            raise AssertionError(f"{tag} D3: the worker's report {wk}: K1 launches must be "
                                 f"{L} x its admission dispatches > 0: {err[-2000:]}")
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        tr.close()
    d3 = {"hello_s": hello_s, "handoff_bytes": dict(ctl.handoff_bytes), **check,
          "worker_k1": wk["k1_launches"], "worker_stats": wk,
          "equal_d1": sum(np.array_equal(res[r.id], d1["res"][r.id]) for r in reqs),
          "decode_clock_s": ctl.decode.clock, **fleet_metrics(res, stats, reqs, wall)}
    log(f"[{tag} D3] socket worker: start-up {hello_s:.2f} s to its hello (process, "
        f"imports, connect), serve wall {wall:.3f} s (the worker's params and first "
        f"dispatches included), {len(d3['handoff_bytes'])} handoffs of "
        f"{sorted(set(d3['handoff_bytes'].values()))} bytes; 0 K1 launches in the "
        f"controller's process, {wk['k1_launches']} in the worker's = {L} layers x "
        f"{wk['admission_dispatches']} admission dispatches ({D_WORKER_SLOTS} rows); "
        f"streams equal to P's plain "
        f"{check['equal']}/{len(reqs)}, to D1's {d3['equal_d1']}/{len(reqs)}, near-tie "
        f"steps {check['ties']}; the worker exited 0 after bye [{smi}]")
    log(f"[{tag} time] D3: {time.time() - t_phase:.1f} s")

    # D4: the native SmolLM-360M decode state (a KV cache of P_MAX_LEN) as a blob
    from repro_torch.configs import get_config
    native = get_config("smollm-360m")
    kv_state = T.init_decode_state(native, 1, P_MAX_LEN, device=dev)
    kv_blob = len(wire.pack_state(kv_state))
    log(f"[{tag} D4] native SmolLM-360M decode state at max_len {P_MAX_LEN}: "
        f"{pytree_nbytes(kv_state)} bytes, blob {kv_blob} bytes = {kv_blob / blob_bytes:.2f}x "
        f"D1's STLT blob ({blob_bytes} bytes) [{smi}]")
    del kv_state
    for row in (d1, d1b, d2):
        del row["res"]
    out.update(D1=d1, D1_bf16=d1b, D2=d2, D3=d3, blob_bytes=blob_bytes,
               bf16_ratio=ratio, codec=codec, compressed_bytes=len(packed),
               kv_blob_bytes=kv_blob, kv_ratio=kv_blob / blob_bytes)
    return out


# ---------------------------------------------------------------------------
# Phase W: whisper-base's STLT variant (the encoder-decoder family)
# ---------------------------------------------------------------------------


def whisper_k1_calls(cfg, grad: bool) -> int:
    """K1 calls of one enc-dec forward (grad=False: 2 a bilateral encoder
    layer, 1 a decoder layer) or forward + backward (each call's dx pass in
    the other direction, and the remat recompute of a side the JAX package
    stacks: ``scan_layers`` and more than one layer). The attention form
    makes none."""
    L, Ld = cfg.num_layers, cfg.num_decoder_layers
    if not cfg.mixer.startswith("stlt"):
        return 0
    if not grad:
        return 2 * L + Ld
    remat = lambda n: cfg.remat and cfg.scan_layers and n > 1  # noqa: E731
    return (4 + 2 * remat(L)) * L + (2 + remat(Ld)) * Ld


def whisper_profile(fn, tag: str, k1_calls: int, annotations=()) -> dict:
    """``serve_profile`` of one call of ``fn`` in phase W, logged with its
    spans and its ten largest kernels."""
    out = serve_profile(fn, 1, k1_calls, annotations)
    if out is None:
        log(f"[{tag} profile] not measured (every profile dropped kernels)")
        return None
    log(f"[{tag} profile] wall {out['wall_ms']:.3f} ms (profiled), device busy "
        f"{out['busy_ms']:.3f} ms = {100 * out['busy']:.1f}% of wall, {out['launches']} kernel "
        f"launches; K1 {out['k1_ms']:.4f} ms ({k1_calls} calls); " + ", ".join(
            f"{a} {t:.4f} ms ({100 * t / out['busy_ms']:.1f}%)"
            for a, t in out["spans_ms"].items()))
    log_top_kernels(tag, out["top"], out["busy_ms"])
    return out


def whisper_frames(cfg, dev, B: int, M: int, seed: int):
    """Random frame embeddings [B, M, d], the stub frontend's output."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, M, cfg.d_model, generator=g, device=dev)


def whisper_decode_phase(W, steps, k1, cfg, dev, B=W_B, new=W_NEW, tag="W1") -> dict:
    """Phase W1 (and A4 with the native config): full-width whisper-base,
    matrices cast as ``steps.serving_params`` casts them. Encode B x M
    frames (the prefill: encode + each decoder layer's cross context, or
    its cross keys and values; 2 K1 calls an STLT encoder layer, none an
    attention one), decode ``new`` tokens greedily from token 1 (no K1), and hold
    each step's logits against ``apply_encdec`` teacher-forced on the
    produced tokens: the largest gap, printed, at most W_GAP_CAP, and every
    token the teacher's argmax or within W_TIE_TOL of it (bounds on
    rounding noise; the tight checks are ``whisper_cpu_check``'s). Times the encode,
    the prefill and a decode step by CUDA events and profiles a decode step
    (the cross context's score products beside the step's HBM bound)."""
    from repro_torch.serving.prefix_cache import pytree_nbytes

    smi, M = smi_line(), steps.WHISPER_ENC_FRAMES
    stlt = cfg.mixer.startswith("stlt")
    masters = W.init_encdec(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = steps.serving_params(masters, cfg)
    frames = whisper_frames(cfg, dev, B, M, seed=0)
    L, Ld = cfg.num_layers, cfg.num_decoder_layers
    prefill, decode = steps.prefill_fn(cfg, new), steps.decode_fn(cfg)
    from repro_torch.kernels import relevance_flash as k2

    with torch.no_grad():
        prefill(params, frames)                  # first call: one-time costs
        torch.cuda.synchronize()
        k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
        state = prefill(params, frames)
        torch.cuda.synchronize()
        enc_launches = k1.stlt_scan_kernel.launches
        if enc_launches != 2 * L * stlt or k2.relevance_flash_kernel.launches:
            raise AssertionError(f"{tag}: {enc_launches} K1 launches in the encode (expected "
                                 f"{2 * L * stlt}), {k2.relevance_flash_kernel.launches} K2")
        state_gib = pytree_nbytes(state["dec"]) / 2**30
        tok = torch.ones(B, dtype=torch.int64, device=dev)
        k1.stlt_scan_kernel.launches = 0
        rows, toks, st = [], [], state
        for _ in range(new):
            logits, st = decode(params, tok, st)
            tok = logits.argmax(-1)
            rows.append(logits.float())
            toks.append(tok)
        torch.cuda.synchronize()
        dec_launches = k1.stlt_scan_kernel.launches
        if dec_launches != 0:
            raise AssertionError(f"{tag}: {dec_launches} K1 launches in {new} decode steps")
        stream = torch.stack(toks, 1)                                   # [B, new]
        dec_in = torch.cat([torch.ones_like(stream[:, :1]), stream[:, :-1]], 1)
        k1.stlt_scan_kernel.launches = 0
        teacher = W.apply_encdec(params, cfg, frames, dec_in).float()   # [B, new, V]
        torch.cuda.synchronize()
        if k1.stlt_scan_kernel.launches != whisper_k1_calls(cfg, grad=False):
            raise AssertionError(f"{tag}: {k1.stlt_scan_kernel.launches} K1 launches in the "
                                 f"teacher-forced forward, expected "
                                 f"{whisper_k1_calls(cfg, grad=False)}")
        stepped = torch.stack(rows, 1)
        gap = float((stepped - teacher).abs().max())
        scale = float(teacher.abs().max())
        if not (bool(torch.isfinite(stepped).all()) and stepped.shape == teacher.shape):
            raise AssertionError(f"{tag}: decode logits are not finite")
        best = teacher.argmax(-1)
        served_gap = (teacher.gather(-1, best[..., None]) - teacher.gather(-1, stream[..., None]))[..., 0]
        ties = int((best != stream).sum())
        worst_tie = float(served_gap.max())
    log(f"[{tag} decode] {B} x {M} frames encoded ({enc_launches} K1 launches; decode state "
        f"{state_gib:.2f} GiB), {new} greedy tokens ({dec_launches} K1 launches); decode "
        f"step vs teacher-forced apply_encdec: largest logit gap {gap:.6g} (cap {W_GAP_CAP}; "
        f"logit scale {scale:.3f}); served tokens off the teacher's argmax {ties}, the "
        f"largest served-vs-argmax gap {worst_tie:.6g} (tolerance {W_TIE_TOL}); first "
        f"tokens {stream[:, :8].tolist()} [{smi}]")
    if not gap <= W_GAP_CAP:
        raise AssertionError(f"{tag}: decode step vs teacher-forced logit gap {gap} > "
                             f"{W_GAP_CAP}")
    if not worst_tie < W_TIE_TOL:
        raise AssertionError(f"{tag}: a served token trails the teacher's argmax by "
                             f"{worst_tie}")
    gap32 = whisper_fp32_gap(W, steps, cfg, masters, frames, new, tag)
    del masters

    with torch.no_grad():
        enc_ms = time_cuda(lambda: W.encode(params, cfg, frames), iters=5)
        prefill_ms = time_cuda(lambda: prefill(params, frames), iters=3)
        step_ms = time_cuda(lambda: decode(params, tok, state), iters=20)
        if stlt:
            ctx_bytes = pytree_nbytes([[st["xctx"]["L_re"], st["xctx"]["L_im"]]
                                       for st in state["dec"]])
            step_bytes = ctx_bytes + pytree_nbytes([st["xctx"]["v"] for st in state["dec"]])
            # the matrices a step reads: self-STLT w_v and w_o, the
            # cross-STLT's w_o (its values are in the context), the FFN
            mixers = [(p["stlt"]["w_v"], p["stlt"]["w_o"], p["cross"]["w_o"])
                      for p in params["dec_layers"]]
        else:
            # the cross keys and values, the self KV caches, the projections
            ctx_bytes = pytree_nbytes([[st["xk"], st["xv"]] for st in state["dec"]])
            step_bytes = ctx_bytes + pytree_nbytes([st["self"] for st in state["dec"]])
            mixers = [tuple(p["attn"].values()) + (p["cross"]["wq"], p["cross"]["wo"])
                      for p in params["dec_layers"]]
        mats = [t for m in mixers for t in m] + [t for p in params["dec_layers"] for t in (
            p["ffn"]["w1"], p["ffn"]["w2"])] + [params["lm_head"]["kernel"]]
        step_bytes += pytree_nbytes(mats)
        bound_ms = 1e3 * step_bytes / PEAK_BYTES_PER_S
        ctx_bound_ms = 1e3 * ctx_bytes / PEAK_BYTES_PER_S
        ctx = "L_re/L_im" if stlt else "keys and values"
        log(f"[{tag} timing] encode {B} x {M} frames {enc_ms:.3f} ms "
            f"({B * M / enc_ms * 1e3:.0f} frames/s), prefill (encode + {Ld} cross contexts) "
            f"{prefill_ms:.3f} ms, decode step (batch {B}) {step_ms:.4f} ms by CUDA events; "
            f"the step's HBM bound {bound_ms:.4f} ms ({step_bytes / 1e9:.3f} GB: the cross "
            f"contexts' {ctx} {ctx_bytes / 1e9:.3f} GB = {ctx_bound_ms:.4f} ms, the rest of "
            f"the state, the decoder's matrices and the head) [{smi}]")
        prof = whisper_profile(lambda: decode(params, tok, state), f"{tag} decode step", 0,
                               annotations=("cross_stlt.scores",) if stlt else ())
        enc_prof = whisper_profile(lambda: prefill(params, frames), f"{tag} prefill",
                                   2 * L * stlt,
                                   annotations=("cross_stlt.coefficients",) if stlt else ())
    del state, st, stepped, teacher
    return {"encode_launches": enc_launches, "decode_launches": dec_launches, "gap": gap,
            "fp32_gap": gap32, "ties": ties, "worst_tie": worst_tie, "encode_ms": enc_ms,
            "prefill_ms": prefill_ms, "step_ms": step_ms, "step_bound_ms": bound_ms,
            "ctx_bound_ms": ctx_bound_ms, "state_gib": state_gib, "profile": prof,
            "prefill_profile": enc_prof}


def whisper_fp32_gap(W, steps, cfg, masters, frames, new: int, tag="W1") -> float:
    """The same encode and greedy decode at full width in fp32 (the
    masters uncast, fp32 activations): each step's logits against the
    teacher-forced ``apply_encdec`` on the produced tokens, at most
    W_FP32_GAP_CAP (a bound on rounding noise at full depth). Returns the
    gap."""
    c = dataclasses.replace(cfg, dtype="float32")
    B = frames.shape[0]
    with torch.no_grad():
        st = steps.prefill_fn(c, new)(masters, frames)
        tok = torch.ones(B, dtype=torch.int64, device=frames.device)
        rows, toks = [], []
        for _ in range(new):
            logits, st = steps.decode_fn(c)(masters, tok, st)
            tok = logits.argmax(-1)
            rows.append(logits)
            toks.append(tok)
        stream = torch.stack(toks, 1)
        dec_in = torch.cat([torch.ones_like(stream[:, :1]), stream[:, :-1]], 1)
        teacher = W.apply_encdec(masters, c, frames, dec_in)
        gap = float((torch.stack(rows, 1) - teacher).abs().max())
    log(f"[{tag} decode] fp32 (masters uncast, fp32 activations): decode step vs "
        f"teacher-forced largest logit gap {gap:.3e} (cap {W_FP32_GAP_CAP}; logit scale "
        f"{float(teacher.abs().max()):.3f})")
    if not gap <= W_FP32_GAP_CAP:
        raise AssertionError(f"{tag}: fp32 decode step vs teacher-forced logit gap {gap}")
    return gap


def whisper_cpu_check(W, steps, train, k1, cfg, dev, new=W_CPU_STEPS, tag="W") -> dict:
    """Phase W1/W2's tight checks (and A4's): whisper-base at its widths but 2 + 2
    layers, in fp32, batch 1, M frames, on the card and on the CPU from the
    same weights. (a) The decode steps' logits (the card's greedy tokens fed
    to both) and the teacher-forced logits, card against CPU, within
    W_CPU_TOL. (b) On each, every decode step against the teacher-forced
    forward on the same tokens within W_FP32_STEP_TOL, which the JAX
    package's own two forms meet at this shape. (c) Step 0 at 1 x (M
    frames, W_TRAIN_N tokens), card against CPU: the loss within
    TRAIN_LOSS_TOL, every grad leaf finite and non-zero, and the grads'
    gap (over the whole grad, and at the worst leaf) within W_GRAD_FLOOR_X
    times the CPU's own gap when K1's chunk is halved (the card's K1 calls,
    both directions and their dx passes, counted). The attention form has
    no K1 and no cross-STLT to amplify rounding: its grads are held within
    TRAIN_GRAD_TOL (each leaf) as phase T2's, its K1 launches to 0.
    Returns the gaps."""
    from repro_torch.utils import tree_map

    M = steps.WHISPER_ENC_FRAMES
    c = dataclasses.replace(cfg, num_layers=2, num_decoder_layers=2, dtype="float32")
    params = W.init_encdec(c, torch.Generator(device=dev).manual_seed(1), device=dev)
    frames = whisper_frames(c, dev, 1, M, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, c.vocab, (1, W_TRAIN_N + 1), generator=g, device=dev)
    batch = {"enc_inputs": frames, "dec_inputs": ids[:, :-1], "labels": ids[:, 1:]}
    stlt = c.mixer.startswith("stlt")
    out = {}
    for where, p, b in (("card", params, batch),
                        ("cpu", tree_map(torch.Tensor.cpu, params),
                         {k: v.cpu() for k, v in batch.items()})):
        f = b["enc_inputs"]
        t0 = time.time()
        with torch.no_grad():
            st = steps.prefill_fn(c, new)(p, f)
            tok = torch.ones(1, dtype=torch.int64, device=f.device)
            rows, toks = [], []
            for i in range(new):
                lg, st = steps.decode_fn(c)(p, tok, st)
                rows.append(lg.cpu())
                tok = (out["card"]["toks"][i] if where == "cpu" else lg.argmax(-1)).to(f.device)
                toks.append(tok.cpu())
            dec_in = torch.cat([torch.ones(1, 1, dtype=torch.int64),
                                torch.stack(toks, 1)[:, :-1]], 1).to(f.device)
            teacher = W.apply_encdec(p, c, f, dec_in).cpu()
        k1.stlt_scan_kernel.launches = 0
        loss, _, grads = train.loss_and_grads(p, c, b, tau=1.0)
        out[where] = {"rows": torch.stack(rows, 1), "toks": toks, "teacher": teacher,
                      "loss": float(loss), "grads": tree_map(torch.Tensor.cpu, grads),
                      "launches": k1.stlt_scan_kernel.launches, "s": time.time() - t0}
    card, cpu = out["card"], out["cpu"]
    # the floor: the CPU against itself with K1's chunk halved (summation
    # order only; the attention form has no K1 chunk)
    spread_grads = cpu["grads"]
    if stlt:
        _, _, spread_grads = train.loss_and_grads(
            tree_map(torch.Tensor.cpu, params),
            dataclasses.replace(c, stlt_chunk=c.stlt_chunk // 2),
            {k: v.cpu() for k, v in batch.items()}, tau=1.0)
    step_err = float((card["rows"] - cpu["rows"]).abs().max())
    tf_err = float((card["teacher"] - cpu["teacher"]).abs().max())
    forms = {w: float((o["rows"] - o["teacher"]).abs().max()) for w, o in out.items()}
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    unread = lambda q: "/cross/nodes/u_" in q  # noqa: E731
    path, worst, n = grad_gaps(card["grads"], cpu["grads"], f"{tag} card vs cpu", unread)
    s_path, s_worst, _ = grad_gaps(spread_grads, cpu["grads"], f"{tag} cpu chunks", unread)
    whole, s_whole = (whole_grad_gap(a, cpu["grads"]) for a in (card["grads"], spread_grads))
    grad_gate = ((W_GRAD_FLOOR_X * s_whole, W_GRAD_FLOOR_X * s_worst) if stlt
                 else (TRAIN_GRAD_TOL, TRAIN_GRAD_TOL))
    log_top_leaves(f"{tag} card vs cpu", card["grads"], cpu["grads"])
    if stlt:
        log_top_leaves(f"{tag} cpu chunk spread", spread_grads, cpu["grads"])
    log(f"[{tag} card vs cpu] fp32, 2 + 2 layers, 1 x {M} frames, {new} decode steps: "
        f"decode-step logits max abs err {step_err:.3e}, teacher-forced {tf_err:.3e} "
        f"(tolerance {W_CPU_TOL}; logit scale {float(cpu['teacher'].abs().max()):.3f}); "
        f"decode step vs teacher-forced on the card {forms['card']:.3e}, on the CPU "
        f"{forms['cpu']:.3e} (tolerance {W_FP32_STEP_TOL}); step 0 at 1 x ({M} + "
        f"{W_TRAIN_N}): loss relative {loss_rel:.3e} (tolerance {TRAIN_LOSS_TOL}), {n} grad "
        f"leaves finite and non-zero, ||g_card - g_cpu|| / ||g_cpu|| over the whole grad "
        f"{whole:.3e} and at the worst leaf {worst:.3e} ({path}), against the CPU's own "
        f"chunk spread {s_whole:.3e} and {s_worst:.3e} ({s_path}); gates {grad_gate[0]:.3e} "
        f"and {grad_gate[1]:.3e}, {card['launches']} K1 launches; card "
        f"{card['s']:.2f} s, CPU {cpu['s']:.2f} s")
    if card["launches"] != whisper_k1_calls(c, grad=True):
        raise AssertionError(f"{tag} card vs cpu: {card['launches']} K1 launches in step 0")
    if not max(step_err, tf_err) <= W_CPU_TOL:
        raise AssertionError(f"{tag}: card and CPU logits disagree: {step_err}, {tf_err}")
    if not max(forms.values()) <= W_FP32_STEP_TOL:
        raise AssertionError(f"{tag}: fp32 decode step vs teacher-forced: {forms}")
    if not (loss_rel <= TRAIN_LOSS_TOL and whole <= grad_gate[0] and worst <= grad_gate[1]):
        raise AssertionError(f"{tag}: card vs CPU step 0: loss {loss_rel}, grad {whole} "
                             f"(whole), {worst} at {path}")
    return {"step_err": step_err, "teacher_err": tf_err, "forms": forms,
            "loss_rel": loss_rel, "grad_whole": whole, "grad_worst": worst, "grad_leaf": path,
            "floor_whole": s_whole, "floor_worst": s_worst}


def whisper_train_phase(W, train, k1, cfg, dev, M, B=W_TRAIN_B, N=W_TRAIN_N,
                        tag="W2") -> dict:
    """Phase W2 (and A4's with the native config): whisper-base trained in bf16 (fp32 masters, the
    matrices cast inside the loss, remat as the config sets it) at B x (M
    frames, N tokens) a step. Step 0 with remat against remat off (K1
    launches 54 and 36 at full depth) and against fp32 compute: loss and
    every grad leaf, finite and non-zero (the cross-STLT's node mixers,
    which it does not read, exactly zero), within the stated tolerances.
    Then 5 AdamW steps, timed by CUDA events (54 K1 launches each), the peak
    memory with remat on and off, and one profiled step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.utils import tree_leaves

    smi = smi_line()
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=5, seed=0)
    params = W.init_encdec(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def batch(step):
        g = torch.Generator(device=dev).manual_seed(100 + step)
        toks = torch.randint(0, cfg.vocab, (B, N + 1), generator=g, device=dev)
        return {"enc_inputs": whisper_frames(cfg, dev, B, M, seed=200 + step),
                "dec_inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def unread(path):   # the cross-STLT reads no node mixers
        return "/cross/nodes/u_" in path

    b0 = batch(0)
    runs = {}
    for name, c in (("first call", cfg), ("remat", cfg),
                    ("no remat", dataclasses.replace(cfg, remat=False)),
                    ("fp32 compute", dataclasses.replace(cfg, dtype="float32"))):
        k1.stlt_scan_kernel.launches = 0
        t0 = time.time()
        loss, _, grads = train.loss_and_grads(params, c, b0, tau=1.0)
        torch.cuda.synchronize()
        n = k1.stlt_scan_kernel.launches
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in tree_leaves(grads))))
        log(f"[{tag} step 0] {name}: loss {float(loss):.6f}, grad norm {gnorm:.4f}, "
            f"{time.time() - t0:.2f} s, {n} K1 launches")
        if n != whisper_k1_calls(c, grad=True) or not torch.isfinite(loss):
            raise AssertionError(f"{tag} {name}: {n} K1 launches (expected "
                                 f"{whisper_k1_calls(c, grad=True)}), loss {float(loss)}")
        runs[name] = (float(loss), grads)
    gaps = {}
    for name, ref, loss_tol, grad_tol in (
            ("no remat", "remat", TRAIN_LOSS_TOL, TRAIN_GRAD_TOL),
            ("fp32 compute", "remat", W_BF16_LOSS_TOL, W_BF16_GRAD_TOL)):
        rel = abs(runs[ref][0] - runs[name][0]) / abs(runs[name][0])
        path, worst, n = grad_gaps(runs[ref][1], runs[name][1], f"{tag} {ref} vs {name}", unread)
        gaps[name] = {"loss": rel, "grad": worst, "leaf": path}
        log(f"[{tag} step 0] bf16 remat vs {name}: loss relative {rel:.3e} (gate {loss_tol}), "
            f"{n} grad leaves all finite and non-zero"
            f"{' (the cross-STLT u exactly zero)' if cfg.mixer.startswith('stlt') else ''}, "
            f"worst ||g - g_ref|| / ||g_ref|| {worst:.3e} ({path}; gate {grad_tol})")
        if not (rel <= loss_tol and worst <= grad_tol):
            raise AssertionError(f"{tag}: bf16 remat vs {name}: loss {rel}, grad {worst} "
                                 f"at {path}")
    del runs

    from repro_torch.kernels import relevance_flash as k2

    opt, step_fn = train.make_step(cfg, tcfg)
    opt_state = opt.init(params)
    ev_ms, walls, counts = [], [], []
    for step in range(tcfg.total_steps):
        b = batch(step)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
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
        log(f"[{tag} train] step {step}: loss {loss:.6f} grad_norm "
            f"{float(metrics['grad_norm']):.4f}; {ev_ms[-1]:.3f} ms (events), "
            f"{walls[-1]:.3f} ms (wall), {counts[-1]} K1 launches")
        if (counts[-1] != whisper_k1_calls(cfg, grad=True) or not np.isfinite(loss)
                or k2.relevance_flash_kernel.launches):
            raise AssertionError(f"{tag} step {step}: {counts[-1]} K1 launches, "
                                 f"{k2.relevance_flash_kernel.launches} K2, loss {loss}")
    med = float(np.median(ev_ms[1:]))
    log(f"[{tag} train] {B} x ({M} frames + {N} tokens) a step: median step {med:.3f} ms by "
        f"CUDA events over steps 1-4 ({[round(t, 3) for t in ev_ms[1:]]}), wall "
        f"{float(np.median(walls[1:])):.3f} ms; {B * N / (med / 1e3):.1f} decoder tokens/s, "
        f"{B * M / (med / 1e3):.1f} encoder frames/s [{smi}]")

    b = batch(tcfg.total_steps)
    memory = {}
    for mode in ("on", "off"):
        c = dataclasses.replace(cfg, remat=mode == "on")
        _, fn = train.make_step(c, tcfg)
        fn(params, opt_state, b, tcfg.total_steps)            # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = time_cuda(lambda: fn(params, opt_state, b, tcfg.total_steps), iters=2, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        memory[mode] = {"peak_gib": peak / 2**30, "held_gib": held / 2**30, "step_ms": ms}
        log(f"[{tag} memory] remat {mode}: peak {peak / 2**30:.2f} GiB over a step (params "
            f"and AdamW state held: {held / 2**30:.2f} GiB), step {ms:.3f} ms (events, "
            f"mean of 2) [{smi}]")
    prof = whisper_profile(lambda: step_fn(params, opt_state, b, tcfg.total_steps), f"{tag} step",
                         whisper_k1_calls(cfg, grad=True),
                         annotations=("cross_stlt.coefficients", "cross_stlt.scores")
                         if cfg.mixer.startswith("stlt") else ())
    return {"step_ms": med, "dec_tok_s": B * N / (med / 1e3),
            "frames_s": B * M / (med / 1e3), "launches_per_step": counts[-1],
            "gaps": gaps, "memory": memory, "profile": prof}


# ---------------------------------------------------------------------------
# Phase A: native attention, the paper's baseline (SmolLM-360M, whisper-base)
# ---------------------------------------------------------------------------

# A1 serves phase P's requests with the native config: plain and with the
# n-gram draft (the node draft and the SLO ladder act on STLT blocks only).
A_RUNS = (("plain", {}), ("ngram", dict(spec_k=P_K, spec_draft="ngram")))
# A1's depth, cut from 32 layers to fit the script's time limit (A1 took
# 125 s at 32 layers on an H100, PERF.md, phase D; 8 layers until phase DA
# came); its per-slot bytes are read at full depth.
A1_LAYERS = 4
# A2: a prompt of A_PROMPT tokens (3 chunks of P_CHUNK and a tail), fp32,
# chunked against monolithic prefill and A_NEW decode steps against the
# teacher-forced forward; the blockwise path against the dense one on one
# layer at A_BLOCK_N tokens; the card against the CPU at 2 layers.
A_PROMPT, A_NEW, A_BLOCK_N = 1700, 16, 8192
# The blockwise path (online softmax over KV blocks of 1024, query blocks
# of 512) and the dense one are one function in fp32, summed in other
# orders (max abs error over 1 + the output's scale; fp32 rounding through
# 8192-term softmax sums).
A_BLOCK_TOL = 1e-4
# A3 trains at T3's shape; its card-vs-CPU step 0 at 2 layers in fp32 on
# A_CPU_B x A_CPU_N tokens (T2's gates). A4 is phase W's shapes.
A_CPU_B, A_CPU_N = 2, 256
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (data sheet, 700 W)


def attention_check_phase(T, A, cfg, dev) -> dict:
    """Phase A2: native SmolLM-360M at full width and depth in fp32 (the
    masters uncast, fp32 activations): a 2 x A_PROMPT prompt folded
    P_CHUNK tokens a chunk through ``prefill_chunk`` (the tail a masked
    [2, P_CHUNK] chunk, as the engine admits it) against the monolithic
    ``prefill``, last logits within LOGIT_TOL; A_NEW greedy decode steps
    from the monolithic state, each against the teacher-forced ``apply_lm``
    on the prompt and the produced tokens, within LOGIT_TOL; layer 0's
    attention at 1 x A_BLOCK_N through the blockwise path against the dense
    one (A_BLOCK_TOL), both timed; and at 2 layers the card against the CPU:
    ``prefill`` logits, 4 decode steps and ``apply_lm``, within LOGIT_TOL.
    No K1 launch in any of it."""
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.utils import tree_map

    smi = smi_line()
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = T.init_lm(c32, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, A_PROMPT), generator=g, device=dev)
    max_len = A_PROMPT + A_NEW
    out = {}
    k1.stlt_scan_kernel.launches = 0
    with torch.no_grad():
        mono, state = T.prefill(params, c32, toks, max_len)
        chunked = T.init_decode_state(c32, 2, max_len, device=dev)
        for off in range(0, A_PROMPT, P_CHUNK):
            n = min(P_CHUNK, A_PROMPT - off)
            buf = torch.zeros(2, P_CHUNK, dtype=toks.dtype, device=dev)
            buf[:, :n] = toks[:, off:off + n]
            last, chunked = T.prefill_chunk(params, c32, buf, chunked,
                                            valid_len=torch.full((2,), n, device=dev))
        out["chunk_err"] = float((last - mono).abs().max())
        scale = float(mono.abs().max())
        tok, rows, fed = mono.argmax(-1), [mono], []
        for _ in range(A_NEW - 1):
            fed.append(tok)
            logits, state = T.decode_step(params, c32, tok, state)
            rows.append(logits)
            tok = logits.argmax(-1)
        seq = torch.cat([toks, torch.stack(fed, 1)], 1)
        teacher, _ = T.apply_lm(params, c32, seq)
        out["step_err"] = float((torch.stack(rows, 1) - teacher[:, A_PROMPT - 1:]).abs().max())
        torch.cuda.synchronize()
        log(f"[A2 attention] fp32, {cfg.num_layers} layers, 2 x {A_PROMPT} tokens: chunked "
            f"({P_CHUNK}-token chunks, masked tail) vs monolithic prefill last logits max "
            f"abs err {out['chunk_err']:.3e}; {A_NEW} decode steps vs teacher-forced "
            f"apply_lm {out['step_err']:.3e} (tolerance {LOGIT_TOL}; logit scale "
            f"{scale:.3f}) [{smi}]")
        if not max(out["chunk_err"], out["step_err"]) <= LOGIT_TOL:
            raise AssertionError(f"A2: chunked/monolithic/decode disagree: {out}")
        del state, chunked, teacher

        # the blockwise path against the dense one, one layer, 1 x A_BLOCK_N
        acfg = T._attn_cfg(c32, "attn")
        p0 = params["layers"][0]["attn"]
        x = torch.randn(1, A_BLOCK_N, cfg.d_model, generator=g, device=dev)
        blk = A.apply_attention(p0, acfg, x)
        dense = A.apply_attention(p0, acfg, x, force_dense=True)
        out["block_err"] = float((blk - dense).abs().max())
        bscale = float(dense.abs().max())
        out["block_ms"] = time_cuda(lambda: A.apply_attention(p0, acfg, x), iters=3)
        out["dense_ms"] = time_cuda(lambda: A.apply_attention(p0, acfg, x, force_dense=True),
                                    iters=3)
        log(f"[A2 attention] one layer at 1 x {A_BLOCK_N}, fp32: blockwise vs dense max abs "
            f"err {out['block_err']:.3e} (scale {bscale:.3f}; tolerance {A_BLOCK_TOL} x "
            f"(1 + scale)); blockwise {out['block_ms']:.3f} ms, dense {out['dense_ms']:.3f} "
            f"ms (events) [{smi}]")
        if not out["block_err"] <= A_BLOCK_TOL * (1 + bscale):
            raise AssertionError(f"A2: blockwise vs dense {out['block_err']}")
        del blk, dense, x

        # the card against the CPU at 2 layers
        c2 = dataclasses.replace(c32, num_layers=2)
        p2 = T.init_lm(c2, torch.Generator(device=dev).manual_seed(3), device=dev)
        p2c = tree_map(torch.Tensor.cpu, p2)
        t2 = toks[:, :600]
        res = {}
        for where, p in (("card", p2), ("cpu", p2c)):
            t = t2.to(p["embed"]["embed"].device)
            lg, st = T.prefill(p, c2, t, 608)
            rows = [lg.cpu()]
            for i in range(4):
                lg, st = T.decode_step(p, c2, t[:, 100 + i], st)
                rows.append(lg.cpu())
            res[where] = (torch.stack(rows, 1), T.apply_lm(p, c2, t)[0].cpu())
        out["cpu_err"] = max(float((a - b).abs().max()) for a, b in zip(res["card"], res["cpu"]))
        log(f"[A2 attention] card vs CPU, fp32, 2 layers: prefill + 4 decode steps and "
            f"apply_lm over 2 x 600 tokens, logits max abs err {out['cpu_err']:.3e} "
            f"(tolerance {LOGIT_TOL}) [{smi}]")
        if not out["cpu_err"] <= LOGIT_TOL:
            raise AssertionError(f"A2: card vs CPU logits {out['cpu_err']}")
    torch.cuda.synchronize()
    if k1.stlt_scan_kernel.launches:
        raise AssertionError(f"A2: {k1.stlt_scan_kernel.launches} K1 launches")
    return out


def attention_timings(T, A, cfg, dev) -> dict:
    """Phase A2's times by CUDA events, bf16 with the matrices cast as the
    serve CLI casts them: layer 0's ``apply_attention`` at the prefill shape
    4 x 1024 (projections included) and its core (``_sdpa_dense`` on q, k,
    v); ``apply_attention_step`` at the decode shape (4 rows at position
    1024 of a 4096-slot cache); and ``F.scaled_dot_product_attention`` on
    the same q, k, v (causal, GQA) and the same cache (masked) as the
    library yardstick: the port never calls it. Each core beside its bound:
    the bytes of q, k, v and the output over HBM's rate, the (causal half
    of the) products over the bf16 tensor cores' peak."""
    from repro_torch.utils import cast_params_for_compute

    smi = smi_line()
    params = cast_params_for_compute(
        T.init_lm(dataclasses.replace(cfg, num_layers=1),
                  torch.Generator(device=dev).manual_seed(0), device=dev), cfg.act_dtype)
    acfg = T._attn_cfg(cfg, "attn")
    p0 = params["layers"][0]["attn"]
    B, N, H, Hkv, dh = 4, 1024, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(B, N, cfg.d_model, generator=g, device=dev).to(cfg.act_dtype)
    out = {}
    with torch.no_grad():
        q, k, v = A._qkv(p0, acfg, x, torch.arange(N, device=dev))
        out["prefill_layer_ms"] = time_cuda(lambda: A.apply_attention(p0, acfg, x), 20)
        out["prefill_ms"] = time_cuda(lambda: A._sdpa_dense(q, k, v, acfg), 20)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        got = A._sdpa_dense(q, k, v, acfg)
        out["prefill_sdpa_err"] = float((got.float() - ref.transpose(1, 2).float()).abs().max())
        out["prefill_library_ms"] = time_cuda(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        flops = 4 * B * H * dh * N * (N + 1) / 2
        out["prefill_bound_ms"] = 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
        out["prefill_bound_by"] = ("bytes" if nbytes / PEAK_BYTES_PER_S
                                   > flops / PEAK_BF16_FLOPS else "operations")

        size, pos = 4096, 1024
        cache = A.init_kv_cache(acfg, B, size, dtype=cfg.act_dtype, device=dev)
        cache["k"].normal_(generator=g)
        cache["v"].normal_(generator=g)
        cache["pos"].fill_(pos)
        x_t = x[:, -1]
        out["decode_layer_ms"] = time_cuda(lambda: A.apply_attention_step(p0, acfg, x_t,
                                                                          cache), 20)
        q1 = A._qkv(p0, acfg, x_t[:, None], cache["pos"][:, None])[0].to(cfg.act_dtype)
        mask = (torch.arange(size, device=dev) <= pos)[None, None, None, :]
        out["decode_library_ms"] = time_cuda(lambda: F.scaled_dot_product_attention(
            q1.transpose(1, 2), cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 20)
        dbytes = 2 * cache["k"].numel() * cache["k"].element_size()
        out["decode_bound_ms"] = 1e3 * dbytes / PEAK_BYTES_PER_S
        profile(lambda: A._sdpa_dense(q, k, v, acfg), "A2 prefill attention core", top=6)
        profile(lambda: A.apply_attention_step(p0, acfg, x_t, cache),
                "A2 decode attention step", top=8)
    log(f"[A2 timing] one attention layer, bf16: prefill {B} x {N} apply_attention "
        f"{out['prefill_layer_ms']:.4f} ms, its core (_sdpa_dense) {out['prefill_ms']:.4f} "
        f"ms, scaled_dot_product_attention {out['prefill_library_ms']:.4f} ms (max abs "
        f"difference {out['prefill_sdpa_err']:.3e}), bound {out['prefill_bound_ms']:.5f} ms "
        f"({out['prefill_bound_by']}); decode {B} rows at position {pos} of a {size}-slot "
        f"cache: apply_attention_step {out['decode_layer_ms']:.4f} ms, "
        f"scaled_dot_product_attention on the cache {out['decode_library_ms']:.4f} ms, "
        f"bound {out['decode_bound_ms']:.5f} ms (bytes: the cache read once) [{smi}]")
    if not out["prefill_sdpa_err"] <= 0.05:
        raise AssertionError(f"A2: the port's attention and SDPA disagree: "
                             f"{out['prefill_sdpa_err']}")
    return out


def train_cpu_check(T, train, c, dev, tag="A3", B=A_CPU_B, N=A_CPU_N) -> dict:
    """A train phase's tight check (A3: native SmolLM-360M at its widths
    but 2 layers; H4: recurrentgemma-9b at ``reduced()`` widths), in fp32,
    B x N tokens, step 0 of config ``c`` on the card and on the CPU from the
    same weights: loss within TRAIN_LOSS_TOL, every grad leaf finite and
    non-zero and within TRAIN_GRAD_TOL (phase T2's gates)."""
    from repro_torch.data import lm_batch_stream
    from repro_torch.utils import tree_map

    params = T.init_lm(c, torch.Generator(device=dev).manual_seed(4), device=dev)
    batch = {k: torch.from_numpy(v) for k, v in
             lm_batch_stream(0, 0, B, N, c.vocab).items()}
    out = {}
    for where, p in (("card", params), ("cpu", tree_map(torch.Tensor.cpu, params))):
        b = {k: v.to(where if where == "cpu" else dev) for k, v in batch.items()}
        loss, _, grads = train.loss_and_grads(p, c, b, tau=1.0)
        out[where] = (float(loss), tree_map(torch.Tensor.cpu, grads))
    rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    path, worst, n = grad_gaps(out["card"][1], out["cpu"][1], f"{tag} card vs CPU")
    log(f"[{tag} step 0] card vs CPU, fp32, {c.num_layers} layers, d_model {c.d_model}, "
        f"{B} x {N}: loss "
        f"{out['card'][0]:.6f} vs {out['cpu'][0]:.6f} (relative {rel:.3e}; gate "
        f"{TRAIN_LOSS_TOL}), {n} grad leaves finite and non-zero, worst ||g_card - g_cpu|| "
        f"/ ||g_cpu|| {worst:.3e} ({path}; gate {TRAIN_GRAD_TOL})")
    if not (rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{tag}: card vs CPU step 0: loss {rel}, grad {worst} at {path}")
    return {"loss": rel, "grad": worst, "leaf": path}


def attention_phase(T, train, W, steps, k1, dev, get_config) -> dict:
    """Phase A: the paper's baseline, native softmax attention, at full
    width (plain torch; no kernel of the port on its path: K1 must make 0
    launches in every part). A1 serves native SmolLM-360M at A1_LAYERS
    layers (bf16, matrices
    cast as the serve CLI casts them) through ``spec_phase`` (plain and the
    n-gram draft; the plain serve profiled: fewer launches to read back than
    the n-gram serve's 332k), with the per-slot decode state beside the
    STLT variant's; A2 checks and times the attention itself; A3 trains it at
    T3's shape through ``smollm_train_phase`` (remat on against off), with
    the card against the CPU at 2 layers; A4 runs native whisper-base
    through phase W's helpers (encode, decode, the card against the CPU at
    2 + 2 layers, a train step)."""
    from repro_torch.models import attention as A
    from repro_torch.serving.prefix_cache import pytree_nbytes

    t_all, smi = time.time(), smi_line()
    cfg = get_config("smollm-360m")
    out = {"times": {}}
    t0 = time.time()
    out["A1"] = spec_phase(T, k1, period_cfg(cfg, A1_LAYERS), dev, None, runs=A_RUNS,
                           tag="A1", profiled="plain")
    native_bytes, stlt_bytes = (
        pytree_nbytes(T.init_decode_state(c, 1, P_MAX_LEN, device=dev))
        for c in (cfg, get_config("smollm-360m", "stlt")))
    out["A1"]["full_slot_bytes"], out["A1"]["stlt_slot_bytes"] = native_bytes, stlt_bytes
    log(f"[A1 serve] decode state of one slot at full depth: native {native_bytes} bytes "
        f"({native_bytes / 2**20:.2f} MiB: bf16 K and V, {cfg.num_layers} layers x "
        f"{P_MAX_LEN} positions x {cfg.num_kv_heads} KV heads x {cfg.dh}), STLT variant "
        f"{stlt_bytes} bytes ({stlt_bytes / 2**20:.2f} MiB: fp32 carries, O(S d), any "
        f"length); ratio {native_bytes / stlt_bytes:.1f} [{smi}]")
    out["times"]["A1"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    out["A2"] = attention_check_phase(T, A, cfg, dev)
    out["A2"].update(attention_timings(T, A, cfg, dev))
    out["times"]["A2"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    out["A3"] = smollm_train_phase(T, train, k1, cfg, dev, T3_B, T3_N, tag="A3",
                                   compare=T3_COMPARE[:1], remat_modes=("full", "off"))
    out["A3"]["cpu"] = train_cpu_check(
        T, train, dataclasses.replace(cfg, num_layers=2, dtype="float32", remat=False), dev)
    out["times"]["A3"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    wcfg = get_config("whisper-base")
    out["A4"] = whisper_decode_phase(W, steps, k1, wcfg, dev, tag="A4")
    out["A4"]["cpu"] = whisper_cpu_check(W, steps, train, k1, wcfg, dev, tag="A4")
    torch.cuda.empty_cache()
    out["A4"]["train"] = whisper_train_phase(W, train, k1, wcfg, dev,
                                             steps.WHISPER_ENC_FRAMES, tag="A4")
    out["times"]["A4"] = time.time() - t0
    torch.cuda.empty_cache()
    log(f"[A time] phase A {time.time() - t_all:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["times"].items()) + f" [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase H: the hybrid family (recurrentgemma-9b) and the untied head
# ---------------------------------------------------------------------------

# recurrentgemma-9b at full width and depth (38 layers: 26 rg-LRU and 12
# local-attention blocks, window 2048, d_model 4096, 16 heads, 1 KV head,
# dh 256, untied 256,000-token head, bf16, matrices cast as the serve CLI
# casts them). H1 serves the native form, H2 the STLT variant (only the
# local-attention third replaced: K1 at head dim 256), each plain and with
# the n-gram draft, on phase P's requests through spec_phase.
H_ARCH = "recurrentgemma-9b"
# H3 (fp32, the model's widths cut to one period of the pattern: rglru,
# rglru, local_attn | stlt): a 2-row prompt folded at P_CHUNK (a 512-token
# chunk and a masked 88-token tail; row 1 ends in the first chunk and
# idles through the second) against the monolithic prefill, H_NEW decode
# steps against the teacher-forced forward, the card against the CPU on
# 1 x H_CPU_N tokens and 4 decode steps. The forms are one function in
# fp32, summed in other orders: LOGIT_TOL.
H_PERIOD, H_PROMPT, H_ROW1, H_NEW, H_CPU_N = 3, 600, 400, 8, 256
# H4 trains the same 3 layers at full width, 2 x 1024 a step (bf16 over
# fp32 masters, remat on, AdamW), remat against off on the card (T3's
# gates) and step 0 card against CPU at reduced() widths (T2's gates).
# Its AdamW moments are bf16 (``opt_moment_dtype``): the update is
# functional, so a step holds the old and the new params and moments at
# once, and with fp32 moments the 2.75B params (the 256,000-token embedding
# and head are 2.1B of them) would need ~82 GiB.
H_TRAIN_B, H_TRAIN_N = 2, 1024
# H5: chatglm3-6b's STLT variant at full width (28 layers, d_model 4096,
# 32 heads, dh 128: K1 at head dim 128; untied 65,024-token head, bf16):
# one greedy generate of H5_B x (H5_PROMPT + H5_NEW), each token held to
# the teacher-forced forward under the near-tie rule.
H5_ARCH, H5_B, H5_PROMPT, H5_NEW = "chatglm3-6b", 2, 512, 16
# The bf16 chunk-form vs recurrent-form logit gaps H accepts (as phase P's
# P_GAP_CAP) and their near-tie tolerances, twice each cap. In bf16 the
# rg-LRU's two forms differ by more than rounding, in the JAX package as in
# the port: the [4, d] conv weight stays fp32 under the serving cast, so the
# chunk form's conv output enters the gates in fp32 and the step's in bf16.
# At 6 layers, d_model 1024 the JAX package's own gap reads 0.050-0.052
# (native) and 0.023-0.025 (STLT), 0.066-0.068 / 0.031 at 12 layers, and
# the port's 0.047-0.049 / 0.023-0.025 on the same weights
# (tests/jax_hybrid_gaps.py, CPU). The H100 read 0.3359 (H1) and 0.125 (H2)
# at full width and depth, the same in two runs, and 0.0781 for H5's
# decode form against the teacher-forced forward (chatglm3-6b-stlt, no
# rg-LRU: bf16 rounding through 28 layers at a logit scale of 5.5)
# (tools/phase_h_gaps.py, PERF.md phase H); each cap is the first
# sixteenth at or above 1.6x its reading. They bound rounding noise through
# the full depth; the fp32 checks of H3 are the tight ones.
H1_GAP_CAP = 0.5625
H1_TIE_TOL = 2 * H1_GAP_CAP
H2_GAP_CAP = 0.25
H2_TIE_TOL = 2 * H2_GAP_CAP
H5_GAP_CAP = 0.125
H5_TIE_TOL = 2 * H5_GAP_CAP
# H1 and H2 serve recurrentgemma-9b cut to H_SERVE_LAYERS layers (one
# period: 2 rg-LRU blocks and a local-attention or STLT block; two periods
# until phase DA came) to fit the script's time limit; at 38 layers H1 and
# H2 took 98 and 86 s (PERF.md, phase D). The caps above were read at full
# depth, where the gaps are largest.
H_SERVE_LAYERS = H_PERIOD


def period_cfg(cfg, layers=H_PERIOD, **kw):
    """``cfg`` cut to one period of its layer pattern (``layers`` layers:
    H_PERIOD for the hybrid, X_PERIOD for xLSTM)."""
    return dataclasses.replace(cfg, num_layers=layers,
                               layer_types=cfg.layer_types[:layers], **kw)


def forward_at(T, cfg, params, seq, positions):
    """Teacher-forced logits of ``seq`` [B, N] at ``positions`` only: the
    blocks of ``apply_lm`` over the whole sequence, the head on the
    positions asked for (full logits of a 256,000-token vocabulary take
    ~1 GB for 1024 positions in fp32)."""
    x = T._with_pe(cfg, T._embed(params, cfg, seq))
    for bt, p in zip(cfg.block_types(), params["layers"]):
        x, _ = T.apply_block(p, cfg, bt, x)
    return T._head(params, cfg, x[:, positions])


def hybrid_check_phase(T, k1, cfg, dev, tag="H3", layers=H_PERIOD) -> dict:
    """Phase H3 for one form of the hybrid (and X2 for xLSTM; ``cfg`` at
    full width): in fp32 at ``layers`` layers (one period), chunked against monolithic prefill (row 0's last
    logits; row 1, which ends in the first chunk, against its own
    monolithic prefill), row 1's state bit for bit through the dispatch in
    which its valid length is 0, H_NEW decode steps against the
    teacher-forced forward, and the card against the CPU (prefill of
    1 x H_CPU_N tokens, 4 decode steps); K1 launches = STLT layers x the 5
    whole-sequence calls (monolithic prefill, 2 chunk dispatches, row 1
    alone, the teacher-forced forward), none in decode."""
    from repro_torch.utils import tree_map

    smi = smi_line()
    c = period_cfg(cfg, layers, dtype="float32")
    params = T.init_lm(c, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, c.vocab, (2, H_PROMPT + H_NEW), generator=g, device=dev)
    max_len, out = H_PROMPT + H_NEW, {}
    k1.stlt_scan_kernel.launches = 0
    with torch.no_grad():
        mono, state = T.prefill(params, c, toks[:, :H_PROMPT], max_len)
        mono1, _ = T.prefill(params, c, toks[1:2, :H_ROW1], max_len)
        lens = np.array([H_PROMPT, H_ROW1])
        st = T.init_decode_state(c, 2, max_len, device=dev)
        idle_same, last = None, {}
        for off in range(0, H_PROMPT, P_CHUNK):
            v = np.clip(lens - off, 0, P_CHUNK)
            buf = torch.zeros(2, P_CHUNK, dtype=toks.dtype, device=dev)
            buf[:, :int(v[0])] = toks[:, off:off + int(v[0])]
            before = T.extract_slot(st, 1, c) if v[1] == 0 else None
            lg, st = T.prefill_chunk(params, c, buf, st, valid_len=torch.from_numpy(v).to(dev))
            for b in np.nonzero((v > 0) & (off + v == lens))[0]:
                last[int(b)] = lg[b]
            if before is not None:
                after = T.extract_slot(st, 1, c)
                idle_same = all(torch.equal(a[k], b[k]) for a, b in
                                zip(after["layers"], before["layers"]) for k in a) \
                    and torch.equal(after["pos"], before["pos"])
        out["chunk_err"] = max(float((last[0] - mono[0]).abs().max()),
                               float((last[1] - mono1[0]).abs().max()))
        scale = float(mono.abs().max())
        tok, rows, fed = mono.argmax(-1), [mono], []
        before_decode = k1.stlt_scan_kernel.launches
        for _ in range(H_NEW - 1):
            fed.append(tok)
            logits, state = T.decode_step(params, c, tok, state)
            rows.append(logits)
            tok = logits.argmax(-1)
        launches_decode = k1.stlt_scan_kernel.launches
        seq = torch.cat([toks[:, :H_PROMPT], torch.stack(fed, 1)], 1)
        teacher = forward_at(T, c, params, seq, torch.arange(H_PROMPT - 1, seq.shape[1]))
        out["step_err"] = float((torch.stack(rows, 1) - teacher).abs().max())
        torch.cuda.synchronize()
        launches = k1.stlt_scan_kernel.launches
        L = stlt_layers(c)
        log(f"[{tag}] {cfg.name} ({c.block_types()}), fp32, d_model {c.d_model}: chunked "
            f"({P_CHUNK}-token chunks, masked tail) vs monolithic prefill last logits max abs "
            f"err {out['chunk_err']:.3e}; the idle row's state bit for bit {idle_same}; "
            f"{H_NEW} decode steps vs teacher-forced {out['step_err']:.3e} (tolerance "
            f"{LOGIT_TOL}; logit scale {scale:.3f}); K1 launches {launches}, of them in "
            f"decode {launches_decode - before_decode} [{smi}]")
        if not (max(out["chunk_err"], out["step_err"]) <= LOGIT_TOL and idle_same):
            raise AssertionError(f"{tag}: chunked/monolithic/decode disagree: {out}, "
                                 f"idle row kept {idle_same}")
        if launches != 5 * L or launches_decode != before_decode or before_decode != 4 * L:
            raise AssertionError(f"{tag}: {launches} K1 launches ({launches_decode} before "
                                 f"the teacher-forced forward), expected {5 * L}")
        del state, st, teacher

        res = {}
        t2 = toks[:1, :H_CPU_N]
        for where, p in (("card", params), ("cpu", tree_map(torch.Tensor.cpu, params))):
            t = t2.to(p["final_norm"]["scale"].device)
            lg, s2 = T.prefill(p, c, t, H_CPU_N + 4)
            got = [lg.cpu()]
            for i in range(4):
                lg, s2 = T.decode_step(p, c, t[:, 10 + i], s2)
                got.append(lg.cpu())
            res[where] = torch.stack(got, 1)
            del p, s2
        out["cpu_err"] = float((res["card"] - res["cpu"]).abs().max())
        log(f"[{tag}] card vs CPU, fp32, {layers} layers: prefill of 1 x {H_CPU_N} and 4 "
            f"decode steps, logits max abs err {out['cpu_err']:.3e} (tolerance {LOGIT_TOL}) "
            f"[{smi}]")
        if not out["cpu_err"] <= LOGIT_TOL:
            raise AssertionError(f"{tag}: card vs CPU logits {out['cpu_err']}")
    return out


def generate_check_phase(T, k1, cfg, params, dev, tag, B, prompt, new, gap_cap, tie_tol,
                         seed) -> dict:
    """Phase H5 (and M4): ``cfg`` at full width in bf16 with ``params`` (the
    matrices cast as the serve CLI casts them), one greedy ``generate`` of
    B x (prompt + new) through the engine (K1 launches = STLT layers, the
    prefill's, none in decode); the decode form rerun on the generated
    tokens and held to the teacher-forced forward: every generated token
    within ``tie_tol`` of the teacher's max logit, the forms' largest gap
    within ``gap_cap``. The init peak is the device's peak since the
    caller's last ``reset_peak_memory_stats``."""
    from repro_torch.serving import ServeEngine

    smi = smi_line()
    torch.cuda.synchronize()
    peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    engine = ServeEngine(params, cfg, max_len=prompt + new, device=dev)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, prompt))
    engine.generate(prompts, 2)   # first call: one-time costs
    torch.cuda.synchronize()
    k1.stlt_scan_kernel.launches = 0
    t0 = time.time()
    tokens = engine.generate(prompts, new)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = k1.stlt_scan_kernel.launches
    if launches != stlt_layers(cfg) or tokens.shape != (B, new):
        raise AssertionError(f"{tag}: {launches} K1 launches, tokens {tokens.shape}")
    toks = torch.from_numpy(prompts).to(dev)
    gen = torch.from_numpy(np.asarray(tokens)).to(dev)
    with torch.no_grad():
        lg, st = T.prefill(params, cfg, toks, prompt + new)
        rows = [lg]
        for i in range(new - 1):
            lg, st = T.decode_step(params, cfg, gen[:, i], st)
            rows.append(lg)
        steps = torch.stack(rows, 1).float()
        seq = torch.cat([toks, gen[:, :-1]], 1)
        teacher = forward_at(T, cfg, params, seq,
                             torch.arange(prompt - 1, seq.shape[1])).float()
    gap = float((steps - teacher).abs().max())
    ties = sum(near_tie(teacher[b, i], int(gen[b, i]), f"{tag}: row {b} step {i}", tie_tol)
               for b in range(B) for i in range(new))
    log(f"[{tag}] {cfg.name} ({cfg.mixer}), bf16, {cfg.num_layers} layers, dh {cfg.dh}: "
        f"generate {B} x ({prompt} + {new}) {wall:.3f} s ({B * new / wall:.1f} new tok/s), "
        f"{launches} K1 launches; init peak {peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB "
        f"held; decode form vs teacher-forced max logit gap {gap:.4g} (cap {gap_cap}), near "
        f"ties {ties} (tolerance {tie_tol}; logit scale {float(teacher.abs().max()):.3f}) "
        f"[{smi}]")
    if not gap <= gap_cap:
        raise AssertionError(f"{tag}: decode vs teacher-forced gap {gap} > {gap_cap}")
    return {"wall_s": wall, "k1_launches": launches, "gap": gap, "ties": ties,
            "init_peak_gib": peak / 2**30, "held_gib": held / 2**30,
            "tokens": np.asarray(tokens)}


def hybrid_phase(T, train, k1, dev, get_config, k1_rows) -> dict:
    """Phase H: recurrentgemma-9b in both forms at full width on the card.
    H1 serves the native form and H2 the STLT variant at H_SERVE_LAYERS
    layers (``spec_phase``, plain and the n-gram draft, at H1_ and
    H2_GAP_CAP; K1 launches 0 in H1, 1 x the dispatches that call it in
    H2), with the per-slot decode state of each at full depth; H3 checks both forms in fp32 at one period of the
    pattern (``hybrid_check_phase``); H4 trains that period at full width
    (``smollm_train_phase``: 3 K1 calls a step in the STLT form, none in
    the native) and holds step 0 to the CPU at ``reduced()`` widths; H5 is
    chatglm3-6b's STLT variant (``generate_check_phase``)."""
    from repro_torch.serving.prefix_cache import pytree_nbytes
    from repro_torch.utils import cast_params_for_compute

    t_all, smi = time.time(), smi_line()
    out = {"times": {}}
    free_cuda()
    for tag, variant, cap, tol in (("H1", "native", H1_GAP_CAP, H1_TIE_TOL),
                                   ("H2", "stlt", H2_GAP_CAP, H2_TIE_TOL)):
        t0 = time.time()
        cfg = period_cfg(get_config(H_ARCH, variant), H_SERVE_LAYERS)
        out[tag] = spec_phase(T, k1, cfg, dev, k1_rows if variant == "stlt" else None,
                              runs=A_RUNS, tag=tag, profiled="plain", verify=H_K1_VERIFY,
                              gap_cap=cap, tie_tol=tol, require_accept=False)
        out["times"][tag] = time.time() - t0
        free_cuda()
    native = get_config(H_ARCH)
    n_bytes, s_bytes = (pytree_nbytes(T.init_decode_state(c, 1, P_MAX_LEN, device=dev))
                        for c in (native, get_config(H_ARCH, "stlt")))
    rec = pytree_nbytes(T._init_block_state(native, "rglru", 1, P_MAX_LEN, dev))
    n_attn, n_rec = (native.block_types().count(bt) for bt in ("local_attn", "rglru"))
    log(f"[H serve] decode state of one slot at max_len {P_MAX_LEN}, full depth: native "
        f"{n_bytes} bytes "
        f"({n_bytes / 2**20:.2f} MiB: {n_attn} bf16 rings of "
        f"{min(P_MAX_LEN, native.local_window)} positions x {native.num_kv_heads} KV head x "
        f"{native.dh}, K and V, and {n_rec} fp32 rg-LRU states of {rec} bytes), STLT variant "
        f"{s_bytes} bytes ({s_bytes / 2**20:.2f} MiB: {n_attn} fp32 STLT carries and the same "
        f"rg-LRU states); ratio {n_bytes / s_bytes:.2f} [{smi}]")
    for tag, variant in (("H3 native", "native"), ("H3 stlt", "stlt")):
        t0 = time.time()
        out[tag] = hybrid_check_phase(T, k1, get_config(H_ARCH, variant), dev, tag=tag)
        out["times"][tag] = time.time() - t0
        free_cuda()
    for tag, variant in (("H4 native", "native"), ("H4 stlt", "stlt")):
        t0 = time.time()
        cfg = get_config(H_ARCH, variant)
        out[tag] = smollm_train_phase(T, train, k1, period_cfg(cfg, opt_moment_dtype="bfloat16"),
                                      dev, H_TRAIN_B, H_TRAIN_N, tag=tag,
                                      compare=T3_COMPARE[:1], remat_modes=("full", "off"))
        free_cuda()
        out[tag]["cpu"] = train_cpu_check(T, train, cfg.reduced(), dev, tag=tag)
        out["times"][tag] = time.time() - t0
        free_cuda()
    t0 = time.time()
    cfg = get_config(H5_ARCH, "stlt")
    torch.cuda.reset_peak_memory_stats()
    params = cast_params_for_compute(
        T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev), cfg.act_dtype)
    out["H5"] = generate_check_phase(T, k1, cfg, params, dev, "H5", H5_B, H5_PROMPT, H5_NEW,
                                     H5_GAP_CAP, H5_TIE_TOL, seed=5)
    del params
    out["times"]["H5"] = time.time() - t0
    free_cuda()
    log(f"[H time] phase H {time.time() - t_all:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["times"].items()) + f" [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase X: xLSTM (xlstm-350m)
# ---------------------------------------------------------------------------

# xlstm-350m at full width and depth (24 layers, d_model 1024, 4 heads,
# mLSTM head dim 512, sLSTM at layers 8, 16 and 24, a tied 50,304-token
# embedding; native only: attention-free, its STLT variant is undefined).
# X1 serves it in bf16 (matrices cast as the serve CLI casts them; the
# mLSTM's conv taps and gate projections and the sLSTM's biases stay fp32)
# on phase P's requests, plain and with the n-gram draft, through
# spec_phase at X1_LAYERS, one period of the pattern (7 mLSTM + 1 sLSTM;
# 111 s at 24 layers on an H100, PERF.md, phase D, so its depth is cut to fit
# the script's time limit); X2 checks that period in fp32 through
# hybrid_check_phase; X3 trains it at full width,
# X3_B x X3_N in bf16 with remat (AdamW), through smollm_train_phase. K1
# makes no launch. The sLSTM is a true recurrence, one Python step per
# token in every form (as JAX's lax.scan): all 24 layers took 14.5 s a
# train step at 8 x 1024 on an H100 (PERF.md, phase X), so X3 trains one
# period (a third of the depth) and reads the peak memory over its timed
# steps instead of extra steps per remat mode, at 8 x 512 (the sLSTM's loop
# is as long as the sequence: X3 took 65.1 s at 8 x 1024, its bf16-vs-fp32
# grad gap 0.106 of the 0.17 gate; 36-48 s at 8 x 512, 0.079; at 8 x 256
# the gap, on the input-gate bias's rounding-noise grad, reached 0.155).
X_ARCH, X_PERIOD = "xlstm-350m", 8
X1_LAYERS = X_PERIOD
X3_B, X3_N = 8, 512
# The bf16 chunk-form vs recurrent-form logit gap X1 accepts, and its
# near-tie tolerance (twice the cap), as phase P's. In bf16 the mLSTM's
# two forms differ by more than rounding, in the JAX package as in the
# port: its [4, 2048] conv taps and [2048, 4] gate projections stay fp32
# under the serving cast, so the chunk form's conv output enters wq, wk and
# the gates in fp32 and the step's in bf16 (tests/test_torch_xlstm.py pins
# it). Set from tools/phase_xm_gaps.py's reading on an H100 (PERF.md, phase
# X): the gap read 0.0625 at full depth, the largest served-vs-argmax gap
# 0.03125; the cap is the first sixteenth at or above 1.6x the gap.
X1_GAP_CAP = 0.125
X1_TIE_TOL = 2 * X1_GAP_CAP
# X3 step 0, bf16 compute vs fp32 compute from the same fp32 masters (as
# T3's gates): loss relative (a quarter of a bf16 ulp), each grad leaf
# ||g_bf16 - g_fp32|| / ||g_fp32||, 1.6x the worst leaf that
# tools/phase_xm_gaps.py read at one period on an H100 (PERF.md, phase X):
# loss 1.1e-6, worst leaf 0.1061 (layers/2/cell/b_i, the mLSTM input-gate
# bias, whose grad is nearly invariant: h = C q / max(|n q|, e^-m)).
X3_BF16_LOSS_TOL = 1e-3
X3_BF16_GRAD_TOL = 0.17


def xlstm_phase(T, train, k1, dev, get_config) -> dict:
    """Phase X: xlstm-350m on the card. X1 serves it at full width,
    X1_LAYERS deep, in bf16 (``spec_phase``, plain and the n-gram draft: each stream against
    its request run alone under the near-tie rule at X1_TIE_TOL, the
    chunk-form vs recurrent-form gap at most X1_GAP_CAP, verify against
    decode dispatches, 0 K1 launches, timed, a plain serve profiled; the
    per-slot state's bytes at full depth); X2 checks one period in
    fp32 (``hybrid_check_phase`` at X_PERIOD layers: chunked vs monolithic,
    the idle row bit for bit, decode vs teacher-forced, the card vs the CPU);
    X3 trains that period at X3_B x X3_N in bf16 with remat
    (``smollm_train_phase``: remat against off and against fp32 compute, 5
    AdamW steps and their peak memory, a profiled step)."""
    from repro_torch.serving.prefix_cache import pytree_nbytes

    t_all, smi = time.time(), smi_line()
    cfg = get_config(X_ARCH)
    out = {"times": {}}
    free_cuda()
    t0 = time.time()
    out["X1"] = spec_phase(T, k1, period_cfg(cfg, X1_LAYERS), dev, None, runs=A_RUNS,
                           tag="X1", profiled="plain", gap_cap=X1_GAP_CAP, tie_tol=X1_TIE_TOL,
                           require_accept=False)
    out["X1"]["full_slot_bytes"] = slot_bytes = pytree_nbytes(
        T.init_decode_state(cfg, 1, P_MAX_LEN, device=dev))
    kinds = {bt: cfg.block_types().count(bt) for bt in ("mlstm", "slstm")}
    states = {bt: T._init_block_state(cfg, bt, 1, P_MAX_LEN, dev) for bt in kinds}
    per = {bt: pytree_nbytes(st) for bt, st in states.items()}
    log(f"[X1 serve] decode state of one slot at full depth: {slot_bytes} bytes "
        f"({slot_bytes / 2**20:.2f} MiB: {kinds['mlstm']} mLSTM states of "
        f"{per['mlstm']} bytes, C {list(states['mlstm']['C'].shape[1:])}, n, m and the conv "
        f"window, and {kinds['slstm']} sLSTM states of {per['slstm']} bytes, all fp32, "
        f"whatever the length) [{smi}]")
    out["times"]["X1"] = time.time() - t0
    free_cuda()
    t0 = time.time()
    out["X2"] = hybrid_check_phase(T, k1, cfg, dev, tag="X2", layers=X_PERIOD)
    out["times"]["X2"] = time.time() - t0
    free_cuda()
    t0 = time.time()
    compare = (("no remat", TRAIN_LOSS_TOL, TRAIN_GRAD_TOL),
               ("fp32 compute", X3_BF16_LOSS_TOL, X3_BF16_GRAD_TOL))
    out["X3"] = smollm_train_phase(T, train, k1, period_cfg(cfg, X_PERIOD), dev, X3_B, X3_N,
                                   tag="X3", compare=compare, remat_modes=())
    out["times"]["X3"] = time.time() - t0
    free_cuda()
    log(f"[X time] phase X {time.time() - t_all:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["times"].items()) + f" [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase M: the MoE family (qwen3-moe-235b-a22b, arctic-480b)
# ---------------------------------------------------------------------------

# qwen3-moe-235b-a22b at full width (d_model 4096, 64 heads, 4 KV heads, dh
# 64, 128 experts of d_ff 1536, top-8, an untied 151,936-token head), its
# depth cut from 94 layers to M1_LAYERS (2.45B params a layer, 3.7B at 1
# layer: 7.4 GB in bf16; cut to pay for phases DA and DM). M1 serves it
# native and as its STLT variant (K1 at dh 64) on phase P's requests, plain,
# in bf16, the matrices cast as they are drawn (``init_cast``). M2 runs 1
# layer in fp32, the card against the CPU on the same calls: apply_moe
# alone on 1 x M2_APPLY_N tokens (capacity
# 40 for a mean load of 32: it drops), and H3's checks (hybrid_check_phase)
# at capacity E / K, where nothing can drop; between them a greedy serve of
# phase P's requests M2_REQUESTS (M2_NEW tokens each, 2 slots) on the card,
# its drops printed (its full-width CPU twin is gone: ~27 s a form, and the
# two CPU checks around it hold the MoE under drops and the model). M3
# trains 1 layer at M3_B x M3_N in bf16 with adafactor (its config's
# optimizer) and remat. M4 runs arctic-480b (d_model 7168, 56 heads, 8 KV
# heads, dh 128, 128 experts of d_ff 4864, top-2 and the dense residual
# branch, an untied 32,000-token head) at 1 of its 35 layers: 14.07B params,
# 52.4 GiB as an fp32 tree, so it is built leaf by leaf, each large matrix
# cast to bf16 as it is drawn (the values of a whole-tree init and then the
# cast; checked at reduced widths on the card), and generates
# M4_B x (M4_PROMPT + M4_NEW) greedily in both forms (K1 at dh 128), held to
# the teacher-forced forward at capacity E / K (generate_check_phase, as
# H5), then once at the config's capacity with its drops printed.
M_ARCH, M4_ARCH = "qwen3-moe-235b-a22b", "arctic-480b"
M1_LAYERS = 1
# (one short request, few tokens: the CPU's full-width prefill and decode
# ticks are most of M2's time)
M2_APPLY_N, M2_REQUESTS, M2_NEW = 512, (2,), 4
# apply_moe alone, card vs CPU in fp32 (cuBLAS's and the CPU's summation
# orders), where no token's choices differ: max abs error over (1 + max |y|)
M2_MOE_TOL = 1e-4
M3_B, M3_N = 2, 1024
M4_B, M4_PROMPT, M4_NEW = 2, 512, 16
# M4's bf16 decode-form vs teacher-forced gap and its near-tie tolerance,
# at capacity E / K (no call drops), bf16 rounding through one layer at a
# logit scale of ~7: tools/phase_xm_gaps.py read 0.0625 (native) and
# 0.0391 (STLT) on an H100 (PERF.md, phase M); the cap is the first
# sixteenth at or above 1.6x the larger.
M4_GAP_CAP = 0.125
M4_TIE_TOL = 2 * M4_GAP_CAP


def init_cast(T, cfg, dev, seed=0, min_size=65536):
    """``T.init_lm(cfg)`` from seed ``seed`` as ``cast_params_for_compute``
    leaves it, built leaf by leaf: every matrix of more than ``min_size``
    elements is cast to the activation dtype as soon as it is drawn
    (``utils.trunc_normal`` wrapped for the call), the rest at the end. The
    same generator draws in the same order, so the values are those of a
    whole fp32 tree cast afterwards, without ever holding that tree."""
    from repro_torch import utils as U

    draw = U.trunc_normal

    def cast_as_drawn(*args, **kwargs):
        x = draw(*args, **kwargs)
        if x.ndim >= 2 and x.numel() > min_size and x.is_floating_point():
            return x.to(cfg.act_dtype)
        return x
    U.trunc_normal = T.trunc_normal = cast_as_drawn
    try:
        params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    finally:
        U.trunc_normal = T.trunc_normal = draw
    return U.cast_params_for_compute(params, cfg.act_dtype, min_size=min_size)


def init_cast_check(T, cfg, dev, tag):
    """``init_cast`` against a whole-tree init and cast, leaf for leaf bit
    for bit, at ``cfg.reduced()`` widths with a cast threshold of 1,024
    elements (so the experts, the attention and the head are cast)."""
    from repro_torch.utils import cast_params_for_compute, tree_flatten_with_paths

    c = cfg.reduced(dtype="bfloat16")
    got = init_cast(T, c, dev, min_size=1024)
    want = cast_params_for_compute(
        T.init_lm(c, torch.Generator(device=dev).manual_seed(0), device=dev), c.act_dtype,
        min_size=1024)
    pairs = list(zip(tree_flatten_with_paths(got), tree_flatten_with_paths(want)))
    cast = sum(x.dtype == torch.bfloat16 for (_, x), _ in pairs)
    if not (len(pairs) == len(tree_flatten_with_paths(want)) and cast > 0 and all(
            p == q and x.dtype == y.dtype and torch.equal(x, y) for (p, x), (q, y) in pairs)):
        raise AssertionError(f"{tag}: init_cast differs from a whole-tree init and cast")
    log(f"[{tag} init] leaf-by-leaf cast init equals the whole-tree init then the cast at "
        f"reduced widths: {len(pairs)} leaves bit for bit, {cast} of them cast")


class DropLog:
    """Per call of the serving entry points (``prefill``, ``prefill_chunk``,
    ``decode_step``, ``spec_verify``, looked up on the transformer module
    by the engine) made inside the ``with``: (entry point, tokens, MoE
    choices dropped). Reading the count syncs once a call."""

    NAMES = ("prefill", "prefill_chunk", "decode_step", "spec_verify")

    def __init__(self, T, moe):
        self.T, self.moe, self.calls, self.saved = T, moe, [], {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.T, name)
            setattr(self.T, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.T, name, fn)

    def _wrap(self, name, fn):
        def call(params, cfg, inputs, *args, **kwargs):
            self.moe.DROPS.reset()
            result = fn(params, cfg, inputs, *args, **kwargs)
            self.calls.append((name, int(np.prod(inputs.shape[:2])),
                               self.moe.DROPS.read()["dropped"]))
            return result
        return call

    def of(self, name) -> list:
        return [c for c in self.calls if c[0] == name]


def moe_serve_phase(T, k1, moe, cfg, dev, tag) -> dict:
    """Phase M1 for one form of qwen3-moe at M1_LAYERS layers (``cfg``):
    built by ``init_cast``, served on phase P's requests (plain, 4 slots,
    chunk 512): every request's tokens, K1 launches = STLT layers x the
    admission dispatches (0 native), the choices each dispatch dropped (a
    decode tick of at most 4 tokens never drops: capacity 8), the per-slot
    state's bytes, timed (the drop count read after each dispatch)."""
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.prefix_cache import pytree_nbytes

    smi = smi_line()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_cast(T, cfg, dev)
    torch.cuda.synchronize()
    init_s, peak, held = time.time() - t0, torch.cuda.max_memory_allocated(), \
        torch.cuda.memory_allocated()
    engine = ServeEngine(params, cfg, max_len=P_MAX_LEN, prefill_chunk=P_CHUNK, device=dev)
    reqs = spec_requests(cfg, Request)
    arrivals = [spec[3] for spec in P_SPEC]
    engine.serve(reqs[:2], slots=P_SLOTS, arrivals=arrivals[:2])   # one-time costs
    torch.cuda.synchronize()
    k1.stlt_scan_kernel.launches = 0
    with DropLog(T, moe) as drops:
        t0 = time.time()
        res, stats = engine.serve(reqs, slots=P_SLOTS, arrivals=arrivals, return_stats=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches, ss, L = k1.stlt_scan_kernel.launches, dict(engine.serve_stats), stlt_layers(cfg)
    if (L and launches == 0) or launches != L * k1_dispatches(ss):
        raise AssertionError(f"{tag}: {launches} K1 launches for {ss}")
    for r in reqs:
        if len(res[r.id]) != r.max_new_tokens or not ((res[r.id] >= 0)
                                                      & (res[r.id] < cfg.vocab)).all():
            raise AssertionError(f"{tag}: request {r.id} gave {res[r.id]}")
    adm, dec = drops.of("prefill_chunk"), drops.of("decode_step")
    if len(adm) != ss["admission_dispatches"] or len(dec) != ss["decode_dispatches"]:
        raise AssertionError(f"{tag}: {len(adm)} + {len(dec)} recorded calls for {ss}")
    if any(d for _, _, d in dec):
        raise AssertionError(f"{tag}: a decode tick dropped choices: {dec}")
    m = serve_metrics(res, stats, reqs, wall)
    slot_bytes = pytree_nbytes(T.init_decode_state(cfg, 1, P_MAX_LEN, device=dev))
    per_dispatch = [d for _, _, d in adm]
    choices = [n * cfg.top_k for _, n, _ in adm]
    log(f"[{tag} serve] {cfg.name} ({cfg.mixer}), {cfg.num_layers} layers, bf16: init "
        f"{init_s:.1f} s, peak {peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB held; wall "
        f"{wall:.3f} s, {m['tokens']} tokens, {m['tok_s']:.1f} generated tok/s; TTFT "
        f"p50/p99 {m['ttft_ms'][0]:.2f}/{m['ttft_ms'][1]:.2f} ms; inter-token gap p50/p99 "
        f"{m['gap_ms'][0]:.3f}/{m['gap_ms'][1]:.3f} ms; {launches} K1 launches = {L} STLT "
        f"layers x {k1_dispatches(ss)} dispatches; {ss} [{smi}]")
    log(f"[{tag} serve] dropped (token, expert) choices per admission dispatch (of "
        f"{choices[0] if choices else 0} choices x {cfg.num_layers} layers each, capacity "
        f"{moe._capacity(adm[0][1], cfg.moe_config()) if adm else 0} an expert): "
        f"{per_dispatch}; decode ticks {len(dec)}, none dropped; per-slot decode state "
        f"{slot_bytes} bytes ({slot_bytes / 2**20:.2f} MiB) [{smi}]")
    return {"k1_launches": launches, "serve_stats": ss, "drops": per_dispatch,
            "slot_bytes": slot_bytes, "init_peak_gib": peak / 2**30, "held_gib": held / 2**30,
            **m}


def moe_routing_flips(moe, params_a, params_b, x, k: int) -> int:
    """Tokens whose chosen experts differ between two copies of a router
    (card and CPU) on the same input x [T, d] (fp32)."""
    ia = moe._top_k(torch.softmax(x.to(params_a.device) @ params_a, -1), k)[1].sort(-1)[0]
    ib = moe._top_k(torch.softmax(x.to(params_b.device) @ params_b, -1), k)[1].sort(-1)[0]
    return int((ia.cpu() != ib.cpu()).any(-1).sum())


def moe_check_phase(T, k1, moe, cfg, dev, tag) -> dict:
    """Phase M2 for one form of qwen3-moe (``cfg`` at full width) at 1 layer
    in fp32: (a) apply_moe alone on 1 x M2_APPLY_N tokens, twice on the card
    (bit for bit) and once on the CPU (max abs error within M2_MOE_TOL of
    1 + max |y| where no token's choices differ; the routing flips and the
    drops of each side printed); (b) a greedy serve of phase P's requests
    M2_REQUESTS, M2_NEW tokens each on 2 slots, on the card (each
    admission's drops at the config's capacity printed, the streams' length
    and range checked); (c) ``hybrid_check_phase`` at capacity E / K, where no call
    can drop (asserted): chunked vs monolithic prefill, the idle row's state
    bit for bit, decode vs the teacher-forced forward, the card against the
    CPU, K1 launches in the STLT form."""
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.utils import tree_map

    smi = smi_line()
    c = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    params = T.init_lm(c, torch.Generator(device=dev).manual_seed(0), device=dev)
    out = {}
    mc = c.moe_config()
    with torch.no_grad():
        # (a) apply_moe alone
        g = torch.Generator(device=dev).manual_seed(12)
        x = torch.randn(1, M2_APPLY_N, c.d_model, generator=g, device=dev)
        pm = params["layers"][0]["moe"]
        pc = tree_map(torch.Tensor.cpu, pm)
        moe.DROPS.reset()
        y1, a1 = moe.apply_moe(pm, mc, x)
        y2, _ = moe.apply_moe(pm, mc, x)
        card_drops = moe.DROPS.read()["dropped"] // 2
        moe.DROPS.reset()
        yc, ac = moe.apply_moe(pc, mc, x.cpu())
        cpu_drops = moe.DROPS.read()["dropped"]
        flips = moe_routing_flips(moe, pm["router"], pc["router"], x[0], mc.top_k)
        err = float((y1.cpu() - yc).abs().max())
        scale = 1.0 + float(yc.abs().max())
        same = torch.equal(y1, y2)
        out["apply"] = {"err": err, "flips": flips, "drops": (card_drops, cpu_drops),
                        "deterministic": same}
        log(f"[{tag} apply_moe] 1 x {M2_APPLY_N} tokens, fp32 (capacity "
            f"{moe._capacity(M2_APPLY_N, mc)} an expert, mean load "
            f"{M2_APPLY_N * mc.top_k / mc.num_experts:.0f}): dropped choices card "
            f"{card_drops}, CPU {cpu_drops}; tokens routed differently {flips}; card vs CPU "
            f"max abs err {err:.3e} (gate {M2_MOE_TOL} x {scale:.3f} where no token's "
            f"choices differ); aux_loss {float(a1['aux_loss']):.6f} / "
            f"{float(ac['aux_loss']):.6f}, router_z {float(a1['router_z']):.6f} / "
            f"{float(ac['router_z']):.6f}; two card calls bit for bit {same} [{smi}]")
        if not same:
            raise AssertionError(f"{tag}: apply_moe is not deterministic on the card")
        if not card_drops > 0:
            raise AssertionError(f"{tag}: apply_moe at 1 x {M2_APPLY_N} dropped nothing")
        if flips == 0 and not (err <= M2_MOE_TOL * scale and card_drops == cpu_drops):
            raise AssertionError(f"{tag}: apply_moe card vs CPU {err}, drops "
                                 f"{card_drops} / {cpu_drops}")
        del x, y1, y2, yc

    # (b) a short greedy serve on the card
    reqs = spec_requests(c, Request)
    picked = [dataclasses.replace(reqs[i], max_new_tokens=M2_NEW) for i in M2_REQUESTS]
    eng = ServeEngine(params, c, max_len=P_MAX_LEN, prefill_chunk=P_CHUNK, device=dev)
    with DropLog(T, moe) as dl:
        streams = eng.serve(picked, slots=2)
    drops = [dd for name, _, dd in dl.calls if name == "prefill_chunk"]
    ok = all(len(streams[r.id]) == M2_NEW and 0 <= min(streams[r.id])
             and max(streams[r.id]) < c.vocab for r in picked)
    log(f"[{tag} serve] phase P's requests {list(M2_REQUESTS)} ({[len(r.prompt) for r in picked]} "
        f"prompt tokens, {M2_NEW} new each, 2 slots), fp32, 1 layer, on the card: streams "
        f"{[list(map(int, streams[r.id])) for r in picked]}; admission drops {drops} [{smi}]")
    if not ok:
        raise AssertionError(f"{tag}: bad serve streams {streams}")
    del params, pc, eng
    free_cuda()

    # (c) the forms and the CPU at capacity E / K: no call drops
    moe.DROPS.reset()
    out.update(hybrid_check_phase(T, k1, dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k), dev, tag=tag, layers=1))
    drops = moe.DROPS.read()
    log(f"[{tag}] capacity E / K: {drops['dropped']} choices dropped over "
        f"{drops['calls']} apply_moe calls [{smi}]")
    if drops["dropped"]:
        raise AssertionError(f"{tag}: a call dropped at capacity E / K: {drops}")
    return out


def moe_train_phase(T, train, k1, moe, cfg, dev, tag="M3") -> dict:
    """Phase M3: qwen3-moe at 1 layer, full width, trained at M3_B x M3_N in
    bf16 with remat and adafactor (``smollm_train_phase``: remat against
    off, 5 steps, the peak memory with remat on and off, a profiled step),
    step 0's aux_loss and router_z finite, positive and in the loss
    (loss = ce + reg + aux_loss + router_z), and step 0 card against CPU at
    ``reduced()`` widths (``train_cpu_check``)."""
    from repro_torch.data import lm_batch_stream

    c = dataclasses.replace(cfg, num_layers=1)
    out = smollm_train_phase(T, train, k1, c, dev, M3_B, M3_N, tag=tag,
                             compare=T3_COMPARE[:1], remat_modes=("full", "off"))
    free_cuda()
    params = init_cast(T, c, dev)   # bf16 matrices: only the loss's terms are read
    b = {k: torch.from_numpy(v).to(dev) for k, v in lm_batch_stream(0, 0, M3_B, M3_N,
                                                                    c.vocab).items()}
    with torch.no_grad():
        _, m = T.lm_loss(params, c, b, deterministic=True)
    m = {k: float(v) for k, v in m.items()}
    parts = m["ce"] + m["reg"] + m["aux_loss"] + m["router_z"]
    log(f"[{tag} loss] {c.name}, 1 layer, bf16, {M3_B} x {M3_N}: loss {m['loss']:.6f} = ce "
        f"{m['ce']:.6f} + reg {m['reg']:.6f} + aux_loss {m['aux_loss']:.6f} + router_z "
        f"{m['router_z']:.6f} ({parts:.6f}) [{smi_line()}]")
    if not (all(np.isfinite(v) for v in m.values()) and m["aux_loss"] > 0
            and m["router_z"] > 0 and abs(m["loss"] - parts) <= 1e-5 * abs(m["loss"])):
        raise AssertionError(f"{tag}: loss terms {m}")
    del params
    free_cuda()
    out["cpu"] = train_cpu_check(T, train, cfg.reduced(), dev, tag=tag)
    out["loss_terms"] = m
    return out


def arctic_generate_phase(T, k1, moe, get_config, dev, variant, tag) -> dict:
    """Phase M4 for one form of arctic-480b at 1 layer, full width, bf16
    (built by ``init_cast``): at capacity E / K, where no call can drop
    (asserted), ``generate_check_phase`` (M4_B x (M4_PROMPT + M4_NEW), every
    token held to the teacher-forced forward at M4_GAP_CAP and M4_TIE_TOL);
    then the same generate at the config's capacity, its drops per call
    and its tokens' agreement with the teacher-forced forward's argmax and
    with the first generate printed."""
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config(M4_ARCH, variant), num_layers=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_cast(T, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    moe.DROPS.reset()
    out = generate_check_phase(T, k1, dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k), params, dev, tag, M4_B, M4_PROMPT,
        M4_NEW, M4_GAP_CAP, M4_TIE_TOL, seed=6)
    if moe.DROPS.read()["dropped"]:
        raise AssertionError(f"{tag}: a call dropped at capacity E / K: {moe.DROPS.read()}")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, size=(M4_B, M4_PROMPT))
    engine = ServeEngine(params, cfg, max_len=M4_PROMPT + M4_NEW, device=dev)
    with DropLog(T, moe) as dl:
        tokens = np.asarray(engine.generate(prompts, M4_NEW))
    gen = torch.from_numpy(tokens).to(dev)
    seq = torch.cat([torch.from_numpy(prompts).to(dev), gen[:, :-1]], 1)
    moe.DROPS.reset()
    with torch.no_grad():
        teacher = forward_at(T, cfg, params, seq, torch.arange(M4_PROMPT - 1, seq.shape[1]))
    out.update(init_s=init_s, drops=[d for _, _, d in dl.calls],
               teacher_drops=moe.DROPS.read()["dropped"],
               agree=float((teacher.argmax(-1) == gen).double().mean()),
               agree_e_k=float((tokens == out["tokens"]).mean()))
    log(f"[{tag}] {cfg.name} ({cfg.mixer}) at the config's capacity ("
        f"{moe._capacity(M4_B * M4_PROMPT, cfg.moe_config())} an expert for the prefill): "
        f"dropped choices per generate call {out['drops']}, teacher-forced forward "
        f"{out['teacher_drops']}; generated tokens equal to the teacher's argmax "
        f"{100 * out['agree']:.1f}%, to capacity E / K's {100 * out['agree_e_k']:.1f}%; init "
        f"{init_s:.1f} s [{smi_line()}]")
    del engine, params, teacher
    return out


def moe_phase(T, train, k1, dev, get_config) -> dict:
    """Phase M: M1 serves qwen3-moe at M1_LAYERS layers in both forms
    (``moe_serve_phase``), M2 checks both forms at 1 layer in fp32 against
    the CPU (``moe_check_phase``), M3 trains 1 layer (``moe_train_phase``),
    M4 runs arctic-480b at 1 layer in both forms (``arctic_generate_phase``,
    after ``init_cast_check``)."""
    from repro_torch.models import moe

    t_all, smi = time.time(), smi_line()
    out = {"times": {}}
    free_cuda()
    init_cast_check(T, get_config(M4_ARCH), dev, "M")
    for tag, variant in (("M1 native", "native"), ("M1 stlt", "stlt")):
        t0 = time.time()
        cfg = dataclasses.replace(get_config(M_ARCH, variant), num_layers=M1_LAYERS)
        out[tag] = moe_serve_phase(T, k1, moe, cfg, dev, tag)
        out["times"][tag] = time.time() - t0
        free_cuda()
    for tag, variant in (("M2 native", "native"), ("M2 stlt", "stlt")):
        t0 = time.time()
        out[tag] = moe_check_phase(T, k1, moe, get_config(M_ARCH, variant), dev, tag)
        out["times"][tag] = time.time() - t0
        free_cuda()
    t0 = time.time()
    out["M3"] = moe_train_phase(T, train, k1, moe, get_config(M_ARCH), dev)
    out["times"]["M3"] = time.time() - t0
    free_cuda()
    for tag, variant in (("M4 native", "native"), ("M4 stlt", "stlt")):
        t0 = time.time()
        out[tag] = arctic_generate_phase(T, k1, moe, get_config, dev, variant, tag)
        out["times"][tag] = time.time() - t0
        free_cuda()
    log(f"[M time] phase M {time.time() - t_all:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["times"].items()) + f" [{smi}]")
    return out


def k1_direction_timings(k1, ops, dev, C, d) -> dict:
    """At phase W's encoder shapes, K1's training pass causal and
    anti-causal (the reverse call flips x, runs the causal pass and flips z
    back, on the host side of the kernel) by CUDA events, and one flip of x
    alone: what an in-kernel reverse would save. Returns {(BH, N, S): row}."""
    out = {}
    for BH, N, S, _ in K1_WHISPER[:2]:
        x, lm, th, ur, ui, _ = vjp_case(dev, BH // 8, 8, N, S, d, C, seed=13)
        operators = ops._operators(lm, th, ur, ui, C)
        row = {"fwd_ms": time_cuda(lambda: ops._pass(x, operators, C, False,
                                                      k1.stlt_scan_kernel), 20),
               "rev_ms": time_cuda(lambda: ops._pass(x, operators, C, True,
                                                      k1.stlt_scan_kernel), 20),
               "flip_ms": time_cuda(lambda: x.flip(1), 20)}
        log(f"[6 timing] K1 training pass at BH={BH} N={N} S={S}: causal "
            f"{row['fwd_ms']:.4f} ms, anti-causal (flip, K1, flip) {row['rev_ms']:.4f} ms; "
            f"one flip of x {row['flip_ms']:.4f} ms")
        out[(BH, N, S, d)] = row
    return out


E_STREAM_TOKENS, E_STREAM_REPORT = 2000, 500
# K1 calls in the quickstart: the layer's forward, then the LM's 2 STLT layers
E_QUICKSTART_K1 = 3


def example_main(name: str):
    """``main`` of ``examples/torch_<name>.py``, loaded from the checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def examples_phase(k1, k2, dev) -> dict:
    """Phase E: the port's examples in this process on the card, at their
    own widths: the quickstart (the layer's forward, the half-lives, five
    decode steps, a small LM's logits; E_QUICKSTART_K1 K1 launches) and the
    long-context stream at E_STREAM_TOKENS tokens (decode steps only: no
    kernel launch), whose decode state must keep its bytes from the first
    report to the last. Every tensor they return must be on the card and
    finite."""
    from repro_torch.utils import tree_leaves

    out = {}
    for name, argv in (("quickstart", []),
                       ("long_context_stream", ["--tokens", str(E_STREAM_TOKENS),
                                                "--report-every", str(E_STREAM_REPORT)])):
        main = example_main(name)
        k1.stlt_scan_kernel.launches = k2.relevance_flash_kernel.launches = 0
        t0 = time.time()
        res = main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"stlt_scan": k1.stlt_scan_kernel.launches,
                    "relevance_flash": k2.relevance_flash_kernel.launches}
        tensors = [t for t in tree_leaves(res) if isinstance(t, torch.Tensor)]
        on_card = all(t.device.type == "cuda" for t in tensors)
        finite = all(bool(torch.isfinite(t).all()) for t in tensors if t.is_floating_point())
        out[name] = {"wall_s": wall, "launches": launches, "tensors": len(tensors)}
        log(f"[E {name}] {' '.join(argv) or 'defaults'}: {wall:.2f} s, kernel launches "
            f"{launches}; {len(tensors)} tensors returned, all on the card {on_card}, finite "
            f"{finite}" + (f"; decode state bytes at each report {res['state_bytes']}"
                           if "state_bytes" in res else ""))
        if not (on_card and finite and tensors):
            raise AssertionError(f"example {name}: tensors on the card {on_card}, finite "
                                 f"{finite}")
        want_k1 = E_QUICKSTART_K1 if name == "quickstart" else 0
        if launches != {"stlt_scan": want_k1, "relevance_flash": 0}:
            raise AssertionError(f"example {name}: kernel launches {launches}, expected "
                                 f"{want_k1} K1 and no K2")
        if "state_bytes" in res:
            sizes = res["state_bytes"]
            if not (len(sizes) == 1 + E_STREAM_TOKENS // E_STREAM_REPORT
                    and len(set(sizes)) == 1):
                raise AssertionError(f"the stream's decode state changed size: {sizes}")
            out[name]["state_bytes"] = sizes[-1]
    return out


def dt_phase() -> dict:
    """Phases DT, DS, DA and DM: the multi-device training and serving layers
    (``tools/phase_dt.py``) as 4 gloo ranks, processes sharing this card:
    DT1 the 2 x 2 sharded step of stlt-base against the single-device step,
    DT2 the context-parallel STLT against serial K1, DT3 the 2-stage
    pipeline against the serial blocks, DT4 the resilient loop bit for bit;
    DS1 the 2 x 2 prefill and decode cells against the single-device
    functions, DS2 the process form of the sharded engine against the
    one-process engine; DA the train, prefill and decode cells of
    chatglm3-6b and of recurrentgemma-9b in both forms at full width
    against the single-device functions; DM the same of qwen3-moe-235b-a22b
    with its experts on ``model`` (1 x 4 in both forms, the 2 x 2 serving
    cells of the native form). Every rank is stopped before this returns;
    any failed check raises."""
    sys.path.insert(0, str(ROOT / "tools"))
    import phase_dt

    t0 = time.time()
    ranks = phase_dt.launch("gloo", cards=1, timeout=700)
    res = phase_dt.check(ranks)
    res["ranks"] = ranks
    log(f"[DT1 sharded step] stlt-base 2 x 2 (data, model), 4 x 1000 tokens, 4 gloo ranks on "
        f"one card: step ms per rank {res['step_ms']} (single-device {res['ref_step_ms']}); "
        f"K1 per rank per step {res['k1_per_step']}; bytes per rank per step "
        f"{res['bytes_per_step']}; step-0 loss gap {res['loss_gap']:.3e}; worst relative "
        f"metric gaps {res['metric_rel_gap']}; worst param gap "
        f"{res['param_gap_over_tol']:.3f} of its gate")
    log(f"[DT2 context parallel] 8 x 131,072 over 4 ranks: ms per rank {res['cp_ms']} (serial "
        f"K1 {res['cp_serial_ms']}); K1 per shard {res['cp_k1']}; exchanged "
        f"{res['cp_bytes']}; error "
        f"{res['cp_err_over_scale']:.3e} of the scale (gate {phase_dt.K1_TOL})")
    log(f"[DT2 backward] forward + backward ms per rank {res['cp_bwd_ms']} (the serial "
        f"training call's forward + backward over 131,072 tokens {res['cp_serial_bwd_ms']}); "
        f"K1 per rank {res['cp_bwd_k1']} (predicted 2); bytes per rank {res['cp_bwd_bytes']} "
        f"(predicted {phase_dt.DT2_BWD_BYTES}); dx error {res['cp_dx_err_over_scale']:.3e} "
        f"of the scale, pole and mixer grads {res['cp_pole_gaps_over_tol']} of K1's gate "
        f"[{smi_line()}]")
    log(f"[DT3 pipeline] 2 stages x 3 blocks, 4 microbatches of 1 x 1000: ms per rank "
        f"{res['pipe_ms']} (serial {res['pipe_serial_ms']}); K1 {res['pipe_k1']}; outputs "
        f"{res['pipe_out_err_over_scale']:.3e} of the scale, worst grad gap "
        f"{res['pipe_grad_gap_over_tol']:.3f} of its gate")
    log(f"[DT4 resilient loop] {res['resilient']} in {res['resilient_wall_s']:.1f} s, final "
        f"params bit for bit DT1's; phase laps {res['phase_s']}; peak GiB per rank "
        f"{res['peak_gib']}; phase DT {time.time() - t0:.1f} s")
    log(f"[DS1 sharded cells] stlt-base 2 x 2, prefill 4 x 1000 then {phase_dt.DS1_NEW} greedy "
        f"decode steps: prefill ms per rank {res['ds1_prefill_ms']} (single-device "
        f"{res['ds1_ref_prefill_ms']}), median decode-step ms {res['ds1_decode_ms_median']} "
        f"(single-device {res['ds1_ref_decode_ms_median']}); K1 per rank (prefill, decode "
        f"step) {res['ds1_k1']}; "
        f"bytes per rank per prefill {res['ds1_prefill_bytes']}, per decode step "
        f"{res['ds1_decode_bytes']}; worst logit gap {res['ds1_logit_gap']:.3e} (gate "
        f"{phase_dt.DS_LOGIT_TOL}), worst state gap {res['ds1_state_gap_over_tol']:.4f} of "
        f"K1's gate; streams equal per rank {res['ds1_streams_equal']} "
        f"({res['ds1_near_ties']} near ties) [{smi_line()}]")
    log(f"[DS2 process-form engine] phase SH's {res['ds2_requests']} requests, 2 host ranks x "
        f"{SH_SLOTS} slots: {res['ds2_same']} streams equal the one-process engine's "
        f"({res['ds2_ties']} near ties), hosts {res['ds2_hosts']}, ticks equal; K1 per rank "
        f"{res['ds2_k1']} = 6 x admission dispatches {res['ds2_dispatches']} (one-process "
        f"{res['ds2_one_dispatches']}); bytes per rank {res['ds2_bytes']}; per host rank "
        f"{res['ds2_metrics']}; the one-process engine {res['ds2_one_metrics']} "
        f"[{smi_line()}]")
    smi = smi_line()
    for tag, row in [*res["da"].items(), *res["dm"].items()]:
        if tag == "laps":
            continue
        moe = (f"; MoE drops per rank {row['drops']} (single-device {row['ref_drops']})"
               if tag.startswith("DM") and "train" in tag else
               f"; MoE drops per rank per prefill {row['prefill_drops']} (single-device "
               f"{row['ref_prefill_drops']}), in the decode steps {row['decode_drops']}; "
               f"dispatch {row['dispatch']}, fsdp {row['fsdp']}"
               if tag.startswith("DM") else "")
        if "train" in tag:
            log(f"[{tag}] {row['tokens'][0]} x {row['tokens'][1]}, steps "
                f"{phase_dt.DA_TRAIN_STEPS} from the init: step ms "
                f"per rank {row['step_ms']} (single-device, alone on the card: "
                f"{row['ref_step_ms']}); K1 per rank per step {row['k1_per_step']} "
                f"(single-device {row['ref_k1']}); bytes per rank per step "
                f"{row['bytes_per_step']}; step-0 loss gap {row['loss_gap']:.3e}; worst "
                f"relative metric gaps {row['metric_rel_gap']}; worst param gap "
                f"{row['param_gap_over_tol']:.3f} of its gate; peak GiB per rank (its "
                f"reference's turn included) {row['peak_gib']}{moe}; cell {row['s']:.1f} s, "
                f"references {row['ref_s']:.1f} s [{smi}]")
        else:
            log(f"[{tag}] prefill {phase_dt.DA_B} x {phase_dt.DA_N} then {row['new']} "
                f"greedy decode steps: prefill ms per rank {row['prefill_ms']} (single-device "
                f"{row['ref_prefill_ms']}), median decode-step ms {row['decode_ms_median']} "
                f"(single-device {row['ref_decode_ms_median']}); K1 per rank (prefill, decode "
                f"step) {row['k1']} (single-device {row['ref_k1']}){moe}; bytes per rank per "
                f"prefill {row['prefill_bytes']}, per "
                f"decode step {row['decode_bytes']}; worst logit gap {row['logit_gap']:.3e} "
                f"(gate {phase_dt.DA_LOGIT_TOL}), worst state gap "
                f"{row['state_gap_over_tol']:.4f} of K1's gate; streams equal per rank "
                f"{row['streams_equal']} ({row['near_ties']} near ties); peak GiB per rank "
                f"{row['peak_gib']}; cell {row['s']:.1f} s, references {row['ref_s']:.1f} s "
                f"[{smi}]")
    log(f"[DA laps] {res['da']['laps']}; [DM laps] {res['dm']['laps']}")
    return res


# Phase LC: the dry-run (``launch.steps.lower_cell``) of the cells phases DT,
# DS and DM ran on the card, built in this process for each of their 4 ranks
# and run on the meta device. Exact gates: each rank's bytes handed to each
# kind of collective and its calls of each kind (``comm.STATS``,
# ``comm.CALLS``) and its K1 launches (the dry-run's dispatches of K1's op)
# equal what the rank measured. Memory: the dry-run's peak (its arguments
# plus the step's live bytes above them) within LC_PEAK_BANDS[kind] of the
# card's (the bytes the rank was handed plus the allocator's rise over the
# step, its peak reset before it). A step without a backward is held
# tightly; a train step's dry-run peak is an upper bound (its counter's
# dispatch mode makes autograd sum grads out of place:
# ``launch/lowering.py``), 1.2039 of the card's at DT1 and 1.0000 at DM1 on
# an H100 (PERF.md, where the bands are stated before each run).
# Then one production cell at full size.
LC_PEAK_BANDS = {"train": (0.97, 1.25), "prefill": (0.97, 1.05), "decode": (0.97, 1.05)}
LC_FULL_CELL = ("qwen3-moe-235b-a22b", "train_4k", "native")   # on 2 x 16 x 16


def lc_cells(res: list) -> list:
    """(tag, fn(mesh) -> the cell's program, its mesh, fn(rank result) ->
    what the rank measured: bytes, calls, k1, held, grown) for every cell
    phase LC compares."""
    import phase_dt
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.launch import steps

    tcfg = TrainConfig(total_steps=100, warmup_steps=2)
    dm = phase_dt.da_config(phase_dt.DM_ARCH, "stlt", phase_dt.DM_LAYERS)
    B, N, new = phase_dt.DS1_B, phase_dt.DS1_N, phase_dt.DS1_NEW
    dB, dN = phase_dt.DA_B, phase_dt.DA_N

    def served(tag, kind):
        def read(r):
            row = r[tag]
            k1 = row[f"{kind}_k1"]
            return {"bytes": row[f"{kind}_bytes"], "calls": row[f"{kind}_calls"],
                    "k1": k1[-1] if isinstance(k1, list) else k1,
                    "held": row[f"{kind}_held"], "grown": row[f"{kind}_grown"]}
        return read

    return [
        ("DT1 train 2x2", lambda m: steps.build_train_step(
            CONFIG, ShapeConfig("dt", phase_dt.DT1_N, phase_dt.DT1_B, "train"), m, tcfg),
         (2, 2), lambda r: r["DT1"][-1]),
        ("DS1 prefill 2x2", lambda m: steps.build_prefill_step(
            CONFIG, ShapeConfig("ds", N, B, "prefill"), m), (2, 2), served("DS1", "prefill")),
        ("DS1 decode 2x2", lambda m: steps.build_decode_step(
            CONFIG, ShapeConfig("ds", N + new, B, "decode"), m), (2, 2), served("DS1", "decode")),
        ("DM1 stlt train 1x4", lambda m: steps.build_train_step(
            dm, ShapeConfig("dm", phase_dt.DM_TRAIN_N, phase_dt.DM_TRAIN_B, "train"), m, tcfg),
         (1, 4), lambda r: r["DM1 stlt train 1x4"]["steps"][-1]),
        ("DM1 stlt prefill 1x4", lambda m: steps.build_prefill_step(
            dm, ShapeConfig("dm", dN, dB, "prefill"), m), (1, 4),
         served("DM1 stlt serve 1x4", "prefill")),
        ("DM1 stlt decode 1x4", lambda m: steps.build_decode_step(
            dm, ShapeConfig("dm", dN + phase_dt.DM_NEW, dB, "decode"), m), (1, 4),
         served("DM1 stlt serve 1x4", "decode"))]


def lc_phase(res: list) -> dict:
    """Phase LC on the rank results of phase DT's job (``res``): every
    compared cell on every rank, then LC_FULL_CELL's dry-run (no depth
    probes) timed. Raises on a failed gate."""
    from repro_torch.distributed import comm
    from repro_torch.launch import dryrun, steps

    t0 = time.time()
    out, failed = {"cells": {}}, []
    for tag, build, shape, measured in lc_cells(res):
        rows = []
        for r in res:
            mesh = comm.RankMesh(shape, ("data", "model"), r["rank"])
            prog = build(mesh)
            c, band = steps.lower_cell(prog, mesh).compile(), LC_PEAK_BANDS[prog.kind]
            want, mem = measured(r), c.memory_analysis()
            row = {"bytes": c.handed_in, "calls": c.calls, "k1": c.launches["stlt_scan"],
                   "peak": mem.peak_memory_in_bytes, "args": mem.argument_size_in_bytes,
                   "temp": mem.temp_size_in_bytes, "card_held": want["held"],
                   "card_grown": want["grown"], "s": c.seconds}
            row["peak_ratio"] = row["peak"] / (want["held"] + want["grown"])
            failed += [f"LC {tag} rank {r['rank']}: the dry-run's {k} {row[k]}, the card's "
                       f"{want[k]}" for k in ("bytes", "calls", "k1") if row[k] != want[k]]
            if not band[0] <= row["peak_ratio"] <= band[1]:
                failed.append(f"LC {tag} rank {r['rank']}: the dry-run's peak {row['peak']} B "
                              f"is {row['peak_ratio']:.4f} of the card's {want['held']} + "
                              f"{want['grown']} B (band {band})")
            rows.append(row)
        out["cells"][tag] = rows
        log(f"[LC {tag}] per rank: bytes {[r['bytes'] for r in rows]}, calls "
            f"{[r['calls'] for r in rows]}, K1 {[r['k1'] for r in rows]}; peak B "
            f"{[r['peak'] for r in rows]} (args {[r['args'] for r in rows]}, "
            f"temp {[r['temp'] for r in rows]}) against the card's held + grown "
            f"{[(r['card_held'], r['card_grown']) for r in rows]}: ratio "
            f"{[round(r['peak_ratio'], 4) for r in rows]} (band {band}); dry-run s "
            f"{[round(r['s'], 2) for r in rows]}")
    if failed:
        raise AssertionError("; ".join(failed))
    arch, shape_name, variant = LC_FULL_CELL
    rec = dryrun.run_cell(arch, shape_name, variant, True, str(ROOT / "build" / "lc"),
                          verbose=False, depth_probe=False)
    if not rec["ok"]:
        raise AssertionError(f"LC full-size cell {LC_FULL_CELL}: {rec['error']}")
    out["full"] = {"s": rec["wall_s"], "peak": rec["memory"]["peak_memory_in_bytes"],
                   "flops": rec["cost_raw"]["flops"],
                   "collective_bytes": rec["cost_raw"]["collective_bytes"]}
    log(f"[LC full size] {arch} {shape_name} {variant} on 2 x 16 x 16, rank 0: "
        f"{rec['wall_s']} s; peak {out['full']['peak']} B, flops {out['full']['flops']:.6e}, "
        f"collective bytes {out['full']['collective_bytes']:.6e}; phase LC "
        f"{time.time() - t0:.1f} s")
    return out


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
    laps, t_lap = {}, [t_all]

    def lap(name):
        """Record the seconds since the previous lap under ``name``."""
        laps[name], t_lap[0] = time.time() - t_lap[0], time.time()

    # 1. build -----------------------------------------------------------------
    t0 = time.time()
    build.build_kernels(echo=True)
    log(f"[1 build] kernels built in {time.time() - t0:.1f} s")
    lap("1")

    # 2. K1 vs its plain version at the main path's shapes, at batch 1 and
    # over a long row -----------------------------------------------------------
    BH = B * H
    k1_err = 0.0
    for bh_t, n_t, s_t, d_t in K1_SHAPES:
        args, _, _ = k1_case(k1, ops, dev, bh_t, n_t, C, s_t, d_t, seed=1)
        got = k1.stlt_scan_kernel(*args, chunk=C)
        want = k1.stlt_scan_reference(*args, chunk=C)
        torch.cuda.synchronize()
        for name, a, b in zip(("z", "h_re", "h_im"), got, want):
            err = float((a - b).abs().max())
            scale = 1.0 + float(b.abs().max())
            k1_err = max(k1_err, err)
            log(f"[2 K1 vs plain] BH={bh_t} N={n_t} S={s_t} d={d_t} {name}: max abs err "
                f"{err:.3e} (scale {scale:.3e})")
            if not err <= K1_TOL * scale:
                raise AssertionError(f"K1 {name} at BH={bh_t} N={n_t} d={d_t} disagrees with "
                                     f"its plain version: {err} > {K1_TOL} * {scale}")
        idle = torch.from_numpy(np.arange(bh_t) % 4 == 0).to(dev)   # valid == 0
        if not (torch.equal(got[1][idle], args[8][idle])
                and torch.equal(got[2][idle], args[9][idle])):
            raise AssertionError("K1: valid == 0 rows must return h0 exactly")
        del args, got, want

    # phase W's training passes (no carry, no snapshot), causal and
    # anti-causal: the bilateral encoder's two calls and their dx passes
    for bh_t, n_t, s_t, d_t in K1_WHISPER:
        x, lm, th, ur, ui, _ = vjp_case(dev, bh_t // H, H, n_t, s_t, d_t, C, seed=3)
        operators = ops._operators(lm, th, ur, ui, C)
        for rev in (False, True):
            got = ops._pass(x, operators, C, rev, k1.stlt_scan_kernel)[0]
            want = ops._pass(x, operators, C, rev, k1.stlt_scan_reference)[0]
            err, scale = float((got - want).abs().max()), 1.0 + float(want.abs().max())
            k1_err = max(k1_err, err)
            log(f"[2 K1 vs plain] training pass BH={bh_t} N={n_t} S={s_t} reverse={rev}: "
                f"max abs err {err:.3e} (scale {scale:.3e})")
            if not err <= K1_TOL * scale:
                raise AssertionError(f"K1's training pass at BH={bh_t} N={n_t} "
                                     f"reverse={rev}: {err} > {K1_TOL} * {scale}")
        del x, operators, got, want

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

    lap("2")
    # T1. the scan's VJP on the card: K1 forward and anti-causal (dx), the
    # analytic pole/mixer grads, against float64 autograd -----------------------
    vjp_err = max(scan_vjp_check(k1, ops, dev, B, H, n_t, S, dh, C, rev)
                  for n_t in (N, N + 37) for rev in (False, True))
    # and at phase T3's shape: SmolLM-360M-stlt, 8 x 15 heads x 1024, S = 32
    smollm = get_config("smollm-360m", "stlt")
    vjp_err = max([vjp_err] + [
        scan_vjp_check(k1, ops, dev, T3_B, smollm.num_heads, T3_N, smollm.stlt_nodes,
                       smollm.dh, smollm.stlt_chunk, rev) for rev in (False, True)])
    # param_grads="recompute", the analytic grads' A/B baseline, at T1's shape
    recompute = [recompute_check(k1, ops, dev, B, H, N, S, dh, C, rev) for rev in (False, True)]

    lap("T1")
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
    lap("3-8")
    # T2. the training path: full-width stlt-base, AdamW steps on the card ----------
    tr = train_phase(T, train, k1, cfg, dev, B, N)
    lap("T2")

    # 6. timing -------------------------------------------------------------------
    k1_rows = k1_timings(k1, ops, dev, C)
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
    main_row = k1_rows[(BH, N, S, dh)]
    k1_ms = main_row["call"]
    plain_ms = time_cuda(lambda: k1.stlt_scan_reference(*main_args, chunk=C), iters=10)
    log(f"[6 timing] K1 plain version at BH={BH} N={N}: {plain_ms:.4f} ms")
    del main_args
    train_args, _, _ = k1_case(k1, ops, dev, *K1_TRAIN[:2], C, *K1_TRAIN[2:], seed=5)
    train_row = k1_rows[K1_TRAIN]
    train_row["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*train_args, chunk=C),
                                   iters=10)
    log(f"[6 timing] K1 at phase T3's train shape BH={K1_TRAIN[0]} N={K1_TRAIN[1]} "
        f"S={K1_TRAIN[2]}: plain version {train_row['plain']:.4f} ms, the kernel alone "
        f"{train_row['alone']:.4f} ms, bound {train_row['bound']:.4f} ms "
        f"({train_row['bound_by']})")
    del train_args
    k1_dir = k1_direction_timings(k1, ops, dev, C, dh)
    for shape in K1_WHISPER:
        w_args, _, _ = k1_case(k1, ops, dev, *shape[:2], C, *shape[2:], seed=5)
        k1_rows[shape]["plain"] = time_cuda(
            lambda: k1.stlt_scan_reference(*w_args, chunk=C), iters=5)
        r = k1_rows[shape]
        log(f"[6 timing] K1 at phase W's shape BH={shape[0]} N={shape[1]} S={shape[2]}: "
            f"kernel alone {r['alone']:.4f} ms, device time {r['device']} ms, call "
            f"{r['call']:.4f} ms, plain version {r['plain']:.4f} ms, bound {r['bound']:.4f} "
            f"ms ({r['bound_by']})")
        del w_args
    long_ms = long_prefill(T, cfg, engine.params, dev, k1_rows[(8, LONG_N, S, dh)]["scan"],
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

    lap("6")
    # S. the serving path: continuous serve with chunked admission through K1
    # and the prefix cache, against each request run alone; wave mode. Last,
    # so that its long profile cannot disturb the kernel timings' profiles.
    srv = serve_phase(T, k1, cfg, engine.params, dev)
    lap("S")

    # F. stlt-base's hann form (no kernel): checked, served, a long prefill
    hann = hann_phase(T, k1, k2, cfg, engine.params, dev, prompts, long_ms)
    free_cuda()
    lap("F")
    # SH. the sharded engine: phase S's requests on 2 hosts x 2 slots with a
    # replicated prefix cache (K1 on every admission), n-gram spec, the CLI
    sharded = sharded_phase(T, k1, cfg, engine.params, dev, srv["streams"])
    free_cuda()
    lap("SH")
    del engine, params, rparams
    torch.cuda.empty_cache()

    # P. SmolLM-360M's STLT variant in bf16: speculative decoding and the SLO
    # node ladder through K1 at S = 32
    spec = spec_phase(T, k1, smollm, dev, k1_rows, keep=True)
    torch.cuda.empty_cache()
    lap("P")

    # D. the same model and requests served by the disaggregated prefill and
    # decode fleets (K1 on the prefill fleet only): loopback, chaos, a socket
    # worker process; the native KV state's blob beside the STLT state's
    disagg = disagg_phase(T, k1, smollm, dev, spec)
    for key in ("params", "plain", "plain_rows"):
        del spec[key]
    free_cuda()
    lap("D")

    # T3. SmolLM-360M-stlt trained in bf16 with remat through K1, and the
    # paper-small preset through the CLI with a checkpoint and a resume
    t3 = smollm_train_phase(T, train, k1, smollm, dev, T3_B, T3_N)
    lap("T3")
    cli = cli_resume_phase(train)
    torch.cuda.empty_cache()
    lap("CLI")

    # W. whisper-base's STLT variant: encode and greedy decode (W1, card vs
    # CPU at 2 + 2 layers), training in bf16 with remat (W2), through K1
    # causal and anti-causal
    from repro_torch.launch import steps
    from repro_torch.models import whisper as W
    wcfg = get_config("whisper-base", "stlt")
    w1 = whisper_decode_phase(W, steps, k1, wcfg, dev)
    w1["cpu"] = whisper_cpu_check(W, steps, train, k1, wcfg, dev)
    torch.cuda.empty_cache()
    w2 = whisper_train_phase(W, train, k1, wcfg, dev, steps.WHISPER_ENC_FRAMES)
    torch.cuda.empty_cache()
    lap("W")

    # A. native attention, the paper's baseline: SmolLM-360M served (plain
    # and n-gram spec), checked, timed beside SDPA, trained; native
    # whisper-base encoded, decoded and trained. No K1 launch.
    attention_phase(T, train, W, steps, k1, dev, get_config)
    torch.cuda.empty_cache()
    lap("A")

    # H. the hybrid family: recurrentgemma-9b served in both forms at full
    # width (K1 at head dim 256 in the STLT variant, none in the native),
    # checked in fp32 at one period, trained; chatglm3-6b-stlt generates
    # (K1 at head dim 128)
    hyb = hybrid_phase(T, train, k1, dev, get_config, k1_rows)
    for shape in K1_HYBRID:
        h_args, _, _ = k1_case(k1, ops, dev, *shape[:2], C, *shape[2:], seed=5)
        k1_rows[shape]["plain"] = time_cuda(
            lambda: k1.stlt_scan_reference(*h_args, chunk=C), iters=5)
        r = k1_rows[shape]
        log(f"[6 timing] K1 at phase H's shape BH={shape[0]} N={shape[1]} S={shape[2]} "
            f"d={shape[3]}: kernel alone {r['alone']:.4f} ms, device time {r['device']} ms, "
            f"call {r['call']:.4f} ms, plain version {r['plain']:.4f} ms, bound "
            f"{r['bound']:.4f} ms ({r['bound_by']})")
        del h_args
    lap("H")

    # X. xLSTM: xlstm-350m served, checked, trained (no K1 launch)
    xl = xlstm_phase(T, train, k1, dev, get_config)
    lap("X")
    # M. the MoE family: qwen3-moe served at 2 layers in both forms (K1 at
    # head dim 64 in the STLT variant), checked against the CPU and trained
    # at 1 layer; arctic generates at 1 layer (K1 at head dim 128)
    mo = moe_phase(T, train, k1, dev, get_config)
    for shape in K1_MOE:
        m_args, _, _ = k1_case(k1, ops, dev, *shape[:2], C, *shape[2:], seed=5)
        k1_rows[shape]["plain"] = time_cuda(
            lambda: k1.stlt_scan_reference(*m_args, chunk=C), iters=5)
        r = k1_rows[shape]
        log(f"[6 timing] K1 at phase M's shape BH={shape[0]} N={shape[1]} S={shape[2]} "
            f"d={shape[3]}: kernel alone {r['alone']:.4f} ms, device time {r['device']} ms, "
            f"call {r['call']:.4f} ms, ops.stlt_scan {r['scan']:.4f} ms, plain version "
            f"{r['plain']:.4f} ms, bound {r['bound']:.4f} ms ({r['bound_by']})")
        del m_args
    lap("M")
    # E. the port's examples on the card: the quickstart, the long stream
    examples = examples_phase(k1, k2, dev)
    lap("E")
    # DT. the multi-device training and serving layers: 4 gloo ranks sharing
    # the card (sharded step, context parallel, pipeline, resilient loop;
    # the sharded serving cells, the process-form engine)
    free_cuda()
    dt = dt_phase()
    cp_args, _, _ = k1_case(k1, ops, dev, *K1_CP[:2], C, *K1_CP[2:], seed=5)
    k1_rows[K1_CP]["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*cp_args, chunk=C),
                                        iters=3)
    r = k1_rows[K1_CP]
    # the CP backward's dx pass at the shard: K1 anti-causal (flip, K1, flip)
    x, lm, th, ur, ui, dz = vjp_case(dev, 1, *K1_CP, C, seed=13)
    operators = ops._operators(lm, th, ur, ui, C)
    r["rev_ms"] = time_cuda(lambda: ops._pass(dz, operators, C, True, k1.stlt_scan_kernel), 20)
    log(f"[6 timing] K1 at phase DT's CP shard BH={K1_CP[0]} N={K1_CP[1]}: kernel alone "
        f"{r['alone']:.4f} ms, device time {r['device']} ms, call {r['call']:.4f} ms, plain "
        f"version {r['plain']:.4f} ms, bound {r['bound']:.4f} ms ({r['bound_by']}); the "
        f"backward's anti-causal pass over dz {r['rev_ms']:.4f} ms")
    del cp_args, x, lm, th, ur, ui, dz, operators
    ds_args, _, _ = k1_case(k1, ops, dev, *K1_DS2[:2], C, *K1_DS2[2:], seed=5)
    k1_rows[K1_DS2]["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*ds_args, chunk=C),
                                         iters=5)
    r = k1_rows[K1_DS2]
    log(f"[6 timing] K1 at phase DS2's host-rank admission BH={K1_DS2[0]} N={K1_DS2[1]}: "
        f"kernel alone {r['alone']:.4f} ms, device time {r['device']} ms, call "
        f"{r['call']:.4f} ms, plain version {r['plain']:.4f} ms, bound {r['bound']:.4f} ms "
        f"({r['bound_by']})")
    del ds_args
    da_args, _, _ = k1_case(k1, ops, dev, *K1_DA2[:2], C, *K1_DA2[2:], seed=5)
    k1_rows[K1_DA2]["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*da_args, chunk=C),
                                         iters=5)
    r = k1_rows[K1_DA2]
    log(f"[6 timing] K1 at phase DA2's rank shape BH={K1_DA2[0]} N={K1_DA2[1]} "
        f"S={K1_DA2[2]} d={K1_DA2[3]}: kernel alone {r['alone']:.4f} ms, device time "
        f"{r['device']} ms, call {r['call']:.4f} ms, plain version {r['plain']:.4f} ms, "
        f"bound {r['bound']:.4f} ms ({r['bound_by']})")
    del da_args
    for shape, what in zip(K1_DM1, ("prefill cell (stateful)", "train cell")):
        dm_args, _, _ = k1_case(k1, ops, dev, *shape[:2], C, *shape[2:], seed=5)
        k1_rows[shape]["plain"] = time_cuda(lambda: k1.stlt_scan_reference(*dm_args, chunk=C),
                                            iters=5)
        r = k1_rows[shape]
        log(f"[6 timing] K1 at phase DM1's rank shape BH={shape[0]} N={shape[1]} "
            f"S={shape[2]} d={shape[3]}, the 1 x 4 {what}: kernel alone {r['alone']:.4f} ms, "
            f"device time {r['device']} ms, call {r['call']:.4f} ms, plain version "
            f"{r['plain']:.4f} ms, bound {r['bound']:.4f} ms ({r['bound_by']})")
        del dm_args
    lap("DT")
    # LC. the dry-run of DT's, DS's and DM's cells against what their ranks
    # measured, and one production cell at full size
    lc_phase(dt["ranks"])
    lap("LC")
    log(f"[6 timing] whole script {time.time() - t_all:.1f} s; by phase: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in laps.items()))

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
        # phase D: K1 launches in the disaggregated serve's prefill fleet
        # (layers x its admission dispatches) and decode fleet (0), and in
        # the chaos serve's prefill fleet (re-prefills included)
        "launches_per_disagg_serve": disagg["D1"]["prefill_k1"],
        "launches_per_disagg_decode_fleet": disagg["D1"]["decode_k1"],
        "launches_per_disagg_chaos_serve": disagg["D2"]["prefill_k1"],
        # and in the socket prefill worker's process (layers x its admission
        # dispatches, from the report it prints after bye)
        "launches_per_disagg_worker_serve": disagg["D3"]["worker_k1"],
        "verify_shape": list(K1_VERIFY), "verify_device_ms": k1_rows[K1_VERIFY]["device"],
        "verify_alone_ms": k1_rows[K1_VERIFY]["alone"],
        "verify_scan_ms": k1_rows[K1_VERIFY]["scan"],
        "verify_plain_ms": k1_rows[K1_VERIFY]["plain"],
        "verify_bound_ms": k1_rows[K1_VERIFY]["bound"],
        "train_fwd_ms": train_k1["fwd_ms"], "dx_ms": train_k1["dx_ms"],
        "dx_device_ms": train_k1["dx_device_ms"], "dx_bound_ms": train_k1["bound"],
        "vjp_max_err_over_scale": vjp_err,
        # phase T1: param_grads="recompute" against "analytic" (worst error
        # over the scale) and both backwards' times, causal and anti-causal
        "recompute_max_err_over_scale": max(r["worst"] for r in recompute),
        "recompute_bwd_ms": [r["recompute_bwd_ms"] for r in recompute],
        "analytic_bwd_ms": [r["analytic_bwd_ms"] for r in recompute],
        # phase F: K1 launches in the hann form's serve (0: no kernel), and
        # phase SH: in the sharded serve (layers x [4, chunk] admission
        # dispatches) and its n-gram spec serve (+ verify dispatches)
        "launches_per_hann_serve": hann["F2"]["launches"][0],
        "launches_per_sharded_serve": sharded["k1_launches"],
        "launches_per_sharded_spec_serve": sharded["spec_k1"],
        # phase W (whisper-base-stlt): K1 launches in one encode (2 a
        # bilateral encoder layer) and in one bf16 train step with remat;
        # K1 at the encode's shape (32 rows x 1500 frames, S = 32) and the
        # train step's (64 x 1500, 64 x 448): device time, the kernel alone,
        # the plain version, the bound; the anti-causal pass with its flips
        "launches_per_whisper_encode": w1["encode_launches"],
        "launches_per_whisper_train_step": w2["launches_per_step"],
        "whisper_shapes": {"x".join(map(str, sh)): {
            k: k1_rows[sh][k] for k in ("device", "alone", "call", "plain", "bound",
                                        "bound_by")} for sh in K1_WHISPER},
        "whisper_direction_ms": {"x".join(map(str, sh)): row
                                 for sh, row in k1_dir.items()},
        # phase H: K1 launches in the native recurrentgemma-9b serves (0),
        # in its STLT variant's plain and n-gram serves (12 STLT layers x
        # the dispatches that call K1), per STLT train step at one period
        # (3: forward, recompute, dx), in chatglm3-6b-stlt's generate (28);
        # K1 at phase H's shapes (d = 256 and 128)
        "launches_per_hybrid_native_serve": hyb["H1"]["runs"]["plain"]["k1_launches"],
        "launches_per_hybrid_native_ngram_serve": hyb["H1"]["runs"]["ngram"]["k1_launches"],
        "launches_per_hybrid_stlt_serve": hyb["H2"]["runs"]["plain"]["k1_launches"],
        "launches_per_hybrid_stlt_ngram_serve": hyb["H2"]["runs"]["ngram"]["k1_launches"],
        "launches_per_hybrid_train_step": hyb["H4 stlt"]["launches_per_step"],
        "launches_per_hybrid_native_train_step": hyb["H4 native"]["launches_per_step"],
        "launches_per_chatglm3_generate": hyb["H5"]["k1_launches"],
        "hybrid_shapes": {"x".join(map(str, sh)): {
            k: k1_rows[sh][k] for k in ("device", "alone", "call", "plain", "bound",
                                        "bound_by")} for sh in K1_HYBRID},
        # phase X: xlstm-350m makes no K1 launch (serve, train step); phase
        # M: K1 launches in qwen3-moe's native (0) and STLT serves at 4
        # layers (4 x the admission dispatches), per qwen3-moe train step at
        # 1 layer (0, native), in arctic's STLT generate at 1 layer (1); K1
        # at phase M's shapes (d = 64 and 128)
        "launches_per_xlstm_serve": xl["X1"]["runs"]["plain"]["k1_launches"],
        "launches_per_xlstm_train_step": xl["X3"]["launches_per_step"],
        "launches_per_moe_native_serve": mo["M1 native"]["k1_launches"],
        "launches_per_moe_stlt_serve": mo["M1 stlt"]["k1_launches"],
        "launches_per_moe_train_step": mo["M3"]["launches_per_step"],
        "launches_per_arctic_stlt_generate": mo["M4 stlt"]["k1_launches"],
        "moe_shapes": {"x".join(map(str, sh)): {
            k: k1_rows[sh][k] for k in ("device", "alone", "call", "scan", "plain", "bound",
                                        "bound_by")} for sh in K1_MOE},
        # phase DT (4 gloo ranks on the card): K1 launches per rank per
        # sharded train step (6 layers x 3 on 2 rows x 4 heads), per
        # context-parallel shard (1, stateful, 8 x 32,768) and per pipeline
        # stage's forward + backward (3 blocks x 4 microbatches x 2); K1 at
        # the CP shard's shape
        # phase E: K1 launches in the quickstart example (the layer's
        # forward and the small LM's 2 layers) and in the stream (0: decode)
        "launches_per_quickstart": examples["quickstart"]["launches"]["stlt_scan"],
        "launches_per_stream": examples["long_context_stream"]["launches"]["stlt_scan"],
        "launches_per_sharded_train_step_rank": dt["k1_per_step"][0],
        "launches_per_cp_shard": dt["cp_k1"][0],
        # and per rank in the context-parallel forward + backward (the
        # stateful forward, the anti-causal dx pass), with its ms per rank
        "launches_per_cp_shard_fwd_bwd": dt["cp_bwd_k1"][0],
        "cp_fwd_bwd_ms": dt["cp_bwd_ms"], "cp_serial_fwd_bwd_ms": dt["cp_serial_bwd_ms"],
        "launches_per_pipeline_stage": dt["pipe_k1"][0],
        "cp_shard_shape": list(K1_CP), "cp_shard_device_ms": k1_rows[K1_CP]["device"],
        "cp_shard_alone_ms": k1_rows[K1_CP]["alone"], "cp_shard_call_ms": k1_rows[K1_CP]["call"],
        "cp_shard_plain_ms": k1_rows[K1_CP]["plain"],
        "cp_shard_bound_ms": k1_rows[K1_CP]["bound"],
        "cp_shard_rev_ms": k1_rows[K1_CP]["rev_ms"],
        # phase DS: K1 launches per rank in one sharded prefill cell (6
        # layers on 2 rows x 4 heads) and in one decode-cell step (0), and
        # per host rank in the process-form serve (6 x its [2, 512]
        # admission dispatches); K1 at that admission shape
        "launches_per_sharded_prefill_rank": dt["ds1_k1"][0][0],
        "launches_per_sharded_decode_step_rank": dt["ds1_k1"][0][1],
        "launches_per_process_form_serve_rank": dt["ds2_k1"],
        "ds2_shape": list(K1_DS2), "ds2_device_ms": k1_rows[K1_DS2]["device"],
        "ds2_alone_ms": k1_rows[K1_DS2]["alone"], "ds2_plain_ms": k1_rows[K1_DS2]["plain"],
        "ds2_bound_ms": k1_rows[K1_DS2]["bound"],
        # phase DM: K1 launches per rank in qwen3-moe-stlt's 1 x 4 cells (its
        # STLT layer on the rank's 16 heads: 3 a train step, 1 a prefill, 0 a
        # decode step; the single-device calls' counts beside them); K1 at
        # those rank shapes
        "launches_per_ep_train_step_rank": dt["dm"]["DM1 stlt train 1x4"]["k1_per_step"],
        "launches_per_ep_prefill_decode_rank": dt["dm"]["DM1 stlt serve 1x4"]["k1"],
        "dm1_shapes": {"x".join(map(str, sh)): {
            k: k1_rows[sh][k] for k in ("device", "alone", "call", "plain", "bound",
                                        "bound_by")} for sh in K1_DM1}}, {
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
