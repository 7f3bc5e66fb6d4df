#!/usr/bin/env python3
"""Read phase W's gaps on one NVIDIA GPU, with its tolerance gates opened.

    python3 tools/phase_w_gaps.py

Builds the kernels, checks K1 against its plain version at phase W's
shapes (both directions of the training pass), then runs
``chip_smoke.whisper_decode_phase`` (full-width whisper-base-stlt in bf16:
encode 4 x 1500 frames, 64 greedy tokens against the teacher-forced
forward), ``whisper_cpu_check`` (fp32, 2 + 2 layers: card vs CPU logits
and step-0 grads, and each side's decode step vs its teacher-forced
forward) and ``whisper_train_phase`` (8 x (1500 frames, 448 tokens), bf16
with remat) with their gates raised out of the way; the K1 launch counts
still hold. The last line is a JSON object: the decode-vs-teacher logit
gap and the near ties, the same gap in fp32, the 2 + 2 layer gaps, step
0's gaps (bf16 remat against remat off and against fp32 compute: loss
relative, the worst grad leaf's relative norm and its path), and the
phase's times, memory and profiles. The full-depth noise bounds
``W_GAP_CAP``, ``W_FP32_GAP_CAP``, ``W_BF16_LOSS_TOL`` and
``W_BF16_GRAD_TOL`` are set from these readings (``W_FP32_STEP_TOL``
from ``tests/jax_whisper_gaps.py``'s); rerun this after a change to the
model's numerics.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_w_gaps: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import steps, train
    from repro_torch.models import whisper as W

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.build_kernels(echo=False)
    cfg = get_config("whisper-base", "stlt")
    dev = torch.device("cuda")
    C, H, dh = cfg.stlt_chunk, cfg.num_heads, cfg.dh
    for BH, N, S, d in cs.K1_WHISPER:
        x, lm, th, ur, ui, _ = cs.vjp_case(dev, BH // H, H, N, S, d, C, seed=3)
        operators = ops._operators(lm, th, ur, ui, C)
        for rev in (False, True):
            got = ops._pass(x, operators, C, rev, k1.stlt_scan_kernel)[0]
            want = ops._pass(x, operators, C, rev, k1.stlt_scan_reference)[0]
            err, scale = float((got - want).abs().max()), 1.0 + float(want.abs().max())
            cs.log(f"[gaps K1] {BH} x {N} S={S} reverse={rev}: max abs err {err:.3e} "
                   f"(scale {scale:.3e})")
            if not err <= cs.K1_TOL * scale:
                raise AssertionError(f"K1 at {BH} x {N} reverse={rev}: {err}")
    cs.K1_SHAPES = cs.K1_WHISPER
    rows = cs.k1_timings(k1, ops, dev, C)
    direction = cs.k1_direction_timings(k1, ops, dev, C, dh)
    cs.W_GAP_CAP = cs.W_TIE_TOL = cs.W_FP32_GAP_CAP = cs.W_CPU_TOL = cs.W_FP32_STEP_TOL = 1e9
    cs.TRAIN_LOSS_TOL = cs.TRAIN_GRAD_TOL = cs.W_BF16_LOSS_TOL = cs.W_BF16_GRAD_TOL = 1e9
    w1 = cs.whisper_decode_phase(W, steps, k1, cfg, dev)
    cpu = cs.whisper_cpu_check(W, steps, train, k1, cfg, dev)
    torch.cuda.empty_cache()
    w2 = cs.whisper_train_phase(W, train, k1, cfg, dev, steps.WHISPER_ENC_FRAMES)
    smi = cs.smi_line()
    cs.log(f"[gaps] {time.time() - t0:.1f} s [{smi}]")
    print(json.dumps({"w1": w1, "cpu": cpu, "w2": w2, "card": smi,
                      "k1_rows": {"x".join(map(str, k)): v for k, v in rows.items()},
                      "direction": {"x".join(map(str, k)): v for k, v in direction.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
