#!/usr/bin/env python3
"""Read phases X's and M's bf16 gaps on one NVIDIA GPU, with their gap gates
opened.

    python3 tools/phase_xm_gaps.py

Builds the kernels, holds K1 against its plain version at phase M's shapes
(``chip_smoke.K1_MOE``: head dims 64 and 128) and times it there, then runs
``chip_smoke.xlstm_phase`` and ``chip_smoke.moe_phase`` alone (xlstm-350m,
qwen3-moe-235b-a22b and arctic-480b; random weights from seed 0) with the
gaps ``X1_GAP_CAP``, ``X3_BF16_GRAD_TOL``, ``M4_GAP_CAP`` and their tie
tolerances raised out of the way. Every other gate of the phases still
holds (the fp32 checks of X2 and M2, the card against the CPU, the remat
checks, the K1 launch counts, the drops). The last line is a JSON object:
X1's largest chunk-form vs recurrent-form logit gap along the plain
streams (``gap``), the near-tie steps of each serve (``ties``), the
largest served-vs-argmax gap among them (``tie_gap``) and whether each
serve's streams equal the plain ones (``same``); X3's bf16-vs-fp32 step-0
gaps; M4's decode-vs-teacher gap at capacity E / K in each form; and each
part's seconds. These readings are what the caps are set from; rerun this
after a change to the model's numerics.
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
        print("phase_xm_gaps: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.build_kernels(echo=False)
    dev = torch.device("cuda")
    C = get_config("qwen3-moe-235b-a22b", "stlt").stlt_chunk
    for BH, N, S, d in cs.K1_MOE:
        args, _, _ = cs.k1_case(k1, ops, dev, BH, N, C, S, d, seed=1)
        got = k1.stlt_scan_kernel(*args, chunk=C)
        want = k1.stlt_scan_reference(*args, chunk=C)
        for name, a, b in zip(("z", "h_re", "h_im"), got, want):
            err, scale = float((a - b).abs().max()), 1.0 + float(b.abs().max())
            cs.log(f"[gaps K1] BH={BH} N={N} S={S} d={d} {name}: max abs err {err:.3e} "
                   f"(scale {scale:.3e})")
            if not err <= cs.K1_TOL * scale:
                raise AssertionError(f"K1 {name} at {BH} x {N} d={d}: {err}")
    cs.K1_SHAPES = cs.K1_MOE
    cs.k1_timings(k1, ops, dev, C)
    cs.X1_GAP_CAP = cs.X1_TIE_TOL = cs.X3_BF16_GRAD_TOL = 1e9
    cs.M4_GAP_CAP = cs.M4_TIE_TOL = 1e9
    t1 = time.time()
    xl = cs.xlstm_phase(T, train, k1, dev, get_config)
    t2 = time.time()
    mo = cs.moe_phase(T, train, k1, dev, get_config)
    cs.log(f"[gaps] {time.time() - t0:.1f} s (X {t2 - t1:.1f} s, M {time.time() - t2:.1f} s) "
           f"[{cs.smi_line()}]")
    print(json.dumps({
        "X1": {k: xl["X1"][k] for k in ("gap", "ties", "tie_gap", "same")},
        "X3": xl["X3"]["gaps"],
        "M4": {tag: mo[tag]["gap"] for tag in ("M4 native", "M4 stlt")},
        "times": {**xl["times"], **mo["times"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
