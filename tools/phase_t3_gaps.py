#!/usr/bin/env python3
"""Read phase T3's gaps on one NVIDIA GPU, with its tolerance gates opened.

    python3 tools/phase_t3_gaps.py

Runs ``chip_smoke.smollm_train_phase`` alone (SmolLM-360M-stlt at full
width in bf16 with remat, 8 x 1024 tokens a step, random weights from seed
0) with its step-0 gates raised out of the way, after building the kernels,
checking and timing K1 at the train shape and holding the scan's VJP there
(phase T1); then ``cli_resume_phase`` (paper-small through the CLI, a
resume against two straight runs), whose gate still holds. The last line
is a JSON object: step 0's gaps, bf16 remat against remat off and against
fp32 compute (loss relative, the worst grad leaf's relative norm and its
path), the straight and resumed CLI distances, and the step's time, peak
memory per remat mode and profile. ``T3_BF16_LOSS_TOL`` and
``T3_BF16_GRAD_TOL`` are set from these readings; rerun this after a
change to the model's numerics.
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
        print("phase_t3_gaps: no CUDA device", file=sys.stderr)
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
    cfg = get_config("smollm-360m", "stlt")
    dev = torch.device("cuda")
    BH, N, S, d = cs.K1_TRAIN
    args, _, _ = cs.k1_case(k1, ops, dev, BH, N, cfg.stlt_chunk, S, d, seed=1)
    for name, a, b in zip(("z", "h_re", "h_im"), k1.stlt_scan_kernel(*args, chunk=cfg.stlt_chunk),
                          k1.stlt_scan_reference(*args, chunk=cfg.stlt_chunk)):
        err, scale = float((a - b).abs().max()), 1.0 + float(b.abs().max())
        cs.log(f"[gaps K1] {cs.K1_TRAIN} {name}: max abs err {err:.3e} (scale {scale:.3e})")
        if not err <= cs.K1_TOL * scale:
            raise AssertionError(f"K1 {name} at {cs.K1_TRAIN}: {err}")
    del args
    cs.K1_SHAPES = (cs.K1_TRAIN,)
    rows = cs.k1_timings(k1, ops, dev, cfg.stlt_chunk)
    vjp = max(cs.scan_vjp_check(k1, ops, dev, cs.T3_B, cfg.num_heads, cs.T3_N,
                                cfg.stlt_nodes, cfg.dh, cfg.stlt_chunk, rev)
              for rev in (False, True))
    cs.TRAIN_LOSS_TOL = cs.TRAIN_GRAD_TOL = cs.T3_BF16_LOSS_TOL = cs.T3_BF16_GRAD_TOL = 1e9
    out = cs.smollm_train_phase(T, train, k1, cfg, dev, cs.T3_B, cs.T3_N)
    cli = cs.cli_resume_phase(train)
    smi = cs.smi_line()
    cs.log(f"[gaps] {time.time() - t0:.1f} s [{smi}]")
    print(json.dumps({"gaps": out.pop("gaps"), "cli": cli, "vjp": vjp,
                      "k1_train_row": rows[cs.K1_TRAIN], "t3": out, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
