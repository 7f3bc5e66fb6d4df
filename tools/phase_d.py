#!/usr/bin/env python3
"""Run phase D of ``chip_smoke.py`` alone on one NVIDIA GPU.

    python3 tools/phase_d.py

Builds the kernels, serves phase P's plain run (``chip_smoke.spec_phase``
with only its plain serve: SmolLM-360M-stlt at full width, matrices cast to
bf16, random weights from seed 0), then phase D on the same params and
requests: the disaggregated fleets over the loopback transport (f32 and
bf16 wire), under chaos with two hosts killed, through a socket prefill
worker process, and the native KV state's blob. Every gate of both phases
holds. The last line is a JSON object of phase D's readings (fleet clocks,
TTFT and gap percentiles, K1 launches per fleet, handoff bytes, fault
counters, the worker's start-up wall).
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
        print("phase_d: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_kernels(echo=False)
    cfg = get_config("smollm-360m", "stlt")
    dev = torch.device("cuda")
    p_out = cs.spec_phase(T, k1, cfg, dev, None, runs=(("plain", {}),), profiled="plain",
                          keep=True)
    out = cs.disagg_phase(T, k1, cfg, dev, p_out)
    cs.log(f"[phase D] {time.time() - t0:.1f} s [{cs.smi_line()}]")
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
