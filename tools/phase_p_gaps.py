#!/usr/bin/env python3
"""Read phase P's bf16 logit gaps on one NVIDIA GPU, with its tolerance gates
opened.

    python3 tools/phase_p_gaps.py

Runs ``chip_smoke.spec_phase`` alone (SmolLM-360M-stlt at full width, its
matrices cast to bf16 as the serve CLI casts them, random weights from seed
0) with ``P_GAP_CAP`` and ``P_TIE_TOL`` raised out of the way, after
building the kernels and timing K1 at the verify shape. Every other gate of
the phase still holds. The last line is a JSON object: the largest
chunk-form vs recurrent-form logit gap along the plain streams (``gap``),
the near-tie steps of each serve (``ties``), the largest served-vs-argmax
logit gap among them (``tie_gap``) and whether each serve's streams equal
the plain ones (``same``). These readings are what ``P_GAP_CAP`` and
``P_TIE_TOL`` are set from; rerun this after a change to the model's
numerics.
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
        print("phase_p_gaps: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_kernels(echo=False)
    cs.P_GAP_CAP, cs.P_TIE_TOL = 1.0, 2.0
    cs.K1_SHAPES = (cs.K1_VERIFY,)
    cfg = get_config("smollm-360m", "stlt")
    dev = torch.device("cuda")
    rows = cs.k1_timings(k1, ops, dev, cfg.stlt_chunk)
    out = cs.spec_phase(T, k1, cfg, dev, rows)
    cs.log(f"[gaps] {time.time() - t0:.1f} s [{cs.smi_line()}]")
    print(json.dumps({k: out[k] for k in ("gap", "ties", "tie_gap", "same")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
