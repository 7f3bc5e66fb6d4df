#!/usr/bin/env python3
"""Read phase H's bf16 logit gaps on one NVIDIA GPU, with its tolerance gates
opened.

    python3 tools/phase_h_gaps.py

Builds the kernels, holds K1 against its plain version at phase H's shapes
(``chip_smoke.K1_HYBRID``: head dims 256 and 128) and times it there, then
runs ``chip_smoke.hybrid_phase`` alone (recurrentgemma-9b in both forms at
full width, chatglm3-6b-stlt; random weights from seed 0) with the gap
caps ``H1_GAP_CAP``, ``H2_GAP_CAP``, ``H5_GAP_CAP`` and their tie
tolerances raised out of the way. Every other gate of the phase still
holds (the fp32 checks of H3, the train-step checks of H4, the K1 launch
counts). The last line is a JSON
object: per serve phase (H1 native, H2 STLT) the largest chunk-form vs
recurrent-form logit gap along the plain streams (``gap``), the near-tie
steps of each serve (``ties``), the largest served-vs-argmax gap among them
(``tie_gap``) and whether each serve's streams equal the plain ones
(``same``); H5's decode-vs-teacher gap and near ties; and each part's
seconds. These readings are what the H gap caps are set from; rerun this
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
        print("phase_h_gaps: no CUDA device", file=sys.stderr)
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
    C = get_config("recurrentgemma-9b", "stlt").stlt_chunk
    for BH, N, S, d in cs.K1_HYBRID:
        args, _, _ = cs.k1_case(k1, ops, dev, BH, N, C, S, d, seed=1)
        got = k1.stlt_scan_kernel(*args, chunk=C)
        want = k1.stlt_scan_reference(*args, chunk=C)
        for name, a, b in zip(("z", "h_re", "h_im"), got, want):
            err, scale = float((a - b).abs().max()), 1.0 + float(b.abs().max())
            cs.log(f"[gaps K1] BH={BH} N={N} S={S} d={d} {name}: max abs err {err:.3e} "
                   f"(scale {scale:.3e})")
            if not err <= cs.K1_TOL * scale:
                raise AssertionError(f"K1 {name} at {BH} x {N} d={d}: {err}")
    cs.K1_SHAPES = cs.K1_HYBRID
    rows = cs.k1_timings(k1, ops, dev, C)
    cs.H1_GAP_CAP = cs.H2_GAP_CAP = cs.H5_GAP_CAP = 1e9
    cs.H1_TIE_TOL = cs.H2_TIE_TOL = cs.H5_TIE_TOL = 1e9
    out = cs.hybrid_phase(T, train, k1, dev, get_config, rows)
    cs.log(f"[gaps] {time.time() - t0:.1f} s [{cs.smi_line()}]")
    print(json.dumps({
        **{tag: {k: out[tag][k] for k in ("gap", "ties", "tie_gap", "same")}
           for tag in ("H1", "H2")},
        "H5": {k: out["H5"][k] for k in ("gap", "ties")}, "times": out["times"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
