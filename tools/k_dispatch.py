#!/usr/bin/env python3
"""The host cost of calling K1 and K2 through their ops, on one NVIDIA GPU.

    python3 tools/k_dispatch.py [--calls 2000]

At each shape, two forms of one kernel call on the same inputs, alternated
call by call (the order flipped every other round):

- ``direct``: the op's CUDA kernel body as a plain function (input checks,
  allocations, the ctypes launch), which is what the wrappers ran before
  K1 and K2 became ops;
- ``op``: the wrapper (``stlt_scan_kernel`` / ``relevance_flash_kernel``:
  ``torch.no_grad`` and the dispatch of ``repro_torch::stlt_scan`` /
  ``repro_torch::relevance_flash`` to the same body).

A call's host time runs from a synchronized start to the call's return.
K1 runs at the main paths' shapes (stlt-base's 4 x 8 heads x 1000 tokens,
a DT1 rank's 8 x 1000, a DM1 rank's 64 and 32 x 1024 at S 32, a verify
dispatch's 60 x 5), K2 at the relevance path's 32 x 1000. Prints a line
per shape (medians and means in microseconds, and op minus direct), then
the card's name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

K1_SHAPES = ((32, 1000, 64, 64), (8, 1000, 64, 64), (64, 1024, 32, 64), (32, 1024, 32, 64),
             (60, 5, 32, 64))   # (BH, N, S, d)
K2_SHAPE = (32, 1000, 64, 64)   # (BH, N, dh, S)


def host_us(fns: dict, calls: int) -> dict:
    """{name: [host microseconds of each call]} over ``calls`` rounds, each
    round one call of every function, the order flipped every other round."""
    names = list(fns)
    for name in names:              # warm
        for _ in range(20):
            fns[name]()
    out = {name: [] for name in names}
    for i in range(calls):
        for name in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            out[name].append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return out


def report(label: str, times: dict):
    d, o = times["direct"], times["op"]
    diffs = [b - a for a, b in zip(d, o)]
    cs.log(f"[dispatch] {label}: direct median {statistics.median(d):.2f} us (mean "
           f"{statistics.fmean(d):.2f}), op median {statistics.median(o):.2f} us (mean "
           f"{statistics.fmean(o):.2f}); op - direct: median of the pairs "
           f"{statistics.median(diffs):.2f} us, means {statistics.fmean(o) - statistics.fmean(d):.2f} us "
           f"over {len(d)} calls each")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k_dispatch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import relevance_flash as k2
    from repro_torch.kernels import stlt_scan as k1

    build.build_kernels()
    dev, C = torch.device("cuda"), 128
    for BH, N, S, d in K1_SHAPES:
        a, _, _ = cs.k1_case(k1, ops, dev, BH, N, C, S, d, seed=5)
        report(f"K1 {BH}x{N} S={S} d={d}", host_us({
            "direct": lambda: k1._stlt_scan_cuda(*a, C),
            "op": lambda: k1.stlt_scan_kernel(*a, chunk=C)}, args.calls))
    BH, N, dh, S = K2_SHAPE
    a = cs.k2_inputs(dev, BH, N, dh, S, 3, adversarial=False)
    report(f"K2 causal {BH}x{N} dh={dh} S={S}", host_us({
        "direct": lambda: k2._relevance_flash_cuda(*a, True),
        "op": lambda: k2.relevance_flash_kernel(*a, causal=True)}, max(args.calls // 10, 50)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
