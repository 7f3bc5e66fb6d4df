#!/usr/bin/env python3
"""Compare two trees of the PyTorch port on one NVIDIA GPU, in one process.

    python3 tools/ab_port.py PARENT CHANGE [--pairs 3]

PARENT and CHANGE are checkouts of this repository (for example a commit
unpacked with ``git archive`` into the gitignored ``build/``). Each tree's
``repro_torch`` is imported from ``TREE/src`` and builds its own kernels;
both stay loaded, and ``sys.modules`` holds a tree's modules while it runs,
so that imports made inside its functions find its own. The trees take
turns as P C C P P C ... (``--pairs`` pairs), and each turn measures, on
``stlt-base`` at full width with random weights from seed 0:

- K1 (``stlt_scan_kernel``) at ``chip_smoke.K1_SHAPES``: its device time
  per call (profiler: every kernel the call launches, gaps excluded), the
  wrapper's call and the whole ``ops.stlt_scan`` call by CUDA events;
- ``T.prefill`` of 4 x 1000 tokens and one decode step at batch 4, by
  events, and ``ServeEngine.generate`` of 4 x (1000 + 32) tokens, by the
  host's clock, twice;
- ``T.prefill`` of one 131,072-token prompt, by events.

It prints a line per measurement, then each quantity's median for either
tree and their ratio, then the card's name and power limit. Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

B, N, NEW = 4, 1000, 32


def _port_modules() -> dict:
    return {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}


def _drop_port_modules():
    for name in _port_modules():
        del sys.modules[name]


class Tree:
    """One tree's port, loaded and built, with the model and engine."""

    def __init__(self, label: str, path: Path, dev):
        self.label = label
        _drop_port_modules()
        src = str(path.resolve() / "src")
        sys.path.insert(0, src)
        try:
            self.cfg = importlib.import_module("repro_torch.configs.stlt_base").CONFIG
            build = importlib.import_module("repro_torch.kernels.build")
            self.ops = importlib.import_module("repro_torch.kernels.ops")
            self.k1 = importlib.import_module("repro_torch.kernels.stlt_scan")
            self.T = importlib.import_module("repro_torch.models.transformer")
            engine = importlib.import_module("repro_torch.serving").ServeEngine
        finally:
            sys.path.remove(src)
        self.modules = _port_modules()
        cs.log(f"[ab] {label}: repro_torch from {Path(self.k1.__file__).resolve()}")
        build.build_kernels()
        self.params = self.T.init_lm(self.cfg, torch.Generator(device=dev).manual_seed(0),
                                     device=dev)
        self.engine = engine(self.params, self.cfg, max_len=N + NEW, device=dev)

    def activate(self):
        _drop_port_modules()
        sys.modules.update(self.modules)


def measure(tree: Tree, dev, prompts, long_toks) -> dict:
    """One turn of ``tree``: {quantity: value}, in ms (generate in s)."""
    tree.activate()
    cfg, T, ops, k1 = tree.cfg, tree.T, tree.ops, tree.k1
    C, S, d = cfg.stlt_chunk, cfg.stlt_nodes, cfg.dh
    out = {}
    for BH, n in cs.K1_SHAPES:
        args, _, raw = cs.k1_case(k1, ops, dev, BH, n, C, S, d, seed=5)
        x, lm, th, ur, ui, h0r, h0i, valid = raw
        iters = 50 if n <= 1000 else 5

        def call():
            k1.stlt_scan_kernel(*args, chunk=C)

        kernels = cs.device_ms(call, 10)
        out[f"K1 {BH}x{n} device ms"] = sum(kernels.values()) if kernels else float("nan")
        out[f"K1 {BH}x{n} call ms"] = cs.time_cuda(call, iters)
        out[f"K1 {BH}x{n} ops.stlt_scan ms"] = cs.time_cuda(lambda: ops.stlt_scan(
            x, lm, th, ur, ui, chunk=C, h0_re=h0r, h0_im=h0i, valid=valid,
            return_state=True), iters)
        del args, raw
    with torch.no_grad():
        tok = torch.from_numpy(prompts).to(dev)
        out["prefill 4x1000 ms"] = cs.time_cuda(
            lambda: T.prefill(tree.params, cfg, tok, N), iters=5)
        _, st = T.prefill(tree.params, cfg, tok, N)
        caps = torch.full((B,), S, dtype=torch.int32, device=dev)
        out["decode step ms"] = cs.time_cuda(
            lambda: T.decode_step(tree.params, cfg, tok[:, -1], st, node_cap=caps),
            iters=20)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        tree.engine.generate(prompts, NEW)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    out["generate 4x(1000+32) s"] = statistics.median(walls)
    with torch.no_grad():
        out[f"prefill 1x{cs.LONG_N} ms"] = cs.time_cuda(
            lambda: T.prefill(tree.params, cfg, long_toks, cs.LONG_N), iters=2, warmup=1)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_port: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    trees = {"P": Tree("P", args.parent, dev), "C": Tree("C", args.change, dev)}
    vocab = trees["P"].cfg.vocab
    prompts = np.random.default_rng(0).integers(0, vocab, size=(B, N))
    long_toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, vocab, size=(1, cs.LONG_N))).to(dev)
    for tree in trees.values():   # first calls pay one-time costs
        tree.activate()
        tree.engine.generate(prompts, NEW)
    order = [("P", "C") if i % 2 == 0 else ("C", "P") for i in range(args.pairs)]
    results = {"P": [], "C": []}
    for turn, label in enumerate(label for pair in order for label in pair):
        row = measure(trees[label], dev, prompts, long_toks)
        results[label].append(row)
        cs.log(f"[ab] turn {turn} {label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()))
    for key in results["P"][0]:
        p = [r[key] for r in results["P"]]
        c = [r[key] for r in results["C"]]
        mp, mc = statistics.median(p), statistics.median(c)
        cs.log(f"[ab] {key}: P {' '.join(f'{v:.4f}' for v in p)} | C "
               f"{' '.join(f'{v:.4f}' for v in c)} | median C/P {mc / mp:.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
