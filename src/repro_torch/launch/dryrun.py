"""Multi-pod dry-run of the port (the JAX package's ``launch/dryrun.py``).

For every (architecture x input-shape x mesh) cell: the cell's step for one
rank (``RANK``) of the production meshes -- 16 x 16 (one pod, 256 chips)
and 2 x 16 x 16 (two pods, 512 chips) -- run once on the ``meta`` device
under counters (``launch.steps.lower_cell(...).compile()``, see
``launch/lowering.py``), recording its memory, its cost (flops, bytes
accessed) and its collectives' bytes by kind. One JSON per cell lands in
results/dryrun/<mesh>/<cell>.json with the JAX dry-run's keys;
benchmarks/roofline.py reads them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--variant native|stlt] [--out results/dryrun]
      [--include-skipped]

Where it differs from the JAX dry-run:
* every number is one rank's (per device, as JAX's are), from the rank's
  own ops: no partitioned HLO is parsed, so ``parse_collective_bytes`` has
  no counterpart. ``collective_bytes`` follows JAX's convention (the bytes
  of each collective's result per device: an all-gather n times what the
  rank hands in, a reduce-scatter 1/n) and ``collective_handed_in_bytes``
  is what the rank hands in (``comm.STATS``, which the card's phases
  measure); a P2P exchange is JAX's ``collective-permute``;
* the run executes every layer, so ``cost_raw`` needs no scan correction.
  The depth probes still run (cheap on ``meta``) and give
  ``cost_corrected`` as JAX computes it, so the two check each other;
* K1's and K2's work is their shape-only upper bound (``work_bounds``);
* a cell the port refuses or fails is written ``ok: false`` with the
  message, as JAX writes a failed compile.
Imports nothing of JAX and sets no XLA flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs as configs_lib
from repro_torch.distributed import comm
from repro_torch.launch import lowering
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import tree_leaves

RANK = 0    # the rank whose step a cell runs (the ranks' shapes are alike)


def memory_stats(compiled) -> dict:
    try:
        ma = compiled.memory_analysis()
        keys = [k for k in dir(ma) if k.endswith("_size_in_bytes") or k in (
            "temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
            "generated_code_size_in_bytes", "alias_size_in_bytes", "peak_memory_in_bytes")]
        out = {}
        for k in set(keys):
            try:
                out[k] = int(getattr(ma, k))
            except Exception:
                pass
        out["repr"] = str(ma)
        return out
    except Exception as e:  # pragma: no cover
        return {"error": repr(e)}


def _pattern_period(cfg) -> int:
    """Repeating layer-pattern length (for the depth-probe correction)."""
    if cfg.family == "hybrid":
        return 3  # (rglru, rglru, local_attn)
    if cfg.family == "xlstm":
        return min(cfg.slstm_every, cfg.num_layers)
    return 1


def _depth_variant(cfg, depth_mult: int):
    """cfg with num_layers = period * depth_mult, unrolled, attention dense
    (``blockwise_threshold`` raised), as the JAX dry-run's probes are."""
    P = _pattern_period(cfg)
    nl = P * depth_mult
    kw = dict(num_layers=nl, scan_layers=False, blockwise_threshold=1 << 60)
    if cfg.layer_types:
        kw["layer_types"] = cfg.layer_types[:nl]
    if cfg.family == "encdec":
        kw["num_decoder_layers"] = min(cfg.num_decoder_layers, depth_mult)
        kw["num_layers"] = depth_mult
    return dataclasses.replace(cfg, **kw), P


def analytic_arg_bytes(prog, mesh) -> dict:
    """Per-device bytes of each argument, from shapes x partition specs (a
    leaf the port keeps on the host, as AdamW's step count, counts 0: the
    JAX package holds that count as an int32 on the device)."""

    def frac(spec):
        denom = 1
        dims = tuple(spec) if spec is not None else ()
        for ax in dims:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= mesh.shape[a]
        return denom

    names = ("params", "opt_state", "batch", "step") if prog.kind == "train" else (
        ("params", "inputs") if prog.kind == "prefill" else ("params", "token", "state"))
    out = {}
    for name, arg, spec_tree in zip(names, prog.args, prog.in_shardings):
        leaves = tree_leaves(arg)
        specs = tree_leaves(spec_tree)
        if len(specs) == 1 and len(leaves) > 1:
            specs = specs * len(leaves)
        total = 0
        for leaf, sp in zip(leaves, specs):
            if not isinstance(leaf, torch.Tensor):  # host state (AdamW's step count)
                continue
            n = leaf.numel() * leaf.element_size()
            total += n // max(1, frac(sp))
        out[name] = total
    out["total"] = sum(out.values())
    return out


def _cell_metrics(compiled) -> dict:
    out = {k: float(v) for k, v in compiled.cost_analysis().items()}
    coll = compiled.collectives()
    out["collective_bytes"] = float(coll["total_bytes"])
    out["collective_handed_in_bytes"] = float(coll["handed_in_bytes"])
    out["_collectives"] = coll
    out["kernel_launches"] = dict(compiled.launches)
    return out


def _compile_for(cfg, shape, mesh, kind):
    if kind == "train":
        prog = steps_lib.build_train_step(cfg, shape, mesh)
    elif kind == "prefill":
        prog = steps_lib.build_prefill_step(cfg, shape, mesh)
    else:
        prog = steps_lib.build_decode_step(cfg, shape, mesh)
    return steps_lib.lower_cell(prog, mesh).compile(), prog


def run_cell(arch: str, shape_name: str, variant: str, multi_pod: bool, out_dir: str,
             verbose: bool = True, depth_probe: bool = True,
             overrides: dict | None = None, tag: str = "") -> dict:
    """Run the full cell's rank step, then two shallow depth probes.

    JAX's cost_analysis counts a scan body once and corrects by probes at
    depth P and 2P (body = c(2P) - c(P), outside = c(P) - body, corrected =
    outside + (L/P) * body). The port's run counts every layer, so
    ``cost_raw`` is whole already; the same correction from the probes
    gives ``cost_corrected``, which equals it wherever the counts grow
    linearly with depth."""
    mesh_name = "multi" if multi_pod else "single"
    cell_key = f"{arch}__{shape_name}__{variant}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, mesh_name, cell_key + ".json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": mesh_name, "ok": False, "overrides": overrides or {}}
    t0 = time.time()
    try:
        spec = make_production_mesh(multi_pod=multi_pod)
        mesh = comm.RankMesh(tuple(spec.shape.values()), spec.axis_names, RANK)
        cfg = configs_lib.get_config(arch, variant)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        shape = configs_lib.SHAPES[shape_name]
        compiled, prog = _compile_for(cfg, shape, mesh, shape.kind)
        t_full = time.time() - t0
        rec.update(kind=prog.kind, memory=memory_stats(compiled),
                   analytic_arg_bytes_per_device=analytic_arg_bytes(prog, mesh),
                   cost_raw=_cell_metrics(compiled), devices=int(mesh.size), rank=RANK,
                   work_bounds=lowering.SHAPE_ONLY_BOUNDS, compile_s=round(t_full, 1))

        if depth_probe:
            cfg1, P = _depth_variant(cfg, 1)
            cfg2, _ = _depth_variant(cfg, 2)
            c1, _ = _compile_for(cfg1, shape, mesh, shape.kind)
            c2, _ = _compile_for(cfg2, shape, mesh, shape.kind)
            m1, m2 = _cell_metrics(c1), _cell_metrics(c2)
            mult = cfg.num_layers / P if cfg.family != "encdec" else cfg.num_layers
            corrected = {}
            for k in ("flops", "bytes accessed", "collective_bytes"):
                a, b = m1.get(k, 0.0), m2.get(k, 0.0)
                body = max(0.0, b - a)
                outside = max(0.0, a - body)
                corrected[k] = outside + mult * body
            rec["cost_corrected"] = corrected
            rec["depth_probe"] = {"P": P, "mult": mult,
                                  "d1": {k: m1.get(k) for k in corrected},
                                  "d2": {k: m2.get(k) for k in corrected}}
        rec["ok"] = True
        if verbose:
            print(compiled.memory_analysis())
            print({k: v for k, v in rec.get("cost_corrected", {}).items()})
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:120]})"
    print(f"[dryrun:{mesh_name}] {cell_key}: {status}  ({rec['wall_s']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default=None,
                    help="native|stlt; default: the cell policy from configs.cells_for")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--include-skipped", action="store_true")
    args = ap.parse_args(argv)

    cells = configs_lib.all_cells()
    if args.arch:
        cells = [c for c in cells if c.arch == args.arch]
    if args.shape:
        cells = [c for c in cells if c.shape.name == args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    for cell in cells:
        if cell.skip and not args.include_skipped:
            n_skip += 1
            mesh_names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
            for mn in mesh_names:
                path = os.path.join(args.out, mn, cell.key + ".json")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"arch": cell.arch, "shape": cell.shape.name,
                               "variant": cell.variant, "mesh": mn,
                               "ok": True, "skipped": cell.skip}, f, indent=1)
            print(f"[dryrun] {cell.key}: SKIP ({cell.skip[:80]})", flush=True)
            continue
        variant = args.variant or cell.variant
        for multi in meshes:
            rec = run_cell(cell.arch, cell.shape.name, variant, multi, args.out,
                           verbose=False)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped-by-design")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
