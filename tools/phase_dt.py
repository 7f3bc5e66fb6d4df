#!/usr/bin/env python3
"""Phase DT: the port's multi-device training layer at stlt-base's full width.

    python3 tools/phase_dt.py                            # 4 ranks, NCCL, one card each
    python3 tools/phase_dt.py --backend gloo --cards 1   # 4 ranks sharing one card

``chip_smoke.py`` runs the second form (``launch``): it needs one card, and
NCCL refuses two ranks on one device, so its ranks share the card over a
gloo group (every product and every K1 launch runs on the
card; only the exchange goes through the host). The first form runs the same
code over NVLink on four cards. Each rank is a process of this script
(``--rank``); they meet through a file store under the gitignored ``build/``
and write their numbers there as JSON. Four checks:

* DT1, the sharded step: stlt-base (6 layers, d_model 512, 8 heads, S = 64,
  adaptive, fp32) on a 2 x 2 (``data``, ``model``) mesh at 4 x 1000 tokens,
  3 AdamW steps (``launch.steps.build_train_step``), against the
  single-device ``make_step`` on rank 0's card with the same draws: step 0's
  loss within 1e-4, the grad norm, ce, reg and s_eff of every step within
  1e-4 relative (the grads' scale, which AdamW's update does not show),
  every param within 1e-4 (1 + max |p|) after each step,
  18 K1 launches per rank per step (forward, remat recompute, dx; on 2 rows
  x 4 heads = 8 rows). Step ms by CUDA events per rank, the bytes each rank
  hands to each collective per step.
* DT2, the context-parallel STLT: 8 rows x 131,072 tokens over the 4 ranks
  (32,768 each; d = 64, S = 64), held to the serial K1 call over all 131,072
  tokens within K1's gate 2e-4 (1 + max |ref|); ms per rank and the bytes
  exchanged (2 x 8 x 64 x 64 x 4 = 262,144 per rank).
* DT3, the pipeline: stlt-base's 6 blocks as 2 stages of 3 on 2-rank
  ``pipe`` groups (the 4 ranks as 2 x 2 (``data``, ``pipe``)), 4 microbatches
  of 1 x 1000: outputs and every stage param's grad against the 6 blocks run
  in turn on the same card.
* DT4, the resilient loop: DT1's step under ``run_resilient_loop`` with a
  ``SimulatedHardwareFailure`` at step 2, restored from the step-1
  checkpoint; the final params bit for bit DT1's.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "dt"
WORLD = 4
DT1_B, DT1_N, DT1_STEPS = 4, 1000, 3
DT1_LOSS_TOL = 1e-4
DT1_PARAM_TOL = 1e-4          # x (1 + max |p|) per leaf
DT1_METRIC_RTOL = 1e-4
DT1_METRICS = ("grad_norm", "ce", "reg", "s_eff")
DT2_B, DT2_N, DT2_D, DT2_S = 8, 131072, 64, 64
K1_TOL = 2e-4                 # x (1 + max |ref|): K1's gate (chip_smoke.K1_TOL)
DT3_M, DT3_N = 4, 1000
DT3_OUT_TOL = 1e-4            # x (1 + max |ref|)
DT3_GRAD_TOL = 1e-3           # x max |ref grad| per leaf (chip_smoke.TRAIN_GRAD_TOL)
DT4_FAIL_AT = 2


def _timed(fn):
    """(fn(), its ms by CUDA events)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _batch(step, dev, vocab):
    import torch

    from repro_torch.data import lm_batch_stream

    return {k: torch.from_numpy(v).to(dev)
            for k, v in lm_batch_stream(0, step, DT1_B, DT1_N, vocab).items()}


def dt1(T, cfg, dev, rank, out):
    """The sharded step against the single-device one; returns what DT4
    needs (the program, the final params)."""
    import torch

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, train
    from repro_torch.utils import tree_flatten_with_paths

    tcfg = TrainConfig(total_steps=100, warmup_steps=2)
    mesh = mesh_lib.make_host_mesh(2, 2, device=dev)
    prog = steps.build_train_step(cfg, ShapeConfig("dt", DT1_N, DT1_B, "train"), mesh, tcfg)
    pspecs, _, bspec, _ = prog.in_shardings
    full = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = sh.local_slices(full, pspecs, mesh)
    state = prog.opt_init(params)
    ref = ref_state = ref_step = None
    if rank == 0:
        opt, ref_step = train.make_step(cfg, tcfg)
        ref, ref_state = full, opt.init(full)
    rows = []
    for step in range(DT1_STEPS):
        batch = _batch(step, dev, cfg.vocab)
        comm.reset_stats()
        k1.stlt_scan_kernel.launches = 0
        (params, state, m), ms = _timed(
            lambda: prog.fn(params, state, sh.local_slices(batch, bspec, mesh), step))
        row = {"step": step, "ms": ms, "k1": k1.stlt_scan_kernel.launches,
               "bytes": dict(comm.STATS), "loss": float(m["loss"]),
               "metrics": {k: float(m[k]) for k in DT1_METRICS}}
        gathered = sh.gather_full(params, pspecs, mesh)
        if rank == 0:
            k1.stlt_scan_kernel.launches = 0
            (ref, ref_state, mr), row["ref_ms"] = _timed(
                lambda: ref_step(ref, ref_state, batch, step))
            row["ref_k1"] = k1.stlt_scan_kernel.launches
            row["ref_loss"] = float(mr["loss"])
            row["ref_metrics"] = {k: float(mr[k]) for k in DT1_METRICS}
            worst, over = 0.0, []
            want = dict(tree_flatten_with_paths(ref))
            for path, got in tree_flatten_with_paths(gathered):
                gap = float((got - want[path]).abs().max())
                tol = DT1_PARAM_TOL * (1 + float(want[path].abs().max()))
                worst = max(worst, gap / tol)
                if gap > tol:
                    over.append((path, gap, tol))
            row["param_gap_over_tol"] = worst
            row["over"] = over[:8]
        rows.append(row)
        del gathered
    out["DT1"] = rows
    return prog, mesh, params, full


def dt2(dev, rank, out):
    import torch

    from repro_torch.distributed import comm
    from repro_torch.distributed.context_parallel import stlt_context_parallel
    from repro_torch.kernels import ops
    from repro_torch.kernels import stlt_scan as k1

    mesh = comm.make_mesh((WORLD,), ("data",), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    B, N, d, S = DT2_B, DT2_N, DT2_D, DT2_S
    x = torch.randn(B, N, d, generator=g, device=dev)
    lm = -(0.0005 + 0.05 * torch.rand(S, generator=g, device=dev))
    th = (torch.pi / 4) * (2 * torch.rand(S, generator=g, device=dev) - 1)
    ur, ui = (torch.randn(S, generator=g, device=dev) / S for _ in range(2))
    n_loc = N // WORLD
    x_loc = x[:, rank * n_loc:(rank + 1) * n_loc].contiguous()
    run = lambda: stlt_context_parallel(x_loc, lm, th, ur, ui, mesh)  # noqa: E731
    run()                                           # warm
    comm.reset_stats()
    k1.stlt_scan_kernel.launches = 0
    z, ms = _timed(run)
    row = {"ms": ms, "k1": k1.stlt_scan_kernel.launches, "bytes": dict(comm.STATS)}
    rows = [t[None].expand(B, S).contiguous() for t in (lm, th, ur, ui)]
    want, row["serial_ms"] = _timed(lambda: ops.stlt_scan(x, *rows))
    want = want[:, rank * n_loc:(rank + 1) * n_loc]
    row["err"] = float((z - want).abs().max())
    row["scale"] = 1.0 + float(want.abs().max())
    out["DT2"] = row


def dt3(T, cfg, dev, rank, full, out):
    import torch

    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels import stlt_scan as k1
    from repro_torch.utils import tree_flatten_with_paths, tree_map

    mesh = comm.make_mesh((2, 2), ("data", "pipe"), device=dev)
    stage, per = mesh.coord("pipe"), cfg.num_layers // 2
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(DT3_M, 1, DT3_N, cfg.d_model, generator=g, device=dev)
    cot = torch.randn(DT3_M, 1, DT3_N, cfg.d_model, generator=g, device=dev)

    def stage_fn(p, h):
        for blk in p["layers"]:
            h = T.apply_block(blk, cfg, "stlt", h, deterministic=True)[0]
        return h

    def fresh(layers):
        """A copy of ``layers`` whose leaves take grads."""
        return {"layers": tree_map(lambda t: t.detach().clone().requires_grad_(True), layers)}

    mine = fresh(full["layers"][stage * per:(stage + 1) * per])
    k1.stlt_scan_kernel.launches = 0

    def run():
        y = pipeline_apply(stage_fn, mine, x, mesh)
        (y * cot).sum().backward()
        return y

    y, ms = _timed(run)
    row = {"ms": ms, "k1": k1.stlt_scan_kernel.launches}
    # the 6 blocks in turn, microbatch by microbatch, on this card
    serial = fresh(full["layers"])

    def run_serial():
        ys = []
        for m in range(DT3_M):
            h = x[m]
            for blk in serial["layers"]:
                h = T.apply_block(blk, cfg, "stlt", h, deterministic=True)[0]
            ys.append(h)
        ys = torch.stack(ys)
        (ys * cot).sum().backward()
        return ys

    want, row["serial_ms"] = _timed(run_serial)
    row["out_err"] = float((y - want).detach().abs().max())
    row["out_scale"] = 1.0 + float(want.detach().abs().max())
    worst = 0.0
    ref = serial["layers"][stage * per:(stage + 1) * per]
    for (path, a), (_, b) in zip(tree_flatten_with_paths(mine["layers"]),
                                 tree_flatten_with_paths(ref)):
        gap = float((a.grad - b.grad).abs().max())
        worst = max(worst, gap / (DT3_GRAD_TOL * max(float(b.grad.abs().max()), 1e-30)))
    row["grad_gap_over_tol"] = worst
    out["DT3"] = row


def dt4(prog, mesh, dt1_params, full, dev, rank, out):
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.fault_tolerance import (SimulatedHardwareFailure,
                                                         run_resilient_loop)
    from repro_torch.utils import tree_flatten_with_paths, tree_leaves

    pspecs, _, bspec, _ = prog.in_shardings
    ckpt_dir = OUT / f"ckpt{rank}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    vocab = int(full["embed"]["embed"].shape[0])

    def init_fn():
        params = sh.local_slices(full, pspecs, mesh)
        return {"params": params, "opt": prog.opt_init(params)}

    def step_fn(state, step):
        batch = sh.local_slices(_batch(step, dev, vocab), bspec, mesh)
        params, opt_state, _ = prog.fn(state["params"], state["opt"], batch, step)
        return {"params": params, "opt": opt_state}

    failed = []

    def inject(step):
        if step == DT4_FAIL_AT and not failed:
            failed.append(step)
            raise SimulatedHardwareFailure(f"card lost at step {step}")

    mgr = CheckpointManager(str(ckpt_dir), async_saves=False)
    t0 = time.time()
    stats = run_resilient_loop(step_fn=step_fn, init_fn=init_fn, ckpt=mgr,
                               total_steps=DT1_STEPS, save_every=1, fail_injector=inject)
    final, _ = mgr.restore_or_init(init_fn)
    differ = [(path, float((a.to(b.device) - b).abs().max()))
              for (path, a), b in zip(tree_flatten_with_paths(final["params"]),
                                      tree_leaves(dt1_params))
              if not torch.equal(a.to(b.device), b)]
    out["DT4"] = {"stats": stats, "bitwise": not differ, "differ": differ[:8],
                  "wall_s": time.time() - t0}
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def rank_main(rank: int, backend: str, cards: int, store: str):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.stlt_base import CONFIG as cfg
    from repro_torch.distributed import comm
    from repro_torch.models import transformer as T

    dev = torch.device("cuda", rank % cards)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.init_process_group(f"file://{store}", WORLD, rank, backend)
    out = {"rank": rank, "backend": backend, "device": str(dev)}
    t0 = time.time()
    prog, mesh, params, full = dt1(T, cfg, dev, rank, out)
    out["t_DT1"] = time.time() - t0
    dt2(dev, rank, out)
    out["t_DT2"] = time.time() - t0
    dt3(T, cfg, dev, rank, full, out)
    out["t_DT3"] = time.time() - t0
    dt4(prog, mesh, params, full, dev, rank, out)
    out["t_DT4"] = time.time() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    (OUT / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def launch(backend: str = "nccl", cards: int = WORLD, timeout: float = 600.0) -> list:
    """Build the kernels, start the 4 ranks, wait for them (killing every
    one if any fails or the time runs out) and return their JSON results."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild

    kbuild.build_kernels()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    store = OUT / "store"
    procs = []
    for r in range(WORLD):
        log = open(OUT / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--backend",
             backend, "--cards", str(cards), "--store", str(store)],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)), log))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [p for p, _ in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                          + (OUT / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes) if c)
        raise RuntimeError(f"phase DT: ranks exited {codes}\n{tails}")
    return [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(WORLD)]


def check(res: list) -> dict:
    """Raise unless every DT check holds; returns the summary."""
    r0 = res[0]
    dt1 = r0["DT1"]
    if abs(dt1[0]["loss"] - dt1[0]["ref_loss"]) > DT1_LOSS_TOL:
        raise AssertionError(f"DT1 step-0 loss {dt1[0]['loss']} vs {dt1[0]['ref_loss']}")
    for row in dt1:
        for k in DT1_METRICS:
            got, want = row["metrics"][k], row["ref_metrics"][k]
            if not abs(got - want) <= DT1_METRIC_RTOL * abs(want):
                raise AssertionError(f"DT1 step {row['step']}: {k} {got} vs the "
                                     f"single-device step's {want}")
        if row["param_gap_over_tol"] > 1.0:
            raise AssertionError(f"DT1 step {row['step']}: params off the single-device "
                                 f"step: {row['over']}")
    for r in res:
        for row in r["DT1"]:
            if row["k1"] != 18:      # 6 layers x (forward, remat recompute, dx)
                raise AssertionError(f"DT1 rank {r['rank']} step {row['step']}: "
                                     f"{row['k1']} K1 launches, expected 18")
        d2 = r["DT2"]
        if not (d2["err"] <= K1_TOL * d2["scale"] and d2["k1"] == 1):
            raise AssertionError(f"DT2 rank {r['rank']}: {d2}")
        d3 = r["DT3"]
        if not (d3["out_err"] <= DT3_OUT_TOL * d3["out_scale"] and d3["grad_gap_over_tol"] <= 1.0):
            raise AssertionError(f"DT3 rank {r['rank']}: {d3}")
        d4 = r["DT4"]
        if not (d4["bitwise"] and d4["stats"]["restarts"] == 1 and d4["stats"]["completed"]):
            raise AssertionError(f"DT4 rank {r['rank']}: {d4}")
    return {
        "step_ms": [[row["ms"] for row in r["DT1"]] for r in res],
        "ref_step_ms": [row["ref_ms"] for row in dt1],
        "bytes_per_step": [r["DT1"][-1]["bytes"] for r in res],
        "k1_per_step": [r["DT1"][-1]["k1"] for r in res],
        "loss_gap": abs(dt1[0]["loss"] - dt1[0]["ref_loss"]),
        "param_gap_over_tol": max(row["param_gap_over_tol"] for row in dt1),
        "metric_rel_gap": {k: max(abs(row["metrics"][k] - row["ref_metrics"][k])
                                  / abs(row["ref_metrics"][k]) for row in dt1)
                           for k in DT1_METRICS},
        "cp_ms": [r["DT2"]["ms"] for r in res], "cp_serial_ms": [r["DT2"]["serial_ms"]
                                                                for r in res],
        "cp_bytes": [r["DT2"]["bytes"] for r in res],
        "cp_k1": [r["DT2"]["k1"] for r in res],
        "cp_err_over_scale": max(r["DT2"]["err"] / r["DT2"]["scale"] for r in res),
        "pipe_ms": [r["DT3"]["ms"] for r in res],
        "pipe_serial_ms": [r["DT3"]["serial_ms"] for r in res],
        "pipe_k1": [r["DT3"]["k1"] for r in res],
        "pipe_out_err_over_scale": max(r["DT3"]["out_err"] / r["DT3"]["out_scale"]
                                       for r in res),
        "pipe_grad_gap_over_tol": max(r["DT3"]["grad_gap_over_tol"] for r in res),
        "resilient": res[0]["DT4"]["stats"], "resilient_wall_s": res[0]["DT4"]["wall_s"],
        "phase_s": {k: res[0][k] for k in ("t_DT1", "t_DT2", "t_DT3", "t_DT4")},
        "peak_gib": [r["peak_gib"] for r in res],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--cards", type=int, default=WORLD, help="cards the 4 ranks share")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.backend, args.cards, args.store)
        return 0
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"phase_dt: needs {args.cards} CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.time()
    summary = check(launch(args.backend, args.cards))
    summary["wall_s"] = time.time() - t0
    print(smi.strip())
    print(json.dumps({"phase_dt": summary, "backend": args.backend, "cards": args.cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
