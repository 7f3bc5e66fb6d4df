"""One rank of the port's multi-device CPU tests (tests/test_torch_distributed.py,
tests/test_torch_sharded_serve.py, tests/test_torch_tp_blocks.py).

    python tests/torch_dist_worker.py DIR RANK WORLD [cuda-cp | cuda-serve | serve | tp | ep]

Joins a gloo job through the file store ``DIR/store``, reads the inputs the
test wrote to ``DIR/inputs.pt`` (made with numpy from a seed), runs every
scenario in turn and, on rank 0, writes what it gathered to
``DIR/results.pt``. Imports torch and the port only (no JAX): the test
holds the results to the JAX package. With ``serve`` the scenarios are the
sharded serving cells and the process form of the sharded engine; with
``tp`` the train, prefill and decode cells of the attention and hybrid
archs and the partial-grad sum of whole KV projections; with ``ep`` the
MoE archs' cells in both dispatches, ``tensor_parallel.apply_moe_ep``'s
forward and grads, and the router's grad summed over ``model``. With
``cuda-cp`` every rank runs the context-parallel STLT on the card (K1) and
writes its error against the serial K1 call to ``DIR/cp<RANK>.pt``
(tests/test_torch_cuda.py). Where the inputs ask (``dry``), a train step's
first call and a cell's prefill and first decode step also record what the
rank handed to each kind of collective, its calls of each kind and its
scan passes, beside the dry-run of the same cell on this rank
(``launch.steps.lower_cell`` on a ``comm.RankMesh``): ``counts(...)``.
"""
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.context_parallel import stlt_context_parallel  # noqa: E402
from repro_torch.distributed.fault_tolerance import remesh  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                    tree)


def _measured(fn):
    """(fn(), what it handed to each kind of collective, its calls of each
    kind and its scan passes: ``ops._runner``'s calls, K1's launches on the
    card)."""
    from repro_torch.kernels import ops

    runner, passes = ops._runner, []
    ops._runner = lambda t: passes.append(1) or runner(t)  # noqa: E731
    comm.reset_stats()
    try:
        out = fn()
    finally:
        ops._runner = runner
    return out, {"bytes": dict(comm.STATS), "calls": dict(comm.CALLS), "k1": len(passes)}


def _dry(prog, mesh):
    """The dry-run of ``prog``'s cell on this rank of ``mesh``: its counts as
    ``_measured`` gives them."""
    c = steps.lower_cell(prog, comm.RankMesh(tuple(mesh.shape.values()), mesh.axis_names,
                                             torch.distributed.get_rank())).compile()
    return {"bytes": c.handed_in, "calls": c.calls, "k1": c.launches["stlt_scan"]}


def train_scenario(inp, cfg, mesh_shape, n_steps):
    """``n_steps`` sharded steps from the inputs' params, with the inputs'
    global draws where it has them: (the gathered params and the metrics
    after each step)."""
    mesh = comm.make_mesh(mesh_shape, ("data", "model"), device="cpu")
    shape = ShapeConfig("t", inp["seq"], inp["batch"], "train")
    prog = steps.build_train_step(cfg, shape, mesh, TrainConfig(**inp["tcfg"]))
    pspecs, _, bspec, _ = prog.in_shardings
    params = sh.local_slices(inp["params"][cfg.name], pspecs, mesh)
    state = prog.opt_init(params)
    draws = inp["draws"].get(cfg.name)
    out = []
    for step in range(n_steps):
        batch = sh.local_slices(inp["batches"][step], bspec, mesh)
        (params, state, metrics), counts = _measured(lambda: prog.fn(
            params, state, batch, step, draws=draws[step] if draws else None))
        out.append({"params": _np(sh.gather_full(params, pspecs, mesh)),
                    "metrics": {k: float(v) for k, v in metrics.items()}})
        if step == 0 and inp.get("dry"):
            out[0]["counts"] = {"real": counts, "dry": _dry(prog, mesh)}
    return out


def cp_scenario(inp):
    mesh = comm.make_mesh((4,), ("data",), device="cpu")
    c = inp["cp"]
    n_loc = c["x"].shape[1] // 4
    x = c["x"][:, mesh.coord("data") * n_loc:(mesh.coord("data") + 1) * n_loc]
    z = stlt_context_parallel(x, c["lm"], c["th"], c["ur"], c["ui"], mesh, chunk=c["chunk"])
    return comm.all_gather(z, 1, mesh.group("data")).numpy()


def cp_grad_scenario(inp, case):
    """jax.grad's counterpart: the loss sum(w z) through the context-parallel
    STLT on the case's x [B, 4 N_loc, d], backward from every rank. Returns
    dx gathered over the ranks, each rank's grads of the poles and mixers
    (each the whole gradient), and the passes the scan ran per rank
    (``ops._runner``'s calls: the stateful forward, the anti-causal dx)."""
    from repro_torch.kernels import ops

    mesh = comm.make_mesh((4,), ("data",), device="cpu")
    group, r = mesh.group("data"), mesh.coord("data")
    c = inp["cp"]
    x_all, w_all = c["grad"][case]
    n_loc = x_all.shape[1] // 4
    x = x_all[:, r * n_loc:(r + 1) * n_loc].clone().requires_grad_(True)
    poles = [c[k].clone().requires_grad_(True) for k in ("lm", "th", "ur", "ui")]
    runner, passes = ops._runner, []
    ops._runner = lambda t: passes.append(1) or runner(t)  # noqa: E731
    try:
        z = stlt_context_parallel(x, *poles, mesh, chunk=c["chunk"])
        (z * w_all[:, r * n_loc:(r + 1) * n_loc]).sum().backward()
    finally:
        ops._runner = runner
    return {"dx": comm.all_gather(x.grad, 1, group).numpy(),
            "poles": comm.all_gather(torch.stack([p.grad for p in poles])[None], 0,
                                     group).numpy(),
            "passes": comm.all_gather(torch.tensor([len(passes)]), 0, group).tolist()}


def pipe_scenario(inp):
    mesh = comm.make_mesh((4,), ("pipe",), device="cpu")
    c = inp["pipe"]
    w = c["W"][mesh.coord("pipe")].clone().requires_grad_(True)
    x = c["x"].clone().requires_grad_(True)
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["W"]), {"W": w}, x, mesh)
    (y * c["cot"]).sum().backward()
    return {"y": y.detach().numpy(),
            "dW": comm.all_gather(w.grad[None], 0, mesh.group("pipe")).numpy(),
            "dx": x.grad.numpy()}


def remesh_scenario(inp):
    cfg = inp["cfgs"]["stlt"]
    old = comm.make_mesh((2, 2), ("data", "model"), device="cpu")
    full = inp["params"][cfg.name]
    specs = sh.param_specs(full, cfg, old)
    new = comm.sub_mesh(np.array([[0, 1]]), ("data", "model"), device="cpu")
    new_specs = sh.param_specs(full, cfg, new)
    got = remesh(sh.local_slices(full, specs, old), specs, old, new_specs, new)
    if not new.member:
        return {"none": got is None}
    want = sh.local_slices(full, new_specs, new)
    same = all(bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(got), tree_leaves(want)))
    regathered = sh.gather_full(got, new_specs, new)
    whole = all(bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(regathered), tree_leaves(full)))
    return {"same": same, "whole": whole}


def refusal(inp, cfg, mesh_shape):
    mesh = comm.make_mesh(mesh_shape, ("data", "model"), device="cpu")
    shape = ShapeConfig("t", inp["seq"], inp["batch"], "train")
    try:
        prog = steps.build_train_step(cfg, shape, mesh, TrainConfig(**inp["tcfg"]))
        params = sh.local_slices(inp["params"].get(cfg.name) or {}, prog.in_shardings[0], mesh)
        prog.fn(params, prog.opt_init(params), {}, 0)
    except NotImplementedError as e:
        return str(e)
    return None


def cell_scenario(inp, case):
    """The prefill cell on the inputs' prompts and ``D`` greedy decode-cell
    steps from the single-device prefill's state at ``M`` positions: this
    rank's coordinates and its shards of every output."""
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W

    cfg = inp["cfgs"][case["cfg"]]
    mesh = comm.make_mesh(case["mesh"], ("data", "model"), device="cpu")
    B, N, M = inp["B"], inp["N"], inp["M"]
    pre = steps.build_prefill_step(cfg, ShapeConfig("p", N, B, "prefill"), mesh)
    dec = steps.build_decode_step(cfg, ShapeConfig("d", M, B, "decode"), mesh)
    full = steps.serving_params(inp["params"][cfg.name], cfg)
    params = sh.local_slices(full, pre.in_shardings[0], mesh)
    x = inp["prompts"][case["cfg"]]
    moe.DROPS.reset()
    prefill, counts = _measured(lambda: pre.fn(params, sh.local_slices(x, pre.in_shardings[1],
                                                                       mesh)))
    out = {"coords": {a: mesh.coord(a) for a in mesh.axis_names}, "prefill": _np(prefill),
           "prefill_drops": moe.DROPS.read()["dropped"]}
    if inp.get("dry"):
        out["counts"] = {"prefill": {"real": counts, "dry": _dry(pre, mesh)}}
    if cfg.family == "encdec":
        state = W.init_encdec_decode_state(full, cfg, x, B, M)
        tok = inp["tok0"]
    else:
        logits, state = T.prefill(full, cfg, x, max_len=M)
        tok = logits.argmax(-1).to(torch.int32)
    state = sh.local_slices(state, dec.in_shardings[2], mesh)
    tok = sh.local_slices(tok, dec.in_shardings[1], mesh)
    out["tok0"] = tok.numpy()
    out["decode"] = []
    for i in range(inp["D"]):
        (logits, state), counts = _measured(lambda: dec.fn(params, tok, state))
        if i == 0 and inp.get("dry"):
            out["counts"]["decode"] = {"real": counts, "dry": _dry(dec, mesh)}
        tok = logits.argmax(-1).to(torch.int32)
        out["decode"].append(_np((logits, state)))
    return out


def cell_refusal(inp, cfg_key, mesh_shape):
    mesh = comm.make_mesh(mesh_shape, ("data", "model"), device="cpu")
    try:
        steps.build_prefill_step(inp["cfgs"][cfg_key],
                                 ShapeConfig("p", inp["N"], inp["B"], "prefill"), mesh)
    except NotImplementedError as e:
        return str(e)
    return None


def engine_scenario(inp):
    """The process form of the sharded engine on ranks 0 and 1 (a
    ``("data",)`` sub-mesh of the job, one host each, 2 rows), each with
    its own prefix-cache shard warmed with the system prompt: every
    host's streams and stats, the rank's dispatches and exchanged bytes."""
    from repro_torch.serving import PrefixCache, ShardedServeEngine

    e = inp["engine"]
    mesh = comm.sub_mesh(np.arange(e["hosts"]), ("data",), device="cpu")
    if not mesh.member:
        return None
    eng = ShardedServeEngine(inp["params"][inp["cfgs"][e["cfg"]].name], inp["cfgs"][e["cfg"]],
                             mesh=mesh, slots_per_host=e["slots"], max_len=e["max_len"],
                             prefill_chunk=e["chunk"], prefix_cache=PrefixCache(capacity=32),
                             device="cpu")
    warmed = eng.warm_prefix(e["sys_prompt"])
    comm.reset_stats()
    res, stats = eng.serve(e["requests"], arrivals=e["arrivals"], return_stats=True)
    return {"streams": res, "stats": stats, "warmed": warmed, "host": eng.host,
            "serve_stats": dict(eng.serve_stats), "bytes": dict(comm.STATS),
            "cache": eng.prefix_cache.stats()}


def cuda_serve(root: str, rank: int):
    """Phase DS of ``tools/phase_dt.py`` at reduced width (2 layers, 64
    nodes) on the card: DS1's
    2 x 2 cells (200-token prefill, 8 decode steps) and DS2's process-form
    engine on phase SH's requests; writes what each rank measured to
    ``DIR/serve<RANK>.pt``."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import phase_dt
    from repro_torch.configs.stlt_base import CONFIG
    from repro_torch.models import transformer as T

    phase_dt.DS1_N, phase_dt.DS1_NEW = 200, 8
    dev = torch.device("cuda")
    # stlt-base's 64 nodes: phase SH's requests cap two of them at 16
    cfg = CONFIG.reduced(num_layers=2, stlt_nodes=CONFIG.stlt_nodes)
    full = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    out = {"layers": cfg.num_layers}
    phase_dt.ds1(T, cfg, full, dev, rank, out)
    phase_dt.ds2(T, cfg, full, dev, rank, out)
    torch.save(out, f"{root}/serve{rank}.pt")


def serve_main(root: str, rank: int, world: int):
    torch.set_num_threads(1)
    comm.init_process_group(f"file://{root}/store", world, rank, "gloo")
    inp = torch.load(f"{root}/inputs.pt", weights_only=False)
    if "whisper_frames" in inp:
        steps.WHISPER_ENC_FRAMES = inp["whisper_frames"]
    res = {name: cell_scenario(inp, case) for name, case in inp["cells"].items()}
    res.update({name: cell_refusal(inp, *args) for name, args in inp["refusals"].items()})
    res["engine"] = engine_scenario(inp)
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, res)
    if rank == 0:
        torch.save(gathered, f"{root}/results.pt")
    torch.distributed.destroy_process_group()


def partial_scenario(inp, c, names):
    """One loss and grad of the case's config on its mesh, with
    ``comm.partial_replicated`` and with it made the identity: the rank's
    grad shards of the leaves ``names`` (whole on every rank of a model
    group: granite's one KV head's ``wk`` and ``wv``, a MoE's router) under
    both, the single-device grad's matching slice, and the spec."""
    from repro_torch.distributed import tensor_parallel as tp_lib
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_flatten_with_paths, tree_unflatten

    cfg = inp["cfgs"][c["cfg"]]
    mesh = comm.make_mesh(c["mesh"], ("data", "model"), device="cpu")
    B, N = inp["B"], inp["N"]
    prog = steps.build_train_step(cfg, ShapeConfig("t", N, B, "train"), mesh,
                                  TrainConfig(**inp["tcfg"]))
    pspecs, _, bspec, _ = prog.in_shardings
    full = inp["params"][cfg.name]
    batch = inp["batches"][c["cfg"]][0]
    bax = steps._batch_axes(cfg, mesh, B)
    ctx = tp_lib.ShardCtx(cfg, mesh, pspecs, bax, B)

    def grads(params):
        paths, leaves = zip(*((k, v.detach().requires_grad_(True))
                              for k, v in tree_flatten_with_paths(params)))
        share, _ = tp_lib.tp_lm_loss(ctx.gather_fsdp(tree_unflatten(params, leaves)), ctx,
                                     sh.local_slices(batch, bspec, mesh))
        g = dict(zip(paths, torch.autograd.grad(share, leaves, allow_unused=True,
                                                materialize_grads=True)))
        # the batch shards' sum, as the step's reduce_grads takes it (FSDP's
        # gather has summed over ``data`` already)
        return {k: comm.all_reduce(g[k], mesh.group("data")) if "data" not in
                tuple(dict(tree_flatten_with_paths(pspecs))[k]) else g[k] for k in names}

    local = sh.local_slices(full, pspecs, mesh)
    got = grads(local)
    real = comm.partial_replicated
    comm.partial_replicated = lambda x, group: x
    try:
        own = grads(local)
    finally:
        comm.partial_replicated = real
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tree_flatten_with_paths(full)}
    loss, _ = T.lm_loss(tree_unflatten(full, list(leaves.values())), cfg, batch,
                        deterministic=False)
    ref = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                               allow_unused=True, materialize_grads=True)))
    specs = dict(tree_flatten_with_paths(pspecs))
    out = {}
    for k in names:
        leaf = k.rsplit("/", 1)[1]
        want = sh.local_slice(ref[k], specs[k], mesh)
        out[f"{leaf}_spec"] = tuple(specs[k])
        out[f"{leaf}_grad"] = got[k].numpy()
        out[f"{leaf}_ref"] = want.numpy()
        out[f"{leaf}_own_gap"] = float((own[k] - want).abs().max())
    return out


def tp_main(root: str, rank: int, world: int):
    torch.set_num_threads(1)
    comm.init_process_group(f"file://{root}/store", world, rank, "gloo")
    inp = torch.load(f"{root}/inputs.pt", weights_only=False)
    res = {}
    for name, case in inp["cells"].items():
        cfg = inp["cfgs"][case["cfg"]]
        view = {**inp, "batches": inp["batches"][case["cfg"]], "seq": inp["N"],
                "batch": inp["B"], "draws": {}}
        res[name] = cell_scenario(inp, case)
        train = train_scenario(view, cfg, case["mesh"], inp["steps"])
        res[name]["train"] = train if rank == 0 else None
    res["partial"] = partial_scenario(inp, inp["partial"],
                                      [f"layers/0/attn/{k}" for k in ("wk", "wv")])
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, res)
    if rank == 0:
        torch.save(gathered, f"{root}/results.pt")
    torch.distributed.destroy_process_group()


def ep_apply_scenario(inp, case):
    """``tensor_parallel.apply_moe_ep`` alone on layer 0's MoE of the case's
    config (its dispatch) on the case's mesh, on the rank's rows of
    ``moe_x``: the rank's y and aux, and the grads of 1e-3 sum(y^2) +
    aux_loss + router_z (each rank's share: its rows' sum, the aux over the
    batch shards) gathered whole."""
    from repro_torch.distributed import tensor_parallel as tp_lib
    from repro_torch.utils import tree_flatten_with_paths, tree_unflatten

    cfg = inp["cfgs"][case["cfg"]]
    mesh = comm.make_mesh(case["mesh"], ("data", "model"), device="cpu")
    full = inp["params"][cfg.name]
    B = inp["moe_x"].shape[0]
    pspecs = sh.param_specs(full, cfg, mesh)
    bax = steps._batch_axes(cfg, mesh, B)
    ctx = tp_lib.ShardCtx(cfg, mesh, pspecs, bax, B)
    paths, leaves = zip(*((k, v.detach().requires_grad_(True)) for k, v in
                          tree_flatten_with_paths(sh.local_slices(full, pspecs, mesh))))
    p = ctx.gather_fsdp(tree_unflatten(full, leaves))
    loc = tp_lib._local_moe(ctx, p["layers"][0]["moe"], "layers/0/moe")
    x = sh.local_slice(inp["moe_x"], sh.P(bax or None), mesh)
    y, aux = tp_lib.apply_moe_ep(loc, cfg.moe_config(), x, ctx.tp_group, ctx.batch_group,
                                 ctx.tp_rank)
    share = 1e-3 * (y ** 2).sum() + (aux["aux_loss"] + aux["router_z"]) / ctx.n_batch
    idx = [i for i, k in enumerate(paths) if k.startswith("layers/0/moe/")]
    g = torch.autograd.grad(share, [leaves[i] for i in idx])
    specs = dict(tree_flatten_with_paths(pspecs))
    grads = {}
    for i, gi in zip(idx, g):
        axes = tuple(a for a in bax if a not in specs[paths[i]].mesh_axes())
        gi = comm.all_reduce(gi, mesh.group(axes)) if axes else gi
        grads[paths[i][len("layers/0/moe/"):]] = _np(sh.gather_leaf(gi, specs[paths[i]], mesh))
    return {"coords": {a: mesh.coord(a) for a in mesh.axis_names}, "y": _np(y),
            "aux": {k: float(v.detach()) for k, v in aux.items()}, "grads": grads}


def ep_main(root: str, rank: int, world: int):
    torch.set_num_threads(1)
    comm.init_process_group(f"file://{root}/store", world, rank, "gloo")
    inp = torch.load(f"{root}/inputs.pt", weights_only=False)
    from repro_torch.models import transformer as T

    res = {"single_drops": {}}
    for key, cfg in inp["cfgs"].items():
        moe.DROPS.reset()
        T.prefill(inp["params"][cfg.name], cfg, inp["prompts"][key], max_len=inp["N"])
        res["single_drops"][key] = moe.DROPS.read()["dropped"]
    for name, case in inp["cells"].items():
        res[name] = cell_scenario(inp, case)
        if case.get("train"):
            cfg = inp["cfgs"][case["cfg"]]
            view = {**inp, "batches": inp["batches"][case["cfg"]], "seq": inp["N"],
                    "batch": inp["B"], "draws": {}}
            train = train_scenario(view, cfg, case["mesh"], inp["steps"])
            res[name]["counts"]["train"] = train[0].pop("counts")
            res[name]["train"] = train if rank == 0 else None
    for name, case in inp["apply"].items():
        res[name] = ep_apply_scenario(inp, case)
    res["router"] = partial_scenario(inp, inp["router"], ["layers/0/moe/router"])
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, res)
    if rank == 0:
        torch.save(gathered, f"{root}/results.pt")
    torch.distributed.destroy_process_group()


def cuda_cp(root: str, rank: int, world: int):
    """K1's stateful call on each rank's slice of 4 rows x 4096 tokens, one
    exchange, against K1 over the whole sequence on the same card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stlt_scan as k1

    dev = torch.device("cuda")
    mesh = comm.make_mesh((world,), ("data",), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    B, N, d, S = 4, 4096, 64, 64
    x = torch.randn(B, N, d, generator=g, device=dev)
    lm = -(0.002 + 0.05 * torch.rand(S, generator=g, device=dev))
    th = 0.5 * torch.rand(S, generator=g, device=dev) - 0.25
    ur, ui = (torch.randn(S, generator=g, device=dev) / S for _ in range(2))
    n_loc = N // world
    k1.stlt_scan_kernel.launches = 0
    z = stlt_context_parallel(x[:, rank * n_loc:(rank + 1) * n_loc].contiguous(), lm, th,
                              ur, ui, mesh)
    launches = k1.stlt_scan_kernel.launches
    want = ops.stlt_scan(x, *(t[None].expand(B, S).contiguous() for t in (lm, th, ur, ui)))
    want = want[:, rank * n_loc:(rank + 1) * n_loc]
    torch.save({"err": float((z - want).abs().max()), "scale": 1 + float(want.abs().max()),
                "launches": launches}, f"{root}/cp{rank}.pt")


def main(root: str, rank: int, world: int):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_process_group(f"file://{root}/store", world, rank, "gloo")
    inp = torch.load(f"{root}/inputs.pt", weights_only=False)
    res = {}
    counts = {}
    for name, (cfg_key, mesh_shape, n) in inp["train"].items():
        res[name] = train_scenario(inp, inp["cfgs"][cfg_key], mesh_shape, n)
        counts[name] = res[name][0].pop("counts", None)
    res["cp"] = cp_scenario(inp)
    res["cp_grad"] = {case: cp_grad_scenario(inp, case) for case in inp["cp"]["grad"]}
    res["pipe"] = pipe_scenario(inp)
    res["remesh"] = {rank: remesh_scenario(inp)}
    for name, (cfg_key, mesh_shape) in inp["refusals"].items():
        res[name] = refusal(inp, inp["cfgs"][cfg_key], mesh_shape)
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, res["remesh"])
    res["remesh"] = {k: v for part in gathered for k, v in part.items()}
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, counts)
    res["counts"] = gathered
    if rank == 0:
        torch.save(res, f"{root}/results.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        if sys.argv[4:] in (["cuda-cp"], ["cuda-serve"]):
            comm.init_process_group(f"file://{sys.argv[1]}/store", int(sys.argv[3]),
                                    int(sys.argv[2]), "gloo")
            torch.backends.cuda.matmul.allow_tf32 = False
            if sys.argv[4] == "cuda-cp":
                cuda_cp(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
            else:
                cuda_serve(sys.argv[1], int(sys.argv[2]))
            torch.distributed.destroy_process_group()
        elif sys.argv[4:] == ["serve"]:
            serve_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
        elif sys.argv[4:] == ["tp"]:
            tp_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
        elif sys.argv[4:] == ["ep"]:
            ep_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
        else:
            main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
