"""One rank of the port's multi-device CPU tests (tests/test_torch_distributed.py).

    python tests/torch_dist_worker.py DIR RANK WORLD [cuda-cp]

Joins a gloo job through the file store ``DIR/store``, reads the inputs the
test wrote to ``DIR/inputs.pt`` (made with numpy from a seed), runs every
scenario in turn and, on rank 0, writes what it gathered to
``DIR/results.pt``. Imports torch and the port only (no JAX): the test
holds the results to the JAX package. With ``cuda-cp`` every rank runs the
context-parallel STLT on the card (K1) and writes its error against the
serial K1 call to ``DIR/cp<RANK>.pt`` (tests/test_torch_cuda.py).
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
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                    tree)


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
        params, state, metrics = prog.fn(params, state, batch, step,
                                         draws=draws[step] if draws else None)
        out.append({"params": _np(sh.gather_full(params, pspecs, mesh)),
                    "metrics": {k: float(v) for k, v in metrics.items()}})
    return out


def cp_scenario(inp):
    mesh = comm.make_mesh((4,), ("data",), device="cpu")
    c = inp["cp"]
    n_loc = c["x"].shape[1] // 4
    x = c["x"][:, mesh.coord("data") * n_loc:(mesh.coord("data") + 1) * n_loc]
    z = stlt_context_parallel(x, c["lm"], c["th"], c["ur"], c["ui"], mesh, chunk=c["chunk"])
    return comm.all_gather(z, 1, mesh.group("data")).numpy()


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
    for name, (cfg_key, mesh_shape, n) in inp["train"].items():
        res[name] = train_scenario(inp, inp["cfgs"][cfg_key], mesh_shape, n)
    res["cp"] = cp_scenario(inp)
    res["pipe"] = pipe_scenario(inp)
    res["remesh"] = {rank: remesh_scenario(inp)}
    for name, (cfg_key, mesh_shape) in inp["refusals"].items():
        res[name] = refusal(inp, inp["cfgs"][cfg_key], mesh_shape)
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, res["remesh"])
    res["remesh"] = {k: v for part in gathered for k, v in part.items()}
    if rank == 0:
        torch.save(res, f"{root}/results.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        if sys.argv[4:] == ["cuda-cp"]:
            comm.init_process_group(f"file://{sys.argv[1]}/store", int(sys.argv[3]),
                                    int(sys.argv[2]), "gloo")
            torch.backends.cuda.matmul.allow_tf32 = False
            cuda_cp(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
            torch.distributed.destroy_process_group()
        else:
            main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
