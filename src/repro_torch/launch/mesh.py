"""Mesh definitions of the port, the counterpart of the JAX package's
``launch/mesh.py``.

The production mesh is 16 x 16 (``data``, ``model``), and 2 x 16 x 16
(``pod``, ``data``, ``model``) across two pods, with ``pod`` outermost (data
parallelism composes over pod x data; ``model`` is the TP/EP axis).
``make_production_mesh`` builds the process mesh when the job's world size
equals the mesh's size, and otherwise gives the shape-only description
(``comm.MeshSpec``), which is all the specs and ``input_specs`` read.
Functions, not module constants: importing this module touches no process
group.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed import comm


def _mesh(shape, axes, device=None):
    if dist.is_initialized() and dist.get_world_size() == comm.MeshSpec(shape, axes).size:
        return comm.make_mesh(shape, axes, device)
    return comm.MeshSpec(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 2, device=None) -> comm.DistMesh:
    """The ``data`` x ``model`` process mesh of a job of ``data * model``
    ranks (tests, phase DT of ``chip_smoke.py``). Raises without a process
    group of that size."""
    if not dist.is_initialized() or dist.get_world_size() != data * model:
        raise RuntimeError(f"make_host_mesh({data}, {model}) needs a process group of "
                           f"{data * model} ranks (comm.init_process_group)")
    return comm.make_mesh((data, model), ("data", "model"), device)


def make_serve_mesh(data: int, device=None):
    """Serving mesh: 1-D ``("data",)`` over ``data`` hosts, for the
    ShardedServeEngine. Delegates to the serving subsystem, so its checks
    live in one place."""
    from repro_torch.serving.multihost import make_serve_mesh as _make

    return _make(data, device)
