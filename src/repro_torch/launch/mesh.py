"""Mesh definitions of the port. Only the serving mesh is ported: the
production and host meshes of the JAX package's ``launch/mesh.py`` belong to
the multi-device training layer, which is not ported yet."""
from __future__ import annotations


def make_serve_mesh(data: int, device=None):
    """Serving mesh: 1-D ``("data",)`` over ``data`` hosts, for the
    ShardedServeEngine. Delegates to the serving subsystem, so its checks
    live in one place."""
    from repro_torch.serving.multihost import make_serve_mesh as _make

    return _make(data, device)
