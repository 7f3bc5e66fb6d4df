"""Sharding rules: parameter-path patterns -> partition specs, the port of
the JAX package's ``distributed/sharding.py``.

Strategy (DESIGN.md §5), as there:
  * batch                -> ("pod", "data")   [+ "model" for dp_only archs]
  * TP (heads/mlp/vocab) -> "model"
  * EP (experts)         -> "model"
  * FSDP (ZeRO-3)        -> "data" on the non-TP param dim, for cfg.fsdp archs
  * KV heads / STLT heads shard on "model" only when divisible, else replicate

A spec is a ``PartitionSpec``: one entry per dim, an axis name, a tuple of
names or None (replicated). The functions read only a mesh's
``axis_names`` and ``shape``, so a shape-only ``comm.MeshSpec`` serves.

The port's params hold one dict per layer, so its paths
(``layers/<i>/stlt/w_v``) are the JAX package's at ``scan_layers=False``,
and its specs equal the JAX package's leaf for leaf for a config at
``scan_layers=False``. The JAX rules read a stacked run's leaves by their
trailing dims, which makes one quirk appear only at ``scan_layers=True``:
a stacked ``nodes/T_hat`` ``[count, H]`` is read as a 2-D ``[H, S]`` node
leaf and gets ``P("model", None)``, which shards the layer dim. The port
stacks nothing and does not reproduce it.

``local_slices`` turns a tree into this rank's shards (the port's
``to_named``: a ``NamedSharding`` placement becomes the slice the rank
holds); ``gather_full`` is its inverse, a collective over the mesh.
``batch_rows`` and ``batch_gather`` move a decode state between the rank's
shards and the rows a serving step computes on: a leaf replicated over the
batch axes (``asum``, ``acnt``, ``pos``) is held whole and computed by
rows.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.utils import tree_flatten_with_paths, tree_leaves, tree_map, tree_unflatten


class PartitionSpec:
    """One entry per dim: an axis name, a tuple of names, or None. A tuple
    of one name is that name and an empty tuple is None, as JAX's
    ``PartitionSpec`` reads them."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple((ax[0] if len(ax) == 1 else ax or None)
                          if isinstance(ax, tuple) else ax for ax in axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __repr__(self):
        return f"P{self.axes!r}"

    def mesh_axes(self) -> tuple:
        """Every mesh axis the spec shards on."""
        out = []
        for ax in self.axes:
            out += [] if ax is None else list(ax if isinstance(ax, tuple) else (ax,))
        return tuple(out)


P = PartitionSpec


def mesh_axes(mesh):
    return tuple(mesh.axis_names)


def batch_axes(cfg: ModelConfig, mesh, global_batch: int):
    """Largest prefix of DP axes that divides the global batch."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    if cfg.dp_only and "model" in mesh.axis_names:
        axes.append("model")
    while axes:
        if global_batch % math.prod(mesh.shape[a] for a in axes) == 0:
            return tuple(axes)
        axes.pop()
    return ()


def _div(n: int, mesh, axis: str = "model") -> Optional[str]:
    """axis name if n is divisible by its size (else None -> replicate)."""
    if axis not in mesh.axis_names:
        return None
    return axis if n % mesh.shape[axis] == 0 else None


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(params_shapes, cfg: ModelConfig, mesh):
    """Tree of PartitionSpec matching the params tree (by path rules)."""
    model = "model" if "model" in mesh.axis_names else None
    fsdp = "data" if (cfg.fsdp and "data" in mesh.axis_names) else None
    if cfg.dp_only:
        model = fsdp = None  # replicate everything

    def heads_ok():
        return model if (model and cfg.num_heads % mesh.shape["model"] == 0) else None

    def spec_for(path: str, shape) -> P:
        """Rules read logical dims from the trailing end of ``shape``."""
        nd = len(shape)
        if nd <= 1 or "norm" in path or path.endswith(("/b", "/bias", "/lam")):
            if nd == 1 and model and shape[0] % mesh.shape["model"] == 0 and shape[0] >= 4096:
                return P(model)
            return P(*([None] * nd))
        # embeddings / head
        if path.endswith("embed/embed"):
            return P(_div(shape[0], mesh), fsdp)
        if path.endswith("lm_head/kernel"):
            return P(fsdp, _div(shape[1], mesh))
        # MoE
        if "/moe/" in path or path.startswith("moe/"):
            if path.endswith("/router"):
                return P(fsdp, None)
            if re.search(r"/dense/w[123]$", path):
                return P(fsdp, model) if path.endswith(("w1", "w3")) else P(model, fsdp)
            if path.endswith(("/w1", "/w3")):  # logical [E, d, f]
                return P(_div(shape[-3], mesh), fsdp, None)
            if path.endswith("/w2"):  # logical [E, f, d]
                return P(_div(shape[-3], mesh), None, fsdp)
        # attention
        if path.endswith("/wq"):
            return P(fsdp, _div(shape[-1], mesh))
        if path.endswith(("/wk", "/wv")):
            ok = model if (model and cfg.num_kv_heads % mesh.shape["model"] == 0) else None
            return P(fsdp, ok)
        if path.endswith("/wo"):
            return P(_div(shape[-2], mesh), fsdp)
        if path.endswith("/bq"):
            return P(_div(shape[-1], mesh))
        if path.endswith(("/bk", "/bv")):
            return P(None)
        # STLT
        if "/nodes/" in path:  # sigma_hat/omega/u_re/u_im: logical [H, S]
            return P(heads_ok(), None)
        if path.endswith("/w_alpha"):  # [d, H, S]
            return P(fsdp, heads_ok(), None)
        if path.endswith("/b_alpha"):
            return P(heads_ok(), None)
        if path.endswith(("/w_v", "/w_g")):
            return P(fsdp, _div(shape[-1], mesh))
        if path.endswith("/w_o"):
            return P(_div(shape[-2], mesh), fsdp)
        # FFN
        if path.endswith(("/w1", "/w3")):
            return P(fsdp, _div(shape[-1], mesh))
        if path.endswith("/w2"):
            return P(_div(shape[-2], mesh), fsdp)
        # xLSTM / RG-LRU
        if path.endswith("/w_up"):
            return P(fsdp, _div(shape[-1], mesh))
        if path.endswith("/w_down"):
            return P(_div(shape[-2], mesh), fsdp)
        if path.endswith(("/w_gate", "/w_x", "/w_a", "/w_i_rg")):
            return P(fsdp, _div(shape[-1], mesh))
        if path.endswith("/w_out"):
            return P(_div(shape[-2], mesh), fsdp)
        if path.endswith("/conv"):
            return P(None, _div(shape[-1], mesh))
        # default: fsdp on the logical first dim when clean
        d0 = fsdp if (fsdp and shape[-2] % mesh.shape["data"] == 0) else None
        return P(d0, *([None] * (min(nd, 2) - 1)))

    specs = []
    for path, leaf in tree_flatten_with_paths(params_shapes):
        shape = _shape(leaf)
        sp = tuple(spec_for(path, shape))
        if len(shape) > len(sp):        # leading dims beyond the rule replicate
            sp = (None,) * (len(shape) - len(sp)) + sp
        fixed = []                      # never shard a dim that does not divide
        for dim, ax in zip(shape, sp + (None,) * (len(shape) - len(sp))):
            if ax is None:
                fixed.append(None)
            else:
                size = math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
                fixed.append(ax if dim % size == 0 else None)
        specs.append(P(*fixed))
    return tree_unflatten(params_shapes, specs)


def _shape_adapted_spec(pspec: P, pshape, leaf_shape) -> P:
    """Adapt a param spec to an optimizer-state leaf (Adafactor vr/vc etc.)."""
    pshape, leaf_shape = tuple(pshape), tuple(leaf_shape)
    if leaf_shape == pshape:
        return pspec
    sp = tuple(pspec) + (None,) * (len(pshape) - len(pspec))
    if leaf_shape == pshape[:-1]:                       # vr: drop last dim
        return P(*sp[:-1])
    if leaf_shape == pshape[:-2] + pshape[-1:]:         # vc: drop 2nd-last
        return P(*(sp[:-2] + sp[-1:]))
    return P(*([None] * len(leaf_shape)))               # scalars / counters


def opt_state_specs(opt_state_shapes, params_shapes, pspecs, cfg: ModelConfig, mesh):
    """Specs for optimizer state, by matching each leaf back to its param."""
    del cfg, mesh
    pflat = dict(tree_flatten_with_paths(params_shapes))
    pspec_flat = dict(zip(pflat, tree_leaves(pspecs)))
    specs = []
    for path, leaf in tree_flatten_with_paths(opt_state_shapes):
        m = re.match(r"^(mu|nu|v)/(.*)$", path)
        core = re.sub(r"/(vr|vc|v)$", "", m.group(2) if m else path)
        if core in pflat:
            specs.append(_shape_adapted_spec(pspec_flat[core], _shape(pflat[core]),
                                             _shape(leaf)))
        else:
            specs.append(P(*([None] * len(_shape(leaf)))))
    return tree_unflatten(opt_state_shapes, specs)


def decode_state_specs(state, axis: str = "data"):
    """Specs laying a decode-state pool's slot axis over ``axis`` (the
    multi-host serving layout): the port's states hold one dict per layer
    (``transformer.init_decode_state``), whose slot axis is dim 0, so this
    equals the JAX package's ``decode_state_specs(state, plan, axis)`` at
    ``scan_layers=False``. Everything but the slot axis is replicated."""
    layers = [tree_map(lambda leaf: P(axis, *([None] * (len(_shape(leaf)) - 1))), st)
              for st in state["layers"]]
    return {"layers": layers, "pos": P(axis)}


# ---------------------------------------------------------------------------
# placement: specs -> this rank's shards, and back
# ---------------------------------------------------------------------------


def _entries(spec: P, ndim: int):
    """(dim, axes tuple) of each sharded dim."""
    out = []
    for dim, ax in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if ax is not None:
            out.append((dim, ax if isinstance(ax, tuple) else (ax,)))
    return out


def local_slice(x, spec: P, mesh):
    """This rank's shard of a full tensor under ``spec`` (a view)."""
    for dim, axes in _entries(spec, x.ndim):
        n = mesh.axis_size(axes)
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.coord(axes) * size, size)
    return x


def local_slices(tree, specs, mesh, device=None):
    """Every leaf's shard on this rank, copied to ``device`` (the mesh's
    device unless named); non-tensor leaves pass through."""
    device = mesh.device if device is None else device

    def place(x, sp):
        if not hasattr(x, "ndim"):
            return x
        return local_slice(x, sp, mesh).to(device, copy=True).contiguous()

    return tree_map(place, tree, specs)


def gather_leaf(x, spec: P, mesh):
    """A full tensor from every rank's shard (all-gathers over the spec's
    axes, last sharded dim first)."""
    for dim, axes in reversed(_entries(spec, x.ndim)):
        x = comm.all_gather(x, dim, mesh.group(axes))
    return x


def gather_full(tree, specs, mesh):
    """The full tree from every rank's shards (a collective: every rank of
    the mesh calls it and gets the whole tree)."""
    return tree_map(lambda x, sp: gather_leaf(x, sp, mesh) if hasattr(x, "ndim") else x,
                    tree, specs)


def _rows_whole(x, spec: P) -> bool:
    """Whether a leaf with a batch dim keeps it whole under ``spec`` (dim 0
    replicated over the batch axes: an adaptive state's ``asum``/``acnt``,
    ``pos``)."""
    return getattr(x, "ndim", 0) > 0 and (len(spec) == 0 or tuple(spec)[0] is None)


def batch_rows(tree, specs, bax: tuple, mesh):
    """This rank's rows of a tree of its shards under ``specs`` (a decode
    state under ``launch.steps.decode_state_specs``): a leaf that keeps its
    batch dim whole is cut to the rank's rows over ``bax``, as a row-sharded
    leaf already is (a view); 0-d leaves pass through."""
    if not bax:
        return tree
    return tree_map(lambda x, sp: local_slice(x, P(bax), mesh) if _rows_whole(x, sp) else x,
                    tree, specs)


def batch_gather(tree, specs, bax: tuple, mesh):
    """The inverse of ``batch_rows``: every leaf the specs keep whole over
    the batch axes is gathered from the ranks' rows, in one all-gather over
    ``bax`` per dtype (the leaves flattened side by side); the others pass
    through."""
    if not bax:
        return tree
    paths, leaves = zip(*tree_flatten_with_paths(tree))
    spec = dict(tree_flatten_with_paths(specs))
    leaves, buckets = list(leaves), {}
    for i, (path, x) in enumerate(zip(paths, leaves)):
        if _rows_whole(x, spec[path]):
            buckets.setdefault(x.dtype, []).append(i)
    group = mesh.group(bax)
    for idx in buckets.values():
        flat = torch.cat([leaves[i].reshape(leaves[i].shape[0], -1) for i in idx], 1)
        whole = comm.all_gather(flat, 0, group)
        widths = [leaves[i][0].numel() for i in idx]
        for i, part in zip(idx, whole.split(widths, 1)):
            leaves[i] = part.reshape((whole.shape[0],) + tuple(leaves[i].shape[1:]))
    return tree_unflatten(tree, leaves)
