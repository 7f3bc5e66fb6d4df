"""Cell builder of the port, the counterpart of the JAX package's
``launch/steps.py``: where the model family, the shape kind (train /
prefill / decode) and the sharding rules meet.

``init_fn``, ``loss_fn`` and ``serving_params`` pick the family's init,
loss and inference dtypes; ``prefill_fn`` and ``decode_fn`` its serving
steps (an LM's ``prefill``/``decode_step``; an enc-dec model's prefill is
the encode plus its decode state, ``init_encdec_decode_state``, and its
decode ``encdec_decode_step``). ``input_specs`` gives allocation-free
stand-ins (tensors on the ``meta`` device) for every model input of an
assigned (arch, shape) cell, with the JAX package's shapes and dtypes;
``abstract_params`` the same for the params.

The sharding half: ``train_batch_specs``, ``decode_state_specs`` (specs
only) and ``build_train_step(cfg, shape, mesh, tcfg)``, whose
``CellProgram.fn`` is the step every rank of a process mesh calls with its
shards (``distributed/tensor_parallel.py`` holds the sharded loss). It
shares ``launch/train.make_step``'s optimizer (``train_optimizer``), mask
temperature and learning rate (``train_schedules``), clip
(``optim.clip_by_norm``) and cast rule (``utils.casts_for_compute``); its
loss, its reductions of grads and metrics over the mesh and its global norm
are its own, a separate path that the tests hold to ``make_step`` and to
the JAX package's step. ``build_prefill_step`` and ``build_decode_step``
give the serving cells the same way: their specs (``args``,
``in_shardings``, ``out_shardings`` and ``donate_argnums`` equal the JAX
package's at ``scan_layers=False``), and on a process mesh the step each
rank calls with its shards (the heads and channels of the LM and hybrid
families' ``stlt``, ``attn``, ``local_attn`` and ``rglru`` blocks and the
experts of their MoEs on ``model`` through
``tensor_parallel.tp_prefill``/``tp_decode_step``; every arch's rows on its
data axes). ``lower_cell`` lowers a cell for one rank of a shape-only
mesh: it runs that rank's step once on the ``meta`` device over a
``comm.RankMesh`` under counters (``launch/lowering.py``); the dry-run
(``launch/dryrun.py``) reads it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional
from unittest import mock

import torch

from repro_torch import configs as configs_lib
from repro_torch.configs.base import DTYPES, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.adaptive import anneal_tau
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.optim import (apply_updates, clip_by_norm, default_wd_mask, make_optimizer,
                               make_schedule)
from repro_torch.utils import (cast_params_for_compute, casts_for_compute,
                               tree_flatten_with_paths, tree_leaves, tree_map, tree_unflatten)

P = sh.PartitionSpec

WHISPER_ENC_FRAMES = 1500  # fixed encoder context for whisper decode shapes


def init_fn(cfg: ModelConfig) -> Callable:
    """fn(generator=None, device=None) -> the family's random params."""
    if cfg.family == "encdec":
        return lambda generator=None, device=None: W.init_encdec(cfg, generator, device)
    return lambda generator=None, device=None: T.init_lm(cfg, generator, device)


def loss_fn(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        return W.encdec_loss
    return T.lm_loss


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """Params in inference dtype: the matrices of more than 65,536 elements
    in ``cfg.act_dtype``, the rest as they are."""
    return cast_params_for_compute(params, cfg.act_dtype)


def prefill_fn(cfg: ModelConfig, max_len: int) -> Callable:
    """fn(params, inputs) -> an enc-dec model's decode state (encode once;
    inputs [B, M, d] frames or [B, M] tokens), or an LM's (last logits,
    decode state)."""
    if cfg.family == "encdec":
        return lambda params, inputs: W.init_encdec_decode_state(
            params, cfg, inputs, inputs.shape[0], max_len)
    return lambda params, inputs: T.prefill(params, cfg, inputs, max_len=max_len)


def decode_fn(cfg: ModelConfig) -> Callable:
    """fn(params, token_t [B], state) -> (logits [B, V], new state)."""
    if cfg.family == "encdec":
        return lambda params, token_t, state: W.encdec_decode_step(params, cfg, token_t,
                                                                   state)
    return lambda params, token_t, state: T.decode_step(params, cfg, token_t, state)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_batch(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A train step's batch: frame or patch stubs [B, N, d] in the
    activation dtype for the enc-dec and for embedding inputs, tokens
    otherwise."""
    B, N = shape.global_batch, shape.seq_len
    labels = _meta((B, N), torch.int32)
    if cfg.family == "encdec":
        return {"enc_inputs": _meta((B, N, cfg.d_model), cfg.act_dtype),
                "dec_inputs": _meta((B, N), torch.int32), "labels": labels}
    if cfg.input_mode in ("embeddings", "both"):
        return {"inputs": _meta((B, N, cfg.d_model), cfg.act_dtype), "labels": labels}
    return {"inputs": _meta((B, N), torch.int32), "labels": labels}


def _prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    B, N = shape.global_batch, shape.seq_len
    if cfg.family == "encdec" or cfg.input_mode in ("embeddings", "both"):
        return _meta((B, N, cfg.d_model), cfg.act_dtype)
    return _meta((B, N), torch.int32)


def input_specs(arch: str, shape_name: str, variant: str = "native") -> dict:
    """Stand-ins for every model input of a cell: tensors on the ``meta``
    device (shape and dtype, no storage), as the JAX package's
    ``input_specs`` gives ``ShapeDtypeStruct``s."""
    cfg = configs_lib.get_config(arch, variant)
    shape = configs_lib.SHAPES[shape_name]
    if shape.kind == "train":
        return _train_batch(cfg, shape)
    if shape.kind == "prefill":
        return {"inputs": _prefill_inputs(cfg, shape)}
    return {"token_t": _meta((shape.global_batch,), torch.int32)}


def _abstract(fn):
    """``fn()``'s tensors as meta tensors of their shapes and dtypes: ``fn``
    runs on fake tensors (no storage; the truncated-normal initializer,
    whose resampling reads values, is skipped, as only shapes are kept)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), mock.patch("torch.nn.init.trunc_normal_", lambda t, *a, **k: t):
        out = fn()
    return tree_map(lambda t: _meta(t.shape, t.dtype) if isinstance(t, torch.Tensor) else t,
                    out)


def abstract_params(cfg: ModelConfig) -> dict:
    """The family's params as meta tensors (the JAX package's
    ``jax.eval_shape`` of its init)."""
    return _abstract(lambda: init_fn(cfg)(torch.Generator().manual_seed(0), "cpu"))


def train_optimizer(cfg: ModelConfig, tcfg: TrainConfig):
    """The optimizer as the JAX package's ``build_train_step`` builds it:
    AdamW with ``tcfg``'s betas and weight decay, its moments in
    ``cfg.opt_moment_dtype``; adafactor without weight decay."""
    if cfg.optimizer == "adamw":
        return make_optimizer("adamw", b1=tcfg.beta1, b2=tcfg.beta2,
                              weight_decay=tcfg.weight_decay,
                              moment_dtype=DTYPES[cfg.opt_moment_dtype])
    return make_optimizer(cfg.optimizer, weight_decay=0.0)


def train_schedules(tcfg: TrainConfig) -> Callable:
    """fn(step) -> (the adaptive masks' temperature, the learning rate), as
    the JAX package's train step sets them."""
    sched = make_schedule(tcfg.schedule, tcfg.learning_rate, tcfg.warmup_steps,
                          tcfg.total_steps)
    return lambda step: (anneal_tau(step, tcfg.total_steps, tcfg.adaptive_tau_start,
                                    tcfg.adaptive_tau_end), sched(step))


# ---------------------------------------------------------------------------
# specs of batches and decode states
# ---------------------------------------------------------------------------


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(the batch's meta stand-ins, their specs): rows over the batch axes."""
    bax = sh.batch_axes(cfg, mesh, shape.global_batch) or None
    batch = _train_batch(cfg, shape)
    return batch, {k: P(bax, *([None] * (v.ndim - 1))) for k, v in batch.items()}


def _state_spec_for(path: str, leaf, cfg: ModelConfig, bax, mesh) -> P:
    """Spec for one decode-state leaf, aligned to the trailing dims."""
    def model_ok(n):
        return ("model" if ("model" in mesh.axis_names and not cfg.dp_only
                            and n % mesh.shape["model"] == 0) else None)

    name = path.split("/")[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def tail(base):
        assert nd >= len(base), (path, shape, base)
        return P(*([None] * (nd - len(base)) + list(base)))

    if name == "pos" or nd == 0:
        return P()
    if name in ("k", "v", "xk", "xv"):              # [B, size, kv, dh]
        kv_ax = model_ok(KV)
        if kv_ax is None:   # few KV heads: shard the time dim instead
            return tail([bax, model_ok(shape[-3]), None, None])
        return tail([bax, None, kv_ax, None])
    if name in ("h_re", "h_im", "buf"):             # [B, H, S|W, dh]
        return tail([bax, model_ok(H), None, None])
    if name in ("L_re", "L_im"):                    # cross ctx [B, H, M, S, dh]
        return tail([bax, model_ok(H), None, None, None])
    if name == "C":                                  # mlstm [B, H, dk, dv]
        return tail([bax, model_ok(H), None, None])
    if name == "n" and nd >= 3 and shape[-2] == H:   # mlstm [B, H, dh]
        return tail([bax, model_ok(H), None])
    if name == "m" and shape[-1] == H:               # mlstm [B, H]
        return tail([bax, model_ok(H)])
    if name == "conv_buf":                           # [B, W-1, di]
        return tail([bax, None, None])
    if name in ("h", "c", "n", "m"):                 # slstm/rglru [B, d]
        return tail([bax, None])
    return P(*([None] * nd))


def decode_state_specs(state_shapes, cfg: ModelConfig, mesh, batch: int):
    """Specs of a decode state (one dict per layer: the JAX package's at
    ``scan_layers=False``): rows over the batch axes, heads over ``model``
    where they divide."""
    bax = sh.batch_axes(cfg, mesh, batch) or None
    specs = [_state_spec_for(path, leaf, cfg, bax, mesh)
             for path, leaf in tree_flatten_with_paths(state_shapes)]
    return tree_unflatten(state_shapes, specs)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellProgram:
    """A cell's step: ``fn``, its arguments' meta stand-ins (``args``, the
    global shapes), their specs and the outputs'. ``opt_init`` makes a
    train step's optimizer state from the rank's params; ``mesh`` is the
    mesh it was built on and ``on(mesh)`` builds the same cell on another."""
    kind: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    opt_init: Optional[Callable] = None
    mesh: Any = None
    on: Optional[Callable] = None


def _batch_axes(cfg: ModelConfig, mesh, global_batch: int) -> tuple:
    """The batch axes a step splits its rows over (FSDP needs ``data``)."""
    bax = sh.batch_axes(cfg, mesh, global_batch)
    if cfg.fsdp and mesh.shape.get("data", 1) > 1 and "data" not in bax:
        raise NotImplementedError(f"FSDP needs 'data' among the batch axes; a global "
                                  f"batch of {global_batch} does not divide over it")
    return bax


def _process_mesh_only(*_, **__):
    raise RuntimeError("a shape-only mesh computes specs; the step runs on a "
                       "process mesh (comm.make_mesh, launch.mesh.make_host_mesh), or on "
                       "one rank's comm.RankMesh in the dry-run (lower_cell)")


def _sharded_step(cfg, tcfg, mesh, opt, pspecs, ospecs, pshapes, global_batch):
    """The step every rank of ``mesh`` calls with its shards:
    step_fn(params, opt_state, batch, step, draws=None) -> (params,
    opt_state, metrics), metrics replicated. ``draws`` are the global
    step's per-layer uniform draws [B, H, S] (``train.step_draws`` when
    None); each rank takes its rows and heads."""
    from repro_torch.launch import train as train_lib

    bax = _batch_axes(cfg, mesh, global_batch)
    ctx = tp_lib.ShardCtx(cfg, mesh, pspecs, bax, global_batch)
    use_tp = tp_lib.tp_refusal(cfg) is None
    schedules = train_schedules(tcfg)
    lfn = loss_fn(cfg)
    specs = dict(tree_flatten_with_paths(pspecs))
    shapes = {k: tuple(t.shape) for k, t in tree_flatten_with_paths(pshapes)}
    # by path (a caller's tree may order its keys otherwise): grads are
    # summed over the batch axes a leaf is not sharded on (an FSDP gather's
    # backward has summed over its own); a leaf enters the global norm on
    # the rank at coordinate 0 of every axis it is not sharded on; a leaf
    # computes in the activation dtype by its global shape
    reduce_axes = {k: tuple(a for a in bax if a not in sp.mesh_axes())
                   for k, sp in specs.items()}
    counted = {k: all(mesh.coord(a) == 0 for a in mesh.axis_names if a not in sp.mesh_axes())
               for k, sp in specs.items()}
    cast = {k: casts_for_compute(s) for k, s in shapes.items()}
    b_loc = global_batch // (mesh.axis_size(bax) if bax else 1)
    b_off = (mesh.coord(bax) if bax else 0) * b_loc
    h_loc = cfg.num_heads // ctx.tp_size
    stlt_layers = [bt == "stlt" for bt in cfg.block_types()]

    def local_draws(draws):
        """The rank's rows of each layer's draws, and on the TP path its
        heads of the STLT layers' (the other layers read none)."""
        if not use_tp:
            return [d.narrow(0, b_off, b_loc) for d in draws]
        return [d.narrow(0, b_off, b_loc).narrow(1, ctx.tp_rank * h_loc, h_loc) if is_stlt
                else None for d, is_stlt in zip(draws, stlt_layers)]

    def reduce_grads(grads, paths):
        buckets = {}
        for i, (g, path) in enumerate(zip(grads, paths)):
            axes = reduce_axes[path]
            if axes:
                buckets.setdefault((axes, g.dtype), []).append(i)
        grads = list(grads)
        for (axes, _), idx in buckets.items():
            flat = comm.all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                                   mesh.group(axes))
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i])
        return grads

    def global_norm(grads, paths):
        sq = torch.zeros((), device=mesh.device)
        for g, path in zip(grads, paths):
            if counted[path]:
                sq = sq + torch.sum(torch.square(g.float()))
        return torch.sqrt(comm.all_reduce(sq, mesh.group(mesh.axis_names)))

    # adafactor's factored moments and its update's RMS are means over whole
    # rows, columns and leaves: over a sharded dim, the shard's sum
    # all-reduced over the dim's axes (each rank updates its shards only).
    # The update reads a factored moment laid out as its leaf's dims are;
    # the rules lay some out otherwise (a square matrix's ``vc`` takes
    # ``vr``'s spec), and those are moved there and back
    means = {k: _sharded_mean(specs[k], shapes[k], mesh) for k in specs}
    moved = _moment_layouts(ospecs, specs, shapes)

    def relayout(state, back: bool):
        return tree_unflatten(state, [
            _relayout(x, *(moved[k][::-1] if back else moved[k]), mesh) if k in moved else x
            for k, x in tree_flatten_with_paths(state)])

    def optimizer_update(grads, opt_state, params, lr):
        if cfg.optimizer == "adamw":
            return opt.update(grads, opt_state, params, lr, default_wd_mask(params, cfg))
        updates, state = opt.update(grads, relayout(opt_state, False), params, lr, None,
                                    means=[means[k] for k, _ in tree_flatten_with_paths(params)])
        return updates, relayout(state, True)

    def step_fn(params, opt_state, batch, step: int, draws=None):
        tau, lr = schedules(step)
        if draws is None and cfg.family == "lm" and cfg.stlt_adaptive:
            draws = train_lib.step_draws(tcfg.seed, step, cfg, global_batch, mesh.device)
        if draws is not None:
            draws = local_draws(draws)
        paths, leaves = zip(*((k, v.detach().requires_grad_(True))
                              for k, v in tree_flatten_with_paths(params)))
        p = ctx.gather_fsdp(tree_unflatten(params, leaves))
        p = tree_unflatten(p, [x.to(cfg.act_dtype) if cast[k] and x.is_floating_point() else x
                               for k, x in zip(paths, tree_leaves(p))])
        if use_tp:
            share, m = tp_lib.tp_lm_loss(p, ctx, batch, draws, tau)
        else:
            share, m = tp_lib.dp_lm_loss(p, ctx, batch, lfn, draws, tau)
        grads = torch.autograd.grad(share, leaves, allow_unused=True, materialize_grads=True)
        del p, share    # the gathered leaves: free before the update's new trees
        with torch.no_grad():
            grads = reduce_grads(grads, paths)
            gnorm = global_norm(grads, paths)
            grads = clip_by_norm(tree_unflatten(params, list(grads)), gnorm, tcfg.grad_clip)
            updates, opt_state = optimizer_update(grads, opt_state, params, lr)
            params = apply_updates(params, updates)
            metrics = _step_metrics(cfg, ctx, use_tp, m, global_batch)
        return params, opt_state, {**metrics, "grad_norm": gnorm,
                                   "lr": torch.tensor(lr, device=mesh.device)}

    return step_fn


def _sharded_mean(spec, shape: tuple, mesh) -> Callable:
    """mean(x, dims) -> the mean over ``dims`` (dims kept) of the whole leaf
    of ``shape`` whose shard under ``spec`` x is (or a tensor of its rank
    reduced along other dims): over a dim the spec shards, the shard's sum
    all-reduced over that dim's axes."""
    axes_of = dict(sh._entries(spec, len(shape)))

    def mean(x, dims):
        dims = tuple(d % x.ndim for d in dims)
        axes = tuple(a for d in dims for a in axes_of.get(d, ()))
        if not axes:
            return x.mean(dims, keepdim=True)
        n = 1
        for d in dims:
            n *= shape[d]
        return comm.all_reduce(x.sum(dims, keepdim=True), mesh.group(axes)) / n

    return mean


def _moment_layouts(ospecs, specs: dict, shapes: dict) -> dict:
    """{state path: (its spec, the spec of its leaf's dims)} for each
    factored moment whose spec is not the one its leaf's dims give (``vr``
    drops the leaf's last dim, ``vc`` its second last)."""
    out = {}
    for path, spec in tree_flatten_with_paths(ospecs):
        m = re.match(r"^v/(.*)/(vr|vc)$", path)
        if not m or m.group(1) not in specs:
            continue
        nd = len(shapes[m.group(1)])
        sp = tuple(specs[m.group(1)]) + (None,) * (nd - len(specs[m.group(1)]))
        own = P(*(sp[:-1] if m.group(2) == "vr" else sp[:-2] + sp[-1:]))
        if tuple(own) != tuple(spec) + (None,) * (len(own) - len(spec)):
            out[path] = (spec, own)
    return out


def _relayout(x, src, dst, mesh):
    """x, this rank's shard under ``src``, as its shard under ``dst``."""
    have, want = dict(sh._entries(src, x.ndim)), dict(sh._entries(dst, x.ndim))
    for dim in range(x.ndim):
        a, b = have.get(dim, ()), want.get(dim, ())
        if a == b:
            continue
        if a:
            x = comm.all_gather(x, dim, mesh.group(a))
        if b:
            x = sh.local_slice(x, P(*([None] * dim), b), mesh).contiguous()
    return x


def _step_metrics(cfg, ctx, use_tp: bool, m: dict, global_batch: int) -> dict:
    """The global step's metrics on every rank."""
    def over_batch(v):
        return comm.all_reduce(v, ctx.batch_group) if ctx.batch_group is not None else v

    if not use_tp:
        return {k: over_batch(v) / ctx.n_batch for k, v in m.items()}
    ce = over_batch(m["ce_sum"]) / m["count"]
    n_stlt = sum(bt == "stlt" for bt in cfg.block_types())
    if n_stlt and cfg.stlt_adaptive:    # the masks' mean over the STLT layers
        s = m["s_sum"]
        if ctx.tp_group is not None:
            s = comm.all_reduce(s, ctx.tp_group)
        s_eff = over_batch(s) / (cfg.num_heads * global_batch * n_stlt)
    else:
        s_eff = torch.tensor(float(cfg.stlt_nodes if n_stlt else 0), device=ce.device)
    return {"loss": ce + m["reg"] + m["aux_loss"] + m["router_z"], "ce": ce, "reg": m["reg"],
            "aux_loss": m["aux_loss"], "router_z": m["router_z"], "s_eff": s_eff}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     tcfg: Optional[TrainConfig] = None) -> CellProgram:
    """The train cell: specs from ``mesh`` (a shape-only ``MeshSpec`` will
    do), and on a process mesh a step that every rank calls with its
    shards of params, optimizer state (``opt_init``) and batch (its rows:
    ``sharding.local_slices(batch, in_shardings[2], mesh)``). The
    optimizer, schedule, mask temperature, clip and metric keys are the JAX
    package's."""
    tcfg = tcfg or TrainConfig()
    opt = train_optimizer(cfg, tcfg)
    pshapes = abstract_params(cfg)
    oshapes = _abstract(lambda: opt.init(init_fn(cfg)(torch.Generator().manual_seed(0), "cpu")))
    pspecs = sh.param_specs(pshapes, cfg, mesh)
    ospecs = sh.opt_state_specs(oshapes, pshapes, pspecs, cfg, mesh)
    batch_shapes, batch_spec = train_batch_specs(cfg, shape, mesh)
    mkeys = ("loss", "ce", "grad_norm", "lr") if cfg.family == "encdec" else (
        "loss", "ce", "reg", "aux_loss", "router_z", "s_eff", "grad_norm", "lr")
    out_sh = (pspecs, ospecs, {k: P() for k in mkeys})

    fn = (_sharded_step(cfg, tcfg, mesh, opt, pspecs, ospecs, pshapes, shape.global_batch)
          if isinstance(mesh, comm.RANK_MESHES) else _process_mesh_only)

    def opt_init(params):
        if cfg.optimizer == "adamw" or not isinstance(mesh, comm.RANK_MESHES):
            return opt.init(params)
        # factored on the whole shapes: the rank's shards of zeros
        return tree_map(lambda t, sp: (torch.zeros(sh.local_slice(t, sp, mesh).shape,
                                                   dtype=t.dtype, device=mesh.device)
                                       if isinstance(t, torch.Tensor) else t), oshapes, ospecs)

    args = (pshapes, oshapes, batch_shapes, _meta((), torch.int32))
    return CellProgram("train", fn, args, (pspecs, ospecs, batch_spec, P()), out_sh,
                       donate_argnums=(0, 1), opt_init=opt_init, mesh=mesh,
                       on=lambda m: build_train_step(cfg, shape, m, tcfg))


def _sharded_serve(cfg: ModelConfig, mesh, pspecs, sspecs, global_batch: int,
                   max_len: int):
    """(prefill_fn(params, inputs), decode_fn(params, token_t, state)) that
    every rank of ``mesh`` calls with its shards: the params (cast by
    ``serving_params``), its rows of the inputs or tokens and its shard of
    the decode state under ``sspecs``. An arch that
    ``tensor_parallel.tp_refusal`` passes runs the TP steps
    (``tp_prefill``/``tp_decode_step``: its heads and channels on
    ``model``); every other arch its family's ``prefill_fn``/``decode_fn``
    on the rank's rows (a ``model`` axis > 1 raises there, naming its
    ROADMAP item). A state leaf replicated over the batch axes (``asum``,
    ``acnt``, ``pos``) is computed by rows and gathered back
    (``sharding.batch_gather``): one all-gather per dtype a step."""
    bax = _batch_axes(cfg, mesh, global_batch)
    ctx = tp_lib.ShardCtx(cfg, mesh, pspecs, bax, global_batch)
    use_tp = tp_lib.tp_refusal(cfg) is None
    family_prefill, family_decode = prefill_fn(cfg, max_len), decode_fn(cfg)

    @torch.no_grad()
    def prefill(params, inputs):
        p = ctx.gather_fsdp(params)
        out = (tp_lib.tp_prefill(p, ctx, inputs, max_len) if use_tp
               else family_prefill(p, inputs))
        if cfg.family == "encdec":
            return sh.batch_gather(out, sspecs, bax, mesh)
        return out[0], sh.batch_gather(out[1], sspecs, bax, mesh)

    @torch.no_grad()
    def decode(params, token_t, state):
        p = ctx.gather_fsdp(params)
        rows = sh.batch_rows(state, sspecs, bax, mesh)
        logits, new = (tp_lib.tp_decode_step(p, ctx, token_t, rows, max_len) if use_tp
                       else family_decode(p, token_t, rows))
        return logits, sh.batch_gather(new, sspecs, bax, mesh)

    return prefill, decode


def _serve_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(serving param stand-ins, their specs, the batch spec's axis entry)."""
    pshapes = serving_params(abstract_params(cfg), cfg)
    bax = sh.batch_axes(cfg, mesh, shape.global_batch)
    return pshapes, sh.param_specs(pshapes, cfg, mesh), (bax or None)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> CellProgram:
    """The prefill cell, the JAX package's: fn(params, inputs) -> an LM's
    (last logits [B, V], decode state), an enc-dec model's decode state
    (the encode plus ``init_encdec_decode_state``). Specs from ``mesh`` (a
    shape-only ``MeshSpec`` will do); on a process mesh ``fn`` is what every
    rank calls with its shards (``sharding.local_slices`` of the params and
    of the inputs under ``in_shardings``) and returns its shards under
    ``out_shardings``."""
    B, N = shape.global_batch, shape.seq_len
    pshapes, pspecs, bax = _serve_specs(cfg, shape, mesh)
    inputs = _prefill_inputs(cfg, shape)
    if cfg.family == "encdec":
        out_shapes = _abstract(lambda: prefill_fn(cfg, N)(
            init_fn(cfg)(torch.Generator().manual_seed(0), "cpu"),
            torch.zeros(inputs.shape, dtype=inputs.dtype)))
        out_sh = decode_state_specs(out_shapes, cfg, mesh, B)
        sspecs = out_sh
    else:
        out_shapes = _abstract(lambda: T.init_decode_state(cfg, B, N, device="cpu"))
        sspecs = decode_state_specs(out_shapes, cfg, mesh, B)
        out_sh = (P(bax, None), sspecs)
    in_spec = P(bax, None, None) if inputs.ndim == 3 else P(bax, None)
    fn = (_sharded_serve(cfg, mesh, pspecs, sspecs, B, N)[0]
          if isinstance(mesh, comm.RANK_MESHES) else _process_mesh_only)
    return CellProgram("prefill", fn, (pshapes, inputs), (pspecs, in_spec), out_sh, mesh=mesh,
                       on=lambda m: build_prefill_step(cfg, shape, m))


def _decode_state_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Stand-ins of a decode cell's state: an LM's ``init_decode_state``;
    an enc-dec model's after encoding ``WHISPER_ENC_FRAMES`` frames."""
    if cfg.family == "encdec":
        return _abstract(lambda: W.init_encdec_decode_state(
            init_fn(cfg)(torch.Generator().manual_seed(0), "cpu"), cfg,
            torch.zeros((batch, WHISPER_ENC_FRAMES, cfg.d_model), dtype=cfg.act_dtype),
            batch, max_len))
    return _abstract(lambda: T.init_decode_state(cfg, batch, max_len, device="cpu"))


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> CellProgram:
    """The decode cell, the JAX package's: fn(params, token_t [B], state) ->
    (logits [B, V], new state), the state donated. Specs from ``mesh``; on
    a process mesh every rank calls ``fn`` with its shards (the state's
    under ``in_shardings[2]``) and gets its shards back."""
    B, N = shape.global_batch, shape.seq_len
    pshapes, pspecs, bax = _serve_specs(cfg, shape, mesh)
    state_shapes = _decode_state_shapes(cfg, B, N)
    sspecs = decode_state_specs(state_shapes, cfg, mesh, B)
    fn = (_sharded_serve(cfg, mesh, pspecs, sspecs, B, N)[1]
          if isinstance(mesh, comm.RANK_MESHES) else _process_mesh_only)
    return CellProgram("decode", fn, (pshapes, _meta((B,), torch.int32), state_shapes),
                       (pspecs, P(bax), sspecs), (P(bax, None), sspecs), donate_argnums=(2,),
                       mesh=mesh, on=lambda m: build_decode_step(cfg, shape, m))


def build_cell_program(arch: str, shape_name: str, mesh, variant: str = "native",
                       tcfg: Optional[TrainConfig] = None) -> CellProgram:
    cfg = configs_lib.get_config(arch, variant)
    shape = configs_lib.SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, tcfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)


def lower_cell(prog: CellProgram, mesh):
    """The cell lowered for one rank (``lowering.Lowered``; its
    ``compile()`` runs the rank's step once on ``meta`` under counters).
    ``mesh`` is a ``comm.RankMesh``, or a shape-only mesh whose rank 0 is
    taken; a program built on another mesh is built again on the rank's
    (``prog.on``)."""
    from repro_torch.launch import lowering

    if not isinstance(mesh, comm.RankMesh):
        mesh = comm.RankMesh(tuple(mesh.shape.values()), mesh.axis_names)
    return lowering.Lowered(prog if prog.mesh is mesh else prog.on(mesh), mesh)
