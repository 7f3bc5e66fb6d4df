"""The sharded loss of the train step: tensor parallelism on the ``model``
axis for the STLT-mixer LM, and the data-parallel loss of every arch.

Where the JAX package's GSPMD places collectives implicitly, the port places
them at these points (Megatron's convention on ``model``: every rank of the
group computes the same loss; ``comm`` documents the operators):

* ``_embed``: the vocab-sharded embedding (``embed/embed`` ->
  ``P("model", fsdp)``) looks up the rank's rows, masks the others and
  all-reduces (``reduce_from``).
* ``_stlt_block``: ``copy_to`` on the normed input, then the rank's heads:
  the column-sharded ``w_v`` (and ``w_g``), its rows of ``nodes/*``,
  ``adaptive/w_alpha`` and ``b_alpha``, and its slice of the replicated
  per-head ``T_hat``; K1 runs on the rank's B_loc x H_loc rows; the
  row-sharded ``w_o`` and an all-reduce. The adaptive masks' batch mean in
  the (Reg) loss is over the global batch (``all_reduce_sum`` over the batch
  axes) and the loss's per-head terms are summed over ``model``.
* The FFN: ``w1`` (and ``w3``) column-sharded, ``w2`` row-sharded; ``b1``,
  replicated by the rules below 4096 entries but used sliced, comes through
  ``slice_replicated``, whose backward gathers the slices' grads.
* ``_head`` and ``_nll``: vocab-parallel logits (tied through the embedding
  shard, or an ``lm_head`` shard), then cross entropy with the max and the
  sum of exp taken over ``model`` and the label's logit from the rank that
  owns it.

A leaf the rules shard on ``data`` (``cfg.fsdp``) is gathered before use
(``gather_shards``: its grad comes back reduce-scattered). Each rank's loss
is its share of a sum over the batch axes (its rows' token-sum of the cross
entropy over the global token count, plus the replicated aux terms over
the number of batch shards), so summing grads over the batch axes gives the
global step's.

The TP path takes an LM whose every block is the factorized STLT with the
exponential window and a dense FFN (stlt-base); ``tp_refusal`` names what
else a ``model`` axis > 1 refuses, and the ROADMAP item that ports it. Any
other arch runs the data axes only, through its own loss on the rank's rows
(``dp_lm_loss``); there, a loss that couples rows (MoE's balance losses and
capacity, the adaptive masks' batch mean) refuses more than one batch shard.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import stlt as stlt_lib
from repro_torch.distributed import comm
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils import tree_flatten_with_paths, tree_map

ROADMAP_TP = "ROADMAP Queue 1 item 7: TP for the other block types"
ROADMAP_EP = "ROADMAP Queue 1 item 7: MoE's shard_map EP dispatch"


def tp_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the TP path cannot run ``cfg`` (None when it can)."""
    if cfg.family != "lm":
        return f"the {cfg.family} family ({ROADMAP_TP})"
    if cfg.is_moe:
        return f"MoE blocks ({ROADMAP_EP})"
    other = sorted(set(cfg.block_types()) - {"stlt"})
    if other:
        return f"block types {other} ({ROADMAP_TP})"
    s = cfg.stlt_config()
    if (s.mode, s.window, s.bidirectional) != ("factorized", "exponential", False) \
            or s.engine not in stlt_lib.SCAN_ENGINES:
        return f"the STLT form {s.mode}/{s.window}/{s.engine} ({ROADMAP_TP})"
    return None


class ShardCtx:
    """The layout the sharded loss reads: the mesh, each leaf's spec by
    path, the TP group (None without a ``model`` axis > 1, or for a
    dp_only arch, whose ``model`` axis is a batch axis) and the batch
    group."""

    def __init__(self, cfg: ModelConfig, mesh, pspecs, batch_axes: tuple,
                 global_batch: int):
        self.cfg, self.mesh = cfg, mesh
        self.specs = dict(tree_flatten_with_paths(pspecs))
        tp = (not cfg.dp_only and "model" in mesh.axis_names and mesh.shape["model"] > 1)
        self.tp_group = mesh.group("model") if tp else None
        self.tp_size = mesh.shape["model"] if tp else 1
        self.tp_rank = mesh.coord("model") if tp else 0
        self.batch_axes = tuple(batch_axes)
        self.batch_group = mesh.group(batch_axes) if batch_axes else None
        self.n_batch = mesh.axis_size(batch_axes) if batch_axes else 1
        self.global_batch = global_batch
        if tp:
            why = tp_refusal(cfg)
            if why is not None:
                raise NotImplementedError(f"a 'model' axis > 1 does not run {why}")
            for what, n in (("num_heads", cfg.num_heads), ("vocab", cfg.vocab),
                            ("d_ff", cfg.d_ff)):
                if n % self.tp_size:
                    raise NotImplementedError(f"{what} = {n} does not divide over a "
                                              f"'model' axis of {self.tp_size}")

    def _model_dims(self, path: str) -> list:
        return [d for d, ax in enumerate(self.specs[path])
                if ax is not None and "model" in (ax if isinstance(ax, tuple) else (ax,))]

    def cols(self, leaf, path: str, dim: int):
        """The rank's slice of ``leaf`` along ``dim`` (heads, columns, vocab):
        the stored shard where the rules shard that dim on ``model``, else
        a slice of the replicated leaf."""
        if self.tp_group is None or dim in self._model_dims(path):
            return leaf
        return comm.slice_replicated(leaf, dim, self.tp_group)

    def whole(self, tree, prefix: str):
        """``tree``'s leaves whole (a leaf the rules shard on ``model``, as
        they do 1-D leaves of 4096 entries or more, is gathered)."""
        def full(path, leaf):
            for dim in self._model_dims(path) if self.tp_group is not None else ():
                leaf = comm.gather_replicated(leaf, dim, self.tp_group)
            return leaf

        return {k: full(f"{prefix}/{k}", v) for k, v in tree.items()}

    def gather_fsdp(self, params):
        """Each leaf gathered over the non-``model`` axes the rules shard it
        on (``cfg.fsdp``): the TP-local tree the forward reads."""
        def gather(path, leaf):
            for dim, ax in enumerate(self.specs[path]):
                axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
                axes = tuple(a for a in axes if a != "model")
                if axes:
                    leaf = comm.gather_shards(leaf, dim, self.mesh.group(axes))
            return leaf

        paths = [p for p, _ in tree_flatten_with_paths(params)]
        it = iter(paths)
        return tree_map(lambda leaf: gather(next(it), leaf), params)


# ---------------------------------------------------------------------------
# the TP forward of the STLT LM
# ---------------------------------------------------------------------------


def _embed(ctx: ShardCtx, params, inputs):
    cfg = ctx.cfg
    if inputs.dtype.is_floating_point:
        return inputs.to(cfg.act_dtype)
    table = params["embed"]["embed"]
    if ctx.tp_group is None:
        return L.embed({"embed": table}, inputs).to(cfg.act_dtype)
    v_loc = table.shape[0]
    ids = inputs.long() - ctx.tp_rank * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    rows = table[ids.clamp(0, v_loc - 1)] * inside[..., None].to(table.dtype)
    return comm.reduce_from(rows, ctx.tp_group).to(cfg.act_dtype)


def _stlt_block(ctx: ShardCtx, p: dict, li: int, x, draws, tau):
    """One block on the rank's heads: (x, the (Reg) loss summed over every
    head, the masks' sum over the rank's rows and heads for s_eff)."""
    cfg = ctx.cfg
    scfg = cfg.stlt_config()
    acfg = scfg.adaptive if tau is None else scfg.adaptive._replace(tau=tau)
    pre = f"layers/{li}"
    spre = pre + "/stlt"
    sp = p["stlt"]
    h = L.apply_norm(cfg.norm, ctx.whole(p["norm1"], pre + "/norm1"), x)
    hf = comm.copy_to(h, ctx.tp_group)
    nodes = {k: ctx.cols(v, f"{spre}/nodes/{k}", 0) for k, v in sp["nodes"].items()}
    masks, s_sum = None, torch.zeros((), device=x.device)
    if acfg.enabled:
        ad = {"w_alpha": ctx.cols(sp["adaptive"]["w_alpha"], spre + "/adaptive/w_alpha", 1),
              "b_alpha": ctx.cols(sp["adaptive"]["b_alpha"], spre + "/adaptive/b_alpha", 0)}
        masks, _ = adaptive_lib.node_masks(ad, hf, acfg, deterministic=False, draws=draws)
        s_sum = masks.detach().float().sum()
    log_mag, theta, sigma, _ = stlt_lib._poles({"nodes": nodes}, scfg)
    heads = scfg.num_heads // ctx.tp_size
    v = stlt_lib._split_heads(L.matmul(hf, ctx.cols(sp["w_v"], spre + "/w_v", 1)), heads)
    u_re, u_im = stlt_lib._masked_u({"nodes": nodes}, masks)
    z = stlt_lib._merge_heads(stlt_lib._factorized(v, log_mag, theta, u_re, u_im, scfg,
                                                   reverse=False))
    if scfg.gate:
        z = z * F.silu(L.matmul(hf, ctx.cols(sp["w_g"], spre + "/w_g", 1)))
    y = comm.reduce_from(L.matmul(z, ctx.cols(sp["w_o"], spre + "/w_o", 0)), ctx.tp_group)
    m_mean = None
    if masks is not None:   # the batch mean over the global batch
        m_mean = (comm.all_reduce_sum(masks.sum(0), ctx.batch_group) / ctx.global_batch)[None]
    reg = comm.reduce_from(
        adaptive_lib.regularization(sigma, nodes["omega"], m_mean, acfg).float(), ctx.tp_group)
    x = x + y.to(x.dtype)
    fpre = pre + "/ffn"
    f = p["ffn"]
    h2 = comm.copy_to(L.apply_norm(cfg.norm, ctx.whole(p["norm2"], pre + "/norm2"), x),
                      ctx.tp_group)
    if cfg.act == "swiglu":
        a = (F.silu(L.matmul(h2, ctx.cols(f["w1"], fpre + "/w1", 1)))
             * L.matmul(h2, ctx.cols(f["w3"], fpre + "/w3", 1)))
        y2 = comm.reduce_from(L.matmul(a, ctx.cols(f["w2"], fpre + "/w2", 0)), ctx.tp_group)
    else:
        a = F.gelu(L.matmul(h2, ctx.cols(f["w1"], fpre + "/w1", 1))
                   + ctx.cols(f["b1"], fpre + "/b1", 0), approximate="tanh")
        y2 = (comm.reduce_from(L.matmul(a, ctx.cols(f["w2"], fpre + "/w2", 0)), ctx.tp_group)
              + ctx.whole({"b2": f["b2"]}, fpre)["b2"])
    return x + y2.to(x.dtype), reg, s_sum


def _head(ctx: ShardCtx, params, x):
    cfg = ctx.cfg
    x = L.apply_norm(cfg.norm, ctx.whole(params["final_norm"], "final_norm"), x)
    x = comm.copy_to(x, ctx.tp_group)
    if "lm_head" in params:
        return L.matmul(x, params["lm_head"]["kernel"])
    return L.matmul(x, params["embed"]["embed"].T)


def _nll(ctx: ShardCtx, logits, labels):
    """Per-token cross entropy from vocab-sharded logits [..., V_loc]."""
    lf = logits.float()
    if ctx.tp_group is None:
        return torch.logsumexp(lf, -1) - torch.gather(lf, -1, labels[..., None].long())[..., 0]
    v_loc = lf.shape[-1]
    top = comm.all_reduce(lf.detach().amax(-1), ctx.tp_group, op="max")
    lse = torch.log(comm.reduce_from(torch.exp(lf - top[..., None]).sum(-1), ctx.tp_group)) + top
    ids = labels.long() - ctx.tp_rank * v_loc
    inside = ((ids >= 0) & (ids < v_loc)).to(lf.dtype)
    picked = torch.gather(lf, -1, ids.clamp(0, v_loc - 1)[..., None])[..., 0] * inside
    return lse - comm.reduce_from(picked, ctx.tp_group)


def _token_count(ctx: ShardCtx, mask, nll) -> torch.Tensor:
    n = (mask.float().sum() if mask is not None
         else torch.tensor(float(nll.numel()), device=nll.device))
    return comm.all_reduce(n, ctx.batch_group) if ctx.batch_group is not None else n


def tp_lm_loss(params: dict, ctx: ShardCtx, batch: dict, draws=None, tau=None):
    """(this rank's share of the loss, sums for the metrics) of the STLT LM
    on the TP-local ``params`` (``ctx.gather_fsdp``) and the rank's rows;
    ``draws[i]`` [B_loc, H_loc, S] are layer i's uniform draws for the
    rank's rows and heads."""
    cfg = ctx.cfg
    x = T._with_pe(cfg, _embed(ctx, params, batch["inputs"]))
    block = T._maybe_remat(lambda p, li, x, d: _stlt_block(ctx, p, li, x, d, tau), cfg)
    reg = s_sum = torch.zeros((), device=x.device)
    for li, p in enumerate(params["layers"]):
        x, r, s = block(p, li, x, None if draws is None else draws[li])
        reg, s_sum = reg + r, s_sum + s
    nll = _nll(ctx, _head(ctx, params, x), batch["labels"])
    mask = batch.get("mask")
    nll_sum = (nll * mask).sum() if mask is not None else nll.sum()
    count = _token_count(ctx, mask, nll)
    share = nll_sum / count + reg / ctx.n_batch
    return share, {"ce_sum": nll_sum.detach(), "count": count, "reg": reg.detach(),
                   "s_sum": s_sum}


def dp_lm_loss(params: dict, ctx: ShardCtx, batch: dict, loss_fn, draws=None, tau=None):
    """(this rank's share, its metrics) for an arch off the TP path: the
    family's own loss on the rank's rows over the number of batch shards
    (the global token mean when every shard holds as many tokens)."""
    cfg = ctx.cfg
    if ctx.n_batch > 1:
        if cfg.is_moe:
            raise NotImplementedError(f"MoE over more than one batch shard ({ROADMAP_EP})")
        if cfg.family == "lm" and cfg.stlt_adaptive:
            raise NotImplementedError("adaptive masks over more than one batch shard need "
                                      f"the TP path's global batch mean ({ROADMAP_TP})")
        if batch.get("mask") is not None:
            raise NotImplementedError("a loss mask over more than one batch shard")
    loss, metrics = loss_fn(params, cfg, batch, deterministic=False, tau=tau, draws=draws)
    return loss / ctx.n_batch, {k: v.detach() for k, v in metrics.items()}
