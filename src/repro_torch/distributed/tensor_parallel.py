"""The sharded train loss and serving steps: tensor parallelism on the
``model`` axis for the LM and hybrid families, and the data-parallel loss
of every arch.

Where the JAX package's GSPMD places collectives implicitly, the port places
them at these points (Megatron's convention on ``model``: every rank of the
group computes the same loss; ``comm`` documents the operators):

* ``_embed``: the vocab-sharded embedding (``embed/embed`` ->
  ``P("model", fsdp)``) looks up the rank's rows, masks the others and
  all-reduces (``reduce_from``). Embedding inputs pass through.
* ``_block``, the one block body of the train loss, the prefill and the
  decode step: norm1, ``copy_to`` on the normed input, the mixer on the
  rank's share giving a partial readout through its rows of the output
  projection, the all-reduce, the residual and the FFN. The mixer's share
  follows the rules' layout of its leaves:

  - the STLT (``_local_stlt``): the column-sharded ``w_v`` (and ``w_g``),
    its rows of ``nodes/*``, ``adaptive/w_alpha`` and ``b_alpha`` and its
    slice of the replicated per-head ``T_hat``; K1 runs on the rank's
    B_loc x H_loc rows (the train loss through the scan's VJP, the prefill
    through ``stlt.stlt_prefill``'s stateful call; the decode step through
    ``stlt.apply_stlt_step``, no K1). In the train loss the adaptive masks'
    batch mean in the (Reg) loss is over the global batch
    (``all_reduce_sum`` over the batch axes) and the loss's per-head terms
    are summed over ``model``; the serving steps' masks are the
    deterministic ones, from the running input mean.
  - attention (``_local_attn``, ``models/attention.py``'s algebra): ``wq``
    (and ``bq``) on the rank's query heads; ``wk``/``wv`` (``bk``/``bv``)
    on its KV heads when they divide over ``model``, else whole on every
    rank (``partial_replicated``: each rank's query heads read some of
    them, so their grads are summed), the grouping contiguous (rank r's
    query heads read KV heads [r KV / tp, (r + 1) KV / tp)). The decode
    cache keeps the rank's KV heads; when they do not divide, the spec
    shards the cache's time axis instead (JAX's flash-decoding layout):
    the prefill writes each rank's time slice of the whole K/V, and a
    decode step writes the new token on the rank owning its slot (a
    ``local_attn`` ring: slot ``pos % W``), all-gathers q over ``model``,
    takes every head's scores over its slice, all-reduces their max and
    then their exp-sums and weighted values, and keeps its own heads.
  - the rg-LRU (``_local_rglru``, ``models/rglru.py``'s algebra):
    ``w_gate``, ``w_x``, ``w_a`` and the conv on the rank's channels,
    ``w_i``, ``b_i``, ``b_a`` and ``lam`` sliced where the rules keep them
    whole, the row-sharded ``w_out``. The gates' d x d products read the
    whole conv output, so it is all-gathered over ``model``
    (``gather_shards``: its backward reduce-scatters); the recurrence runs
    on the rank's channels. The decode state keeps ``h`` and ``conv_buf``
    whole on every rank (JAX's spec), so the prefill and each step gather
    the rank's channels back.

  The FFN: ``w1`` (and ``w3``) column-sharded, ``w2`` row-sharded; ``b1``,
  replicated by the rules below 4096 entries but used sliced, comes through
  ``slice_replicated``, whose backward gathers the slices' grads. A MoE
  block (``_local_moe``, ``apply_moe_ep``) holds its E / tp experts
  (expert parallelism on ``model``, JAX's ``P("model", fsdp, None)``), the
  whole router and Arctic's dense branch column- and row-sharded; the
  router reads the normed activation whole (its aux losses, equal on every
  rank, are counted once) and the experts through ``copy_to``; the
  all-reduce of the combine is the block's second. The block's aux losses
  enter the train loss as the STLT's (Reg) does: replicated on the TP
  group, over the number of batch shards.
* ``_head`` and ``_nll``: vocab-parallel logits (tied through the embedding
  shard, or an ``lm_head`` shard), then cross entropy with the max and the
  sum of exp taken over ``model`` and the label's logit from the rank that
  owns it; the serving steps all-gather the last token's logits over
  ``model`` instead.

A leaf the rules shard on ``data`` (``cfg.fsdp``) is gathered before use
(``gather_shards``: its grad comes back reduce-scattered). Each rank's loss
is its share of a sum over the batch axes (its rows' token-sum of the cross
entropy over the global token count, plus the replicated aux terms over
the number of batch shards), so summing grads over the batch axes gives the
global step's.

The TP path takes the LM and hybrid families with dense FFNs or MoEs over
the ``stlt`` (factorized, exponential window, a scan engine), ``attn``,
``local_attn`` and ``rglru`` blocks; ``tp_refusal`` names what else a
``model`` axis > 1 refuses, and the ROADMAP item that ports it. Any other
arch runs the data axes only, through its own loss on the rank's rows
(``dp_lm_loss``; its serving steps through the family's own prefill and
decode, ``launch.steps``); there, a loss that couples rows (MoE's balance
losses and capacity, the adaptive masks' batch mean) refuses more than one
batch shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import stlt as stlt_lib
from repro_torch.distributed import comm
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import transformer as T
from repro_torch.utils import tree_flatten_with_paths, tree_map

ROADMAP_TP = ("ROADMAP Queue 1 item 7: TP for stlt_rel blocks, the hann window, the non-scan "
              "STLT engines and the xLSTM and enc-dec families")
TP_BLOCKS = ("stlt", "attn", "local_attn", "rglru")


def tp_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the TP path cannot run ``cfg`` (None when it can)."""
    if cfg.family not in ("lm", "hybrid"):
        return f"the {cfg.family} family ({ROADMAP_TP})"
    if cfg.is_moe and cfg.dense_residual and cfg.act != "swiglu":
        return f"a {cfg.act} MoE dense branch ({ROADMAP_TP})"
    other = sorted(set(cfg.block_types()) - set(TP_BLOCKS))
    if other:
        return f"block types {other} ({ROADMAP_TP})"
    if "stlt" in cfg.block_types():
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
            dims = [("num_heads", cfg.num_heads), ("vocab", cfg.vocab)]
            if cfg.is_moe:
                dims.append(("num_experts", cfg.num_experts))
                if cfg.dense_residual:
                    dims.append(("dense_ff", cfg.dense_ff or cfg.d_ff))
            else:
                dims.append(("d_ff", cfg.d_ff))
            if "rglru" in cfg.block_types():
                dims.append(("d_model", cfg.d_model))
            for what, n in dims:
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
# the TP forward
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


def _local_stlt(ctx: ShardCtx, sp: dict, spre: str):
    """The rank's heads of one STLT layer: (its params, the ``STLTConfig`` of
    H_loc heads over H_loc x dh value channels). The column-sharded ``w_v``
    (and ``w_g``), its rows of ``nodes/*``, ``adaptive/w_alpha`` and
    ``b_alpha`` and of the replicated per-head ``T_hat``, the row-sharded
    ``w_o``. The input stays the whole (replicated) normed activation, so
    the adaptive masks' pooled mean is every rank's own."""
    scfg = ctx.cfg.stlt_config()
    heads = scfg.num_heads // ctx.tp_size
    loc = {"nodes": {k: ctx.cols(v, f"{spre}/nodes/{k}", 0) for k, v in sp["nodes"].items()},
           "w_v": ctx.cols(sp["w_v"], spre + "/w_v", 1),
           "w_o": ctx.cols(sp["w_o"], spre + "/w_o", 0)}
    if scfg.gate:
        loc["w_g"] = ctx.cols(sp["w_g"], spre + "/w_g", 1)
    if scfg.adaptive.enabled:
        loc["adaptive"] = {
            "w_alpha": ctx.cols(sp["adaptive"]["w_alpha"], spre + "/adaptive/w_alpha", 1),
            "b_alpha": ctx.cols(sp["adaptive"]["b_alpha"], spre + "/adaptive/b_alpha", 0)}
    return loc, dataclasses.replace(scfg, num_heads=heads,
                                    d_model=heads * scfg.head_dim)


class _AttnShard(NamedTuple):
    """The rank's share of one attention layer: its params, the
    ``AttentionConfig`` of its query heads over the KV heads it holds,
    ``kv_idx`` (the held KV head each of its query heads reads when every
    rank holds every KV head; None: GQA's own grouping over its share) and
    ``time_parts`` (the ranks the decode cache's time axis is split over)."""
    params: dict
    cfg: attn_lib.AttentionConfig
    kv_idx: Optional[tuple]
    time_parts: int


def _local_attn(ctx: ShardCtx, ap: dict, apre: str, btype: str,
                max_len: Optional[int] = None) -> _AttnShard:
    """The rank's heads of one attention layer (``max_len`` sizes the decode
    cache, whose layout the serving steps read)."""
    full = T._attn_cfg(ctx.cfg, btype)
    H, KV, dh, tp = full.num_heads, full.num_kv_heads, full.dh, ctx.tp_size
    h_loc, split = H // tp, KV % tp == 0
    loc = {"wq": ctx.cols(ap["wq"], apre + "/wq", 1), "wo": ctx.cols(ap["wo"], apre + "/wo", 0)}
    if full.qkv_bias:
        loc["bq"] = ctx.cols(ap["bq"], apre + "/bq", 0)
    for k in ("wk", "wv") + (("bk", "bv") if full.qkv_bias else ()):
        loc[k] = (ctx.cols(ap[k], f"{apre}/{k}", ap[k].ndim - 1) if split
                  else comm.partial_replicated(ap[k], ctx.tp_group))
    kv_idx = None if split else tuple((ctx.tp_rank * h_loc + i) // (H // KV)
                                      for i in range(h_loc))
    size = 0 if max_len is None else (min(max_len, full.window) if full.window else max_len)
    time_parts = tp if (not split and max_len is not None and size % tp == 0) else 1
    lcfg = dataclasses.replace(full, d_model=h_loc * dh, num_heads=h_loc,
                               num_kv_heads=KV // tp if split else KV, head_dim=dh)
    return _AttnShard(loc, lcfg, kv_idx, time_parts)


def _attn_forward(sh: _AttnShard, hf):
    """The rank's query heads over the whole sequence ``hf`` (the dense or
    blockwise core, ``attention.apply_attention``): (the partial readout
    through its rows of ``wo``, k and v of the held KV heads)."""
    B, N, _ = hf.shape
    q, k, v = attn_lib._qkv(sh.params, sh.cfg, hf, torch.arange(N, device=hf.device))
    if sh.kv_idx is None:
        out = attn_lib._sdpa(q, k, v, sh.cfg)
    else:
        idx = torch.tensor(sh.kv_idx, device=hf.device)
        out = attn_lib._sdpa(q, k[:, :, idx], v[:, :, idx],
                             dataclasses.replace(sh.cfg, num_kv_heads=sh.cfg.num_heads))
    return L.matmul(out.reshape(B, N, -1), sh.params["wo"]), k, v


def _attn_prefill(ctx: ShardCtx, sh: _AttnShard, hf, max_len: int):
    """``attention.prefill_kv_cache`` on the rank's heads: (partial readout,
    the rank's share of the cache: its KV heads, or its time slice of every
    KV head's)."""
    y, k, v = _attn_forward(sh, hf)
    cache = attn_lib.cache_from_kv(sh.cfg, k, v, max_len, hf.dtype)
    if sh.time_parts > 1:
        part = cache["k"].shape[1] // sh.time_parts
        for name in ("k", "v"):
            cache[name] = cache[name].narrow(1, ctx.tp_rank * part, part).contiguous()
    return y, cache


def _attn_step(ctx: ShardCtx, sh: _AttnShard, h, cache: dict):
    """One decode step of the rank's heads (``attention.apply_attention_step``)
    on its share of the cache: its KV heads (the step itself), or every KV
    head over its time slice or the whole cache."""
    if sh.kv_idx is None:
        return attn_lib.apply_attention_step(sh.params, sh.cfg, h, cache)
    c, B = sh.cfg, h.shape[0]
    pos = cache["pos"]
    q, k, v = attn_lib._qkv(sh.params, c, h[:, None, :], pos[:, None])
    part = cache["k"].shape[1]
    size = part * sh.time_parts
    t0 = ctx.tp_rank * part if sh.time_parts > 1 else 0
    slot = pos % size if c.window > 0 else pos
    ck = attn_lib._write(cache["k"], (slot - t0)[:, None], k)     # the slot's owner writes
    cv = attn_lib._write(cache["v"], (slot - t0)[:, None], v)
    group = ctx.tp_group if sh.time_parts > 1 else None
    idx = torch.tensor(sh.kv_idx, device=h.device)
    if group is not None:      # every query head over this rank's slots
        q = comm.all_gather(q, 2, group)
        H = q.shape[2]
        idx = torch.arange(H, device=h.device) // (H // c.num_kv_heads)
    s = attn_lib._einsum("bhd,bmhd->bhm", q[:, 0], ck[:, :, idx]) / math.sqrt(c.dh)
    j = t0 + torch.arange(part, device=h.device)[None, :]
    if c.window > 0:   # a ring: every slot valid once it has wrapped
        ok = (j <= slot[:, None]) | (pos[:, None] >= size)
    else:
        ok = j <= pos[:, None]
    ok = ok[:, None, :]
    s = torch.where(ok, s.to(torch.float32), attn_lib.NEG_INF)
    top = s.amax(-1)
    if group is not None:
        top = comm.all_reduce(top, group, op="max")
    p = torch.where(ok, torch.exp(s - top[..., None]), 0.0)
    sums = torch.cat([p.sum(-1)[..., None],
                      attn_lib._einsum("bhm,bmhd->bhd", p, cv[:, :, idx])], -1)
    if group is not None:      # the exp-sums and weighted values; keep this rank's heads
        h_loc = c.num_heads
        sums = comm.all_reduce(sums, group).narrow(1, ctx.tp_rank * h_loc, h_loc)
    o = (sums[..., 1:] / sums[..., :1]).to(h.dtype).reshape(B, 1, -1)
    y = L.matmul(o, sh.params["wo"])[:, 0]
    return y, {"k": ck, "v": cv, "pos": pos + 1}


_RGLRU_DIMS = {"w_gate": 1, "w_x": 1, "conv": 1, "w_a": 1, "b_a": 0, "w_i": 1, "b_i": 0,
               "lam": 0, "w_out": 0}


def _local_rglru(ctx: ShardCtx, rp: dict, rpre: str) -> dict:
    """The rank's channels of one rg-LRU block: its columns of ``w_gate``,
    ``w_x``, ``w_a``, ``w_i`` and of the conv, its entries of ``b_a``,
    ``b_i`` and ``lam``, its rows of ``w_out``."""
    return {k: ctx.cols(rp[k], f"{rpre}/{k}", dim) for k, dim in _RGLRU_DIMS.items()}


def _gather_channels(ctx: ShardCtx):
    """The gates' input: the whole conv output from the ranks' channels."""
    return lambda xc: comm.gather_shards(xc, xc.ndim - 1, ctx.tp_group)


def _whole_rglru_state(ctx: ShardCtx, st: dict) -> dict:
    """An rg-LRU state on the rank's channels gathered whole (one
    all-gather of ``h`` and ``conv_buf`` side by side)."""
    if ctx.tp_group is None:
        return st
    both = comm.all_gather(torch.cat([st["h"][:, None], st["conv_buf"]], 1), 2, ctx.tp_group)
    return {"h": both[:, 0], "conv_buf": both[:, 1:]}


def _own_channels(ctx: ShardCtx, st: dict) -> dict:
    if ctx.tp_group is None:
        return st
    d_loc = st["h"].shape[-1] // ctx.tp_size
    return {k: v.narrow(-1, ctx.tp_rank * d_loc, d_loc) for k, v in st.items()}


def _local_moe(ctx: ShardCtx, mp: dict, mpre: str) -> dict:
    """The rank's share of one MoE block: its experts (the rules shard the
    expert dim on ``model``), the whole router, the dense branch's
    columns of ``w1``/``w3`` and rows of ``w2``."""
    loc = {"router": mp["router"],
           **{k: ctx.cols(mp[k], f"{mpre}/{k}", 0) for k in ("w1", "w3", "w2")}}
    if "dense" in mp:
        dp, dpre = mp["dense"], mpre + "/dense"
        loc["dense"] = {"w1": ctx.cols(dp["w1"], dpre + "/w1", 1),
                        "w3": ctx.cols(dp["w3"], dpre + "/w3", 1),
                        "w2": ctx.cols(dp["w2"], dpre + "/w2", 0)}
    return loc


def apply_moe_ep(params, cfg: moe_lib.MoEConfig, x: torch.Tensor, ep_group=None,
                 batch_group=None, rank: int = 0):
    """The expert-parallel MoE on one rank, after the JAX package's
    ``_apply_moe_shardmap``: x [B_loc, N, d] (or a decode step's [B_loc, d])
    is the rank's rows, whole on every rank of ``ep_group`` (the ``model``
    axis); ``params`` the whole ``router``, the rank's experts
    ``w1``/``w3``/``w2`` [E_loc, ...] (experts [rank E_loc, (rank + 1)
    E_loc)) and its ``dense_ff`` columns of ``dense``'s ``w1``/``w3`` and
    rows of ``w2`` (``_local_moe``). ``cfg.dispatch == "gather"`` is the
    global view over the batch shards of ``batch_group``: capacity from the
    global token count, each expert's slot positions after the choices of
    the shards before this one (one all-gather of the rank's E_loc counts;
    the rows are in rank order), the balance losses from sums over the
    global batch (one all-reduce of 2E + 1 floats); ``"shard_map"`` each
    shard's own capacity and positions, the aux losses the shards' mean (as
    JAX's ``pmean``). Returns (y, whole on every rank, aux {aux_loss,
    router_z}, equal on every rank of the mesh); ``moe.DROPS`` counts the
    rank's own experts' drops.

    The gather path's slot table holds only what this rank can keep: E_loc x
    the most any of its experts keeps here (at most the global capacity; a
    shard fills about 1 / n_batch of it), read on the host once a call; a
    shape-only call (``meta``) takes the global capacity.

    Autograd follows the TP convention (every rank of ``ep_group`` computes
    the same loss): the experts read x through ``copy_to``, the gates'
    cotangent, which comes from the rank's experts only, is summed over
    ``ep_group`` (``partial_replicated``) and the router reads x directly,
    so the aux losses' grads, whole on every rank, are counted once. The
    aux sums over ``batch_group`` go through ``all_reduce_sum``: each rank's
    loss adds its share of them."""
    squeeze = x.ndim == 2               # a decode step's [B, d]
    if squeeze:
        x = x[:, None]
    B, N, d = x.shape
    T, E, E_loc = B * N, cfg.num_experts, params["w1"].shape[0]
    n_batch = comm.group_size(batch_group)
    xt = x.reshape(T, d)
    r = moe_lib.route(params, cfg, xt, rank * E_loc)
    gates = comm.partial_replicated(r.gates, ep_group)
    if cfg.dispatch == "gather" and n_batch > 1:
        t_all = T * n_batch
        sums = comm.all_reduce_sum(torch.cat([r.probs.sum(0), r.top1.sum(0), r.lse2.sum()[None]]),
                                   batch_group) / t_all
        aux_loss = cfg.aux_loss_weight * E * torch.sum(sums[:E] * sums[E:2 * E])
        router_z = cfg.router_z_weight * sums[2 * E]
        C = moe_lib._capacity(t_all, cfg)
        counts = comm.all_gather(r.counts[None], 0, batch_group)
        before = counts[:comm.group_rank(batch_group)].sum(0)
        glob = r.pos + torch.cat([before, before.new_zeros(1)])[r.local]
        kept = torch.clamp(torch.minimum(r.counts, C - before), min=0)
        # shape-only (meta, the dry-run): the most a call can keep, C
        width = C if kept.device.type == "meta" else max(1, int(kept.max()))
    else:
        C = width = moe_lib._capacity(T, cfg)
        glob = r.pos
        aux_loss, router_z = moe_lib.balance_losses(cfg, r.probs, r.top1, r.lse2)
        if n_batch > 1:                 # JAX's pmean over the batch axes
            aux_loss = comm.all_reduce_sum(aux_loss, batch_group) / n_batch
            router_z = comm.all_reduce_sum(router_z, batch_group) / n_batch
    mine = r.local < E_loc
    keep = mine & (glob < C)
    moe_lib.DROPS.add((mine & ~keep).sum())
    y = moe_lib.experts_combine(params, cfg, comm.copy_to(xt, ep_group), r.local, r.pos, keep,
                                gates, width, x.dtype)
    y = comm.reduce_from(y, ep_group).reshape(B, N, d)
    return (y[:, 0] if squeeze else y), {"aux_loss": aux_loss, "router_z": router_z}


def _block(ctx: ShardCtx, p: dict, li: int, btype: str, x, mixer, extra=None):
    """One block on the rank's share, the body the train loss and both
    serving steps share: norm1, ``copy_to``, ``mixer(p, prefix, btype, h,
    extra)`` giving (its partial readout, anything else), the all-reduce,
    the residual and the FFN or the MoE. Returns (x, the mixer's other
    output, the MoE's (aux_loss, router_z): zeros for an FFN)."""
    cfg = ctx.cfg
    pre = f"layers/{li}"
    h = L.apply_norm(cfg.norm, ctx.whole(p["norm1"], pre + "/norm1"), x)
    y, out = mixer(p, pre, btype, comm.copy_to(h, ctx.tp_group), extra)
    x = x + comm.reduce_from(y, ctx.tp_group).to(x.dtype)
    h2 = L.apply_norm(cfg.norm, ctx.whole(p["norm2"], pre + "/norm2"), x)
    if cfg.is_moe:
        y2, aux = apply_moe_ep(_local_moe(ctx, p["moe"], pre + "/moe"), cfg.moe_config(), h2,
                               ctx.tp_group, ctx.batch_group, ctx.tp_rank)
        return x + y2.to(x.dtype), out, (aux["aux_loss"], aux["router_z"])
    zero = torch.zeros((), device=x.device)
    fpre = pre + "/ffn"
    f = p["ffn"]
    h2 = comm.copy_to(h2, ctx.tp_group)
    if cfg.act == "swiglu":
        a = (F.silu(L.matmul(h2, ctx.cols(f["w1"], fpre + "/w1", 1)))
             * L.matmul(h2, ctx.cols(f["w3"], fpre + "/w3", 1)))
        y2 = comm.reduce_from(L.matmul(a, ctx.cols(f["w2"], fpre + "/w2", 0)), ctx.tp_group)
    else:
        a = F.gelu(L.matmul(h2, ctx.cols(f["w1"], fpre + "/w1", 1))
                   + ctx.cols(f["b1"], fpre + "/b1", 0), approximate="tanh")
        y2 = (comm.reduce_from(L.matmul(a, ctx.cols(f["w2"], fpre + "/w2", 0)), ctx.tp_group)
              + ctx.whole({"b2": f["b2"]}, fpre)["b2"])
    return x + y2.to(x.dtype), out, (zero, zero)


def _train_mixer(ctx: ShardCtx, tau):
    """The train loss's mixer; its extra input is the layer's draws (the
    rank's rows and heads), its extra output (the (Reg) loss summed over
    every head, the masks' sum over the rank's rows and heads for s_eff),
    zeros off the STLT. The STLT's masks are stochastic, from the draws, K1
    runs through the scan's VJP, and the masks' batch mean in (Reg) is over
    the global batch."""
    def mixer(p, pre, btype, hf, draws):
        zero = torch.zeros((), device=hf.device)
        if btype == "rglru":
            return (rglru_lib.apply_rglru_block(_local_rglru(ctx, p["rec"], pre + "/rec"),
                                                ctx.cfg, hf, gather=_gather_channels(ctx)),
                    (zero, zero))
        if btype != "stlt":
            return _attn_forward(_local_attn(ctx, p["attn"], pre + "/attn", btype), hf)[0], \
                (zero, zero)
        sp, scfg = _local_stlt(ctx, p["stlt"], pre + "/stlt")
        acfg = scfg.adaptive if tau is None else scfg.adaptive._replace(tau=tau)
        masks, s_sum = None, zero
        if acfg.enabled:
            masks, _ = adaptive_lib.node_masks(sp["adaptive"], hf, acfg, deterministic=False,
                                               draws=draws)
            s_sum = masks.detach().float().sum()
        log_mag, theta, sigma, _ = stlt_lib._poles(sp, scfg)
        v = stlt_lib._split_heads(L.matmul(hf, sp["w_v"]), scfg.num_heads)
        u_re, u_im = stlt_lib._masked_u(sp, masks)
        z = stlt_lib._factorized(v, log_mag, theta, u_re, u_im, scfg, reverse=False)
        m_mean = None
        if masks is not None:   # the batch mean over the global batch
            m_mean = (comm.all_reduce_sum(masks.sum(0), ctx.batch_group)
                      / ctx.global_batch)[None]
        reg = comm.reduce_from(
            adaptive_lib.regularization(sigma, sp["nodes"]["omega"], m_mean, acfg).float(),
            ctx.tp_group)
        return stlt_lib._readout(sp, scfg, hf, z), (reg, s_sum)

    return mixer


def _prefill_mixer(ctx: ShardCtx, max_len: int):
    """The prefill's mixer: (partial readout, the rank's share of the
    layer's decode state). The STLT's serving masks are deterministic, from
    the rank's ``w_alpha`` columns."""
    def mixer(p, pre, btype, hf, _):
        if btype == "stlt":
            return stlt_lib.stlt_prefill(*_local_stlt(ctx, p["stlt"], pre + "/stlt"), hf)
        if btype == "rglru":
            y, st = rglru_lib.rglru_prefill(_local_rglru(ctx, p["rec"], pre + "/rec"), ctx.cfg,
                                            hf, gather=_gather_channels(ctx))
            return y, _whole_rglru_state(ctx, st)
        return _attn_prefill(ctx, _local_attn(ctx, p["attn"], pre + "/attn", btype, max_len),
                             hf, max_len)

    return mixer


def _step_mixer(ctx: ShardCtx, max_len: int):
    """The decode step's mixer: (partial readout, the layer's new state
    share) from its state share."""
    def mixer(p, pre, btype, h, st):
        if btype == "stlt":
            return stlt_lib.apply_stlt_step(*_local_stlt(ctx, p["stlt"], pre + "/stlt"), h, st)
        if btype == "rglru":
            y, new = rglru_lib.apply_rglru_step(_local_rglru(ctx, p["rec"], pre + "/rec"),
                                                ctx.cfg, h, _own_channels(ctx, st),
                                                gather=_gather_channels(ctx))
            return y, _whole_rglru_state(ctx, new)
        return _attn_step(ctx, _local_attn(ctx, p["attn"], pre + "/attn", btype, max_len), h, st)

    return mixer


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
    """(this rank's share of the loss, sums for the metrics) of the LM on
    the TP-local ``params`` (``ctx.gather_fsdp``) and the rank's rows;
    ``draws[i]`` [B_loc, H_loc, S] are STLT layer i's uniform draws for the
    rank's rows and heads (None elsewhere)."""
    cfg = ctx.cfg
    x = T._with_pe(cfg, _embed(ctx, params, batch["inputs"]))
    btypes, mixer = cfg.block_types(), _train_mixer(ctx, tau)
    block = T._maybe_remat(lambda p, li, x, d: _block(ctx, p, li, btypes[li], x, mixer, d), cfg)
    reg = s_sum = aux_loss = router_z = torch.zeros((), device=x.device)
    for li, p in enumerate(params["layers"]):
        x, (r, s), (a, z) = block(p, li, x, None if draws is None else draws[li])
        reg, s_sum = reg + r, s_sum + s
        aux_loss, router_z = aux_loss + a.float(), router_z + z.float()
    nll = _nll(ctx, _head(ctx, params, x), batch["labels"])
    mask = batch.get("mask")
    nll_sum = (nll * mask).sum() if mask is not None else nll.sum()
    count = _token_count(ctx, mask, nll)
    share = nll_sum / count + (reg + aux_loss + router_z) / ctx.n_batch
    return share, {"ce_sum": nll_sum.detach(), "count": count, "reg": reg.detach(),
                   "s_sum": s_sum, "aux_loss": aux_loss.detach(),
                   "router_z": router_z.detach()}


def _serve_logits(ctx: ShardCtx, params, x):
    """The vocab-parallel logits of x [B_loc, d], gathered over ``model``
    (the serving steps' out spec replicates the vocab)."""
    logits = _head(ctx, params, x)
    return logits if ctx.tp_group is None else comm.all_gather(logits, -1, ctx.tp_group)


def tp_prefill(params: dict, ctx: ShardCtx, inputs, max_len: int):
    """The TP prefill (``transformer.prefill``) on the TP-local ``params``
    and the rank's rows ``inputs`` [B_loc, N] (or embeddings [B_loc, N,
    d]): (the last token's logits [B_loc, V], the rank's rows of the decode
    state, each layer's under its spec: the STLT's heads of ``h_re`` and
    ``h_im`` (K1's stateful call on B_loc x H_loc rows), an attention
    layer's share of its ``max_len`` cache, the rg-LRU's whole state)."""
    cfg = ctx.cfg
    x = T._with_pe(cfg, _embed(ctx, params, inputs))
    mixer = _prefill_mixer(ctx, max_len)
    states = []
    for li, (btype, p) in enumerate(zip(cfg.block_types(), params["layers"])):
        x, st, _ = _block(ctx, p, li, btype, x, mixer)
        states.append(st)
    B, N = x.shape[0], x.shape[1]
    pos = torch.full((B,), N, dtype=torch.int32, device=x.device)
    return _serve_logits(ctx, params, x[:, -1]), {"layers": states, "pos": pos}


def tp_decode_step(params: dict, ctx: ShardCtx, token_t, state: dict, max_len: int):
    """One TP decode step (``transformer.decode_step``): ``token_t``
    [B_loc] and the rank's rows of the state (each layer's share, as
    ``tp_prefill`` leaves it; ``max_len`` the cell's, which sizes the
    attention caches) -> (logits [B_loc, V], the new state's rows). No K1
    launch: ``stlt.apply_stlt_step`` on the rank's heads."""
    cfg = ctx.cfg
    pos = state["pos"]
    x_t = _embed(ctx, params, token_t)
    if T._has_pe(cfg):
        x_t = x_t + L.sinusoidal_pe(1, cfg.d_model, offset=pos, dtype=x_t.dtype,
                                    device=x_t.device)[:, 0]
    mixer = _step_mixer(ctx, max_len)
    states = []
    for li, (btype, p, st) in enumerate(zip(cfg.block_types(), params["layers"],
                                            state["layers"])):
        x_t, st, _ = _block(ctx, p, li, btype, x_t, mixer, st)
        states.append(st)
    return _serve_logits(ctx, params, x_t), {"layers": states, "pos": pos + 1}


def dp_lm_loss(params: dict, ctx: ShardCtx, batch: dict, loss_fn, draws=None, tau=None):
    """(this rank's share, its metrics) for an arch off the TP path: the
    family's own loss on the rank's rows over the number of batch shards
    (the global token mean when every shard holds as many tokens)."""
    cfg = ctx.cfg
    if ctx.n_batch > 1:
        if cfg.is_moe:
            raise NotImplementedError("MoE over more than one batch shard off the TP path "
                                      f"({tp_refusal(cfg) or ROADMAP_TP})")
        if cfg.family == "lm" and cfg.stlt_adaptive:
            raise NotImplementedError("adaptive masks over more than one batch shard need "
                                      f"the TP path's global batch mean ({ROADMAP_TP})")
        if batch.get("mask") is not None:
            raise NotImplementedError("a loss mask over more than one batch shard")
    loss, metrics = loss_fn(params, cfg, batch, deterministic=False, tau=tau, draws=draws)
    return loss / ctx.n_batch, {k: v.detach() for k, v in metrics.items()}
