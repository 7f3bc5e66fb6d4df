"""The learnable STLT layer. Two readouts, as in the JAX package:

* ``mode="factorized"`` (causal, exponential window):

      v   = x W_v                                  (per head)
      L_k = windowed Laplace scan of v at node k   (streaming recurrence)
      z   = Re(sum_k m_k u_k L_k) W_o

  The scan always goes through ``kernels/ops.stlt_scan`` (K1 on the card,
  its plain version on the CPU): the JAX engines ``chunked``,
  ``chunked_fused`` and ``pallas`` compute the same function, so all three
  engine names take that path.
* ``mode="relevance"`` (the paper's figure, causal or bidirectional):

      R[n,m] = Re(sum_k m_k L[n,k] . conj(L[m,k])) / sqrt(S)
      z      = softmax(R + causal mask + pad mask) (x W_v) W_o

  with L the transform of the per-head layer inputs. Every engine name
  takes ``kernels/relevance_flash.relevance_flash`` (K2 on the card, its
  plain version on the CPU); in the JAX package only ``pallas`` does and
  the others materialize [N, N]. ``_relevance_materialized`` is kept as the
  small-N oracle the tests use; nothing on the main path calls it. The
  relevance readout has no streaming state: ``stlt_prefill``,
  ``init_stlt_state`` and ``apply_stlt_step`` refuse it, as the JAX package
  asserts.

The hann window and the bidirectional factorized transform, and the
``associative``/``sequential`` engines of the factorized readout, are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import nodes as nodes_lib
from repro_torch.core import scan as scan_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.relevance_flash import relevance_flash
from repro_torch.models.layers import matmul
from repro_torch.utils import lecun_normal

SCAN_ENGINES = ("chunked", "chunked_fused", "pallas")


@dataclasses.dataclass(frozen=True)
class STLTConfig:
    d_model: int
    num_heads: int = 8
    num_nodes: int = 32           # S (S_max when adaptive)
    mode: str = "factorized"      # factorized | relevance
    bidirectional: bool = False
    window: str = "exponential"   # exponential | hann
    hann_support: int = 128
    chunk: int = 128
    engine: str = "chunked"
    gate: bool = False            # SiLU input gating on the readout
    delta: float = 1.0
    init_T: float = 32.0
    sigma_min: float = 1e-3
    sigma_max: float = 1.0
    omega_max: float = math.pi / 4
    learnable_sigma: bool = True
    learnable_omega: bool = True
    learnable_T: bool = True
    zero_omega: bool = False
    adaptive: adaptive_lib.AdaptiveConfig = adaptive_lib.AdaptiveConfig()
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads


def _check_ported(cfg: STLTConfig, streaming: bool = False):
    """Raise for what the port does not run. ``streaming`` marks the
    prefill/decode entry points, which need the factorized readout."""
    if cfg.mode == "relevance":
        if streaming:
            raise ValueError("the relevance readout has no streaming state: "
                             "prefill and decode need mode='factorized'")
        return
    if cfg.mode != "factorized":
        raise NotImplementedError(f"STLT mode {cfg.mode!r} is not ported yet")
    if cfg.window != "exponential":
        raise NotImplementedError(f"STLT window {cfg.window!r} is not ported yet")
    if cfg.bidirectional:
        raise NotImplementedError("the bidirectional STLT is not ported yet")
    if cfg.engine not in SCAN_ENGINES:
        raise NotImplementedError(f"STLT engine {cfg.engine!r} is not ported yet")


def init_stlt(generator: torch.Generator, cfg: STLTConfig, device=None) -> dict:
    d, dtype = cfg.d_model, cfg.param_dtype
    params = {
        "nodes": nodes_lib.init_nodes(
            generator, cfg.num_heads, cfg.num_nodes,
            sigma_min=cfg.sigma_min, sigma_max=cfg.sigma_max,
            omega_max=0.0 if cfg.zero_omega else cfg.omega_max,
            init_T=cfg.init_T, dtype=dtype, device=device),
        "w_v": lecun_normal(generator, (d, d), dtype=dtype, device=device),
        "w_o": lecun_normal(generator, (d, d), dtype=dtype, device=device),
    }
    if cfg.gate:
        params["w_g"] = lecun_normal(generator, (d, d), dtype=dtype, device=device)
    if cfg.adaptive.enabled:
        params["adaptive"] = adaptive_lib.init_adaptive(
            generator, d, cfg.num_heads, cfg.num_nodes, dtype=dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _poles(params: dict, cfg: STLTConfig):
    return nodes_lib.node_poles(
        params["nodes"], delta=cfg.delta,
        fold_window=(cfg.window == "exponential"),
        learnable_sigma=cfg.learnable_sigma,
        learnable_omega=cfg.learnable_omega and not cfg.zero_omega,
        learnable_T=cfg.learnable_T)


def _split_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, N, d = x.shape
    return x.reshape(B, N, H, d // H).transpose(1, 2)  # [B, H, N, dh]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, dh = x.shape
    return x.transpose(1, 2).reshape(B, N, H * dh)


def _masked_u(params: dict, masks: Optional[torch.Tensor]):
    """Fold adaptive masks into the complex node mixers: [H, S] (no masks)
    or [B, H, S]."""
    u_re, u_im = params["nodes"]["u_re"], params["nodes"]["u_im"]
    if masks is not None:
        u_re = u_re[None] * masks
        u_im = u_im[None] * masks
    return u_re, u_im


def _serve_node_masks(params: dict, cfg: STLTConfig, pooled, node_cap, log_mag):
    """Deterministic serve-time keep-masks [B, H, S] (or None): the adaptive
    mask from the pooled running input mean, times the per-row SLO cap mask
    (row b keeps its ``node_cap[b]`` most important nodes; cap == S keeps
    all)."""
    masks = None
    if cfg.adaptive.enabled:
        masks = adaptive_lib.masks_from_pooled(params["adaptive"], pooled,
                                               cfg.adaptive, dtype=torch.float32)
    if node_cap is not None:
        imp = adaptive_lib.node_importance(
            params["nodes"]["u_re"], params["nodes"]["u_im"], log_mag)
        cap_m = adaptive_lib.node_cap_mask(
            imp, torch.as_tensor(node_cap, dtype=torch.int32, device=imp.device))
        masks = cap_m if masks is None else masks * cap_m
    return masks


def _scan(v, log_mag, theta, u_re, u_im, cfg: STLTConfig, state=None,
          valid=None, return_state=False):
    """[B, H, N, dh] through ``ops.stlt_scan`` with rows (b, h), H fastest.
    log_mag/theta [H, S]; u [H, S] static or [B, H, S] masked."""
    B, H, N, dh = v.shape
    S = log_mag.shape[-1]
    lm, th = log_mag.repeat(B, 1), theta.repeat(B, 1)
    if u_re.ndim == 2:
        ur, ui = u_re.repeat(B, 1), u_im.repeat(B, 1)
    else:
        ur, ui = u_re.reshape(B * H, S), u_im.reshape(B * H, S)
    h0r = state["h_re"].reshape(B * H, S, dh) if state is not None else None
    h0i = state["h_im"].reshape(B * H, S, dh) if state is not None else None
    vr = None if valid is None else valid.to(torch.int32).repeat_interleave(H)
    out = kernel_ops.stlt_scan(v.reshape(B * H, N, dh), lm, th, ur, ui,
                               chunk=cfg.chunk, h0_re=h0r, h0_im=h0i, valid=vr,
                               return_state=return_state)
    if not return_state:
        return out.reshape(B, H, N, dh)
    z, (h_re, h_im) = out
    return z.reshape(B, H, N, dh), {"h_re": h_re.reshape(B, H, S, dh),
                                    "h_im": h_im.reshape(B, H, S, dh)}


def _readout(params: dict, cfg: STLTConfig, x, z):
    z = _merge_heads(z)
    if cfg.gate:
        z = z * F.silu(matmul(x, params["w_g"]))
    return matmul(z, params["w_o"])


def _relevance_readout(cfg: STLTConfig, x, v, log_mag, theta, masks,
                       pad_mask=None):
    """The relevance readout through ``relevance_flash`` (the JAX package's
    ``_relevance_flash_readout``, taken here for every engine name).

    x [B, N, d] the (normed) layer inputs, transformed per head; v
    [B, H, N, dh] the values; masks [B, H, S] or None, folded on the query
    side; pad_mask [B, N] (True = real token) zeroes padded inputs before
    the transform and removes padded keys from the softmax. Outputs at
    padded query positions are garbage by contract."""
    B, H, N, dh = v.shape
    S = cfg.num_nodes
    xh = _split_heads(x, H).reshape(B * H, N, dh).float()
    lm, th = log_mag.repeat(B, 1), theta.repeat(B, 1)   # [B*H, S], H fastest
    mk = None if masks is None else masks.reshape(B * H, S)
    km = None if pad_mask is None else pad_mask.repeat_interleave(H, dim=0)
    z = relevance_flash(xh, v.reshape(B * H, N, dh), lm, th, masks=mk,
                        kmask=km, causal=not cfg.bidirectional, tile=cfg.chunk)
    return z.reshape(B, H, N, dh).to(v.dtype)


def _complex_scan(lam, x, reverse: bool = False):
    """L[t] = lam * L[t-1] + x[t] (or from the end), one step at a time:
    lam [BH, S] complex, x [BH, N, dh] -> L [BH, N, S, dh] complex."""
    N = x.shape[1]
    a = lam[:, :, None]
    h = torch.zeros(x.shape[0], lam.shape[1], x.shape[2], dtype=lam.dtype,
                    device=x.device)
    out = [None] * N
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        h = a * h + x[:, t, None, :]
        out[t] = h
    return torch.stack(out, dim=1)


def _relevance_materialized(cfg: STLTConfig, x, v, log_mag, theta, masks,
                            pad_mask=None):
    """Materialized relevance readout, the small-N oracle: the full
    [B, H, N, N] relevance matrix and [B*H, N, S, dh] complex coefficients
    (a plain complex scan; the port has no ``scan_associative``)."""
    B, H, N, dh = v.shape
    S = cfg.num_nodes
    xh = _split_heads(x, H)
    if pad_mask is not None:
        xh = torch.where(pad_mask[:, None, :, None], xh, 0.0)
    lam = torch.exp(torch.complex(log_mag, theta)).repeat(B, 1)   # [B*H, S]
    xc = xh.reshape(B * H, N, dh).to(lam.dtype)
    L = _complex_scan(lam, xc)
    if cfg.bidirectional:
        L = L + _complex_scan(lam, xc, reverse=True) - xc[:, :, None, :]
    L = L.reshape(B, H, N, S, dh)
    Lw = L if masks is None else L * masks[:, :, None, :, None]
    R = torch.einsum("bhnkd,bhmkd->bhnm", Lw, L.conj()).real / math.sqrt(S)
    valid = torch.ones((1, 1, N, N), dtype=torch.bool, device=x.device)
    if not cfg.bidirectional:
        valid = torch.tril(valid)
    if pad_mask is not None:
        valid = valid & pad_mask[:, None, None, :]
    Rm = torch.where(valid, R, -1e30)
    p = torch.exp(Rm - Rm.amax(-1, keepdim=True).detach()) * valid
    l = p.sum(-1, keepdim=True)
    A = torch.where(l > 0, p / torch.where(l > 0, l, 1.0), 0.0)
    return torch.einsum("bhnm,bhmd->bhnd", A, v)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def apply_stlt(params: dict, cfg: STLTConfig, x: torch.Tensor, *,
               deterministic: bool = True,
               draws: Optional[torch.Tensor] = None,
               tau: Optional[float] = None,
               pad_mask: Optional[torch.Tensor] = None):
    """Full-sequence STLT block. x: [B, N, d_model] -> (y, aux dict).

    With ``deterministic=False`` the adaptive masks take logistic noise from
    the uniform ``draws`` [B, H, S] (``adaptive.node_masks``; none without
    them). Differentiable: the factorized scan is
    ``ops._StltScan``, the relevance readout K2's autograd Function.

    aux: {"reg": scalar (Reg) loss, "s_eff": [B], "masks": [B,H,S] | None,
    "T": [H], "sigma": [H, S]}.
    """
    _check_ported(cfg)
    B, N, d = x.shape
    S = cfg.num_nodes
    acfg = cfg.adaptive if tau is None else cfg.adaptive._replace(tau=tau)
    masks = None
    s_eff = torch.full((B,), float(S), device=x.device)
    if acfg.enabled:
        masks, s_eff = adaptive_lib.node_masks(
            params["adaptive"], x, acfg, deterministic=deterministic,
            draws=draws, pad_mask=pad_mask)
    log_mag, theta, sigma, T = _poles(params, cfg)
    v = _split_heads(matmul(x, params["w_v"]), cfg.num_heads)
    if cfg.mode == "relevance":
        z = _relevance_readout(cfg, x, v, log_mag, theta, masks, pad_mask)
    else:
        u_re, u_im = _masked_u(params, masks)
        z = _scan(v, log_mag, theta, u_re, u_im, cfg)
    y = _readout(params, cfg, x, z)
    reg = adaptive_lib.regularization(sigma, params["nodes"]["omega"], masks, acfg)
    return y, {"reg": reg, "s_eff": s_eff, "masks": masks, "T": T, "sigma": sigma}


def stlt_prefill(params: dict, cfg: STLTConfig, x: torch.Tensor,
                 state: Optional[dict] = None,
                 valid: Optional[torch.Tensor] = None,
                 node_cap: Optional[torch.Tensor] = None):
    """Parallel prefill: x [B, N, d] -> (y [B, N, d], O(S*d) state).

    ``state`` resumes from a carried streaming state (one scan pass seeded
    with its carry); ``valid`` [B] marks row b's tokens past ``valid[b]`` as
    padding: they never enter the carried state (the per-row snapshot), and
    outputs there are garbage. With adaptive masks, ONE deterministic mask
    per chunk comes from the carried input-mean summary ``asum/acnt`` plus
    this chunk's valid tokens; ``node_cap`` [B] further keeps each row's
    top-``node_cap[b]`` nodes.
    """
    _check_ported(cfg, streaming=True)
    B, N, d = x.shape
    log_mag, theta, _, _ = _poles(params, cfg)
    v = _split_heads(matmul(x, params["w_v"]), cfg.num_heads)
    live = None
    if valid is not None:
        if state is None:
            state = init_stlt_state(cfg, B, device=x.device)
        live = torch.arange(N, device=x.device)[None, :] < valid[:, None]
        v = torch.where(live[:, None, :, None], v, torch.zeros((), device=x.device))

    acfg = cfg.adaptive
    masks = None
    sum_state = {}
    if acfg.enabled or node_cap is not None:
        pooled = None
        if acfg.enabled:
            if live is None:
                csum = x.sum(-2, dtype=torch.float32)
                ccnt = torch.full((B,), float(N), device=x.device)
            else:
                csum = torch.where(live[..., None], x, 0).sum(-2, dtype=torch.float32)
                ccnt = valid.to(torch.float32)
            asum = (state["asum"] if state is not None and "asum" in state
                    else torch.zeros((B, d), device=x.device))
            acnt = (state["acnt"] if state is not None and "acnt" in state
                    else torch.zeros((B,), device=x.device))
            asum, acnt = asum + csum, acnt + ccnt
            pooled = asum / torch.clamp(acnt, min=1.0)[:, None]
            sum_state = {"asum": asum, "acnt": acnt}
        masks = _serve_node_masks(params, cfg, pooled, node_cap, log_mag)
    u_re, u_im = _masked_u(params, masks)

    z, new_state = _scan(v, log_mag, theta, u_re, u_im, cfg, state=state,
                         valid=valid, return_state=True)
    return _readout(params, cfg, x, z), {**new_state, **sum_state}


def init_stlt_state(cfg: STLTConfig, batch: int, dtype=torch.float32,
                    device=None) -> dict:
    """O(S*d) streaming state; adaptive configs also carry the running input
    sum ``asum`` [batch, d_model] and count ``acnt`` [batch]."""
    _check_ported(cfg, streaming=True)
    H, S, dh = cfg.num_heads, cfg.num_nodes, cfg.head_dim
    st = {"h_re": torch.zeros((batch, H, S, dh), dtype=dtype, device=device),
          "h_im": torch.zeros((batch, H, S, dh), dtype=dtype, device=device)}
    if cfg.adaptive.enabled:
        st["asum"] = torch.zeros((batch, cfg.d_model), device=device)
        st["acnt"] = torch.zeros((batch,), device=device)
    return st


def stlt_state_at(params: dict, cfg: STLTConfig, x: torch.Tensor, state: dict,
                  q: torch.Tensor) -> dict:
    """Streaming state after the first ``q[b]`` tokens of window ``x``
    [B, N, d], resumed from ``state``: the speculative-decode rollback. No
    outputs and no scan: the carry is the closed-form snapshot of the window
    as one chunk (``scan.stlt_window_state``), so a rejected draft suffix
    (positions >= q[b]) never enters it. Adaptive configs add the accepted
    prefix to the running input sum ``asum``/``acnt``, as q[b] decode steps
    would."""
    _check_ported(cfg, streaming=True)
    B, N, d = x.shape
    H, S, dh = cfg.num_heads, cfg.num_nodes, cfg.head_dim
    if state is None:
        state = init_stlt_state(cfg, B, device=x.device)
    q = torch.as_tensor(q, dtype=torch.int32, device=x.device)
    v = _split_heads(matmul(x, params["w_v"]), H)
    sum_state = {}
    if cfg.adaptive.enabled:
        live = torch.arange(N, device=x.device)[None, :] < q[:, None]
        csum = torch.where(live[..., None], x, 0).sum(-2, dtype=torch.float32)
        asum = (state["asum"] if "asum" in state
                else torch.zeros((B, d), device=x.device))
        acnt = (state["acnt"] if "acnt" in state
                else torch.zeros((B,), device=x.device))
        sum_state = {"asum": asum + csum, "acnt": acnt + q.to(torch.float32)}
    log_mag, theta, _, _ = _poles(params, cfg)
    h_re, h_im = scan_lib.stlt_window_state(
        v.reshape(B * H, N, dh).float(),
        state["h_re"].reshape(B * H, S, dh).float(),
        state["h_im"].reshape(B * H, S, dh).float(),
        log_mag.repeat(B, 1), theta.repeat(B, 1), q.repeat_interleave(H))
    return {"h_re": h_re.reshape(B, H, S, dh), "h_im": h_im.reshape(B, H, S, dh),
            **sum_state}


def apply_stlt_step(params: dict, cfg: STLTConfig, x_t: torch.Tensor,
                    state: dict, node_cap: Optional[torch.Tensor] = None):
    """One decode step. x_t: [B, d_model] -> (y_t [B, d_model], new state).

    With adaptive masks the deterministic mask is recomputed every step from
    the running input mean (updated here to include x_t); ``node_cap`` [B]
    keeps each row's top-k nodes (cap == S rows run unmasked)."""
    _check_ported(cfg, streaming=True)
    B, d = x_t.shape
    H = cfg.num_heads
    v_t = matmul(x_t, params["w_v"]).reshape(B, H, cfg.head_dim)
    log_mag, theta, _, _ = _poles(params, cfg)

    acfg = cfg.adaptive
    masks = None
    sum_state = {}
    if acfg.enabled or node_cap is not None:
        pooled = None
        if acfg.enabled:
            asum = (state["asum"] if "asum" in state
                    else torch.zeros((B, d), device=x_t.device))
            acnt = (state["acnt"] if "acnt" in state
                    else torch.zeros((B,), device=x_t.device))
            asum = asum + x_t.float()
            acnt = acnt + 1.0
            pooled = asum / torch.clamp(acnt, min=1.0)[:, None]
            sum_state = {"asum": asum, "acnt": acnt}
        masks = _serve_node_masks(params, cfg, pooled, node_cap, log_mag)
    u_re, u_im = _masked_u(params, masks)

    z, h_re, h_im = scan_lib.stlt_decode_step(
        v_t, state["h_re"], state["h_im"], log_mag, theta, u_re, u_im)
    z = z.reshape(B, d)
    if cfg.gate:
        z = z * F.silu(matmul(x_t, params["w_g"]))
    return matmul(z, params["w_o"]), {"h_re": h_re, "h_im": h_im, **sum_state}
