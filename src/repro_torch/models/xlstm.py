"""xLSTM blocks (arXiv:2405.04517), the port's counterpart of the JAX
package's ``models/xlstm.py``, function for function: the mLSTM (matrix
memory, chunkwise-parallel over a sequence, an exact sequential update per
decode step) and the sLSTM (scalar memory, a true recurrence with a
block-diagonal R, one step per token everywhere).

The mLSTM has exponential input gates and sigmoid forget gates with the
max-stabilizer m_t. Its whole-sequence form (``mlstm_chunked``) runs
intra-chunk attention-like scores and an O(dh^2) inter-chunk carry, in
chunks of ``min(64, max(8, N))`` tokens as the JAX package's are: the
result is chunk-invariant only in exact arithmetic. Padded steps carry
log-input -1e30 and log-forget 0, so they pass the state through.

Projection factor 2 for the mLSTM (qk-dim = v-dim), 1 for the sLSTM with
one output projection; a block is ``x + cell(norm(x))`` with no FFN. Plain
torch, as the JAX module is plain ``jnp``: no kernel of the port is on this
path.

The dtypes are the JAX package's, including where prefill and step part in
bf16: the conv taps ``[4, 2 d]`` and the gate projections ``w_i``, ``w_f``
``[2 d, H]`` are too small for ``cast_params_for_compute`` and stay fp32,
so the prefill's conv output and its gate products are fp32, while the
step casts its conv output back to the activation dtype; the sLSTM's R is
cast and promoted back to fp32 inside the step. States are fp32: mLSTM
``C`` [B, H, dh, dh], ``n`` [B, H, dh], ``m`` [B, H] (init -1e30) and
``conv_buf`` [B, CONV_W - 1, 2 d]; sLSTM ``h``, ``c``, ``n``, ``m`` [B, d]
(``m`` init -1e30).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import matmul
from repro_torch.utils import lecun_normal

CONV_W = 4
NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _di(cfg) -> int:
    return 2 * cfg.d_model  # projection factor 2


def init_mlstm(generator, cfg, device=None) -> dict:
    """The cell's parameters, drawn in the JAX package's key order."""
    d, di, H = cfg.d_model, _di(cfg), cfg.num_heads
    kw = dict(dtype=cfg.p_dtype, device=device)
    w_up = lecun_normal(generator, (d, 2 * di), **kw)   # -> (x_m, z)
    conv = (0.1 * torch.randn((CONV_W, di), generator=generator, device=device)).to(cfg.p_dtype)
    wq, wk, wv, w_i, w_f = (lecun_normal(generator, shape, **kw) for shape in
                            ((di, di), (di, di), (di, di), (di, H), (di, H)))
    w_down = lecun_normal(generator, (di, d), fan_in=di, **kw)
    return {"w_up": w_up, "conv": conv, "wq": wq, "wk": wk, "wv": wv, "w_i": w_i,
            "w_f": w_f, "b_i": torch.zeros((H,), **kw),
            "b_f": 3.0 * torch.ones((H,), **kw),     # forget-open init
            "norm": L.init_rmsnorm(di, cfg.p_dtype, device),   # multi-head out norm
            "w_down": w_down}


def _causal_conv(x, w):
    """Depthwise causal conv, width CONV_W. x [B, N, di], w [CONV_W, di],
    summed in the JAX package's order."""
    n = x.shape[1]
    out = w[-1] * x
    for t in range(CONV_W - 1):
        shift = CONV_W - 1 - t
        out = out + w[t] * F.pad(x, (0, 0, shift, 0))[:, :n]
    return out


def _mlstm_gates_qkv(params, cfg, x, conv_buf=None):
    B, N, _ = x.shape
    di, H = _di(cfg), cfg.num_heads
    dh = di // H
    up = matmul(x, params["w_up"])
    x_m, z = up[..., :di], up[..., di:]
    if conv_buf is None:
        x_c = F.silu(_causal_conv(x_m, params["conv"]))
    else:  # resume: the carried buffer supplies the conv left context
        ext = torch.cat([conv_buf.to(x_m.dtype), x_m], dim=1)
        x_c = F.silu(_causal_conv(ext, params["conv"])[:, CONV_W - 1:])
    q = matmul(x_c, params["wq"]).reshape(B, N, H, dh)
    k = matmul(x_c, params["wk"]).reshape(B, N, H, dh) / math.sqrt(dh)
    v = matmul(x_m, params["wv"]).reshape(B, N, H, dh)
    li = (matmul(x_c, params["w_i"]) + params["b_i"]).float()   # log input gate
    lf = F.logsigmoid((matmul(x_c, params["w_f"]) + params["b_f"]).float())
    return q, k, v, li, lf, z


def mlstm_chunked(q, k, v, li, lf, chunk: int = 64, return_state: bool = False,
                  init_state=None):
    """Stabilized chunkwise-parallel mLSTM.

    q/k/v: [B, N, H, dh]; li/lf: [B, N, H] (log input gate, log forget gate).
    ``init_state`` (C0, n0, m0) resumes the recurrence from a carried state
    (chunked prefill). Returns h [B, N, H, dh] (and the state at position N
    with ``return_state``: padding is state-transparent)."""
    B, N, H, dh = q.shape
    dt = torch.float32
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    pad = (-N) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    nc = q.shape[1] // chunk
    if init_state is None:
        C_p = torch.zeros((B, H, dh, dh), dtype=dt, device=q.device)
        n_p = torch.zeros((B, H, dh), dtype=dt, device=q.device)
        m_p = torch.full((B, H), NEG, dtype=dt, device=q.device)
    else:
        C_p, n_p, m_p = (s.to(dt) for s in init_state)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, lic, lfc = q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl]
        b = torch.cumsum(lfc, dim=1)                              # [B, W, H]
        a = torch.cummax(lic - b, dim=1).values                   # max_i (li_i - b_i)
        m = b + torch.maximum(a, m_p[:, None, :])                 # per-pos stabilizer
        # intra-chunk scores
        logw = b[:, :, None, :] - b[:, None, :, :] + lic[:, None, :, :] - m[:, :, None, :]
        w = torch.where(tri[None, :, :, None], torch.exp(logw), 0.0)   # [B, W, W, H]
        s = torch.einsum("bihd,bjhd->bijh", qc, kc) * w
        out_intra = torch.einsum("bijh,bjhd->bihd", s, vc)
        den_intra = s.sum(dim=2)                                  # [B, W, H]
        # inter-chunk
        scale = torch.exp(b + m_p[:, None, :] - m)                # [B, W, H]
        out_inter = torch.einsum("bihd,bhde->bihe", qc, C_p) * scale[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qc, n_p) * scale
        den = torch.abs(den_intra + den_inter)
        hs.append((out_intra + out_inter) / torch.maximum(den, torch.exp(-m))[..., None])
        # carry update (state at chunk end, stabilized by m_W)
        m_W = m[:, -1, :]                                         # [B, H]
        wk_end = torch.exp(b[:, -1, None, :] - b + lic - m_W[:, None, :])   # [B, W, H]
        decay = torch.exp(b[:, -1, :] + m_p - m_W)
        C_p = torch.einsum("bjhd,bjhe->bhde", wk_end[..., None] * kc, vc) \
            + decay[..., None, None] * C_p
        n_p = torch.einsum("bjh,bjhd->bhd", wk_end, kc) + decay[..., None] * n_p
        m_p = m_W
    h = torch.cat(hs, dim=1)[:, :N]
    if return_state:
        return h, (C_p, n_p, m_p)
    return h


def _mlstm_out(params, x, h, z):
    """Multi-head out norm, the output gate silu(z) and the down projection."""
    B, N, _ = x.shape
    h = h.reshape(B, N, -1).to(x.dtype)
    h = L.rms_norm(params["norm"], h) * F.silu(z)
    return matmul(h, params["w_down"])


def apply_mlstm(params, cfg, x):
    """The cell over a whole sequence x [B, N, d] from a zero state."""
    N = x.shape[1]
    q, k, v, li, lf, z = _mlstm_gates_qkv(params, cfg, x)
    h = mlstm_chunked(q, k, v, li, lf, chunk=min(64, max(8, N)))
    return _mlstm_out(params, x, h, z)


def mlstm_prefill(params, cfg, x, state=None, valid=None):
    """Parallel prefill: outputs + the exact streaming state (C, n, m,
    conv_buf).

    ``state`` (optional) resumes from a carried state: (C, n, m) seed the
    chunkwise scan and the conv buffer supplies the conv's left context.
    ``valid`` (optional [B] ints): positions >= valid[b] are padding, made
    state-transparent through the gates (log-forget 0, log-input -1e30),
    and the conv buffer is gathered per row from [old buffer || chunk] at
    valid[b] + j. Without ``valid``, a chunk shorter than CONV_W - 1 keeps
    the old buffer's head."""
    B, N, _ = x.shape
    di = _di(cfg)
    if valid is not None and state is None:
        state = init_mlstm_state(cfg, B, device=x.device)
    conv_buf = None if state is None else state["conv_buf"]
    init = None if state is None else (state["C"], state["n"], state["m"])
    q, k, v, li, lf, z = _mlstm_gates_qkv(params, cfg, x, conv_buf=conv_buf)
    if valid is not None:
        valid = valid.to(device=x.device, dtype=torch.int64)
        live = torch.arange(N, device=x.device)[None, :, None] < valid[:, None, None]
        li = torch.where(live, li, NEG)
        lf = torch.where(live, lf, 0.0)
    h, (C, n, m) = mlstm_chunked(q, k, v, li, lf, chunk=min(64, max(8, N)),
                                 return_state=True, init_state=init)
    y = _mlstm_out(params, x, h, z)
    # conv buffer: the last CONV_W - 1 pre-conv activations
    x_m = matmul(x, params["w_up"])[..., :di].float()
    if valid is not None:
        rows = torch.arange(B, device=x.device)
        extb = torch.cat([state["conv_buf"], x_m], dim=1)
        bidx = valid[:, None] + torch.arange(CONV_W - 1, device=x.device)[None, :]
        return y, {"C": C, "n": n, "m": m, "conv_buf": extb[rows[:, None], bidx]}
    buf = torch.zeros((B, CONV_W - 1, di), dtype=torch.float32, device=x.device)
    take = min(CONV_W - 1, N)
    if take:
        buf[:, CONV_W - 1 - take:] = x_m[:, N - take:]
    if state is not None and N < CONV_W - 1:
        buf[:, :CONV_W - 1 - N] = state["conv_buf"][:, N:]
    return y, {"C": C, "n": n, "m": m, "conv_buf": buf}


def init_mlstm_state(cfg, batch: int, device=None) -> dict:
    di, H = _di(cfg), cfg.num_heads
    dh = di // H
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **kw),
            "n": torch.zeros((batch, H, dh), **kw),
            "m": torch.full((batch, H), NEG, **kw),
            "conv_buf": torch.zeros((batch, CONV_W - 1, di), **kw)}


def apply_mlstm_step(params, cfg, x_t, state):
    """The exact sequential mLSTM update of one token x_t [B, d]:
    (y [B, d], the advanced state)."""
    B, _ = x_t.shape
    di, H = _di(cfg), cfg.num_heads
    dh = di // H
    up = matmul(x_t, params["w_up"])
    x_m, z = up[..., :di], up[..., di:]
    window = torch.cat([state["conv_buf"], x_m.float()[:, None]], dim=1)
    x_c = F.silu(torch.einsum("bwd,wd->bd", window, params["conv"].float()))
    x_c = x_c.to(x_t.dtype)
    q = matmul(x_c, params["wq"]).reshape(B, H, dh).float()
    k = (matmul(x_c, params["wk"]) / math.sqrt(dh)).reshape(B, H, dh).float()
    v = matmul(x_m, params["wv"]).reshape(B, H, dh).float()
    li = (matmul(x_c, params["w_i"]) + params["b_i"]).float()    # [B, H]
    lf = F.logsigmoid((matmul(x_c, params["w_f"]) + params["b_f"]).float())
    m_new = torch.maximum(lf + state["m"], li)
    sc_f = torch.exp(lf + state["m"] - m_new)
    sc_i = torch.exp(li - m_new)
    C = sc_f[..., None, None] * state["C"] + sc_i[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = sc_f[..., None] * state["n"] + sc_i[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, di).to(x_t.dtype)
    h = L.rms_norm(params["norm"], h[:, None, :])[:, 0] * F.silu(z)
    y = matmul(h, params["w_down"])
    return y, {"C": C, "n": n, "m": m_new, "conv_buf": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(generator, cfg, device=None) -> dict:
    """The cell's parameters, drawn in the JAX package's key order."""
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    kw = dict(dtype=cfg.p_dtype, device=device)
    w_in = lecun_normal(generator, (d, 4 * d), **kw)             # z, i, f, o
    r = (0.1 * torch.randn((4, H, dh, dh), generator=generator, device=device)
         ).to(cfg.p_dtype)                                        # block-diag R
    w_out = lecun_normal(generator, (d, d), **kw)
    zeros = torch.zeros((d,), **kw)
    return {"w_in": w_in, "r": r,
            "b": torch.cat([zeros, zeros, 3.0 * torch.ones((d,), **kw), zeros]),
            "norm": L.init_rmsnorm(d, cfg.p_dtype, device), "w_out": w_out}


def _slstm_step_core(params, cfg, x_proj_t, st):
    """x_proj_t: [B, 4d] input projections + bias, st: the state of the
    previous token; returns the next state."""
    H, d = cfg.num_heads, cfg.d_model
    dh = d // H
    B = x_proj_t.shape[0]
    hh = st["h"].reshape(B, H, dh)
    rec = torch.einsum("bhd,ghde->bghe", hh, params["r"].float())   # [B, 4, H, dh]
    pre = x_proj_t.float().reshape(B, 4, d) + rec.reshape(B, 4, d)
    z = torch.tanh(pre[:, 0])
    li = pre[:, 1]                          # log input gate (exp gating)
    lf = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(lf + st["m"], li)
    sc_f = torch.exp(lf + st["m"] - m_new)
    sc_i = torch.exp(li - m_new)
    c = sc_f * st["c"] + sc_i * z
    n = sc_f * st["n"] + sc_i
    h = o * c / torch.clamp(n, min=1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_out(params, x, hs):
    """The per-token hidden states [B, N, d] through the out norm and the
    output projection."""
    h = L.rms_norm(params["norm"], torch.stack(hs, dim=1).to(x.dtype))
    return matmul(h, params["w_out"])


def _fp32_r(params) -> dict:
    """params with R promoted to fp32 once for a loop of steps (each step
    promotes it again, as JAX's does: then a no-op)."""
    return {**params, "r": params["r"].float()}


def apply_slstm(params, cfg, x):
    """The recurrence over a whole sequence x [B, N, d] from a zero state,
    one step per token (h_{t-1} feeds the gates)."""
    x_proj = matmul(x, params["w_in"]) + params["b"]     # [B, N, 4d]
    st, hs, p = init_slstm_state(cfg, x.shape[0], device=x.device), [], _fp32_r(params)
    for t in range(x.shape[1]):
        st = _slstm_step_core(p, cfg, x_proj[:, t], st)
        hs.append(st["h"])
    return _slstm_out(params, x, hs)


def slstm_prefill(params, cfg, x, state=None, valid=None):
    """The recurrence over a chunk: outputs + the final state. ``state``
    (optional) resumes mid-prompt. ``valid`` (optional [B] ints): a step at
    position >= valid[b] keeps row b's previous state (a per-row ``where``),
    so the final state is exactly the state after valid[b] tokens."""
    B, N, _ = x.shape
    x_proj = matmul(x, params["w_in"]) + params["b"]
    st = init_slstm_state(cfg, B, device=x.device) if state is None else state
    if valid is not None:
        live = torch.arange(N, device=x.device)[:, None] < valid.to(x.device)[None, :]
    hs, p = [], _fp32_r(params)
    for t in range(N):
        new = _slstm_step_core(p, cfg, x_proj[:, t], st)
        if valid is not None:
            new = {k: torch.where(live[t][:, None], new[k], st[k]) for k in st}
        st = new
        hs.append(st["h"])
    return _slstm_out(params, x, hs), st


def init_slstm_state(cfg, batch: int, device=None) -> dict:
    d = cfg.d_model
    kw = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), **kw), "c": torch.zeros((batch, d), **kw),
            "n": torch.zeros((batch, d), **kw), "m": torch.full((batch, d), NEG, **kw)}


def apply_slstm_step(params, cfg, x_t, state):
    """One token x_t [B, d]: (y [B, d], the advanced state)."""
    xp = matmul(x_t, params["w_in"]) + params["b"]
    new = _slstm_step_core(params, cfg, xp, state)
    h = L.rms_norm(params["norm"], new["h"].to(x_t.dtype)[:, None, :])[:, 0]
    return matmul(h, params["w_out"]), new
