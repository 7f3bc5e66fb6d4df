"""Griffin / RecurrentGemma recurrent block (arXiv:2402.19427), the port's
counterpart of the JAX package's ``models/rglru.py``, function for function.

Block = two parallel branches over the normed input:
  gate branch:  gelu(x W_gate)
  rec branch:   x W_x -> causal depthwise conv (width 4) -> RG-LRU
output = (gate * rec) W_out.

RG-LRU (real gated linear recurrence unit, per channel):
  r_t = sigmoid(x_t W_a + b_a)          recurrence gate
  i_t = sigmoid(x_t W_i + b_i)          input gate
  a_t = exp(c * r_t * log(a_param))     with a_param = sigmoid(Lambda), c = 8
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is linear with input-dependent decay, so the whole-sequence
forms run it through ``core/scan.scan_associative`` (its varying-decay
engine); the decode step is one update. Plain torch, as the JAX module is
plain ``jnp``: no kernel of the port is on this path.

The dtypes are the JAX package's, including where prefill and step part in
bf16: the conv weight ``[4, d]`` is too small for ``cast_params_for_compute``
and stays fp32, so the prefill's conv output is fp32 and its gate products
run in fp32, while the step casts its fp32 conv output back to the
activation dtype before the gates. The state is fp32: ``h`` [B, d] and the
conv window's last ``CONV_W - 1`` inputs ``conv_buf`` [B, CONV_W - 1, d].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import scan as scan_lib
from repro_torch.models.layers import matmul
from repro_torch.utils import lecun_normal

CONV_W = 4
C_EXP = 8.0


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def init_rglru_block(generator, cfg, device=None) -> dict:
    """The block's parameters, drawn in the JAX package's key order."""
    d = cfg.d_model
    kw = dict(dtype=cfg.p_dtype, device=device)
    w_gate = lecun_normal(generator, (d, d), **kw)
    w_x = lecun_normal(generator, (d, d), **kw)
    conv = (0.1 * torch.randn((CONV_W, d), generator=generator, device=device)).to(cfg.p_dtype)
    w_a = lecun_normal(generator, (d, d), **kw)
    # a_param init so that a^c is in ~[0.9, 0.999] (long memory at init)
    lam0 = 0.9 + (0.999 - 0.9) * torch.rand((d,), generator=generator, device=device)
    root = lam0 ** (1.0 / C_EXP)
    lambda_init = torch.log(root / (1 - root))
    w_i = lecun_normal(generator, (d, d), **kw)
    w_out = lecun_normal(generator, (d, d), **kw)
    return {"w_gate": w_gate, "w_x": w_x, "conv": conv, "w_a": w_a,
            "b_a": torch.zeros((d,), **kw), "w_i": w_i, "b_i": torch.zeros((d,), **kw),
            "lam": lambda_init.to(cfg.p_dtype), "w_out": w_out}


def _conv_causal(x, w):
    """Causal depthwise conv of x [B, N, d] with taps w [CONV_W, d] (the
    last tap on the current token), summed in the JAX package's order."""
    n = x.shape[1]
    out = w[-1] * x
    for t in range(CONV_W - 1):
        shift = CONV_W - 1 - t
        out = out + w[t] * F.pad(x, (0, 0, shift, 0))[:, :n]
    return out


def _rglru_gates(params, xc, gather=None):
    """a_t [.., d] in (0, 1) and the gated input, both fp32. ``gather``
    (tensor parallel: ``xc`` holds the rank's channels and ``params`` its
    columns) gives the whole conv output the gates' d x d products read."""
    xa = xc if gather is None else gather(xc)
    log_a_param = F.logsigmoid(params["lam"].float())
    r = torch.sigmoid((matmul(xa, params["w_a"]) + params["b_a"]).float())
    i = torch.sigmoid((matmul(xa, params["w_i"]) + params["b_i"]).float())
    a = torch.exp(C_EXP * r * log_a_param)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-8)) * (i * xc.float())
    return a, gated_in


def apply_rglru_block(params, cfg, x, gather=None):
    """The block over a whole sequence x [B, N, d] from a zero state
    (``gather``: ``_rglru_gates``')."""
    gate = _gelu(matmul(x, params["w_gate"]))
    xc = _conv_causal(matmul(x, params["w_x"]), params["conv"])
    a, b = _rglru_gates(params, xc, gather)
    h = scan_lib.scan_associative(a, b, axis=-2).to(x.dtype)   # input-dependent real poles
    return matmul(gate * h, params["w_out"])


def init_rglru_state(cfg, batch: int, device=None) -> dict:
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv_buf": torch.zeros((batch, CONV_W - 1, d), dtype=torch.float32,
                                    device=device)}


def rglru_prefill(params, cfg, x, state=None, valid=None, gather=None):
    """Parallel prefill: outputs + final recurrent state + conv buffer.

    ``state`` (optional) resumes from a carried state: the conv buffer
    supplies the depthwise conv's left context and the carry ``h0`` enters
    by linearity, h_n += (prod_{t<=n} a_t) h0, on top of the zero-state
    scan (one ``cumprod`` over the chunk).

    ``valid`` (optional [B] ints): positions >= valid[b] are padding. The
    carried ``h`` is read at position valid[b] - 1 (position 0 for a
    valid == 0 row, whose state the caller's per-row select keeps) and the
    conv buffer is gathered per row from [old buffer || chunk] at
    valid[b] + j, so padded steps never enter the state. Without ``valid``,
    a chunk shorter than CONV_W - 1 keeps the old buffer's head.
    """
    B, N = x.shape[0], x.shape[1]
    if valid is not None and state is None:
        state = init_rglru_state(cfg, B, device=x.device)
    gate = _gelu(matmul(x, params["w_gate"]))
    xr = matmul(x, params["w_x"])
    if state is None:
        xc = _conv_causal(xr, params["conv"])
    else:
        ext = torch.cat([state["conv_buf"].to(xr.dtype), xr], dim=1)
        xc = _conv_causal(ext, params["conv"])[:, CONV_W - 1:]
    a, b = _rglru_gates(params, xc, gather)
    h = scan_lib.scan_associative(a, b, axis=-2)
    if state is not None:
        h = h + torch.cumprod(a, dim=-2) * state["h"][:, None, :]
    y = matmul(gate * h.to(x.dtype), params["w_out"])
    if valid is not None:
        valid = valid.to(device=x.device, dtype=torch.int64)
        rows = torch.arange(B, device=x.device)
        h_last = h[rows, torch.clamp(valid - 1, min=0)]
        # conv buffer slot j (oldest first) holds the token at chunk offset
        # valid - (CONV_W-1) + j == extended index valid + j; offsets < 0
        # resolve into the carried old buffer, exactly as "no input yet"
        extb = torch.cat([state["conv_buf"], xr.float()], dim=1)
        bidx = valid[:, None] + torch.arange(CONV_W - 1, device=x.device)[None, :]
        return y, {"h": h_last, "conv_buf": extb[rows[:, None], bidx]}
    buf = torch.zeros((B, CONV_W - 1, xr.shape[-1]), dtype=torch.float32, device=x.device)
    take = min(CONV_W - 1, N)
    if take:
        buf[:, CONV_W - 1 - take:] = xr[:, N - take:].float()
    if state is not None and N < CONV_W - 1:
        # short chunk: the old buffer still supplies the head of the window
        buf[:, :CONV_W - 1 - N] = state["conv_buf"][:, N:]
    return y, {"h": h[:, -1], "conv_buf": buf}


def apply_rglru_step(params, cfg, x_t, state, gather=None):
    """One token x_t [B, d]: (y [B, d], the advanced state) (``gather``:
    ``_rglru_gates``')."""
    gate = _gelu(matmul(x_t, params["w_gate"]))
    xr = matmul(x_t, params["w_x"]).float()
    window = torch.cat([state["conv_buf"], xr[:, None]], dim=1)
    xc = torch.einsum("bwd,wd->bd", window, params["conv"].float())
    a, b = _rglru_gates(params, xc.to(x_t.dtype), gather)
    h = a * state["h"] + b
    y = matmul(gate * h.to(x_t.dtype), params["w_out"])
    return y, {"h": h, "conv_buf": window[:, 1:]}

