"""Linear recurrences and the STLT recurrence algebra around the scan kernel.

The fused chunked scan itself lives behind ``kernels/ops.stlt_scan`` (the
Hopper kernel on the card, its plain version on the CPU). This module keeps
the generic first-order recurrence

    h_n = a_n * h_{n-1} + b_n          (complex or real, diagonal)

in two engines, ``scan_sequential`` (one step a token: the oracle) and
``scan_associative`` (the JAX package's log-depth ``lax.associative_scan``;
here a chunked closed form, see its docstring), and the closed-form pieces
around the kernel: pole powers, the per-row carry-snapshot operators, and
the single-token decode step (plain torch — the JAX package has no kernel
for decode either).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _aligned_inputs(a, b, axis: int):
    """a and b with the ranks of their broadcast shape, the time axis
    resolved, and their common dtype."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    nd = len(shape)
    dt = torch.promote_types(a.dtype, b.dtype)
    a = a.reshape((1,) * (nd - a.ndim) + tuple(a.shape)).to(dt)
    b = b.reshape((1,) * (nd - b.ndim) + tuple(b.shape)).to(dt)
    return a, b, shape, axis % nd


def scan_sequential(a, b, h0: Optional[torch.Tensor] = None, axis: int = -2,
                    reverse: bool = False):
    """h_n = a_n * h_{n-1} + b_n, one token at a time (the oracle). ``a``
    broadcasts against ``b`` (a static decay has size 1 on the time axis);
    ``h0`` is the initial state (zeros by default); ``reverse`` scans
    anti-causally. Returns h, shaped as a and b broadcast together."""
    a, b, shape, axis = _aligned_inputs(a, b, axis)
    a_t = a.expand(shape).movedim(axis, 0)
    b_t = b.expand(shape).movedim(axis, 0)
    h = torch.zeros(b_t.shape[1:], dtype=b_t.dtype, device=b_t.device) if h0 is None \
        else h0.to(b_t.dtype)
    N = b_t.shape[0]
    out = [None] * N
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        h = a_t[t] * h + b_t[t]
        out[t] = h
    return torch.stack(out, dim=axis)


def _powers(a, length: int):
    """a^p for p in [0, length] by repeated doubling: [length + 1, *a.shape]."""
    pw = torch.stack([torch.ones_like(a), a])
    while pw.shape[0] < length + 1:
        pw = torch.cat([pw, pw * (pw[-1] * a)])
    return pw[:length + 1]


def _scan_static(a, b, shape, axis: int, chunk: int, reverse: bool):
    """The recurrence with a decay constant over time, in closed form:
    within a chunk of C tokens L[i] = sum_{j<=i} a^(i-j) b[j] (j >= i and
    a^(j-i) anti-causally) is one batched product with the Toeplitz
    operator of a's powers, and across chunks the carry enters as
    L_c[i] += a^(i+1) h_{c-1}, h_c = a^C h_{c-1} + L_c[C-1] (anti-causally
    a^(C-i) h_{c+1}, h_c = a^C h_{c+1} + L_c[0]: no flips). The dims where
    only a varies become rows of the product and those where only b varies
    its columns, so neither input is broadcast in memory, and the result is
    one [.., nc*C, ..] buffer narrowed to N tokens (not contiguous when N
    is not a multiple of C). Autograd saves the operators and b, never a
    per-level history."""
    N = b.shape[axis]
    C = max(1, min(chunk, N))
    nc = -(-N // C)
    a = a.movedim(axis, 0)[0]                              # [*rest] (1s broadcast)
    b = b.movedim(axis, 0)                                 # [N, *rest]
    rest = [s for i, s in enumerate(shape) if i != axis]
    va = [a.shape[i] > 1 for i in range(len(rest))]
    vb = [b.shape[i + 1] > 1 for i in range(len(rest))]
    P = [i for i in range(len(rest)) if va[i] and vb[i]]
    QA = [i for i in range(len(rest)) if va[i] and not vb[i]]
    QB = [i for i in range(len(rest)) if vb[i] and not va[i]]
    ONE = [i for i in range(len(rest)) if not (va[i] or vb[i])]
    nP = math.prod(rest[i] for i in P)
    nQA = math.prod(rest[i] for i in QA)
    nQB = math.prod(rest[i] for i in QB)
    a2 = a.permute(P + QA + QB + ONE).reshape(nP, nQA)
    b2 = b.permute([0] + [i + 1 for i in P + QB + QA + ONE]).reshape(N, nP, nQB)
    b2 = F.pad(b2, (0, 0, 0, 0, 0, nc * C - N)) if nc * C > N else b2
    pw = _powers(a2, C)                                    # [C+1, nP, nQA]
    idx = torch.arange(C, device=b.device)
    lag = idx[:, None] - idx[None, :]                      # [C, C] (i, j): i - j
    if reverse:
        lag = -lag
    tri = pw[lag.clamp(min=0)] * (lag >= 0)[..., None, None].to(pw.dtype)
    tri = tri.permute(2, 0, 3, 1).reshape(nP, C * nQA, C)  # [P, (i, qa), j]
    bc = b2.reshape(nc, C, nP, nQB).permute(2, 1, 0, 3).reshape(nP, C, nc * nQB)
    L = (tri @ bc).reshape(nP, C, nQA, nc, nQB)
    # the carries entering each chunk [P, QA, nc, QB], then their injection
    edge, dec = L[:, 0 if reverse else C - 1], pw[C][..., None]
    h = torch.zeros_like(edge[:, :, 0])
    starts = [None] * nc
    for c in (range(nc - 1, -1, -1) if reverse else range(nc)):
        starts[c] = h
        h = dec * h + edge[:, :, c]
    inj = (pw.flip(0)[:C] if reverse else pw[1:]).permute(1, 0, 2)[..., None, None]
    L = L.add_(inj * torch.stack(starts, dim=2)[:, None])  # [P, C, QA, nc, QB]
    # back to the broadcast shape's order, (nc, C) merged on the time axis
    pos, k = {}, 0
    for group in (P, "C", QA, "nc", QB, ONE):
        for i in ([group] if isinstance(group, str) else group):
            pos[i], k = k, k + 1
    L = L.reshape([rest[i] for i in P] + [C] + [rest[i] for i in QA] + [nc]
                  + [rest[i] for i in QB] + [1] * len(ONE))
    perm = []
    for d in range(len(shape)):
        perm += [pos["nc"], pos["C"]] if d == axis else [pos[d if d < axis else d - 1]]
    full = list(shape)
    full[axis] = nc * C
    return L.permute(perm).reshape(full).narrow(axis, 0, N)


def _scan_varying(a, b, shape, axis: int, chunk: int):
    """The causal recurrence with a decay that varies over time: each chunk
    of C tokens is scanned one position at a time, all chunks at once,
    keeping the running products of a; then the chunk-start carries enter
    as L_c[i] += (prod_{m<=i} a_c[m]) h_{c-1}. O(C + N/C) steps."""
    N = shape[axis]
    C = max(1, min(chunk, N))
    nc = -(-N // C)
    a_t = a.expand(shape).movedim(axis, 0)
    b_t = b.expand(shape).movedim(axis, 0)
    if nc * C > N:
        pad = (0, 0) * (len(shape) - 1) + (0, nc * C - N)
        a_t, b_t = F.pad(a_t, pad), F.pad(b_t, pad)
    a_c = a_t.reshape((nc, C) + a_t.shape[1:])
    b_c = b_t.reshape((nc, C) + b_t.shape[1:])
    h = torch.zeros_like(b_c[:, 0])
    prod = torch.ones_like(a_c[:, 0])
    loc, prods = [], []
    for i in range(C):
        h = a_c[:, i] * h + b_c[:, i]
        prod = prod * a_c[:, i]
        loc.append(h)
        prods.append(prod)
    loc, prods = torch.stack(loc, 1), torch.stack(prods, 1)   # [nc, C, *rest]
    carry = torch.zeros_like(loc[0, 0])
    starts = []
    for c in range(nc):
        starts.append(carry)
        carry = loc[c, C - 1] + prods[c, C - 1] * carry
    L = loc + prods * torch.stack(starts)[:, None]
    return L.reshape((nc * C,) + L.shape[2:])[:N].movedim(0, axis)


def scan_associative(a, b, axis: int = -2, reverse: bool = False, chunk: int = 64):
    """The same recurrence as ``scan_sequential`` (zero initial state), the
    port's counterpart of the JAX package's ``lax.associative_scan`` engine.

    A log-depth doubling would save every level under autograd (11 of them
    at 1500 tokens); this is a chunked closed form instead, O(output) memory:
    a decay constant over time (size 1 on ``axis``, the STLT's poles) takes
    ``_scan_static`` (batched products with the chunk's power operator,
    either direction without flips), any other ``_scan_varying``. The
    result may be a strided view. ``a`` and ``b`` broadcast against each other
    and the result has their broadcast shape, so a per-node pole [.., 1, S, 1]
    and per-token inputs [.., N, 1, d] give [.., N, S, d] without either
    input being expanded in memory."""
    a, b, shape, axis = _aligned_inputs(a, b, axis)
    if a.shape[axis] == 1:
        return _scan_static(a, b, shape, axis, chunk, reverse)
    if reverse:
        return _scan_varying(a.flip(axis), b.flip(axis), shape, axis, chunk).flip(axis)
    return _scan_varying(a, b, shape, axis, chunk)


def _chunk_powers(log_mag: torch.Tensor, theta: torch.Tensor, length: int):
    """lambda^p for p in [0, length] as (real, imag): log_mag/theta [..., S]
    -> [..., length+1, S]."""
    p = torch.arange(length + 1, dtype=log_mag.dtype,
                     device=log_mag.device)[:, None]
    mag = torch.exp(p * log_mag[..., None, :])
    ang = p * theta[..., None, :]
    return mag * torch.cos(ang), mag * torch.sin(ang)


def stlt_snapshot_operators(log_mag, theta, q, chunk: int):
    """Per-row in-chunk snapshot operators for a carry snapshot at token
    index ``q[b]``.

    With c* = max(q-1, 0)//C the chunk containing token q-1 and r = q - c*·C
    the in-chunk offset (r = 0 for q = 0):

        w[b, j, k] = lambda_k^(r_b-1-j)  for j < r_b, else 0
        d[b, k]    = lambda_k^(r_b)

    log_mag/theta: [S] shared or [B, S] per-row; q: [B] ints in [0, N].
    Returns (cstar [B] int64, w_re, w_im [B, C, S], d_re, d_im [B, S]).
    """
    C = chunk
    q = q.to(torch.int64)
    cstar = torch.clamp(q - 1, min=0) // C
    r = (q - cstar * C).to(torch.float32)
    lm = log_mag if log_mag.ndim == 2 else log_mag[None, :]
    th = theta if theta.ndim == 2 else theta[None, :]
    j = torch.arange(C, dtype=torch.float32, device=lm.device)
    e = r[:, None] - 1.0 - j[None, :]
    live = e >= 0.0
    e = torch.where(live, e, torch.zeros_like(e))
    mag = torch.where(live[..., None], torch.exp(e[..., None] * lm[:, None, :]),
                      torch.zeros((), device=lm.device))
    ang = e[..., None] * th[:, None, :]
    dmag = torch.exp(r[:, None] * lm)
    return (cstar, mag * torch.cos(ang), mag * torch.sin(ang),
            dmag * torch.cos(r[:, None] * th), dmag * torch.sin(r[:, None] * th))


def stlt_carry_snapshot(x_star, h_start_re, h_start_im, log_mag, theta, q,
                        chunk: int):
    """Per-row carry at token index ``q[b]`` from the chunk containing token
    q-1 and the carry at that chunk's start:

        h_q = sum_{j<r} lambda^(r-1-j) x_star[j]  +  lambda^r h_start

    x_star [batch, C, d]; h_start_re/im [batch, S, d]; q [batch].
    Returns (h_re, h_im) [batch, S, d].
    """
    _, w_re, w_im, d_re, d_im = stlt_snapshot_operators(log_mag, theta, q, chunk)
    s_re = torch.einsum("bcs,bcd->bsd", w_re, x_star)
    s_im = torch.einsum("bcs,bcd->bsd", w_im, x_star)
    h_re = s_re + d_re[..., None] * h_start_re - d_im[..., None] * h_start_im
    h_im = s_im + d_re[..., None] * h_start_im + d_im[..., None] * h_start_re
    return h_re, h_im


def stlt_window_state(x, h0_re, h0_im, log_mag, theta, q):
    """Carry after the first ``q[b]`` tokens of a short window ``x``
    [batch, L, d] resumed from ``h0``: the speculative-decode rollback. The
    window is one chunk, so its chunk-start carry is ``h0`` and the state at
    the accepted length is one closed-form snapshot; tokens at and past
    ``q[b]`` never touch it. ``q == 0`` rows give h0 (up to the exact
    lambda^0 = 1 products)."""
    return stlt_carry_snapshot(x, h0_re, h0_im, log_mag, theta, q,
                               chunk=x.shape[-2])


def stlt_decode_step(x_t, h_re, h_im, log_mag, theta, u_re, u_im):
    """Single-token streaming update: O(S*d) state and work.

    x_t [..., d]; h_re/h_im [..., S, d]; log_mag/theta [..., S] (broadcast);
    u_re/u_im [..., S]. Returns (z_t [..., d], h_re', h_im').
    """
    a_re = torch.exp(log_mag) * torch.cos(theta)
    a_im = torch.exp(log_mag) * torch.sin(theta)
    h_re_new = (a_re[..., :, None] * h_re - a_im[..., :, None] * h_im
                + x_t[..., None, :])
    h_im_new = a_re[..., :, None] * h_im + a_im[..., :, None] * h_re
    z = (h_re_new * u_re[..., :, None] - h_im_new * u_im[..., :, None]).sum(dim=-2)
    return z, h_re_new, h_im_new
