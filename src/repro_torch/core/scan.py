"""STLT recurrence algebra shared by the scan kernel's host side and decode.

The fused chunked scan itself lives behind ``kernels/ops.stlt_scan`` (the
Hopper kernel on the card, its plain version on the CPU). This module keeps
the closed-form pieces around it: pole powers, the per-row carry-snapshot
operators, and the single-token decode step (plain torch — the JAX package
has no kernel for decode either).
"""
from __future__ import annotations

import torch


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
