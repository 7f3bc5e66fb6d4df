"""Host side of the STLT scan: operator precompute and device dispatch.

``stlt_scan`` builds K1's per-row chunk operators from the poles and mixers
(plain torch, tiny and N-independent), then runs the scan in ONE pass: the
Hopper kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.
There is no fallback: a CUDA tensor launches the kernel or raises. Kernel
launches are counted in ``stlt_scan_kernel.launches``.

Unlike the JAX package's ``_run_kernel``, nothing is padded here: the
kernel reads rows past N as zeros and takes any d without padding it to a
block width.

Carry I/O: ``h0_re/h0_im`` [BH, S, d] seed the scan; with ``return_state``
the carry after ``valid[row]`` tokens (default N) comes back from the same
pass, through the gated in-chunk snapshot operators (``_snapshot_ops``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import scan as scan_lib
from repro_torch.kernels.stlt_scan import stlt_scan_kernel, stlt_scan_reference


def _filter_ops(log_mag, theta, u_re, u_im, chunk: int):
    """Per-row chunk operators from poles — all [BH, S] inputs ->

      g   [BH, C]     combined causal filter g[t] = Re(sum_k u_k lambda_k^t)
      A,B [BH, C, S]  carry injection (z_carry[i] = A[i,k] h_re + B[i,k] h_im)
      pre,pim [BH, S, C]  carry gather (h'[k] += sum_j lambda^(C-1-j) x[j])
      dec [BH, 2, S]  chunk-to-chunk decay lambda^C
    """
    C = chunk
    pw_re, pw_im = scan_lib._chunk_powers(log_mag, theta, C)   # [BH, C+1, S]
    g = (torch.einsum("bts,bs->bt", pw_re[:, :C], u_re)
         - torch.einsum("bts,bs->bt", pw_im[:, :C], u_im))
    a_re, a_im = pw_re[:, 1:], pw_im[:, 1:]                     # lambda^(i+1)
    A = u_re[:, None, :] * a_re - u_im[:, None, :] * a_im
    B = -(u_re[:, None, :] * a_im + u_im[:, None, :] * a_re)
    rev = torch.arange(C - 1, -1, -1, device=log_mag.device)
    pre = pw_re[:, rev].transpose(1, 2)
    pim = pw_im[:, rev].transpose(1, 2)
    dec = torch.stack([pw_re[:, C], pw_im[:, C]], dim=1)
    return g, A, B, pre, pim, dec


def _toeplitz(g):
    """g [BH, C] -> lower-triangular Toeplitz M [BH, C, C]."""
    C = g.shape[-1]
    idx = torch.arange(C, device=g.device)
    diff = idx[:, None] - idx[None, :]
    return torch.where(diff >= 0, g[:, diff.clamp(0, C - 1)],
                       torch.zeros((), device=g.device))


def _snapshot_ops(log_mag, theta, valid, n_tokens: int, chunk: int, nc: int):
    """Per-row carry-snapshot operators for a snapshot at token ``valid[row]``
    (``n_tokens`` when valid is None): (spre, spim [BH, S, C],
    sdec [BH, 2, S], gate [BH, nc] int32). The gate fires in chunk
    c* = max(q-1, 0)//C only, and never for valid == 0 rows."""
    BH = log_mag.shape[0]
    if valid is None:
        q = torch.full((BH,), n_tokens, dtype=torch.int64, device=log_mag.device)
    else:
        q = valid.to(torch.int64)
    cstar, w_re, w_im, d_re, d_im = scan_lib.stlt_snapshot_operators(
        log_mag, theta, q, chunk)
    spre = w_re.transpose(1, 2)
    spim = w_im.transpose(1, 2)
    sdec = torch.stack([d_re, d_im], dim=1)
    chunks = torch.arange(nc, device=log_mag.device)
    gate = (chunks[None, :] == cstar[:, None]) & (q > 0)[:, None]
    return spre, spim, sdec, gate.to(torch.int32)


def stlt_scan(
    x: torch.Tensor,          # [BH, N, d]
    log_mag: torch.Tensor,    # [BH, S]
    theta: torch.Tensor,
    u_re: torch.Tensor,
    u_im: torch.Tensor,
    *,
    chunk: int = 128,
    h0_re: Optional[torch.Tensor] = None,   # [BH, S, d] initial carry
    h0_im: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,   # [BH] per-row valid length
    return_state: bool = False,
):
    """Fused factorized causal STLT: z = Re(sum_k u_k * scan(lambda_k, x)).

    Returns z [BH, N, d] in x's dtype, and with ``return_state`` also
    (h_re, h_im) [BH, S, d] fp32: the carry after ``valid[row]`` tokens."""
    BH, N, d = x.shape
    S = log_mag.shape[-1]
    if x.device.type == "cuda":
        run = stlt_scan_kernel
    elif x.device.type == "cpu":
        run = stlt_scan_reference
    else:
        raise ValueError(f"stlt_scan runs on cuda or cpu, not {x.device}")
    f32 = torch.float32
    lm, th = log_mag.to(f32), theta.to(f32)
    g, A, B, pre, pim, dec = _filter_ops(lm, th, u_re.to(f32), u_im.to(f32),
                                         chunk)
    nc = -(-N // chunk)
    spre, spim, sdec, gate = _snapshot_ops(lm, th, valid, N, chunk, nc)
    if h0_re is None:
        h0_re = h0_im = torch.zeros((BH, S, d), dtype=f32, device=x.device)
    operands = [t.to(f32).contiguous() for t in (
        x, _toeplitz(g), A, B, pre, pim, dec, h0_re, h0_im, spre, spim, sdec)]
    z, h_re, h_im = run(gate, *operands, chunk=chunk)
    z = z.to(x.dtype)
    if return_state:
        return z, (h_re, h_im)
    return z
