"""Host side of the STLT scan: operator precompute, device dispatch and the
scan's custom VJP.

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

Training (no carry in, no state out) goes through ``_StltScan``, the port of
the JAX package's custom VJP, on both devices. z is a causal convolution
with the combined filter g[t] = Re(sum_k u_k lambda_k^t), so

  dL/dx               = the SAME pass run anti-causally over dz (K1 on the
                        card, launched by the same wrapper);
  dL/d(poles, mixers) = ``_analytic_param_grads``: the adjoints of the tiny
                        chunk operators (a forward carry recurrence and a
                        reverse adjoint recurrence over chunks), chained
                        through ``_filter_ops`` by autograd. No O(N*S*d)
                        tensor is materialized.

``reverse=True`` (anti-causal) flips x on the token axis, runs the one causal
pass and flips z back, as the JAX package's ``_run_kernel`` does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import scan as scan_lib
from repro_torch.kernels.stlt_scan import stlt_scan_kernel, stlt_scan_reference


def _filter_ops(log_mag, theta, u_re, u_im, chunk: int):
    """Per-row chunk operators from poles — all [BH, S] inputs ->

      g   [BH, C]     combined causal filter g[t] = Re(sum_k u_k lambda_k^t)
      A,B [BH, C, S]  carry injection (z_carry[i] = A[i,k] h_re + B[i,k] h_im)
      pre,pim [BH, S, C]  carry gather (h'[k] += sum_j lambda^(C-1-j) x[j])
      dec [BH, 2, S]  chunk-to-chunk decay lambda^C

    The analytic param grads chain through autograd of THIS function
    (everything downstream of it is linear in the operators)."""
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
                       torch.zeros((), dtype=g.dtype, device=g.device))


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


def _runner(x: torch.Tensor):
    """The one causal pass for x's device: K1 or its plain version."""
    if x.device.type == "cuda":
        return stlt_scan_kernel
    if x.device.type == "cpu":
        return stlt_scan_reference
    raise ValueError(f"stlt_scan runs on cuda or cpu, not {x.device}")


def _operators(log_mag, theta, u_re, u_im, chunk: int):
    """The pass's operators (M, A, B, pre, pim, dec), contiguous, in the
    poles' dtype."""
    g, A, B, pre, pim, dec = _filter_ops(log_mag, theta, u_re, u_im, chunk)
    return tuple(t.contiguous() for t in (_toeplitz(g), A, B, pre, pim, dec))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address, as K1's wrapper checks
    (a contiguous view into a larger buffer may start off alignment)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pass(x, operators, chunk: int, reverse: bool, run, h0=None, snapshot=None):
    """One pass of the scan over x with ``operators`` (``_operators``)
    through ``run`` (``_runner``) -> (z, h_re, h_im): the serving call and
    the training call both take it. ``h0`` (h0_re, h0_im) seeds the carry
    (zero when None). ``snapshot`` (spre, spim, sdec, gate) from
    ``_snapshot_ops`` takes the carry at each row's gated token; without it
    the gate never fires, the snapshot operators are unread (the carry
    operators stand in for them) and h_re/h_im are h0. ``reverse`` runs the
    pass anti-causally, on x flipped on the token axis: a snapshot then
    counts tokens from the end. Differentiable by autograd when ``run`` is
    the plain version."""
    BH, N, d = x.shape
    M, A, B, pre, pim, dec = operators
    if reverse:
        x = x.flip(1)
    if h0 is None:
        zero = torch.zeros((BH, pre.shape[1], d), dtype=x.dtype, device=x.device)
        h0 = (zero, zero)
    if snapshot is None:
        gate = torch.zeros((BH, -(-N // chunk)), dtype=torch.int32, device=x.device)
        snapshot = (pre, pim, dec, gate)
    spre, spim, sdec, gate = snapshot
    z, h_re, h_im = run(gate, _aligned(x), M, A, B, pre, pim, dec,
                        *(_aligned(h) for h in h0), spre.contiguous(),
                        spim.contiguous(), sdec.contiguous(), chunk=chunk)
    return (z.flip(1) if reverse else z), h_re, h_im


def _analytic_param_grads(x, dz, log_mag, theta, u_re, u_im, chunk: int,
                          reverse: bool):
    """dL/d(log_mag, theta, u_re, u_im) [BH, S] through the chunk operators,
    the port of the JAX package's analytic kernel path. In x's precision
    (float32, or float64 for float64 inputs).

    z depends on the params ONLY through (g, A, B, Pre, Pim, dec), so with
    X_c, dZ_c the chunks, h_c the forward chunk-START carries and G_c the
    adjoint of the carry AFTER chunk c (G_{nc-1} = 0):
      * dg[t]  = sum of the t-th lower diagonal of P = sum_c dZ_c X_c^T;
      * dA/dB  = sum_c dZ_c h_c^T (re / im);
      * dPre/dPim = sum_c G_c X_c^T (re / im), ddec from G_c and h_c;
      * the operator cotangents chain through autograd of ``_filter_ops``.
    Only the two carry recurrences run chunk by chunk; every contraction is
    one batched product over all chunks."""
    BH, N, d = x.shape
    C = chunk
    dt = torch.promote_types(x.dtype, torch.float32)
    xf, dzf = x.to(dt), dz.to(dt)
    if reverse:
        xf, dzf = xf.flip(1), dzf.flip(1)
    nc = -(-N // C)
    xc = F.pad(xf, (0, 0, 0, nc * C - N)).reshape(BH, nc, C, d)
    dzc = F.pad(dzf, (0, 0, 0, nc * C - N)).reshape(BH, nc, C, d)

    with torch.enable_grad():
        poles = [t.detach().to(dt).requires_grad_(True)
                 for t in (log_mag, theta, u_re, u_im)]
        ops_out = _filter_ops(*poles, C)
    _, A, B, pre, pim, dec = (t.detach() for t in ops_out)
    S = pre.shape[1]
    dec_re, dec_im = dec[:, 0, :, None], dec[:, 1, :, None]      # [BH, S, 1]

    # forward chunk-start carries h_c = (R_c, I_c) [BH, nc, S, d]
    u_re_c = pre[:, None] @ xc                                    # [BH, nc, S, d]
    u_im_c = pim[:, None] @ xc
    r = i = torch.zeros((BH, S, d), dtype=dt, device=x.device)
    R, I = [], []
    for c in range(nc):
        R.append(r)
        I.append(i)
        r, i = (u_re_c[:, c] + dec_re * r - dec_im * i,
                u_im_c[:, c] + dec_re * i + dec_im * r)
    R, I = torch.stack(R, 1), torch.stack(I, 1)

    # reverse adjoint recurrence: G_c, the adjoint of the carry after chunk c
    v_re = A.transpose(1, 2)[:, None] @ dzc                       # [BH, nc, S, d]
    v_im = B.transpose(1, 2)[:, None] @ dzc
    gr = gi = torch.zeros((BH, S, d), dtype=dt, device=x.device)
    Gr, Gi = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        Gr[c], Gi[c] = gr, gi
        gr, gi = (v_re[:, c] + dec_re * gr + dec_im * gi,
                  v_im[:, c] - dec_im * gr + dec_re * gi)
    Gr, Gi = torch.stack(Gr, 1), torch.stack(Gi, 1)

    def over_chunks(a, b):
        """sum_c a_c b_c^T: [BH, nc, P, d] x [BH, nc, Q, d] -> [BH, P, Q]."""
        return torch.einsum("bcpd,bcqd->bpq", a, b)

    P = over_chunks(dzc, xc)
    dA, dB = over_chunks(dzc, R), over_chunks(dzc, I)
    dpre, dpim = over_chunks(Gr, xc), over_chunks(Gi, xc)
    ddec = torch.stack([(Gr * R + Gi * I).sum((1, 3)),
                        (Gi * R - Gr * I).sum((1, 3))], dim=1)   # [BH, 2, S]
    # collapse the Toeplitz cotangent onto the filter: dg[t] = sum of the
    # t-th lower diagonal of P, in a fixed order (a scatter-add's atomics
    # would make the grads differ from run to run on the card): with the
    # columns flipped and each row padded by C, row i of the [C, 2C - 1]
    # reshape is shifted right by i, so column t + C - 1 holds diagonal t
    idx = torch.arange(C, device=x.device)
    diff = idx[:, None] - idx[None, :]
    lower = torch.where(diff >= 0, P, torch.zeros((), dtype=dt, device=x.device)).flip(-1)
    skew = F.pad(lower, (0, C)).reshape(BH, -1)[:, :C * (2 * C - 1)].reshape(BH, C, 2 * C - 1)
    dg = skew[:, :, C - 1:].sum(1)
    grads = torch.autograd.grad(ops_out, poles, (dg, dA, dB, dpre, dpim, ddec))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (log_mag, theta, u_re, u_im)))


def _recompute_param_grads(x, dz, log_mag, theta, u_re, u_im, chunk: int,
                           reverse: bool):
    """dL/d(log_mag, theta, u_re, u_im) by autograd through the plain version
    of the pass, re-run on the detached x (``param_grads="recompute"``)."""
    f32 = torch.float32
    with torch.enable_grad():
        poles = [t.detach().to(f32).requires_grad_(True)
                 for t in (log_mag, theta, u_re, u_im)]
        z = _pass(x.detach().to(f32), _operators(*poles, chunk), chunk, reverse,
                  stlt_scan_reference)[0]
        grads = torch.autograd.grad(z, poles, dz.to(f32))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (log_mag, theta, u_re, u_im)))


PARAM_GRADS = {"analytic": _analytic_param_grads, "recompute": _recompute_param_grads}


class _StltScan(torch.autograd.Function):
    """The training scan: z = pass(x) with a zero carry; backward runs the
    same pass anti-causally over dz for dx (K1 again on the card) and
    ``PARAM_GRADS[param_grads]`` for the poles and mixers. Grads come back
    per row ([BH, S]); a caller that repeats poles over the batch sums them
    by autograd."""

    @staticmethod
    def forward(ctx, x, log_mag, theta, u_re, u_im, chunk: int, reverse: bool,
                param_grads: str = "analytic"):
        f32 = torch.float32
        operators = _operators(log_mag.to(f32), theta.to(f32), u_re.to(f32),
                               u_im.to(f32), chunk)
        z = _pass(x.to(f32), operators, chunk, reverse, _runner(x))[0]
        ctx.save_for_backward(x, log_mag, theta, u_re, u_im, *operators)
        ctx.chunk, ctx.reverse, ctx.param_grads = chunk, reverse, param_grads
        return z.to(x.dtype)

    @staticmethod
    def backward(ctx, dz):
        x, log_mag, theta, u_re, u_im, *operators = ctx.saved_tensors
        chunk, reverse = ctx.chunk, ctx.reverse
        dx = dparams = None
        if ctx.needs_input_grad[0]:
            dx = _pass(dz.to(torch.float32), operators, chunk, not reverse,
                       _runner(dz))[0].to(x.dtype)
        if any(ctx.needs_input_grad[1:5]):
            # the annotation lets a profile read the param grads' device and
            # host time (chip_smoke.py, phase T2)
            with torch.profiler.record_function("stlt_scan.param_grads"):
                dparams = PARAM_GRADS[ctx.param_grads](x, dz, log_mag, theta, u_re,
                                                       u_im, chunk, reverse)
        return (dx, *(dparams or (None,) * 4), None, None, None)


def stlt_scan(
    x: torch.Tensor,          # [BH, N, d]
    log_mag: torch.Tensor,    # [BH, S]
    theta: torch.Tensor,
    u_re: torch.Tensor,
    u_im: torch.Tensor,
    *,
    chunk: int = 128,
    reverse: bool = False,
    h0_re: Optional[torch.Tensor] = None,   # [BH, S, d] initial carry
    h0_im: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,   # [BH] per-row valid length
    return_state: bool = False,
    param_grads: str = "analytic",          # analytic | recompute
):
    """Fused factorized STLT: z = Re(sum_k u_k * scan(lambda_k, x)),
    anti-causal with ``reverse``.

    Returns z [BH, N, d] in x's dtype, and with ``return_state`` also
    (h_re, h_im) [BH, S, d] fp32: the carry after ``valid[row]`` tokens.
    The training call (no h0, valid or state) is differentiable through
    ``_StltScan``; the stateful serving call is not differentiated. Carry
    resume and per-row valid snapshots are forward-only, as the JAX package
    asserts; ``reverse`` with ``return_state`` returns the anti-causal
    carry after all N tokens (the snapshot at N of the flipped pass).
    ``param_grads`` picks the training call's pole and mixer grads: the
    analytic adjoints (default) or ``"recompute"``, the legacy baseline."""
    if param_grads not in PARAM_GRADS:
        raise ValueError(f"unknown param_grads {param_grads!r} "
                         f"(expected one of {sorted(PARAM_GRADS)})")
    if reverse and (h0_re is not None or valid is not None):
        raise ValueError("carry resume / per-row valid snapshots are forward-only "
                         "(decoders are causal)")
    stateful = return_state or h0_re is not None or valid is not None
    if not stateful:
        return _StltScan.apply(x, log_mag, theta, u_re, u_im, chunk, reverse,
                               param_grads)
    f32 = torch.float32
    lm, th = log_mag.to(f32), theta.to(f32)
    operators = _operators(lm, th, u_re.to(f32), u_im.to(f32), chunk)
    N = x.shape[1]
    h0 = None if h0_re is None else (h0_re.to(f32), h0_im.to(f32))
    z, h_re, h_im = _pass(x.to(f32), operators, chunk, reverse, _runner(x), h0=h0,
                          snapshot=_snapshot_ops(lm, th, valid, N, chunk,
                                                 -(-N // chunk)))
    z = z.to(x.dtype)
    if return_state:
        return z, (h_re, h_im)
    return z
