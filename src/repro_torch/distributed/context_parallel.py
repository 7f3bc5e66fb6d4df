"""Context-parallel (sequence-sharded) STLT, the port of the JAX package's
``distributed/context_parallel.py``: the paper's streaming claim across
devices (DESIGN.md §5).

For long-context prefill the sequence is sharded over a mesh axis. A
diagonal linear recurrence composes across shards in closed form: rank i
runs K1's stateful call (``ops.stlt_scan`` with ``return_state``) on its
slice from a zero carry, the end states are exchanged once (one all-gather
of O(devices * S * d) bytes, against ring attention's O(N * d)), and each
rank adds the incoming carry's term

    H_in(i) = sum_{j<i} lambda^{N_loc (i-1-j)} h_j          (log space)
    z[n]   += Re(sum_k u_k lambda_k^{n+1} H_in[k])          (n local)

as the JAX package does: a plain [N_loc, S] x [B, S, d] product, computed
outside any kernel there too. K1's own carry-in path (``h0 = H_in``) would
give the same term, at the price of a second K1 pass over the shard: the
closed form costs one K1 launch per shard and a product of 2 x N_loc x S x
B x d multiply-adds.

This is the forward (long-context prefill), as the JAX package uses it.
K1's stateful call is forward-only in the port, so this function takes no
gradient (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import comm
from repro_torch.kernels import ops as kernel_ops


@torch.no_grad()
def stlt_context_parallel(x: torch.Tensor, log_mag: torch.Tensor, theta: torch.Tensor,
                          u_re: torch.Tensor, u_im: torch.Tensor, mesh, axis: str = "data",
                          chunk: int = 128) -> torch.Tensor:
    """Unilateral factorized STLT over a sequence-sharded input. Every rank
    of ``mesh`` calls it with its slice x [B, N_loc, d] of x [B, N_global,
    d] (the sequence split over ``axis``, rank i holding tokens
    [i N_loc, (i+1) N_loc)) and the poles and mixers [S]; returns its slice
    of z [B, N_loc, d]."""
    B, n_loc, d = x.shape
    S = log_mag.shape[0]
    lm, th, ur, ui = (t.float()[None].expand(B, S).contiguous()
                      for t in (log_mag, theta, u_re, u_im))
    z, (h_re, h_im) = kernel_ops.stlt_scan(x, lm, th, ur, ui, chunk=chunk,
                                           return_state=True)
    # the one exchange: every rank's end state [B, S, d], re and im together
    g = comm.all_gather(torch.stack([h_re, h_im])[None], 0, mesh.group(axis))
    g_re, g_im = g[:, 0], g[:, 1]                                # [D, B, S, d]
    D, i = g.shape[0], mesh.coord(axis)
    lm, th = log_mag.float(), theta.float()
    j = torch.arange(D, device=x.device)
    pw = ((i - 1 - j).clamp(min=0) * n_loc).to(torch.float32)   # exponent per source
    valid = (j < i)[:, None]
    mag = torch.exp(pw[:, None] * lm[None, :])                   # [D, S]
    ang = pw[:, None] * th[None, :]
    w_re = torch.where(valid, mag * torch.cos(ang), 0.0)
    w_im = torch.where(valid, mag * torch.sin(ang), 0.0)
    hin_re = (torch.einsum("ds,dbsk->bsk", w_re, g_re)
              - torch.einsum("ds,dbsk->bsk", w_im, g_im))
    hin_im = (torch.einsum("ds,dbsk->bsk", w_re, g_im)
              + torch.einsum("ds,dbsk->bsk", w_im, g_re))
    n = torch.arange(1, n_loc + 1, device=x.device, dtype=torch.float32)
    mag_n = torch.exp(n[:, None] * lm[None, :])                  # [N_loc, S]
    ang_n = n[:, None] * th[None, :]
    c_re, c_im = mag_n * torch.cos(ang_n), mag_n * torch.sin(ang_n)
    ur, ui = u_re.float(), u_im.float()
    a = ur[None, :] * c_re - ui[None, :] * c_im                  # Re(u lambda^n)
    bc = -(ur[None, :] * c_im + ui[None, :] * c_re)              # -Im(u lambda^n)
    corr = (torch.einsum("ns,bsk->bnk", a, hin_re)
            + torch.einsum("ns,bsk->bnk", bc, hin_im))
    return z + corr.to(z.dtype)
