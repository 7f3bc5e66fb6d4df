"""K2, the flash relevance readout: the Hopper CUDA kernel's wrapper, its
plain PyTorch version, and the autograd Function around them.

The paper-figure readout computes, per row (one (batch, head) pair),

    R[n, m] = Re(sum_k mk_k L[n,k,:] . conj(L[m,k,:])) / sqrt(S)
    z       = softmax_m(R + causal mask + key-pad mask) v

where ``L`` is the per-node Laplace transform of the per-head inputs ``x``
(``L[t] = lambda L[t-1] + x[t]``; bidirectional adds the reverse transform
and subtracts the double-counted ``x``). Masked keys are zeroed before the
transform and scored ``-1e30`` with probability exactly 0, so a fully masked
row returns 0, not NaN.

* ``relevance_flash_reference`` is the plain version, after the JAX
  package's ``relevance_flash_reference``: tiles of ``tile`` rows, each
  tile's L rebuilt from a lower-triangular Toeplitz operator (``_flash_ops``)
  plus the carry at the tile start, online softmax over key tiles, and
  ``torch.utils.checkpoint`` per query tile so its autograd is the
  recompute-per-tile backward. Causal mode skips key tiles above the
  diagonal; every score there is masked, so skipping them changes nothing.
* ``relevance_flash_kernel`` launches ``csrc/relevance_flash.cu`` (CUDA
  tensors only) after computing the tile-boundary carries on the host every
  ``KERNEL_CARRY`` rows, where the kernel's recurrence segments start; it
  counts its launches in ``relevance_flash_kernel.launches``. The kernel
  replaces the JAX package's Pallas kernel
  ``repro/kernels/relevance_flash.py::_flash_body``: warp-specialized, the
  recurrence in two producer warpgroups and the score contraction as
  3xTF32 ``wgmma`` in a consumer warpgroup (its header has the design).
* ``relevance_flash`` is the public entry: a CUDA tensor runs the kernel
  (or raises), a CPU tensor the plain version; both sit inside
  ``_RelFlash``, whose backward is autograd through the plain version. The
  JAX package's backward is likewise autodiff through its jnp reference,
  not a kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.scan import _chunk_powers

NEG = -1e30           # finite -inf stand-in: exp underflows to exact 0
KERNEL_BLOCK = 64     # the CUDA kernel's query/key block (rows)
KERNEL_CARRY = 32     # rows between the tile carries the kernel reads
KERNEL_MAX_DH = 64    # the kernel keeps at most 64 feature columns per row
_SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
_launch_fn = None


# ---------------------------------------------------------------------------
# host-side operators and tile-boundary carries
# ---------------------------------------------------------------------------


def _tile_carries(x, pw_re, pw_im, tile: int, bidirectional: bool):
    """Carries at tile boundaries of x [BH, Np, dh] (Np % tile == 0) from
    the powers ``pw`` [BH, tile+1, S] of each row's poles.

    Returns hc re/im [BH, nt, S, dh], the forward carry at each tile START
    (h_0 = 0, h_c = L[c*tile - 1]), and when bidirectional gc re/im, the
    reverse carry at each tile END (g_c = sum_{m >= (c+1)T} lambda^(m-(c+1)T)
    x[m]), else None. Each tile's own sum comes from one batched product
    with the powers; the carries are their prefix over tiles under the decay
    lambda^T, a scan taken by doubling (log2(nt) steps), so the number of
    launches barely grows with N."""
    BH, Np, dh = x.shape
    T = tile
    nt = Np // T
    xt = x.reshape(BH, nt, T, dh)
    idx = torch.arange(T, device=x.device)
    dec = torch.complex(pw_re[:, T], pw_im[:, T])[:, None, :, None]  # [BH, 1, S, 1]

    def scan(pre_re, pre_im, reverse: bool):
        # u_c = sum_j pre[j] x[cT + j], [BH, nt, S, dh]; reversed, tile c
        # becomes nt - 1 - c and the tile-end carries are a forward scan
        u = torch.complex(pre_re[:, None] @ xt, pre_im[:, None] @ xt)
        if reverse:
            u = u.flip(1)
        a, k = dec, 1            # inclusive prefix: H_c = sum_{c' <= c} dec^(c-c') u_c'
        while k < nt:
            u = torch.cat([u[:, :k], torch.addcmul(u[:, k:], a, u[:, :-k])], 1)
            a, k = a * a, 2 * k
        h = torch.cat([torch.zeros_like(u[:, :1]), u[:, :-1]], 1)  # the carry into c
        if reverse:
            h = h.flip(1)
        return h.real.contiguous(), h.imag.contiguous()

    # forward: h' = sum_j lambda^(T-1-j) x[j] + lambda^T h
    hc = scan(pw_re[:, T - 1 - idx].transpose(1, 2),
              pw_im[:, T - 1 - idx].transpose(1, 2), reverse=False)
    if not bidirectional:
        return hc, None
    # reverse: g' = sum_j lambda^j x[j] + lambda^T g, tiles last to first
    gc = scan(pw_re[:, idx].transpose(1, 2), pw_im[:, idx].transpose(1, 2),
              reverse=True)
    return hc, gc


def _flash_ops(x, log_mag, theta, tile: int, bidirectional: bool):
    """Per-row tile operators and carries for x [BH, Np, dh] (Np % tile ==
    0, masked positions already zeroed), as the JAX package's ``_flash_ops``:

      tri2t_re/im [BH, T*S, T]  row (i, k), col j: lambda_k^(i-j) for i >= j
      inj_re/im   [BH, T, S]    forward carry injection lambda^(i+1)
      hc_re/im    [BH, nt, S, dh] carry at each tile start
    and, when bidirectional, the mirrored ``rtri2t``, ``rinj`` (lambda^(T-i))
    and the tile-end reverse carries ``gc``."""
    BH = x.shape[0]
    S = log_mag.shape[-1]
    T = tile
    pw_re, pw_im = _chunk_powers(log_mag, theta, T)              # [BH, T+1, S]
    idx = torch.arange(T, device=x.device)
    diff = idx[:, None] - idx[None, :]                          # i - j

    def tri2t(pw, d):
        t = torch.where(d[None, :, :, None] >= 0,
                        pw[:, d.clamp(0, T)], torch.zeros((), device=x.device))
        return t.transpose(2, 3).reshape(BH, T * S, T)

    ops = {"tri2t_re": tri2t(pw_re, diff), "tri2t_im": tri2t(pw_im, diff),
           "inj_re": pw_re[:, 1:T + 1], "inj_im": pw_im[:, 1:T + 1]}
    (ops["hc_re"], ops["hc_im"]), gc = _tile_carries(x, pw_re, pw_im, T,
                                                     bidirectional)
    if bidirectional:
        ops["rtri2t_re"] = tri2t(pw_re, -diff)
        ops["rtri2t_im"] = tri2t(pw_im, -diff)
        ops["rinj_re"] = pw_re[:, T - idx]
        ops["rinj_im"] = pw_im[:, T - idx]
        ops["gc_re"], ops["gc_im"] = gc
    return ops


def _reconstruct(xt, ops, hre, him, gre, gim, bidirectional: bool):
    """Tile coefficients: xt [BH, T, dh] -> L re/im [BH, T, S, dh] from the
    Toeplitz operators and the tile's carries."""
    BH, T, dh = xt.shape
    S = hre.shape[-2]
    l_re = (ops["tri2t_re"] @ xt).reshape(BH, T, S, dh)
    l_im = (ops["tri2t_im"] @ xt).reshape(BH, T, S, dh)
    l_re = l_re + ops["inj_re"][..., None] * hre[:, None] - ops["inj_im"][..., None] * him[:, None]
    l_im = l_im + ops["inj_re"][..., None] * him[:, None] + ops["inj_im"][..., None] * hre[:, None]
    if bidirectional:
        l_re = l_re + (ops["rtri2t_re"] @ xt).reshape(BH, T, S, dh)
        l_im = l_im + (ops["rtri2t_im"] @ xt).reshape(BH, T, S, dh)
        l_re = l_re + ops["rinj_re"][..., None] * gre[:, None] - ops["rinj_im"][..., None] * gim[:, None]
        l_im = l_im + ops["rinj_re"][..., None] * gim[:, None] + ops["rinj_im"][..., None] * gre[:, None]
        l_re = l_re - xt[:, :, None, :]     # L + L_rev counts the center twice
    return l_re, l_im


def _pad_tiles(x, v, kmask, tile: int):
    """Pad [BH, N, ...] inputs to a tile multiple; zero masked/pad inputs."""
    BH, N, _ = x.shape
    pad = (-N) % tile
    km = torch.ones((BH, N), dtype=torch.float32, device=x.device) \
        if kmask is None else kmask.to(torch.float32)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        km = F.pad(km, (0, pad))
    return x * km[:, :, None], v, km


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def relevance_flash_reference(x, v, log_mag, theta, mk, km, *, tile: int,
                              causal: bool, dtype: torch.dtype = torch.float32):
    """The plain version of K2: x, v [BH, N, dh]; log_mag, theta, mk [BH, S];
    km [BH, N] or None -> z [BH, N, dh] in ``dtype`` (fp32; float64 gives a
    yardstick for the fp32 versions' rounding). Tiled online softmax with
    the JAX reference's operators and accumulation order; under autograd
    each query tile is checkpointed, so the backward recomputes per tile and
    never holds [N, N]."""
    BH, N, dh = x.shape
    S = log_mag.shape[-1]
    T = tile
    x, v, km = _pad_tiles(x.to(dtype), v.to(dtype), km, T)
    nt = x.shape[1] // T
    bidir = not causal
    ops = _flash_ops(x, log_mag.to(dtype), theta.to(dtype), T, bidirectional=bidir)
    zero = torch.zeros((BH, S, dh), dtype=dtype, device=x.device)
    xt, vt = x.reshape(BH, nt, T, dh), v.reshape(BH, nt, T, dh)
    kmt = km.reshape(BH, nt, T)
    hre, him = ops["hc_re"], ops["hc_im"]
    gre, gim = (ops["gc_re"], ops["gc_im"]) if bidir else (None, None)
    mkf = mk.to(dtype)[:, None, :, None]
    scale = 1.0 / math.sqrt(S)
    ar = torch.arange(T, device=x.device)

    def carry(t, c):
        return zero if t is None else t[:, c]

    def q_body(qi):
        ql_re, ql_im = _reconstruct(xt[:, qi], ops, hre[:, qi], him[:, qi],
                                    carry(gre, qi), carry(gim, qi), bidir)
        q_re = (ql_re * mkf).reshape(BH, T, S * dh)
        q_im = (ql_im * mkf).reshape(BH, T, S * dh)
        m = torch.full((BH, T), NEG, dtype=dtype, device=x.device)
        l = torch.zeros((BH, T), dtype=dtype, device=x.device)
        acc = torch.zeros((BH, T, dh), dtype=dtype, device=x.device)
        for ki in range(qi + 1 if causal else nt):
            kl_re, kl_im = _reconstruct(xt[:, ki], ops, hre[:, ki], him[:, ki],
                                        carry(gre, ki), carry(gim, ki), bidir)
            k_re = kl_re.reshape(BH, T, S * dh)
            k_im = kl_im.reshape(BH, T, S * dh)
            r = (q_re @ k_re.transpose(1, 2) + q_im @ k_im.transpose(1, 2)) * scale
            valid = kmt[:, ki][:, None, :] > 0.0                     # [BH, 1, T]
            if causal:
                valid = valid & ((ki * T + ar)[None, :] <= (qi * T + ar)[:, None])[None]
            r = torch.where(valid, r, NEG)
            m_new = torch.maximum(m, r.amax(-1))
            p = torch.where(valid, torch.exp(r - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + p @ vt[:, ki]
            m = m_new
        safe = torch.where(l > 0, l, torch.ones((), device=x.device))
        return torch.where(l[..., None] > 0, acc / safe[..., None], 0.0)

    # each q tile keeps only what it closes over (operators, carries); its
    # score tiles are recomputed in the backward
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, v, log_mag, theta, mk))
    zs = [checkpoint(q_body, qi, use_reentrant=False) if grad else q_body(qi)
          for qi in range(nt)]
    return torch.cat(zs, dim=1)[:, :N]


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _load():
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels import build

        lib = ctypes.CDLL(str(build.build_kernels()["relevance_flash"]))
        lib.relevance_flash_smem_bytes.argtypes = []
        lib.relevance_flash_smem_bytes.restype = ctypes.c_size_t
        for name in ("relevance_flash_block", "relevance_flash_carry_stride"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        got = (lib.relevance_flash_block(), lib.relevance_flash_carry_stride())
        if got != (KERNEL_BLOCK, KERNEL_CARRY):
            raise RuntimeError(f"K2 blocks by {got[0]} rows with carries every "
                               f"{got[1]}; the wrapper expects {KERNEL_BLOCK} and "
                               f"{KERNEL_CARRY}")
        fn = lib.relevance_flash_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = (fn, lib.relevance_flash_smem_bytes)
    return _launch_fn


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_args(x, v, log_mag, theta, mk, km, causal: bool):
    """K2's launch arguments: (tensors, sizes) after checking the inputs,
    zeroing x's masked keys and computing the host carries; the last tensor
    is z, allocated here."""
    if x.device.type != "cuda":
        raise ValueError(f"relevance_flash_kernel needs CUDA tensors, got {x.device}")
    BH, N, dh = x.shape
    S = log_mag.shape[-1]
    T = KERNEL_BLOCK
    nt = -(-N // T)
    if N < 1 or S < 1 or not 1 <= dh <= KERNEL_MAX_DH or not 1 <= BH <= 2**31 - 1 \
            or nt > 65535:
        raise ValueError(f"K2 needs N >= 1, nodes >= 1, 1 <= dh <= {KERNEL_MAX_DH} "
                         f"and at most 65535 blocks of {T} rows (got N={N}, "
                         f"nodes={S}, dh={dh}, rows={BH})")
    dev = x.device
    for name, t, shape in (("x", x, (BH, N, dh)), ("v", v, (BH, N, dh)),
                           ("log_mag", log_mag, (BH, S)), ("theta", theta, (BH, S)),
                           ("mk", mk, (BH, S)), ("km", km, (BH, N))):
        _check(name, t, shape, dev)
    xk = x * km[:, :, None]
    pw_re, pw_im = _chunk_powers(log_mag, theta, KERNEL_CARRY)
    (hre, him), gc = _tile_carries(F.pad(xk, (0, 0, 0, nt * T - N)), pw_re, pw_im,
                                   KERNEL_CARRY, bidirectional=not causal)
    gre, gim = gc if gc is not None else (hre, him)   # not read when causal
    z = torch.empty((BH, N, dh), dtype=torch.float32, device=dev)
    carries = [t.contiguous() for t in (hre, him, gre, gim)]
    return (xk, v, log_mag, theta, mk, km, *carries, z), (BH, N, S, dh, int(causal))


def _launch(tensors, sizes):
    """Launch K2 on the current stream with ``_kernel_args``' output."""
    launch, smem_bytes = _load()
    if smem_bytes() > _SMEM_LIMIT:
        raise ValueError(f"K2 needs {smem_bytes()} bytes of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in tensors), *sizes, stream)
    if err:
        raise RuntimeError(f"relevance_flash kernel launch failed: CUDA error {err}")


def relevance_flash_kernel(x, v, log_mag, theta, mk, km, *, causal: bool):
    """Launch K2 on the current CUDA stream.

    x, v [BH, N, dh] with dh <= 64; log_mag, theta, mk [BH, S]; km [BH, N]
    key validity; all fp32 and contiguous on one CUDA device. Masked keys of
    x are zeroed here, and the tile-boundary carries are computed here on the
    host every ``KERNEL_CARRY`` rows, where the kernel's recurrence segments
    start (x is padded to the kernel's block of ``KERNEL_BLOCK`` rows for the
    carries only; the kernel reads rows past N as zeros).
    Returns z [BH, N, dh] fp32."""
    tensors, sizes = _kernel_args(x, v, log_mag, theta, mk, km, causal)
    _launch(tensors, sizes)
    relevance_flash_kernel.launches += 1
    return tensors[-1]


relevance_flash_kernel.launches = 0


# ---------------------------------------------------------------------------
# autograd Function and public dispatch
# ---------------------------------------------------------------------------


def _run_flash(x, v, log_mag, theta, mk, km, tile: int, causal: bool):
    if x.device.type == "cuda":
        return relevance_flash_kernel(*(t.contiguous() for t in (x, v, log_mag,
                                                                  theta, mk, km)),
                                      causal=causal)
    if x.device.type == "cpu":
        return relevance_flash_reference(x, v, log_mag, theta, mk, km,
                                         tile=tile, causal=causal)
    raise ValueError(f"relevance_flash runs on cuda or cpu, not {x.device}")


class _RelFlash(torch.autograd.Function):
    """Forward: K2 on the card, the plain version on the CPU. Backward:
    recompute through the plain tiled reference under autograd (no kernel,
    as in the JAX package's custom VJP), grads for x, v, log_mag, theta, mk."""

    @staticmethod
    def forward(ctx, x, v, log_mag, theta, mk, km, tile, causal):
        ctx.save_for_backward(x, v, log_mag, theta, mk, km)
        ctx.tile, ctx.causal = tile, causal
        return _run_flash(x, v, log_mag, theta, mk, km, tile, causal)

    @staticmethod
    def backward(ctx, dz):
        saved = ctx.saved_tensors
        want = [i for i in range(5) if ctx.needs_input_grad[i]]
        grads = [None] * 8
        if not want:
            return tuple(grads)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(i in want) for i, t in enumerate(saved[:5])]
            z = relevance_flash_reference(*ins, saved[5], tile=ctx.tile,
                                          causal=ctx.causal)
            got = torch.autograd.grad(z, [ins[i] for i in want], dz)
        for i, g in zip(want, got):
            grads[i] = g
        return tuple(grads)


def relevance_flash(x, v, log_mag, theta, *, masks: Optional[torch.Tensor] = None,
                    kmask: Optional[torch.Tensor] = None, causal: bool = True,
                    tile: int = 128):
    """Flash relevance readout: z = softmax-over-keys(R) @ v, [BH, N, dh] fp32.

    x, v [BH, N, dh]; log_mag, theta [BH, S] per-row poles; masks [BH, S]
    adaptive node masks (query side); kmask [BH, N] 1 = valid key; causal
    False is the bidirectional (encoder) mode. ``tile`` is the plain
    version's tile; the kernel blocks by ``KERNEL_BLOCK``. Differentiable in
    x, v, the poles and the masks."""
    BH, N, _ = x.shape
    S = log_mag.shape[-1]
    f32 = torch.float32
    mk = torch.ones((BH, S), dtype=f32, device=x.device) if masks is None \
        else masks.to(f32)
    km = torch.ones((BH, N), dtype=f32, device=x.device) if kmask is None \
        else kmask.to(f32)
    return _RelFlash.apply(x.to(f32), v.to(f32), log_mag.to(f32),
                           theta.to(f32), mk, km, tile, causal)
