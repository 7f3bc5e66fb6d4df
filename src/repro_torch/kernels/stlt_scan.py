"""K1, the fused factorized STLT scan: the Hopper CUDA kernel's wrapper and
its plain PyTorch version.

Per chunk c of C tokens, with X_c [C, d] and the complex carry h [S, d]:

    z_c   = M X_c + A h_re + B h_im
    h_re' = Pre X_c + dec_re h_re - dec_im h_im
    h_im' = Pim X_c + dec_re h_im + dec_im h_re

The carry starts at h0; in the one chunk where ``gate[row, c]`` fires the
snapshot ``[Spre; Spim] X_c + sdec * h`` (chunk-start h) is the returned
state, and rows whose gate never fires (valid == 0) return h0. The
operators come from ``ops.py``. The kernel is ``csrc/stlt_scan.cu``; it
replaces the JAX package's Pallas kernel ``repro/kernels/stlt_scan.py::_kernel``.

``stlt_scan_kernel`` launches the kernel through the op
``repro_torch::stlt_scan`` (CUDA tensors; on ``meta`` tensors, the dry-run,
the op's shape-only form gives the outputs' shapes and nothing launches)
and counts one launch per CUDA call in ``stlt_scan_kernel.launches``.
A call issues four CUDA launches on the current stream: the operators
packed into the kernel's mma fragment order, the chunks' carry
contributions (and the snapshot's product), the carry recurrence across
chunks, and the readout. The host only checks the inputs and allocates the
outputs and one scratch buffer. A row's gate fires in one chunk at most, as
``ops._snapshot_ops`` builds it. ``stlt_scan_reference`` does the same
chunk algebra with torch matmuls, one chunk at a time, on any device.
``work`` counts one call's flops and bytes (``chip_smoke.k1_bound``, the
dry-run's cost of the op).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
_launch_fn = None


def _load():
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels import build

        lib = ctypes.CDLL(str(build.build_kernels()["stlt_scan"]))
        lib.stlt_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.stlt_scan_smem_bytes.restype = ctypes.c_size_t
        lib.stlt_scan_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.stlt_scan_scratch_bytes.restype = ctypes.c_size_t
        fn = lib.stlt_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = (fn, lib.stlt_scan_smem_bytes, lib.stlt_scan_scratch_bytes)
    return _launch_fn


def _check(name, t, shape, dtype, device, aligned: bool = True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _sizes(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec, chunk: int,
           aligned: bool = True) -> tuple:
    """(BH, N, d, C, S) after checking every input's shape, dtype, device and
    layout (with ``aligned``, its address too)."""
    BH, N, d = x.shape
    S, C = pre.shape[1], chunk
    nc = -(-N // C)
    if N < 1 or C % 8 or S % 4 or not 1 <= BH <= 65535:
        raise ValueError(f"K1 needs N >= 1, chunk % 8 == 0, nodes % 4 == 0 and "
                         f"1 <= rows <= 65535 (one grid row each; got N={N}, "
                         f"chunk={C}, nodes={S}, rows={BH})")
    f32, dev = torch.float32, x.device
    for name, t, shape in (
            ("x", x, (BH, N, d)), ("m", m, (BH, C, C)), ("a", a, (BH, C, S)),
            ("b", b, (BH, C, S)), ("pre", pre, (BH, S, C)),
            ("pim", pim, (BH, S, C)), ("dec", dec, (BH, 2, S)),
            ("h0_re", h0_re, (BH, S, d)), ("h0_im", h0_im, (BH, S, d)),
            ("spre", spre, (BH, S, C)), ("spim", spim, (BH, S, C)),
            ("sdec", sdec, (BH, 2, S)), ("gate", gate, (BH, nc))):
        _check(name, t, shape, torch.int32 if name == "gate" else f32, dev, aligned)
    return BH, N, d, C, S


def _kernel_args(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec,
                 chunk: int):
    """K1's launch arguments: (tensors, sizes) after checking the inputs; the
    scratch buffer (packed operators, carries) and the outputs (the last
    three tensors: z, h_re, h_im) are allocated here."""
    if x.device.type != "cuda":
        raise ValueError(f"stlt_scan_kernel needs CUDA tensors, got {x.device}")
    BH, N, d, C, S = _sizes(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec,
                            chunk)
    f32, dev = torch.float32, x.device
    _, smem_bytes, scratch_bytes = _load()
    smem = smem_bytes(C, S)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"K1 at chunk={C}, nodes={S} needs {smem} bytes of shared "
                         f"memory (limit {_SMEM_LIMIT})")
    scratch = torch.empty(scratch_bytes(BH, N, d, C, S) // 4, dtype=f32, device=dev)
    z = torch.empty((BH, N, d), dtype=f32, device=dev)
    h_re = torch.empty((BH, S, d), dtype=f32, device=dev)
    h_im = torch.empty((BH, S, d), dtype=f32, device=dev)
    return ((gate, x, m, a, b, pre, pim, spre, spim, dec, h0_re, h0_im, sdec, scratch,
             z, h_re, h_im), (BH, N, d, C, S))


def _launch(tensors, sizes):
    """Launch K1 on the current stream with ``_kernel_args``' output."""
    launch = _load()[0]
    with torch.cuda.device(tensors[1].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(t.data_ptr() for t in tensors), *sizes, stream)
    if err:
        raise RuntimeError(f"stlt_scan kernel launch failed: CUDA error {err}")


# K1 as the op ``repro_torch::stlt_scan``: the launch is its CUDA kernel and
# ``_stlt_scan_fake`` its shape-only form on ``meta`` (a plain ``Library``
# op: its dispatch adds a few microseconds a call, ``custom_op``'s several
# times that)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("stlt_scan(Tensor gate, Tensor x, Tensor m, Tensor a, Tensor b, Tensor pre, "
            "Tensor pim, Tensor dec, Tensor h0_re, Tensor h0_im, Tensor spre, Tensor spim, "
            "Tensor sdec, int chunk) -> (Tensor, Tensor, Tensor)")


def _stlt_scan_cuda(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec, chunk):
    tensors, sizes = _kernel_args(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im,
                                  spre, spim, sdec, chunk)
    _launch(tensors, sizes)
    stlt_scan_kernel.launches += 1
    return tuple(tensors[-3:])


_LIB.impl("stlt_scan", _stlt_scan_cuda, "CUDA")


@torch.library.register_fake("repro_torch::stlt_scan", lib=_LIB)
def _stlt_scan_fake(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec, chunk):
    BH, N, d, C, S = _sizes(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec,
                            chunk, aligned=False)
    return (x.new_empty((BH, N, d)), x.new_empty((BH, S, d)), x.new_empty((BH, S, d)))


def stlt_scan_kernel(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im,
                     spre, spim, sdec, *, chunk: int):
    """Launch K1 on the current CUDA stream.

    gate [BH, nc] int32 (nc = ceil(N / chunk)); x [BH, N, d]; m [BH, C, C];
    a, b [BH, C, S]; pre, pim, spre, spim [BH, S, C]; dec, sdec [BH, 2, S];
    h0_re, h0_im [BH, S, d]; all fp32 and contiguous on one CUDA device.
    Returns (z [BH, N, d], h_re, h_im [BH, S, d]) fp32. One call is four
    CUDA launches, counted as one. On ``meta`` tensors nothing runs and
    nothing counts: the op's shape-only form gives the outputs."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"stlt_scan_kernel needs CUDA tensors, got {x.device}")
    with torch.no_grad():
        return torch.ops.repro_torch.stlt_scan.default(gate, x, m, a, b, pre, pim, dec, h0_re,
                                                       h0_im, spre, spim, sdec, chunk)


stlt_scan_kernel.launches = 0


def work(BH: int, N: int, d: int, C: int, S: int, valid: Optional[np.ndarray] = None) -> tuple:
    """(product flops, decay flops, bytes) of one K1 call: x [BH, N, d] at
    chunk C over S nodes, the carry snapshot at ``valid[row]`` tokens
    (every row's at N when None, the most a call can take). Bytes: each
    input read once, each output written once."""
    nc = -(-N // C)
    n_local = np.arange(N) % C
    # z row n: the lower-triangular Toeplitz row (n mod C + 1 taps) plus the
    # carry injection A h_re + B h_im (2S taps), d columns, 2 flops a tap
    prods = BH * d * 2.0 * float((n_local + 1 + 2 * S).sum())
    # carry into chunks 1..nc-1: [Pre; Pim] X_c (2S x C) and the decay
    prods += BH * (nc - 1) * d * 2.0 * 2 * S * C
    decay = BH * (nc - 1) * d * 8.0 * S
    # the gated snapshot: 2S x r taps with r the live in-chunk offset
    q = np.full(BH, N, np.int64) if valid is None else valid.astype(np.int64)
    r = np.where(q > 0, q - np.maximum(q - 1, 0) // C * C, 0)
    prods += float((d * 2.0 * 2 * S * r).sum())
    decay += float((d * 8.0 * S * (q > 0)).sum())
    # operators: M [C, C], A, B [C, S], Pre, Pim, Spre, Spim [S, C], decays;
    # a window shorter than a chunk (verify, commit) needs only their first
    # c = min(C, N) rows or columns
    c = min(C, N)
    nbytes = 4 * BH * (2 * N * d + 4 * S * d) + 4 * BH * (c * c + 6 * c * S + 4 * S) \
        + 4 * BH * nc
    return prods, decay, nbytes


def stlt_scan_reference(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im,
                        spre, spim, sdec, *, chunk: int):
    """The plain PyTorch version of K1: same arguments and results, one
    chunk at a time with batched matmuls."""
    BH, N, d = x.shape
    C = chunk
    nc = gate.shape[1]
    xc = F.pad(x, (0, 0, 0, nc * C - N)).view(BH, nc, C, d)
    dec_re, dec_im = dec[:, 0, :, None], dec[:, 1, :, None]
    sd_re, sd_im = sdec[:, 0, :, None], sdec[:, 1, :, None]
    h_re, h_im = h0_re, h0_im
    out_re, out_im = h0_re, h0_im
    zs = []
    for c in range(nc):
        xk = xc[:, c]
        zs.append(m @ xk + a @ h_re + b @ h_im)
        fire = (gate[:, c] > 0)[:, None, None]
        out_re = torch.where(fire, spre @ xk + sd_re * h_re - sd_im * h_im, out_re)
        out_im = torch.where(fire, spim @ xk + sd_re * h_im + sd_im * h_re, out_im)
        h_re, h_im = (pre @ xk + dec_re * h_re - dec_im * h_im,
                      pim @ xk + dec_re * h_im + dec_im * h_re)
    z = torch.cat(zs, dim=1)[:, :N]
    return z, out_re, out_im
