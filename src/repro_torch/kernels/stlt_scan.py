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

``stlt_scan_kernel`` launches the kernel (CUDA tensors only) and counts one
launch per call in ``stlt_scan_kernel.launches``. A call issues four CUDA
launches on the current stream: the operators packed into the kernel's mma
fragment order, the chunks' carry contributions (and the snapshot's
product), the carry recurrence across chunks, and the readout. The host
only checks the inputs and allocates the outputs and one scratch buffer. A
row's gate fires in one chunk at most, as ``ops._snapshot_ops`` builds it.
``stlt_scan_reference`` does the same chunk algebra with torch matmuls, one
chunk at a time, on any device.
"""
from __future__ import annotations

import ctypes

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


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_args(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im, spre, spim, sdec,
                 chunk: int):
    """K1's launch arguments: (tensors, sizes) after checking the inputs; the
    scratch buffer (packed operators, carries) and the outputs (the last
    three tensors: z, h_re, h_im) are allocated here."""
    if x.device.type != "cuda":
        raise ValueError(f"stlt_scan_kernel needs CUDA tensors, got {x.device}")
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
            ("sdec", sdec, (BH, 2, S))):
        _check(name, t, shape, f32, dev)
    _check("gate", gate, (BH, nc), torch.int32, dev)
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


def stlt_scan_kernel(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im,
                     spre, spim, sdec, *, chunk: int):
    """Launch K1 on the current CUDA stream.

    gate [BH, nc] int32 (nc = ceil(N / chunk)); x [BH, N, d]; m [BH, C, C];
    a, b [BH, C, S]; pre, pim, spre, spim [BH, S, C]; dec, sdec [BH, 2, S];
    h0_re, h0_im [BH, S, d]; all fp32 and contiguous on one CUDA device.
    Returns (z [BH, N, d], h_re, h_im [BH, S, d]) fp32. One call is four
    CUDA launches, counted as one."""
    tensors, sizes = _kernel_args(gate, x, m, a, b, pre, pim, dec, h0_re, h0_im,
                                  spre, spim, sdec, chunk)
    _launch(tensors, sizes)
    stlt_scan_kernel.launches += 1
    return tensors[-3:]


stlt_scan_kernel.launches = 0


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
