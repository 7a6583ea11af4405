"""Mamba-1 selective scan: the CUDA kernel's launcher.

Port of ``repro.kernels.selective_scan``.  The TPU kernel it replaces
(``selective_scan`` / ``_scan_kernel``) becomes
``csrc/selective_scan.cu`` for sm_90a — see that file for the design
and what bounds it.  Unlike the TPU kernel it starts from a given state
``h0`` and returns the final state with ``y``.  The plain version is
``ref.selective_scan_ref``; callers go through
``repro_torch.kernels.ops.selective_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 64               # csrc kMaxState: 8 lanes x 8 states

# selective_scan_launch(x_dtype, x, dt, B, C, A, D, h0, y, h_final,
# batch, seqlen, d_in, n, stream)
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        fn = build.load("selective_scan").selective_scan_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _refuse(msg: str):
    raise ValueError(f"selective_scan kernel: {msg}")


def selective_scan_cuda(x, dt, b_mat, c_mat, a_mat, d_vec, h0=None):
    """Launch ``csrc/selective_scan.cu`` on x's current CUDA stream.

    x/dt: (B, S, d_in); b_mat/c_mat: (B, S, n), n <= 64; a_mat:
    (d_in, n); d_vec: (d_in,); h0: (B, d_in, n) start state or None
    (zeros).  x is float32 or bfloat16 and contiguous; the kernel reads
    dt, B, C, A, D and h0 as contiguous fp32 (cast here, a no-op for the
    Mamba block's fp32 dt, B and C).
    Returns (y (B, S, d_in) fp32, h_final (B, d_in, n) fp32).  Reads
    nothing back from the card (the call can be captured in a CUDA
    graph).  Raises on anything the kernel does not take — never
    computes on the CPU."""
    dev = x.device
    if dev.type != "cuda" and not torch.cuda.is_available():
        raise RuntimeError("selective_scan kernel: CUDA is not available")
    if dev.type != "cuda":
        _refuse(f"x must be a CUDA tensor, got {dev}")
    # the messages are built only on a refusal: this runs once a layer of
    # every prefill
    if x.dim() != 3:
        _refuse(f"x must be (B, S, d_in), got {tuple(x.shape)}")
    b, s, d_in = x.shape
    if b_mat.dim() != 3:
        _refuse(f"b_mat must be (B, S, n), got {tuple(b_mat.shape)}")
    n = b_mat.shape[-1]
    if dt.shape != x.shape:
        _refuse(f"dt {tuple(dt.shape)} vs x {tuple(x.shape)}")
    if b_mat.shape != (b, s, n) or c_mat.shape != (b, s, n):
        _refuse(f"b_mat {tuple(b_mat.shape)} / c_mat {tuple(c_mat.shape)} "
                f"vs x {tuple(x.shape)}")
    if a_mat.shape != (d_in, n) or d_vec.shape != (d_in,):
        _refuse(f"a_mat {tuple(a_mat.shape)} / d_vec {tuple(d_vec.shape)}")
    if h0 is not None and h0.shape != (b, d_in, n):
        _refuse(f"h0 {tuple(h0.shape)} vs {(b, d_in, n)}")
    if not 1 <= n <= MAX_STATE:
        _refuse(f"state size {n} outside [1, {MAX_STATE}]")
    if b > 65535:
        _refuse(f"batch {b} > 65535")
    if x.dtype not in _DTYPE_CODE:
        _refuse(f"x dtype {x.dtype}: float32 or bfloat16")
    if not x.is_contiguous():
        _refuse("x must be contiguous")
    rest = [dt, b_mat, c_mat, a_mat, d_vec] + ([] if h0 is None else [h0])
    for t in rest:
        if t.device != dev:
            _refuse(f"operand on {t.device}, x on {dev}")
    dt32, b32, c32, a32, d32 = (t.to(torch.float32).contiguous()
                                for t in (dt, b_mat, c_mat, a_mat, d_vec))
    h32 = None if h0 is None else h0.to(torch.float32).contiguous()
    y = torch.empty((b, s, d_in), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, d_in, n), dtype=torch.float32, device=dev)
    rc = _launcher()(
        _DTYPE_CODE[x.dtype],
        x.data_ptr(), dt32.data_ptr(), b32.data_ptr(), c32.data_ptr(),
        a32.data_ptr(), d32.data_ptr(),
        None if h32 is None else h32.data_ptr(), y.data_ptr(),
        h_final.data_ptr(), b, s, d_in, n,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {rc}")
    return y, h_final
