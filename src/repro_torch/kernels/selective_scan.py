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
MAX_STATE = 64               # csrc kMaxState: 16 lanes x 4 states

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        fn = build.load("selective_scan").selective_scan_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci] + [vp] * 9 + [ci, ci, ci, ci, vp]
        fn.restype = ci
        _lib = fn
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan kernel: {msg}")


def selective_scan_cuda(x, dt, b_mat, c_mat, a_mat, d_vec, h0=None):
    """Launch ``csrc/selective_scan.cu`` on x's current CUDA stream.

    x/dt: (B, S, d_in); b_mat/c_mat: (B, S, n), n <= 64; a_mat:
    (d_in, n); d_vec: (d_in,); h0: (B, d_in, n) start state or None
    (zeros).  x is float32 or bfloat16 and contiguous; the kernel reads
    dt, B, C, A, D and h0 as contiguous fp32 (cast here, a no-op for the
    Mamba block's fp32 dt, B and C).
    Returns (y (B, S, d_in) fp32, h_final (B, d_in, n) fp32).  Raises on
    anything the kernel does not take — never computes on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("selective_scan kernel: CUDA is not available")
    dev = x.device
    _require(dev.type == "cuda", f"x must be a CUDA tensor, got {dev}")
    _require(x.dim() == 3, f"x must be (B, S, d_in), got {tuple(x.shape)}")
    b, s, d_in = x.shape
    _require(b_mat.dim() == 3, f"b_mat must be (B, S, n), got "
             f"{tuple(b_mat.shape)}")
    n = b_mat.shape[-1]
    _require(tuple(dt.shape) == (b, s, d_in),
             f"dt {tuple(dt.shape)} vs x {tuple(x.shape)}")
    _require(tuple(b_mat.shape) == (b, s, n)
             and tuple(c_mat.shape) == (b, s, n),
             f"b_mat {tuple(b_mat.shape)} / c_mat {tuple(c_mat.shape)} vs "
             f"x {tuple(x.shape)}")
    _require(tuple(a_mat.shape) == (d_in, n) and tuple(d_vec.shape) == (d_in,),
             f"a_mat {tuple(a_mat.shape)} / d_vec {tuple(d_vec.shape)}")
    _require(h0 is None or tuple(h0.shape) == (b, d_in, n),
             f"h0 {None if h0 is None else tuple(h0.shape)} vs "
             f"{(b, d_in, n)}")
    _require(1 <= n <= MAX_STATE, f"state size {n} outside [1, {MAX_STATE}]")
    _require(b <= 65535, f"batch {b} > 65535")
    _require(x.dtype in _DTYPE_CODE,
             f"x dtype {x.dtype}: float32 or bfloat16")
    _require(x.is_contiguous(), "x must be contiguous")
    rest = [dt, b_mat, c_mat, a_mat, d_vec] + ([] if h0 is None else [h0])
    for t in rest:
        _require(t.device == dev, f"operand on {t.device}, x on {dev}")
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
