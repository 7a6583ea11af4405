"""Fused multiplexer head (paper Eq. 5-6): the CUDA kernel's launcher
and its plain PyTorch version.

Port of ``repro.kernels.mux_score``.  The TPU kernel it replaces
(``mux_score`` / ``_mux_kernel``) becomes ``csrc/mux_score.cu`` for
sm_90a: L2-normalise(meta) -> meta @ v^T -> / cost_i -> softmax in one
pass per row.  It runs on every request before any model is chosen.
The plain version is ``ref.mux_score_ref``; callers go through
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        fn = build.load("mux_score").mux_score_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
        _lib = fn
    return _lib


def mux_score_cuda(meta, v, cost, *, normalize: bool = True) -> torch.Tensor:
    """meta: (B, M); v: (N, M); cost: (N,), all on one CUDA device.
    Returns weights (B, N) fp32.  Operands are read as contiguous fp32
    (cast here when given otherwise).  Raises on anything the kernel
    does not take — never computes on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("mux_score kernel: CUDA is not available")
    dev = meta.device
    if dev.type != "cuda":
        raise ValueError(f"mux_score kernel: meta must be a CUDA tensor, "
                         f"got {dev}")
    b, m_dim = meta.shape
    n = v.shape[0]
    if tuple(v.shape) != (n, m_dim) or tuple(cost.shape) != (n,):
        raise ValueError(f"mux_score kernel: v {tuple(v.shape)} / cost "
                         f"{tuple(cost.shape)} do not match meta "
                         f"{tuple(meta.shape)}")
    if v.device != dev or cost.device != dev:
        raise ValueError("mux_score kernel: operands on different devices")
    meta, v, cost = (t.to(torch.float32).contiguous() for t in (meta, v, cost))
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    rc = _launcher()(meta.data_ptr(), v.data_ptr(), cost.data_ptr(),
                     out.data_ptr(), b, m_dim, n, int(bool(normalize)),
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mux_score kernel launch failed: CUDA error {rc}")
    return out
