"""Fused multiplexer head (paper Eq. 5-6): the CUDA kernel's launchers.

Port of ``repro.kernels.mux_score``.  The TPU kernel it replaces
(``mux_score`` / ``_mux_kernel``) becomes ``csrc/mux_score.cu`` for
sm_90a, one templated kernel in two forms (see that file for the design
and what bounds it):

* :func:`mux_head_cuda`, the probe's path: the probe's last hidden states
  h (B, S, d) -> mean over S -> out projection -> tanh -> the head, in one
  launch;
* :func:`mux_score_cuda`, the TPU kernel's own contract: meta (B, M) ->
  L2-normalise -> meta @ v^T -> / cost -> softmax.

Both launch on the current stream, read nothing back from the card and
allocate only their output, so a call can be captured in a CUDA graph.
The plain versions are ``ref.mux_head_ref`` and ``ref.mux_score_ref``;
callers go through ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# mux_score_launch(head, x, w_out, v, cost, out, batch, seq, d, m_dim,
# n_models, normalize, stream)
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        fn = build.load("mux_score").mux_score_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


@functools.lru_cache(maxsize=16)
def _init_device(device_index: int) -> None:
    """Raise the kernel's shared-memory limit on a device, once (the
    first call on a device, which a CUDA graph's warm-up makes before
    any capture)."""
    fn = build.load("mux_score").mux_score_init
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    rc = fn(device_index)
    if rc != 0:
        raise RuntimeError(f"mux_score kernel: init failed: CUDA error {rc}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous fp32; the tensor itself when it already is."""
    if t.dtype != torch.float32:
        t = t.float()
    return t if t.is_contiguous() else t.contiguous()


def _check(name: str, first: torch.Tensor, v, cost, m_dim: int) -> int:
    if first.device.type != "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} kernel: CUDA is not available")
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: inputs must be CUDA tensors, got "
                         f"{dev}")
    n = v.shape[0]
    if v.dim() != 2 or tuple(v.shape) != (n, m_dim) \
            or tuple(cost.shape) != (n,):
        raise ValueError(f"{name} kernel: v {tuple(v.shape)} / cost "
                         f"{tuple(cost.shape)} do not match M = {m_dim}")
    if v.device != dev or cost.device != dev:
        raise ValueError(f"{name} kernel: operands on different devices")
    return n


def _launch(head: bool, x, w_out, v, cost, batch: int, seq: int, d: int,
            m_dim: int, n: int, normalize: bool) -> torch.Tensor:
    dev = x.device
    out = torch.empty((batch, n), dtype=torch.float32, device=dev)
    if batch == 0:
        return out
    _init_device(dev.index)
    rc = _launcher()(int(head), x.data_ptr(),
                     w_out.data_ptr() if head else None, v.data_ptr(),
                     cost.data_ptr(), out.data_ptr(), batch, seq, d, m_dim,
                     n, int(bool(normalize)),
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mux_score kernel launch failed: CUDA error {rc}")
    return out


def mux_score_cuda(meta, v, cost, *, normalize: bool = True) -> torch.Tensor:
    """The meta form.  meta: (B, M); v: (N, M); cost: (N,), all on one
    CUDA device.  Returns weights (B, N) fp32.  Operands are read as
    contiguous fp32 (cast here only when given otherwise).  Raises on
    anything the kernel does not take — never computes on the CPU."""
    if meta.dim() != 2:
        raise ValueError(f"mux_score kernel: meta must be (B, M), got "
                         f"{tuple(meta.shape)}")
    b, m_dim = meta.shape
    n = _check("mux_score", meta, v, cost, m_dim)
    return _launch(False, _f32(meta), None, _f32(v), _f32(cost), b, 1, 0,
                   m_dim, n, normalize)


def mux_head_cuda(h, w_out, v, cost, *, normalize: bool) -> torch.Tensor:
    """The head form.  h: (B, S, d) the probe's last hidden states, S >= 1;
    w_out: (d, M); v: (N, M); cost: (N,) (already raised to the cost
    exponent), all on one CUDA device.  Returns softmax_i((v_i .
    n(tanh(mean_s(h) @ w_out))) / cost_i) (B, N) fp32, n the L2
    normalisation when ``normalize``.  Operands are read as contiguous
    fp32 (cast here only when given otherwise).  Raises on anything the
    kernel does not take — never computes on the CPU."""
    if h.dim() != 3:
        raise ValueError(f"mux_head kernel: h must be (B, S, d), got "
                         f"{tuple(h.shape)}")
    b, s, d = h.shape
    if w_out.dim() != 2 or w_out.shape[0] != d:
        raise ValueError(f"mux_head kernel: w_out {tuple(w_out.shape)} does "
                         f"not match d = {d}")
    m_dim = w_out.shape[1]
    n = _check("mux_head", h, v, cost, m_dim)
    if w_out.device != h.device:
        raise ValueError("mux_head kernel: operands on different devices")
    if s < 1 and b > 0:
        raise ValueError("mux_head kernel: the mean over S needs S >= 1")
    return _launch(True, _f32(h), _f32(w_out), _f32(v), _f32(cost), b, s, d,
                   m_dim, n, normalize)
