"""Whole-prompt flash attention: the CUDA kernel's launcher and its
plain PyTorch version.

Port of ``repro.kernels.flash_attention``.  The TPU kernel it replaces
(``flash_attention`` / ``_attn_kernel``) becomes
``csrc/flash_attention.cu`` for sm_90a — see that file for the design
and what bounds it.  :func:`flash_attention_cuda` checks and launches
it; :func:`flash_attention_plain` is the same function in plain
PyTorch.  Callers go through ``repro_torch.kernels.ops.attention``,
which picks one of the two by the tensors' device (and runs the
model's own ``blocked_attention`` on the CPU, as the JAX dispatcher
does off the TPU).

Causal alignment is top-left: query i sees keys <= i whatever T is.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64                # csrc kRows: g * block_q per block
MAX_HEAD_DIM = 256           # csrc: 16 float4 quads per lane


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          logit_cap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q scaled in fp32 after the
    upcast (as the kernel, and the TPU kernel, do), then the
    materialising oracle ``ref.flash_attention_ref``.  Returns
    (B, S, H, vd) in q.dtype."""
    scale_ = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = ref.flash_attention_ref(q.float() * scale_, k.float(), v.float(),
                                  causal=causal, window=window, chunk=chunk,
                                  logit_cap=logit_cap, scale=1.0)
    return out.to(q.dtype)


def block_q_for(group: int, seq_len: int) -> int:
    """Query positions per block: the block's g * block_q rows fit the
    kernel's 64."""
    return max(1, min(MAX_ROWS // group, seq_len))


def rows_without_keys(seq_len: int, kv_len: int, *, causal: bool,
                      window: Optional[int], chunk: Optional[int]) -> int:
    """How many query rows see no key at all under these masks (only
    possible with S > T or without the causal rule).  The reference
    gives such a row a uniform softmax over every key; the kernel
    refuses the input instead."""
    if causal and seq_len <= kv_len:
        return 0                # query i always sees key i
    qp = np.arange(seq_len)
    hi = np.minimum(qp, kv_len - 1) if causal else np.full_like(qp,
                                                                kv_len - 1)
    lo = np.zeros_like(qp)
    if window is not None:
        lo = np.maximum(lo, qp - window + 1)
    if chunk is not None:
        lo = np.maximum(lo, (qp // chunk) * chunk)
    return int((lo > hi).sum())


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_launch
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       cf, cf, ci, ci, ci, vp]
        fn.restype = ci
        _lib = fn
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on q's current CUDA stream.

    q (B, S, H, hd); k (B, T, K, hd); v (B, T, K, vd); contiguous, one
    dtype (float32 or bfloat16), H % K == 0, hd and vd <= 256, group
    H / K <= 64.  Returns (B, S, H, vd) in q.dtype.  Raises on anything
    the kernel does not take — never computes on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("flash_attention kernel: CUDA is not available")
    dev = q.device
    _require(dev.type == "cuda", f"q must be a CUDA tensor, got {dev}")
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k, v must be 4-d (B, S|T, heads, dim)")
    b, s, h, hd = q.shape
    t, kk = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    _require(tuple(k.shape) == (b, t, kk, hd),
             f"k {tuple(k.shape)} vs q {tuple(q.shape)}")
    _require(tuple(v.shape[:3]) == (b, t, kk),
             f"v {tuple(v.shape)} vs k {tuple(k.shape)}")
    _require(kk > 0 and h % kk == 0,
             f"{h} query heads not a multiple of {kk} kv heads")
    g = h // kk
    _require(g <= MAX_ROWS, f"group {g} > {MAX_ROWS}")
    _require(0 < hd <= MAX_HEAD_DIM and 0 < vd <= MAX_HEAD_DIM,
             f"head dims {hd}/{vd} outside (0, {MAX_HEAD_DIM}]")
    _require(q.dtype in _DTYPE_CODE and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: one of float32, "
             f"bfloat16 for all three")
    for x in (k, v):
        _require(x.device == dev, f"operand on {x.device}, q on {dev}")
    for x in (q, k, v):
        _require(x.is_contiguous(), "operands must be contiguous")
    _require(t > 0, "no keys (T = 0)")
    for name, val in (("window", window), ("chunk", chunk)):
        _require(val is None or val >= 1, f"{name} must be >= 1, got {val}")
    _require(rows_without_keys(s, t, causal=causal, window=window,
                               chunk=chunk) == 0,
             "some query rows see no key under these masks")
    out = torch.empty((b, s, h, vd), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out
    scale_ = scale if scale is not None else 1.0 / math.sqrt(hd)
    rc = _launcher()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, t, kk, g, hd, vd, block_q_for(g, s),
        float(scale_), float(logit_cap) if logit_cap is not None else 0.0,
        int(bool(causal)), int(window) if window is not None else 0,
        int(chunk) if chunk is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out
