"""Paged decode attention: the CUDA kernel's launcher, its plain
PyTorch version, and the host helpers around it.

Port of ``repro.kernels.paged_attention``.  The TPU kernel it replaces
(``paged_attention`` / ``_paged_attn_kernel``) becomes
``csrc/paged_attention.cu`` for sm_90a — see that file for the design
and what bounds it.  :func:`paged_attention_cuda` checks and launches
it; :func:`paged_attention_plain` is the same function in plain
PyTorch.  Callers go through ``repro_torch.kernels.ops``, which picks
one of the two by the tensors' device.

:func:`decode_prefetch` packs a decode step's block tables and lengths
into the one ``(B, M+1)`` int32 operand the kernel reads (built once
per step, shared by every layer); :func:`decode_hbm_bytes` is the TPU
kernel's analytic K/V byte count of one call, page-granular.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 256           # csrc kMaxHdPerLane * 32
MAX_GROUP_OUT = 2048         # csrc kThreads * kMaxOutPerThread


def decode_prefetch(block_tables, lengths) -> torch.Tensor:
    """Pack a decode step's block tables (B, M) and per-row lengths (B,)
    into ONE (B, M+1) int32 operand: columns 0..M-1 are page ids, column
    M is the row's length.  Pass it as ``paged_attention(...,
    prefetch=...)``."""
    bt = torch.as_tensor(block_tables).to(torch.int32)
    ln = torch.as_tensor(lengths, device=bt.device).to(torch.int32)
    return torch.cat([bt, ln.reshape(bt.shape[0], 1)], dim=1).contiguous()


def decode_hbm_bytes(k_pages, v_pages, block_tables, lengths, *,
                     window: Optional[int] = None,
                     chunk: Optional[int] = None,
                     v_dim: Optional[int] = None) -> int:
    """Analytic K/V device-memory bytes of one call of the TPU kernel:
    a host-side mirror of its per-page liveness test (length / window /
    chunk), counting whole live pages (and their int8 scale slabs) once
    per (row, kv_head).  The CUDA kernel reads only the visible tokens
    of each live page, so this is an upper bound on its K/V traffic.
    """
    ps = int(k_pages.shape[1])
    kk = int(k_pages.shape[2])
    hd = int(k_pages.shape[3])
    vd = int(v_dim) if v_dim is not None else int(v_pages.shape[-1])
    visit = (ps * hd * k_pages.dtype.itemsize
             + ps * vd * v_pages.dtype.itemsize)
    if k_pages.dtype == torch.int8:     # two bf16 (slot, head) scale rows
        visit += 2 * ps * 2
    m = int(block_tables.shape[1])
    live_pages = 0
    for length in torch.as_tensor(lengths).reshape(-1).tolist():
        q_pos = length - 1
        for i in range(m):
            k_first, k_last = i * ps, i * ps + ps - 1
            live = k_first < length
            if window is not None:
                live &= k_last > q_pos - window
            if chunk is not None:
                live &= k_last >= (q_pos // chunk) * chunk
            live_pages += bool(live)
    return live_pages * kk * visit


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          logit_cap: Optional[float] = None,
                          scale: Optional[float] = None,
                          k_scales=None, v_scales=None,
                          v_dim: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int8 pages dequantise in
    fp32 (as the kernel, and the TPU kernel, do), ``v_dim`` slices the
    leading V features, then the gather oracle
    ``ref.paged_attention_ref``."""
    if k_pages.dtype == torch.int8:
        k_pages = k_pages.float() * k_scales.float()[..., None]
        v_pages = v_pages.float() * v_scales.float()[..., None]
    if v_dim is not None:
        v_pages = v_pages[..., :v_dim]
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, window=window, chunk=chunk,
                                   scale=scale, logit_cap=logit_cap)


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        fn = lib.paged_attention_launch
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, ci, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, cf, cf, ci, ci, vp]
        fn.restype = ci
        _lib = fn
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, lengths, *,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         scale: Optional[float] = None,
                         k_scales=None, v_scales=None,
                         v_dim: Optional[int] = None,
                         prefetch=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on q's current CUDA stream.

    Shapes as :func:`paged_attention_plain`; ``prefetch`` is the
    combined (B, M+1) operand from :func:`decode_prefetch` and replaces
    block_tables / lengths when given.  Block tables, lengths and the
    prefetch operand are int32.  Raises on anything the kernel does not
    take — never computes on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("paged_attention kernel: CUDA is not available")
    dev = q.device
    _require(dev.type == "cuda", f"q must be a CUDA tensor, got {dev}")
    b, h, hd = q.shape
    num_pages, ps, kk, k_hd = k_pages.shape
    v_ld = v_pages.shape[-1]
    vd = v_dim if v_dim is not None else v_ld
    _require(k_hd == hd, f"k head_dim {k_hd} != q head_dim {hd}")
    _require(v_pages.shape[:3] == (num_pages, ps, kk),
             f"v_pages {tuple(v_pages.shape)} vs k_pages "
             f"{tuple(k_pages.shape)}")
    _require(h % kk == 0, f"{h} query heads not a multiple of {kk} kv heads")
    g = h // kk
    _require(0 < vd <= v_ld, f"v_dim {vd} outside (0, {v_ld}]")
    _require(hd <= MAX_HEAD_DIM, f"head_dim {hd} > {MAX_HEAD_DIM}")
    _require(g * vd <= MAX_GROUP_OUT,
             f"group * v_dim = {g * vd} > {MAX_GROUP_OUT}")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q dtype {q.dtype} not float32/bfloat16")
    _require(k_pages.dtype in _DTYPE_CODE and v_pages.dtype == k_pages.dtype,
             f"page dtypes {k_pages.dtype}/{v_pages.dtype}")
    quantized = k_pages.dtype == torch.int8
    tensors = [q, k_pages, v_pages]
    if quantized:
        _require(k_scales is not None and v_scales is not None,
                 "int8 pages need k_scales and v_scales")
        for s in (k_scales, v_scales):
            _require(s.dtype == torch.bfloat16
                     and tuple(s.shape) == (num_pages, ps, kk),
                     f"scales must be bf16 {(num_pages, ps, kk)}, got "
                     f"{s.dtype} {tuple(s.shape)}")
        tensors += [k_scales, v_scales]
    if prefetch is not None:
        m = prefetch.shape[1] - 1
        _require(tuple(prefetch.shape) == (b, m + 1)
                 and prefetch.dtype == torch.int32,
                 f"prefetch must be int32 ({b}, M+1), got "
                 f"{prefetch.dtype} {tuple(prefetch.shape)}")
        tensors.append(prefetch)
        bt_ptr, bt_stride = prefetch.data_ptr(), m + 1
        len_ptr, len_stride = prefetch.data_ptr() + 4 * m, m + 1
    else:
        m = block_tables.shape[1]
        _require(tuple(block_tables.shape) == (b, m)
                 and block_tables.dtype == torch.int32,
                 f"block_tables must be int32 ({b}, M), got "
                 f"{block_tables.dtype} {tuple(block_tables.shape)}")
        _require(lengths.numel() == b and lengths.dtype == torch.int32,
                 f"lengths must be int32 ({b},), got {lengths.dtype} "
                 f"{tuple(lengths.shape)}")
        tensors += [block_tables, lengths]
        bt_ptr, bt_stride = block_tables.data_ptr(), m
        len_ptr, len_stride = lengths.data_ptr(), 1
    for t in tensors:
        _require(t.device == dev, f"operand on {t.device}, q on {dev}")
        _require(t.is_contiguous(), "operands must be contiguous")
    out = torch.empty((b, h, vd), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    scale_ = scale if scale is not None else 1.0 / math.sqrt(hd)
    rc = _launcher()(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        bt_ptr, bt_stride, len_ptr, len_stride, out.data_ptr(), b, kk, g, hd,
        v_ld, vd, ps, m, float(scale_),
        float(logit_cap) if logit_cap is not None else 0.0,
        int(window) if window is not None else 0,
        int(chunk) if chunk is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out
