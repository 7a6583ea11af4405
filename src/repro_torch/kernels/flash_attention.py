"""Whole-prompt flash attention: the CUDA kernels' launcher and their
plain PyTorch version.

Port of ``repro.kernels.flash_attention``.  The TPU kernel it replaces
(``flash_attention`` / ``_attn_kernel``) has two variants on the card,
chosen by dtype in :func:`flash_plan`: bf16 operands go to the
tensor-core variant ``csrc/flash_attention_sm90.cu`` (``wgmma``
products fed by a TMA / mbarrier ring), fp32 operands to the SIMT
variant ``csrc/flash_attention.cu`` (fp32 FMAs) — see those files for
the designs and what bounds them.  :func:`flash_attention_cuda` checks
and launches the planned variant; :func:`flash_attention_plain` is the
same function in plain PyTorch.  Callers go through
``repro_torch.kernels.ops.attention``, which picks one of the two by
the tensors' device (and runs the model's own ``blocked_attention`` on
the CPU, as the JAX dispatcher does off the TPU).

K3's gradient (the TPU kernel has none; the JAX package trains through
plain attention and autodiff): either variant can also write each row's
log-sum-exp (``lse=True``), from which ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd_cuda`) computes dq, dk and dv; its plain
versions are :func:`flash_attention_lse_plain` and
:func:`flash_attention_bwd_plain`.  ``ops.FlashAttention`` binds the two
kernels as one autograd function.

Causal alignment is top-left: query i sees keys <= i whatever T is.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

MAX_ROWS = 64                  # csrc kRows: g * block_q per block
MAX_HEAD_DIM = 256             # SIMT: 16 float4 quads a lane; wgmma: 4 chunks
WGMMA_WIDTHS = (64, 128, 256)  # padded head widths of the wgmma variant
MAX_Q_TILES = 65535            # wgmma: q tiles run along grid.y
MAX_BWD_DIM = 128              # csrc/flash_attention_bwd.cu kMaxDim
_VARIANTS = {torch.bfloat16: "wgmma", torch.float32: "simt"}


def _scale_of(q, scale: Optional[float]) -> float:
    """The query scale: ``scale``, or 1 / sqrt(hd)."""
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          logit_cap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q scaled in fp32 after the
    upcast (as the kernel, and the TPU kernel, do), then the
    materialising oracle ``ref.flash_attention_ref``.  Returns
    (B, S, H, vd) in q.dtype."""
    out = ref.flash_attention_ref(q.float() * _scale_of(q, scale), k.float(),
                                  v.float(), causal=causal, window=window,
                                  chunk=chunk, logit_cap=logit_cap, scale=1.0)
    return out.to(q.dtype)


def flash_attention_lse_plain(q, k, *, causal: bool = True,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None,
                              logit_cap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Each row's log-sum-exp of its visible (scaled, capped) scores, the
    scores of :func:`flash_attention_plain` (q scaled in fp32 after the
    upcast): (B, H, S) fp32, what the kernels write with ``lse=True``."""
    b, s, h, _ = q.shape
    sc = ref.flash_scores(q.float() * _scale_of(q, scale), k.float(),
                          causal=causal, window=window, chunk=chunk,
                          logit_cap=logit_cap, scale=1.0)
    return torch.logsumexp(sc, dim=-1).reshape(b, h, s)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None,
                              logit_cap: Optional[float] = None,
                              scale: Optional[float] = None):
    """Plain PyTorch version of the backward kernel: from q, k, v, the
    forward's ``out`` and row log-sum-exp ``lse`` (B, H, S) and ``dout``,
    with P recomputed from ``lse``, D = rowsum(dout * out) and dS =
    P (dP - D) (times 1 - tanh^2 under the cap), returns (dq, dk, dv)
    in fp32; dk and dv are summed over each KV head's query heads."""
    b, s, h, hd = q.shape
    t, kk, vd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kk
    sc_ = _scale_of(q, scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    x = torch.einsum("bskgd,btkd->bkgst", (qf * sc_).reshape(b, s, kk, g, hd),
                     kf)
    dy = 1.0
    if logit_cap is not None:
        th = torch.tanh(x / logit_cap)
        x, dy = th * logit_cap, 1.0 - th * th
    mask = ref.flash_mask(s, t, causal=causal, window=window, chunk=chunk,
                          device=q.device)
    p = torch.where(mask, torch.exp(x - lse.float().reshape(b, kk, g, s, 1)),
                    0.0)
    do = dout.float().reshape(b, s, kk, g, vd)
    dp = torch.einsum("bskgv,btkv->bkgst", do, vf)
    delta = (do * out.float().reshape(b, s, kk, g, vd)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * dy
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(b, s, h, hd) * sc_
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      qf.reshape(b, s, kk, g, hd)) * sc_
    dv = torch.einsum("bkgst,bskgv->btkv", p, do)
    return dq, dk, dv


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


class FlashPlan(NamedTuple):
    """What a launch on the card takes from the plan.  ``variant`` is
    "wgmma" (bf16, ``csrc/flash_attention_sm90.cu``) or "simt" (fp32,
    ``csrc/flash_attention.cu``); a block serves ``group`` heads x
    ``block_q`` positions of one KV head.  For the wgmma variant,
    ``width`` is the one padded width q, k and v are laid out at in
    shared memory (TMA zero-fills the rest), and ``longest_first`` has
    its blocks take the q tiles from the last, which under the causal
    rule sees the most keys.  The SIMT variant pads inside its launch
    and counts its tiles up (``width`` 0, ``longest_first`` False)."""
    variant: str
    group: int
    block_q: int
    width: int
    longest_first: bool


def _refuse(msg: str):
    raise ValueError(f"flash_attention kernel: {msg}")


@functools.lru_cache(maxsize=256)
def flash_plan(q_shape, k_shape, v_shape, dtype, *, causal: bool = True,
               window: Optional[int] = None,
               chunk: Optional[int] = None) -> FlashPlan:
    """The variant and tiling for q (B, S, H, hd), k (B, T, K, hd), v
    (B, T, K, vd) of ``dtype`` under these masks: bf16 goes to the
    tensor-core ("wgmma") variant, fp32 to the SIMT one.  Raises
    ValueError for what neither variant takes; there is no fallback
    from one to the other.  Cached by its arguments: a prefill asks
    once per layer with the same ones."""
    if not (len(q_shape) == 4 and len(k_shape) == 4 and len(v_shape) == 4):
        _refuse("q, k, v must be 4-d (B, S|T, heads, dim)")
    b, s, h, hd = q_shape
    t, kk = k_shape[1], k_shape[2]
    vd = v_shape[-1]
    if tuple(k_shape) != (b, t, kk, hd):
        _refuse(f"k {tuple(k_shape)} vs q {tuple(q_shape)}")
    if tuple(v_shape[:3]) != (b, t, kk):
        _refuse(f"v {tuple(v_shape)} vs k {tuple(k_shape)}")
    if kk <= 0 or h % kk:
        _refuse(f"{h} query heads not a multiple of {kk} kv heads")
    g = h // kk
    if g > MAX_ROWS:
        _refuse(f"group {g} > {MAX_ROWS}")
    if not (0 < hd <= MAX_HEAD_DIM and 0 < vd <= MAX_HEAD_DIM):
        _refuse(f"head dims {hd}/{vd} outside (0, {MAX_HEAD_DIM}]")
    variant = _VARIANTS.get(dtype)
    if variant is None:
        _refuse(f"dtype {dtype}: the kernels take bfloat16 or float32")
    if t <= 0:
        _refuse("no keys (T = 0)")
    for name, val in (("window", window), ("chunk", chunk)):
        if val is not None and val < 1:
            _refuse(f"{name} must be >= 1, got {val}")
    if rows_without_keys(s, t, causal=causal, window=window, chunk=chunk):
        _refuse("some query rows see no key under these masks")
    bq = block_q_for(g, s)
    if variant == "simt":
        return FlashPlan("simt", g, bq, 0, False)
    if hd % 8 or vd % 8:
        _refuse(f"head dims {hd}/{vd} must be multiples of 8 (TMA strides "
                f"of 16 bytes)")
    q_tiles = -(-s // bq)
    if q_tiles > MAX_Q_TILES:
        _refuse(f"{q_tiles} q tiles > {MAX_Q_TILES}")
    width = next(w for w in WGMMA_WIDTHS if max(hd, vd) <= w)
    return FlashPlan("wgmma", g, bq, width, causal)


_launchers = {}


def _launcher(variant: str):
    """The C entry point of a variant's library, built at first use."""
    fn = _launchers.get(variant)
    if fn is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if variant == "wgmma":
            fn = build.load("flash_attention_sm90").flash_attention_sm90_launch
            ints = 10       # batch .. g, hd, vd, width, block_q, longest_first
        else:
            fn = build.load("flash_attention").flash_attention_launch
            ints = 8        # batch .. g, hd, vd, block_q
        fn.argtypes = [vp] * 5 + [ci] * ints + [cf, cf, ci, ci, ci, vp]
        fn.restype = ci
        _launchers[variant] = fn
    return fn


def wgmma_block_k() -> int:
    """Keys per K/V tile of the wgmma variant (asks the built library;
    needs nvcc)."""
    fn = build.load("flash_attention_sm90").flash_attention_sm90_block_k
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def wgmma_smem_bytes(width: int) -> int:
    """Dynamic shared memory of a wgmma-variant launch at padded width
    ``width`` (asks the built library; needs nvcc)."""
    fn = build.load("flash_attention_sm90").flash_attention_sm90_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(width)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         scale: Optional[float] = None,
                         counts: Optional[Dict[str, int]] = None,
                         lse: bool = False):
    """Launch the variant :func:`flash_plan` picks on q's current CUDA
    stream.  Where ``counts`` is given (the dispatcher's
    ``ops.launches``), a launch adds one to ``flash_attention`` and one
    to ``flash_attention_<variant>`` of the variant it launched.  With
    ``lse`` the kernel also writes each row's log-sum-exp, (B, H, S)
    fp32, and the call returns (out, lse) — the backward's input.

    q (B, S, H, hd); k (B, T, K, hd); v (B, T, K, vd); contiguous, one
    dtype (bfloat16: the wgmma variant, hd and vd multiples of 8, 16-byte
    aligned; float32: the SIMT variant), H % K == 0, hd and vd <= 256,
    group H / K <= 64.  Returns (B, S, H, vd) in q.dtype.  Raises on
    anything the kernels do not take — never computes on the CPU."""
    dev = q.device
    if dev.type != "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flash_attention kernel: CUDA is not available")
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        _refuse(f"q, k, v must be on one CUDA device, got {dev}, "
                f"{k.device}, {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        _refuse(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} differ")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        _refuse("operands must be contiguous")
    p = flash_plan(q.shape, k.shape, v.shape, q.dtype, causal=causal,
                   window=window, chunk=chunk)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if p.variant == "wgmma" and (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        _refuse("operands must be 16-byte aligned (TMA)")
    b, s, h, hd = q.shape
    t, kk, vd = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, s, h, vd), dtype=q.dtype, device=dev)
    row_lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
               if lse else None)
    if out.numel() == 0:
        return (out, row_lse) if lse else out
    tiling = ((p.width, p.block_q, int(p.longest_first))
              if p.variant == "wgmma" else (p.block_q,))
    rc = _launcher(p.variant)(
        *ptrs, out.data_ptr(), 0 if row_lse is None else row_lse.data_ptr(),
        b, s, t, kk, p.group, hd, vd, *tiling,
        _scale_of(q, scale), logit_cap or 0.0, int(causal), window or 0,
        chunk or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({p.variant}) launch "
                           f"failed: CUDA error {rc}"
                           + (" (tensor-map encode)" if rc >= 1000 else ""))
    if counts is not None:
        counts["flash_attention"] += 1
        counts["flash_attention_" + p.variant] += 1
    return (out, row_lse) if lse else out


@functools.lru_cache(maxsize=256)
def flash_bwd_plan(q_shape, k_shape, v_shape, dtype, *, causal: bool = True,
                   window: Optional[int] = None,
                   chunk: Optional[int] = None) -> None:
    """Refuse (ValueError) what the backward kernel does not take: all
    that :func:`flash_plan` refuses, and S != T, hd or vd above 128 or
    not a multiple of 8."""
    flash_plan(q_shape, k_shape, v_shape, dtype, causal=causal,
               window=window, chunk=chunk)
    s, hd, t, vd = q_shape[1], q_shape[3], k_shape[1], v_shape[3]
    if s != t:
        _refuse(f"backward needs S == T, got S {s}, T {t}")
    for name, d in (("hd", hd), ("vd", vd)):
        if d > MAX_BWD_DIM or d % 8:
            _refuse(f"backward takes {name} <= {MAX_BWD_DIM} and a multiple "
                    f"of 8, got {d}")


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: Optional[int] = None,
                             chunk: Optional[int] = None,
                             logit_cap: Optional[float] = None,
                             scale: Optional[float] = None,
                             counts: Optional[Dict[str, int]] = None):
    """Launch K3's backward (``csrc/flash_attention_bwd.cu``) on q's
    current CUDA stream: (dq, dk, dv) in q's dtype from the forward's
    inputs, its ``out`` and ``lse`` (B, H, S) fp32 (``lse=True``) and
    ``dout``.  All of q, k, v, out and dout share one dtype (bfloat16
    or float32) and are contiguous.  Shapes are checked first
    (:func:`flash_bwd_plan`, ValueError), then the device; nothing is
    computed on the CPU.  Where ``counts`` is given, a call adds one to
    ``flash_attention_bwd``."""
    b, s, h, hd = q.shape
    flash_bwd_plan(tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype,
                   causal=causal, window=window, chunk=chunk)
    kk, vd = k.shape[2], v.shape[-1]
    for name, x in (("out", out), ("dout", dout)):
        if tuple(x.shape) != (b, s, h, vd) or x.dtype != q.dtype:
            _refuse(f"{name} {tuple(x.shape)} {x.dtype}, want "
                    f"{(b, s, h, vd)} {q.dtype}")
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        _refuse(f"lse {tuple(lse.shape)} {lse.dtype}, want {(b, h, s)} "
                f"float32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        _refuse(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} differ")
    tensors = (q, k, v, out, lse, dout)
    dev = q.device
    if dev.type != "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flash_attention kernel: CUDA is not available")
    if any(x.device != dev for x in tensors) or dev.type != "cuda":
        _refuse("q, k, v, out, lse, dout must be on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        _refuse("backward operands must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        _refuse("backward operands must be 16-byte aligned (tile copies)")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    rc = _bwd_launcher()(
        *(x.data_ptr() for x in (q, k, v, out, lse, dout, delta, dq, dk, dv)),
        b, s, kk, h // kk, hd, vd, _scale_of(q, scale), logit_cap or 0.0,
        int(causal), window or 0, chunk or 0, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc}")
    if counts is not None:
        counts["flash_attention_bwd"] += 1
    return dq, dk, dv


def _bwd_launcher():
    """The backward library's C entry point, built at first use."""
    fn = _launchers.get("bwd")
    if fn is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
        fn.argtypes = [vp] * 10 + [ci] * 6 + [cf, cf] + [ci] * 4 + [vp]
        fn.restype = ci
        _launchers["bwd"] = fn
    return fn
