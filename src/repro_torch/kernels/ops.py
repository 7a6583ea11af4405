"""Dispatch by the tensors' device: a CPU tensor gets a plain PyTorch
path (the kernel's plain version; for whole-prompt attention the
model's ``blocked_attention``, as the JAX dispatcher runs off the
TPU), a CUDA tensor gets the hand-written kernel — or an exception.
There is no switch and no fallback: a CUDA request that the kernel
cannot serve raises instead of computing elsewhere.

``launches`` counts, per kernel, the calls that launched it (the
plain path does not count), so a run can show that its main path went
through the kernels; K3's wrapper also counts each launch under the
variant it launched (``flash_attention_wgmma`` or
``flash_attention_simt``), and K1's also under the form of its operands
where it is not the plain one: ``paged_attention_int8`` (int8 pages and
their scales) and ``paged_attention_latent`` (absorbed MLA: V read as
the leading ``v_dim`` features of the K pages themselves).  K1 and K3
also count a launch that masks by a sliding window (a ``swa`` layer's)
under ``paged_attention_window`` / ``flash_attention_window``.  K3's
backward counts one ``flash_attention_bwd`` a backward call (its
forward, K3 with row log-sum-exps, counts as a K3 launch).  K2's two
forms both count under ``mux_score``.  A call made while its thread
captures a CUDA graph launches nothing: inside :func:`tally_launches`
it adds to that capture's tally instead, and each replay of the graph
adds the tally to ``launches`` (``repro_torch.graphs.CudaGraphed``).
Counter reads and resets belong to the caller (``reset_launches``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.mux_score import mux_head_cuda, mux_score_cuda
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.selective_scan import selective_scan_cuda

launches: Dict[str, int] = {"paged_attention": 0, "paged_attention_int8": 0,
                             "paged_attention_latent": 0,
                             "paged_attention_window": 0, "mux_score": 0,
                             "flash_attention": 0, "flash_attention_wgmma": 0,
                             "flash_attention_simt": 0,
                             "flash_attention_window": 0,
                             "flash_attention_bwd": 0, "selective_scan": 0}


_capture = threading.local()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _counts() -> Dict[str, int]:
    """Where this thread's launches count: ``launches``, or the open
    tally of a capture on this thread."""
    tally = getattr(_capture, "tally", None)
    return launches if tally is None else tally


@contextlib.contextmanager
def tally_launches() -> Iterator[Dict[str, int]]:
    """While open, the wrappers called on this thread (and only on it)
    add their launches to the yielded tally, not to ``launches``: for a
    capture, whose replays launch what it recorded."""
    outer = getattr(_capture, "tally", None)
    _capture.tally = dict.fromkeys(launches, 0)
    try:
        yield _capture.tally
    finally:
        _capture.tally = outer


def add_launches(tally: Dict[str, int]) -> None:
    """Count the launches of a tally (one replay of a captured graph)."""
    for name, n in tally.items():
        launches[name] += n


class FlashAttention(torch.autograd.Function):
    """K3 under autograd on the card: the forward launches K3 with row
    log-sum-exps and saves q, k, v, out and lse; the backward launches
    K3's backward kernel.  Both count in the dispatcher's counters the
    forward was given (under a non-reentrant checkpoint the forward runs
    again, and counts again, inside the backward pass)."""

    @staticmethod
    def forward(ctx, q, k, v, kw, counts):
        out, lse = flash_attention_cuda(q, k, v, counts=counts, lse=True,
                                        **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw, ctx.counts = kw, counts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                              dout.contiguous(),
                                              counts=ctx.counts, **ctx.kw)
        return dq, dk, dv, None, None


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def attention(q, k, v, *, causal: bool = True,
              window: Optional[int] = None, chunk: Optional[int] = None,
              logit_cap: Optional[float] = None,
              scale: Optional[float] = None):
    """Whole-prompt attention.  q (B, S, H, hd); k/v (B, T, K, hd|vd);
    causal alignment top-left.  A CPU tensor gets the model's
    ``blocked_attention`` (what ``repro.kernels.ops.attention`` runs off
    the TPU; autograd differentiates it, as JAX does the reference's), a
    CUDA tensor the flash-attention kernel's variant for its dtype
    (bf16: wgmma, fp32: SIMT), which counts its launch in ``launches``;
    where a gradient is needed, through :class:`FlashAttention`, whose
    backward is K3's backward kernel.  Returns (B, S, H, vd) in
    q.dtype."""
    if q.device.type == "cpu":
        from repro_torch.models.attention import blocked_attention
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk, scale=scale,
                                 logit_cap=logit_cap)
    counts = _counts()
    kw = dict(causal=causal, window=window, chunk=chunk, logit_cap=logit_cap,
              scale=scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        out = FlashAttention.apply(q, k, v, kw, counts)
    else:
        out = flash_attention_cuda(q, k, v, counts=counts, **kw)
    if window is not None:
        counts["flash_attention_window"] += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: Optional[int] = None,
                    chunk: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    scale: Optional[float] = None,
                    k_scales=None, v_scales=None,
                    v_dim: Optional[int] = None,
                    prefetch=None):
    """Paged decode attention.  q: (B, H, hd) one token per row;
    k_pages/v_pages: (P, page_size, K, hd|vd); block_tables: (B, M);
    lengths: (B,); int8 pages carry (P, page_size, K) bf16 scales.
    ``prefetch`` is the combined (B, M+1) operand from
    :func:`repro_torch.kernels.paged_attention.decode_prefetch`, built
    once per decode step; the plain version reads block_tables/lengths
    directly.  Returns (B, H, vd) in q.dtype; rows of length 0 are exact
    zeros."""
    kw = dict(window=window, chunk=chunk, logit_cap=logit_cap, scale=scale,
              k_scales=k_scales, v_scales=v_scales, v_dim=v_dim)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, **kw)
    out = paged_attention_cuda(q, k_pages, v_pages, block_tables, lengths,
                               prefetch=prefetch, **kw)
    counts = _counts()
    counts["paged_attention"] += 1
    if k_scales is not None:
        counts["paged_attention_int8"] += 1
    if v_dim is not None and v_pages is k_pages:
        counts["paged_attention_latent"] += 1
    if window is not None:
        counts["paged_attention_window"] += 1
    return out


def selective_scan(x, dt, b_mat, c_mat, a_mat, d_vec, h0=None):
    """Mamba-1 scan from start state ``h0`` (zeros when None).
    x/dt: (B, S, d_in); b_mat/c_mat: (B, S, n); a_mat: (d_in, n);
    d_vec: (d_in,).  Returns (y (B, S, d_in) fp32 including D * x,
    h_final (B, d_in, n) fp32).  On the CPU autograd differentiates the
    plain version; K4 has no backward yet, so a non-CPU call that needs
    a gradient raises instead of returning a detached result."""
    if x.device.type == "cpu":
        return ref.selective_scan_ref(x, dt, b_mat, c_mat, a_mat, d_vec, h0)
    if _needs_grad(x, dt, b_mat, c_mat, a_mat, d_vec, h0):
        raise NotImplementedError(
            "selective_scan on the card has no backward: Mamba training on "
            "the card waits for K4's gradient (ROADMAP.md, queue 1)")
    out = selective_scan_cuda(x.contiguous(), dt, b_mat, c_mat, a_mat, d_vec,
                              h0)
    _counts()["selective_scan"] += 1
    return out


def mux_score(meta, v, cost, *, normalize: bool = True):
    """Fused router head: weights (B, N) fp32 from meta (B, M), v (N, M)
    and cost (N,)."""
    if meta.device.type == "cpu":
        return ref.mux_score_ref(meta, v, cost, normalize=normalize)
    out = mux_score_cuda(meta, v, cost, normalize=normalize)
    _counts()["mux_score"] += 1
    return out


def mux_head(h, w_out, v, cost, *, normalize: bool):
    """The token probe's fused head: weights (B, N) fp32 from its last
    hidden states h (B, S, d), the out projection w_out (d, M), v (N, M)
    and cost (N,) raised to the cost exponent."""
    if h.device.type == "cpu":
        return ref.mux_head_ref(h, w_out, v, cost, normalize=normalize)
    out = mux_head_cuda(h, w_out, v, cost, normalize=normalize)
    _counts()["mux_score"] += 1
    return out
