"""Plain PyTorch versions of the port's kernels — the arithmetic the
CUDA kernels are held against, and what the dispatch layer
(repro_torch.kernels.ops) runs for tensors on the CPU.

Ports of ``repro.kernels.ref.flash_attention_ref``,
``paged_attention_ref``, ``selective_scan_ref`` (with a start state
``h0``) and ``mux_score_ref``, with ``mux_head_ref``, the probe's
whole fused head (mean pool, out projection and tanh before
``mux_score_ref``).  They repeat the kernels' arithmetic
at full materialisation and are no yardstick of speed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_mask(s: int, t: int, *, causal: bool, window: Optional[int],
               chunk: Optional[int], device=None) -> torch.Tensor:
    """(S, T) bool: which keys each query sees (top-left causal, the
    window kv > q - window, the chunk floor kv >= (q // chunk) * chunk)."""
    q_pos = torch.arange(s, device=device)[:, None]
    kv_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= kv_pos > q_pos - window
    if chunk is not None:
        floor = torch.div(q_pos, chunk, rounding_mode="floor") * chunk
        mask &= kv_pos >= floor
    return mask


def flash_scores(q, k, *, causal: bool = True, window: Optional[int] = None,
                 chunk: Optional[int] = None,
                 logit_cap: Optional[float] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """The fp32 scores (B, K, g, S, T) of q (B, S, H, hd) against k
    (B, T, K, hd) — q scaled in its own dtype, then the tanh cap — with
    masked entries at ``NEG_INF``."""
    b, s, h, hd = q.shape
    t, kk = k.shape[1], k.shape[2]
    g = h // kk
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qr = (q * scale).reshape(b, s, kk, g, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qr.float(), k.float())
    if logit_cap is not None:
        sc = torch.tanh(sc / logit_cap) * logit_cap
    mask = flash_mask(s, t, causal=causal, window=window, chunk=chunk,
                      device=q.device)
    return torch.where(mask[None, None, None], sc,
                       torch.full_like(sc, NEG_INF))


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive full-materialisation attention.

    q: (B, S, H, hd); k/v: (B, T, K, hd|vd); H % K == 0.  Causal
    alignment is top-left (query i sees keys <= i).  q is scaled in its
    own dtype, the scores and softmax are fp32.
    Returns (B, S, H, vd) in q.dtype.
    """
    b, s, h, _ = q.shape
    sc = flash_scores(q, k, causal=causal, window=window, chunk=chunk,
                      logit_cap=logit_cap, scale=scale)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkv->bskgv", p, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        scale: Optional[float] = None,
                        logit_cap: Optional[float] = None) -> torch.Tensor:
    """Naive paged decode attention: gather pages via block table, mask
    by per-row length, full-materialisation softmax.

    q: (B, H, hd) one query token per row; k_pages/v_pages:
    (P, page_size, K, hd|vd) pool-wide page slabs; block_tables: (B, M)
    page ids ordered by logical position; lengths: (B,) visible tokens
    per row (the query sits at lengths - 1).
    Returns (B, H, vd) in q.dtype; rows with length 0 are exact zeros.
    """
    b, h, hd = q.shape
    kk = k_pages.shape[2]
    g = h // kk
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, -1, kk, k_pages.shape[-1])
    v = v_pages[bt].reshape(b, -1, kk, v_pages.shape[-1])
    t = k.shape[1]
    qr = (q * scale).reshape(b, kk, g, hd)
    sc = torch.einsum("bkgd,btkd->bkgt", qr.float(), k.float())
    if logit_cap is not None:
        sc = torch.tanh(sc / logit_cap) * logit_cap
    lengths = lengths.to(device=q.device, dtype=torch.long).reshape(-1)
    kv_pos = torch.arange(t, device=q.device)[None, :]          # (1, T)
    q_pos = lengths[:, None] - 1                                 # (B, 1)
    mask = kv_pos < lengths[:, None]
    if window is not None:
        mask &= kv_pos > q_pos - window
    if chunk is not None:
        mask &= kv_pos >= torch.div(q_pos, chunk, rounding_mode="floor") * chunk
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkv->bkgv", p, v.float())
    out = out.reshape(b, h, v.shape[-1])
    # a row with length 0 has an all-masked softmax; the kernel
    # contract for such rows is exact zeros
    out = torch.where(lengths[:, None, None] > 0, out, torch.zeros_like(out))
    return out.to(q.dtype)


def selective_scan_ref(x, dt, b_mat, c_mat, a_mat, d_vec, h0=None):
    """Sequential-in-time Mamba-1 recurrence (fp32).

    x/dt: (B, S, d_in); b_mat/c_mat: (B, S, n); a_mat: (d_in, n);
    d_vec: (d_in,); h0: (B, d_in, n) start state (zeros when None).
    For each t: h = exp(dt_t A) * h + (dt_t x_t) B_t, y_t = h C_t + D x_t.
    Returns (y (B, S, d_in) fp32, h_final (B, d_in, n) fp32).
    """
    xf, dtf = x.float(), dt.float()
    bf, cf, af = b_mat.float(), c_mat.float(), a_mat.float()
    b, s, d_in = x.shape
    h = (torch.zeros((b, d_in, a_mat.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t, :, None] * af[None])         # (B,d_in,n)
        h = decay * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = (torch.stack(ys, 1) if ys else torch.zeros_like(xf))
    return y + xf * d_vec.float()[None, None], h


def mux_score_ref(meta, v, cost, *, normalize: bool = True) -> torch.Tensor:
    """Fused multiplexer head (paper Eq. 5-6).

    meta: (B, M) raw meta-features; v: (N, M); cost: (N,) relative FLOPs.
    Returns softmax_i((v_i . normalize(m)) / c_i): (B, N) fp32.
    """
    m = meta.float()
    if normalize:
        m = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True),
                            min=1e-6)
    logits = m @ v.float().T / cost.float()[None, :]
    return torch.softmax(logits, dim=-1)


def mux_head_ref(h, w_out, v, cost, *, normalize: bool) -> torch.Tensor:
    """The token probe's fused head: meta = tanh(mean_s(h) @ w_out), then
    :func:`mux_score_ref`.

    h: (B, S, d) the probe's last hidden states; w_out: (d, M); v: (N, M);
    cost: (N,) relative FLOPs already raised to the cost exponent.
    Returns (B, N) fp32.
    """
    meta = torch.tanh(h.float().mean(dim=1) @ w_out.float())
    return mux_score_ref(meta, v, cost, normalize=normalize)
