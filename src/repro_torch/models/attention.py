"""Attention: projections, blocked prefill attention, masked decode /
causal attention over explicit KV views, the per-request ring KV cache
and the pool-wide paged KV store.

Port of the paged and ring subsets of ``repro.models.attention``.
Differences from the JAX package, by design:

* Cache tensors are updated **in place** (advanced-index assignment,
  i.e. ``index_put_``) where JAX returns a new cache from a donated one:
  ``cache_insert`` / ``cache_prefill`` / ``paged_cache_insert`` /
  ``paged_cache_prefill`` mutate ``cache`` and also return it, so call
  sites read the same in both packages.
* An int8 cache dequantises in fp32 (ring and paged), as the decode
  kernel does; the JAX package writes a bf16 product, which XLA keeps
  in fp32 when it fuses it into the fp32 score product.
* Paged decode attention always goes through
  ``kernels.ops.paged_attention``: the hand-written CUDA kernel for
  CUDA tensors, its plain PyTorch version (the gather oracle) for CPU
  tensors.  Ring decode attention is plain PyTorch on both, as it is
  plain code in the JAX package.
* No fused PyTorch attention operator is called anywhere here; score
  products are computed in fp32 from fp32 copies of bf16 operands,
  which is what JAX's ``preferred_element_type=float32`` gives.

Pages are pool-wide, NOT per batch row: cache["k"] is
(num_pages, page_size, K, hd) and a request owns an ordered list of
pages recorded in its block-table row.  Logical token j of a request
lives in page block_table[j // page_size] at slot j % page_size.  Page
0 is the scratch page: padding block-table entries and inactive batch
rows point at it, and everything they write there is masked out.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import decode_prefetch
from repro_torch.models.layers import apply_norm, softcap

Params = Dict[str, Any]

NEG_INF = -1e30
SCRATCH_PAGE = 0


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def qkv_project(params: Params, x, *, num_heads: int, num_kv_heads: int,
                head_dim: int, v_head_dim: Optional[int] = None,
                qk_norm: bool = False):
    """x: (B, S, D) -> q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,vhd)."""
    b, s, _ = x.shape
    v_hd = v_head_dim or head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, v_hd)
    if qk_norm:
        q = apply_norm(params["q_norm"], q, "rmsnorm")
        k = apply_norm(params["k_norm"], k, "rmsnorm")
    return q, k, v


def out_project(params: Params, o):
    b, s, h, v_hd = o.shape
    return o.reshape(b, s, h * v_hd) @ params["wo"].to(o.dtype)


# ---------------------------------------------------------------------------
# Prefill attention (blocked, no S x S materialisation)
# ---------------------------------------------------------------------------

def _masked_fill(sc, mask):
    return torch.where(mask, sc, torch.full_like(sc, NEG_INF))


def blocked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      chunk: Optional[int] = None,
                      scale: Optional[float] = None,
                      logit_cap: Optional[float] = None, kv_block: int = 512,
                      q_block: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally windowed/chunked) attention.

    q: (B, S, H, hd); k: (B, T, K, hd); v: (B, T, K, vd); H % K == 0.
    ``q_offset`` is the absolute position of q[.,0] (k/v start at 0).
    Full causal: per Q block, an online softmax over exactly the
    causally live KV blocks.  Window/chunk: per Q block, one softmax
    over a KV band of static width.  Returns (B, S, H, vd).
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    kk = k.shape[2]
    g = h // kk
    vd = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qr = (q * scale).reshape(b, s, kk, g, hd).float()
    kf, vf = k.float(), v.float()
    dev = q.device
    bq = min(q_block, s)
    nq = -(-s // bq)
    outs = []
    if window is not None or chunk is not None:
        span = window if window is not None else chunk
        band = int(min(t, span + bq))
        for i in range(nq):
            q_blk = qr[:, i * bq:(i + 1) * bq]
            n = q_blk.shape[1]
            q_first = q_offset + i * bq
            if window is not None:
                lo = max(q_first - span + 1, 0)
            else:   # chunked: band starts at the first query's chunk floor
                lo = (q_first // span) * span
            kv_pos = lo + torch.arange(band, device=dev)
            q_pos = q_first + torch.arange(n, device=dev)
            k_band, v_band = kf[:, lo:lo + band], vf[:, lo:lo + band]
            live = k_band.shape[1]          # < band where the slice clamps
            kv_pos = kv_pos[:live]
            sc = torch.einsum("bskgd,btkd->bkgst", q_blk, k_band)
            if logit_cap is not None:
                sc = softcap(sc, logit_cap)
            mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] < t)
            if window is not None:
                mask &= kv_pos[None, :] > q_pos[:, None] - span
            else:
                mask &= kv_pos[None, :] >= torch.div(
                    q_pos[:, None], span, rounding_mode="floor") * span
            p = torch.softmax(_masked_fill(sc, mask[None, None, None]), dim=-1)
            o = torch.einsum("bkgst,btkv->bskgv", p, v_band)
            outs.append(o.to(q.dtype).reshape(b, n, h, vd))
        return torch.cat(outs, dim=1)

    nblk = -(-t // kv_block)
    for i in range(nq):
        q_blk = qr[:, i * bq:(i + 1) * bq]                  # (B,bq,K,G,hd)
        n = q_blk.shape[1]
        q_pos = q_offset + i * bq + torch.arange(n, device=dev)
        hi = nblk if not causal else min(
            nblk, -(-(q_offset + (i + 1) * bq) // kv_block))
        m = torch.full((b, kk, g, n), NEG_INF, device=dev)
        l = torch.zeros((b, kk, g, n), device=dev)
        acc = torch.zeros((b, kk, g, n, vd), device=dev)
        for j in range(hi):
            k_blk = kf[:, j * kv_block:(j + 1) * kv_block]
            v_blk = vf[:, j * kv_block:(j + 1) * kv_block]
            kv_pos = j * kv_block + torch.arange(k_blk.shape[1], device=dev)
            sc = torch.einsum("bskgd,btkd->bkgst", q_blk, k_blk)
            if logit_cap is not None:
                sc = softcap(sc, logit_cap)
            if causal:
                sc = _masked_fill(sc, (kv_pos[None, :] <= q_pos[:, None])
                                  [None, None, None])
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkv->bkgsv", p, v_blk)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,K,G,bq,vd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, h, vd))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Masked attention over explicit KV views
# ---------------------------------------------------------------------------

def masked_decode_attention(q, k, v, kv_pos, pos, *,
                            window: Optional[int] = None,
                            chunk: Optional[int] = None,
                            scale: Optional[float] = None,
                            logit_cap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over an explicit KV view.

    q: (B, 1, H, hd); k: (B, T, K, hd); v: (B, T, K, vd).
    kv_pos: absolute position held by each KV slot, (T,) shared or
    (B, T) per row; -1 marks an empty slot.  pos: query position(s),
    scalar or (B,).  Returns (B, 1, H, vd).
    """
    return masked_causal_attention(q, k, v, kv_pos,
                                   torch.as_tensor(pos).reshape(-1, 1),
                                   window=window, chunk=chunk, scale=scale,
                                   logit_cap=logit_cap)


def masked_causal_attention(q, k, v, kv_pos, q_pos, *,
                            window: Optional[int] = None,
                            chunk: Optional[int] = None,
                            scale: Optional[float] = None,
                            logit_cap: Optional[float] = None) -> torch.Tensor:
    """Multi-token causal attention over an explicit KV view at
    absolute positions — the shared-prefix tail prefill, where the
    queries attend KV this call did not compute (resident prefix pages)
    plus their own just-inserted tail.

    q: (B, S, H, hd); k: (B, T, K, hd); v: (B, T, K, vd).
    kv_pos: (T,) shared or (B, T) per row; -1 marks an empty slot.
    q_pos: (S,) shared or (B, S) per row.  Materialises the S x T score
    block (tails are short).  Returns (B, S, H, vd).
    """
    b, s, h, hd = q.shape
    kk = k.shape[2]
    g = h // kk
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qr = (q * scale).reshape(b, s, kk, g, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qr.float(), k.float())
    if logit_cap is not None:
        sc = softcap(sc, logit_cap)
    q_pos = torch.as_tensor(q_pos, device=dev).long()
    if q_pos.ndim == 1:
        q_pos = q_pos[None]                                     # (1|B, S)
    kv_pos = torch.as_tensor(kv_pos, device=dev).long()
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None]                                   # (1|B, T)
    lower = torch.zeros_like(q_pos)
    if window is not None:
        lower = q_pos - window + 1
    if chunk is not None:
        lower = torch.div(q_pos, chunk, rounding_mode="floor") * chunk
    mask = ((kv_pos[:, None, :] >= 0)
            & (kv_pos[:, None, :] <= q_pos[:, :, None])
            & (kv_pos[:, None, :] >= lower[:, :, None]))        # (1|B, S, T)
    p = torch.softmax(_masked_fill(sc, mask[:, None, None]), dim=-1)
    out = torch.einsum("bkgst,btkv->bskgv", p, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# Ring-buffer KV cache + decode attention
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, capacity: int, num_kv_heads: int,
                  head_dim: int, *, v_head_dim: Optional[int] = None,
                  dtype=torch.bfloat16, device) -> Params:
    """Per-request ring of ``capacity`` slots; ``pos`` holds the absolute
    position in each slot (-1 = empty).  dtype=int8 stores quantized k/v
    with per-(token, head) max-abs bf16 scales."""
    v_hd = v_head_dim or head_dim
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    cache = {
        "k": torch.zeros((batch, capacity, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, num_kv_heads, v_hd), dtype=dtype,
                         device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, capacity, num_kv_heads),
                                      dtype=torch.bfloat16, device=device)
    return cache


def _dequant_kv(cache: Params):
    """Returns (k, v) of a ring cache, dequantised in fp32 if int8."""
    k, v = cache["k"], cache["v"]
    if k.dtype == torch.int8:
        k = k.float() * cache["k_scale"].float()[..., None]
        v = v.float() * cache["v_scale"].float()[..., None]
    return k, v


def _ring_write(cache: Params, slots, positions, k, v) -> None:
    """cache[...][:, slots] = k / v (B, len(slots), K, hd), quantising
    for an int8 cache; cache["pos"][slots] = positions."""
    if cache["k"].dtype == torch.int8:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
        cache["k_scale"][:, slots] = ks
        cache["v_scale"][:, slots] = vs
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["pos"][slots] = positions.to(torch.int32)


def cache_insert(cache: Params, k_new, v_new, pos) -> Params:
    """Insert one token's k/v (B, 1, K, hd) at ring slot pos % capacity,
    in place.  ``pos`` is a shared position: an int or a 1-element
    tensor."""
    cap = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=k_new.device).long().reshape(1)
    _ring_write(cache, pos % cap, pos, k_new, v_new)
    return cache


def cache_prefill(cache: Params, k, v, start: int = 0) -> Params:
    """Write S tokens (B, S, K, hd) at absolute positions start.., in
    place, at ring slots position % capacity; when S exceeds the
    capacity only the trailing ``capacity`` tokens survive."""
    cap = cache["k"].shape[1]
    s = k.shape[1]
    if s > cap:  # only the trailing `cap` tokens survive a ring overwrite
        k, v = k[:, -cap:], v[:, -cap:]
        start, s = start + (s - cap), cap
    positions = start + torch.arange(s, device=k.device)
    _ring_write(cache, positions % cap, positions, k, v)
    return cache


def decode_attention(q, cache: Params, pos, *, window: Optional[int] = None,
                     chunk: Optional[int] = None,
                     scale: Optional[float] = None,
                     logit_cap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over the ring cache.

    q: (B, 1, H, hd); pos: absolute position of the query token (the
    cache must already hold the query token's own k/v).
    Returns (B, 1, H, vd).
    """
    k, v = _dequant_kv(cache)
    return masked_decode_attention(q, k, v, cache["pos"], pos, window=window,
                                   chunk=chunk, scale=scale,
                                   logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

def init_paged_kv_cache(num_pages: int, page_size: int, num_kv_heads: int,
                        head_dim: int, *, v_head_dim: Optional[int] = None,
                        dtype=torch.bfloat16, device) -> Params:
    """Pool-wide paged KV store.  dtype=int8 stores quantized k/v with
    per-(slot, head) max-abs bf16 scales."""
    v_hd = v_head_dim or head_dim
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    cache = {
        "k": torch.zeros((num_pages, page_size, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((num_pages, page_size, num_kv_heads, v_hd),
                         dtype=dtype, device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((num_pages, page_size, num_kv_heads),
                                      dtype=torch.bfloat16, device=device)
    return cache


def _quantize(x):
    """x (..., hd) -> (int8 values, bf16 scales over the last dim)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _write(cache: Params, page, slot, k, v) -> None:
    """cache[...][page, slot] = k / v, quantising for an int8 pool."""
    if cache["k"].dtype == torch.int8:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
        cache["k_scale"][page, slot] = ks
        cache["v_scale"][page, slot] = vs
    cache["k"][page, slot] = k.to(cache["k"].dtype)
    cache["v"][page, slot] = v.to(cache["v"].dtype)


def paged_cache_insert(cache: Params, k_new, v_new, block_tables,
                       pos) -> Params:
    """Insert one token per row, in place: k/v (B, 1, K, hd) at per-row
    position ``pos`` (B,) via ``block_tables`` (B, M).  Inactive rows
    should point at SCRATCH_PAGE; colliding scratch writes are
    harmless."""
    ps = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=k_new.device).long().reshape(-1)
    page = torch.gather(block_tables.long(), 1,
                        torch.div(pos, ps, rounding_mode="floor")[:, None])[:, 0]
    _write(cache, page, pos % ps, k_new[:, 0], v_new[:, 0])
    return cache


def paged_cache_prefill(cache: Params, k, v, block_tables, start=0, *,
                        insert_from=None) -> Params:
    """Write S tokens (B, S, K, hd) at positions start..start+S-1 of
    each row's block-table mapping, in place.

    ``start`` is a scalar or per-row (B,).  ``insert_from`` (absolute
    position, scalar or (B,)) redirects writes *below* it to the scratch
    page: a tail recomputes those positions for the forward pass but
    must not touch resident shared pages that already hold their K/V.
    Positions whose page index falls past the block-table width also
    land on scratch (right-padding of a page-rounded tail near
    max_len)."""
    ps = cache["k"].shape[1]
    b, s = k.shape[:2]
    bt = block_tables.long()
    m = bt.shape[1]
    dev = k.device
    positions = (torch.as_tensor(start, device=dev).long().reshape(-1, 1)
                 + torch.arange(s, device=dev)[None])           # (1|B, S)
    positions = positions.expand(b, s)
    idx = torch.div(positions, ps, rounding_mode="floor")
    page = torch.gather(bt, 1, torch.clamp(idx, max=m - 1))     # (B, S)
    page = torch.where(idx >= m, SCRATCH_PAGE, page)
    if insert_from is not None:
        ins = torch.as_tensor(insert_from, device=dev).long().reshape(-1, 1)
        page = torch.where(positions >= ins, page, SCRATCH_PAGE)
    _write(cache, page, positions % ps, k, v)
    return cache


def gather_pages(pages, block_tables):
    """pages (P, ps, ...) gathered to a per-row view (B, M * ps, ...)."""
    g = pages[block_tables.long()]                # (B, M, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_gather_kv(cache: Params, block_tables):
    """Block-table gather of a paged cache -> (k, v) (B, T, K, hd) with
    T = M * page_size.  An int8 pool dequantizes in fp32, as the decode
    kernel does (the JAX package writes a bf16 product, which XLA keeps
    in fp32 when it fuses it into the fp32 score product)."""
    k = gather_pages(cache["k"], block_tables)
    v = gather_pages(cache["v"], block_tables)
    if k.dtype == torch.int8:
        k = k.float() * gather_pages(cache["k_scale"],
                                     block_tables).float()[..., None]
        v = v.float() * gather_pages(cache["v_scale"],
                                     block_tables).float()[..., None]
    return k, v


def paged_prefill_attention(q, cache: Params, block_tables, q_offset, *,
                            window: Optional[int] = None,
                            chunk: Optional[int] = None,
                            scale: Optional[float] = None,
                            logit_cap: Optional[float] = None) -> torch.Tensor:
    """Tail-prefill attention over the paged pool: queries at absolute
    positions q_offset + arange(S) attend the block-table gather of the
    pool — the resident shared-prefix pages plus the tail K/V this
    prefill just wrote.  q: (B, S, H, hd); q_offset scalar or (B,)."""
    k, v = paged_gather_kv(cache, block_tables)
    dev = q.device
    kv_pos = torch.arange(k.shape[1], device=dev)
    q_pos = (torch.as_tensor(q_offset, device=dev).long().reshape(-1, 1)
             + torch.arange(q.shape[1], device=dev)[None])      # (1|B, S)
    return masked_causal_attention(q, k, v, kv_pos, q_pos, window=window,
                                   chunk=chunk, scale=scale,
                                   logit_cap=logit_cap)


def build_decode_prefetch(block_tables, pos) -> torch.Tensor:
    """The combined (B, M+1) int32 block-table + lengths operand of one
    decode step (lengths = pos + 1 in the last column).  Built ONCE per
    step and passed to every layer's ``paged_decode_attention``."""
    lengths = torch.as_tensor(pos, device=block_tables.device).reshape(-1) + 1
    return decode_prefetch(block_tables, lengths)


def paged_decode_attention(q, cache: Params, block_tables, pos, *,
                           window: Optional[int] = None,
                           chunk: Optional[int] = None,
                           scale: Optional[float] = None,
                           logit_cap: Optional[float] = None,
                           prefetch=None) -> torch.Tensor:
    """Single-token attention over a paged pool via per-row block tables,
    through ``ops.paged_attention`` (the CUDA kernel for CUDA tensors,
    its plain version for CPU tensors).

    q: (B, 1, H, hd); block_tables: (B, M); pos: (B,) per-row query
    positions (each row's k/v already inserted).  ``prefetch`` is the
    step's combined operand (``build_decode_prefetch``); it carries the
    block tables and lengths every layer reads.  Returns (B, 1, H, vd).
    """
    if prefetch is None:
        prefetch = build_decode_prefetch(block_tables, pos)
    out = ops.paged_attention(
        q[:, 0], cache["k"], cache["v"], prefetch[:, :-1], prefetch[:, -1],
        window=window, chunk=chunk, scale=scale, logit_cap=logit_cap,
        k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"),
        prefetch=prefetch)
    return out[:, None]


def attention_span(kind: str, seq_len: int, *, window: Optional[int] = None,
                   chunk: Optional[int] = None) -> int:
    """KV span a layer kind needs at a given sequence length."""
    if kind == "swa" and window is not None:
        return min(window, seq_len)
    if kind == "chunked" and chunk is not None:
        return min(chunk, seq_len)
    return seq_len
