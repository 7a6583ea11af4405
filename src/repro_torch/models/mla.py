"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

Port of ``repro.models.mla``.  Prefill expands the compressed KV latent
to per-head K/V (MLA is MHA after expansion): a whole prompt goes
through ``kernels.ops.attention`` (the flash-attention kernel on the
card, the blocked plain path on the CPU), a shared-prefix tail or a
chunk (``q_offset``) through the masked causal attention over the
block-table gather of the pool, as the reference does.

Decode uses the *absorbed* form: queries are projected into latent
space (q_nope @ W_uk), so attention runs directly against the cached
latent as MQA with head_dim = kv_lora + d_rope and V read as the
leading kv_lora features of the same slab (K1's ``v_dim`` form on the
paged path).  The cache stores only the latent and the shared rope key,
(kv_lora + d_rope) features a token a layer, plus the reference's V
slab of width 1 that nothing reads.

As in ``repro_torch.models.attention``, caches are written in place;
``mla_prefill`` / ``mla_decode`` still return ``(out, cache)`` so call
sites match the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       init_norm)

Params = Dict[str, Any]


def init_mla(generator, *, d_model: int, num_heads: int, q_lora: int,
             kv_lora: int, d_nope: int, d_rope: int, v_head_dim: int,
             dtype=torch.float32, device) -> Params:
    h = num_heads
    return {
        "q_down": dense_init(generator, d_model, q_lora, dtype,
                             device=device),
        "q_norm": init_norm(q_lora, "rmsnorm", dtype, device=device),
        "q_up": dense_init(generator, q_lora, h * (d_nope + d_rope), dtype,
                           device=device),
        "kv_down": dense_init(generator, d_model, kv_lora + d_rope, dtype,
                              device=device),
        "kv_norm": init_norm(kv_lora, "rmsnorm", dtype, device=device),
        "k_up": dense_init(generator, kv_lora, h * d_nope, dtype,
                           device=device),
        "v_up": dense_init(generator, kv_lora, h * v_head_dim, dtype,
                           device=device),
        "wo": dense_init(generator, h * v_head_dim, d_model, dtype,
                         device=device),
    }


def _project_latent(params: Params, x, *, kv_lora: int, positions,
                    rope_theta: float):
    """x (B,S,D) -> normalised latent (B,S,kv_lora), roped k_rope
    (B,S,d_rope)."""
    ckv = x @ params["kv_down"].to(x.dtype)
    c_kv, k_rope = ckv[..., :kv_lora], ckv[..., kv_lora:]
    c_kv = apply_norm(params["kv_norm"], c_kv, "rmsnorm")
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        theta=rope_theta)[:, :, 0]
    return c_kv, k_rope


def _project_q(params: Params, x, *, num_heads: int, d_nope: int,
               d_rope: int, positions, rope_theta: float):
    b, s, _ = x.shape
    q = x @ params["q_down"].to(x.dtype)
    q = apply_norm(params["q_norm"], q, "rmsnorm")
    q = (q @ params["q_up"].to(x.dtype)).reshape(b, s, num_heads,
                                                 d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, positions, theta=rope_theta)
    return q_nope, q_rope


def _expand(c, k_rope, k_up, v_up, *, num_heads: int, d_nope: int,
            v_head_dim: int):
    """Latent (B,T,kv_lora) + shared rope key (B,T,d_rope) -> per-head
    k (B,T,H,d_nope+d_rope) and v (B,T,H,v_head_dim)."""
    b, t, _ = c.shape
    h = num_heads
    k = torch.cat([(c @ k_up).reshape(b, t, h, d_nope),
                   k_rope[:, :, None, :].expand(b, t, h, k_rope.shape[-1])],
                  dim=-1)
    return k, (c @ v_up).reshape(b, t, h, v_head_dim)


def mla_prefill(params: Params, x, *, num_heads: int, kv_lora: int,
                d_nope: int, d_rope: int, v_head_dim: int,
                rope_theta: float, positions, cache: Params = None,
                block_tables=None, q_offset=None, insert_from=None):
    """Prefill forward.  Returns (out (B,S,D), cache).

    ``q_offset`` switches to the shared-prefix *tail* path: the tail's
    latent is written into the paged pool at absolute positions
    q_offset.., then attention runs over the block-table gather of the
    pool (resident prefix latent + the tail), expanded to per-head K/V.
    ``insert_from`` keeps writes off resident shared pages (see
    ``attention.paged_cache_prefill``)."""
    b, s, _ = x.shape
    h = num_heads
    scale = 1.0 / math.sqrt(d_nope + d_rope)
    q_nope, q_rope = _project_q(params, x, num_heads=h, d_nope=d_nope,
                                d_rope=d_rope, positions=positions,
                                rope_theta=rope_theta)
    c_kv, k_rope = _project_latent(params, x, kv_lora=kv_lora,
                                   positions=positions, rope_theta=rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k_up = params["k_up"].to(x.dtype)
    v_up = params["v_up"].to(x.dtype)
    kw = dict(num_heads=h, d_nope=d_nope, v_head_dim=v_head_dim)

    if block_tables is not None and q_offset is not None:
        latent = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
        attn.paged_cache_prefill(cache, latent, latent[..., :1],
                                 block_tables, start=q_offset,
                                 insert_from=insert_from)
        lat = attn.gather_pages(cache["k"], block_tables)[:, :, 0]
        lat = lat.to(x.dtype)                                 # (B,T,L)
        t = lat.shape[1]
        k_g, v_g = _expand(lat[..., :kv_lora], lat[..., kv_lora:], k_up,
                           v_up, **kw)
        q_pos = (torch.as_tensor(q_offset, device=x.device).long()
                 .reshape(-1, 1)
                 + torch.arange(s, device=x.device)[None])     # (1|B, S)
        out = attn.masked_causal_attention(
            q, k_g, v_g, torch.arange(t, device=x.device), q_pos,
            scale=scale)
        out = out.reshape(b, s, h * v_head_dim) @ params["wo"].to(x.dtype)
        return out, cache

    # whole prompt: expand the latent to per-head K/V (MHA after
    # expansion) for the flash-attention kernel (the blocked plain path
    # on the CPU)
    k, v = _expand(c_kv, k_rope, k_up, v_up, **kw)
    out = ops.attention(q, k, v, causal=True, scale=scale)
    out = out.reshape(b, s, h * v_head_dim) @ params["wo"].to(x.dtype)
    if cache is not None:
        latent = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
        if block_tables is not None:
            attn.paged_cache_prefill(cache, latent, latent[..., :1],
                                     block_tables, start=0)
        else:
            attn.cache_prefill(cache, latent, latent[..., :1], start=0)
    return out, cache


def mla_decode(params: Params, x, cache: Params, pos, *, num_heads: int,
               kv_lora: int, d_nope: int, d_rope: int, v_head_dim: int,
               rope_theta: float, block_tables=None, prefetch=None):
    """Absorbed single-token decode.  cache['k']: (B, cap, 1,
    kv_lora+d_rope) (ring, ``pos`` a shared (1,) position), or with
    ``block_tables`` (B, M) a paged latent pool (P, page_size, 1,
    kv_lora+d_rope) with per-row positions ``pos`` (B,); ``prefetch``
    is the step's combined block-table + lengths operand
    (``attention.build_decode_prefetch``).

    Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    h = num_heads
    positions = pos.reshape(-1, 1).expand(b, 1)
    q_nope, q_rope = _project_q(params, x, num_heads=h, d_nope=d_nope,
                                d_rope=d_rope, positions=positions,
                                rope_theta=rope_theta)
    c_kv, k_rope = _project_latent(params, x, kv_lora=kv_lora,
                                   positions=positions, rope_theta=rope_theta)
    latent = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]

    # absorb W_uk into q: (B,1,H,d_nope) x (kv_lora,H,d_nope) -> latent
    k_up = params["k_up"].to(x.dtype).reshape(kv_lora, h, d_nope)
    q_abs = torch.einsum("bshd,lhd->bshl", q_nope, k_up)
    q_cat = torch.cat([q_abs, q_rope], dim=-1)        # (B,1,H,kv_lora+d_rope)
    scale = 1.0 / math.sqrt(d_nope + d_rope)

    # MQA over the latent cache; v = the latent's leading kv_lora features
    if block_tables is not None:
        attn.paged_cache_insert(cache, latent, latent[..., :1], block_tables,
                                pos)
        if prefetch is None:
            prefetch = attn.build_decode_prefetch(block_tables, pos)
        # V rides as the leading kv_lora features of the K slab (v_dim),
        # so the kernel reads each latent row from one pool
        out_lat = ops.paged_attention(
            q_cat[:, 0], cache["k"], cache["k"], prefetch[:, :-1],
            prefetch[:, -1], scale=scale, v_dim=kv_lora,
            prefetch=prefetch)[:, None]
    else:
        attn.cache_insert(cache, latent, latent[..., :1], pos)
        latent_cache = {"k": cache["k"], "v": cache["k"][..., :kv_lora],
                        "pos": cache["pos"]}
        out_lat = attn.decode_attention(q_cat, latent_cache, pos,
                                        scale=scale)
    # un-absorb W_uv: (B,1,H,kv_lora) x (kv_lora,H,v_hd)
    v_up = params["v_up"].to(x.dtype).reshape(kv_lora, h, v_head_dim)
    out = torch.einsum("bshl,lhv->bshv", out_lat, v_up)
    out = out.reshape(b, 1, h * v_head_dim) @ params["wo"].to(x.dtype)
    return out, cache
