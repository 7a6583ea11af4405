"""Pattern-tiled decoder LM: dense self-attention, MLA and Mamba-1
blocks, on the paged and the ring cache paths.

Port of ``repro.models.transformer`` for configs whose pattern holds
``mixer="attn"`` or ``mixer="mla"`` layers with a dense, MoE or no MLP —
olmo-1b, codeqwen1.5-7b, minicpm3-4b, gemma2-27b and olmoe-1b-7b among
them — or ``mixer="mamba"`` layers with no MLP (falcon-mamba-7b).
Mamba layers with an MLP (jamba), cross-attention, codebook heads and
sinusoidal positions are not ported yet and raise
``NotImplementedError``.
An MLA layer caches its latent (``kv_lora + d_rope`` features a token,
one "KV head") in bf16 when an int8 pool is asked for, as the JAX
package does: latent quantisation is not supported.

Layout: as in the JAX package, the params of pattern position i are
stacked over the G = num_layers / len(pattern) groups (leaves
``(G, ...)``) and so are the caches; the forward pass loops over groups
and indexes group g as a view.  Caches are updated in place (see
``repro_torch.models.attention`` and ``repro_torch.models.mamba``);
``prefill``, ``prefill_paged`` and ``decode_step`` still return
``(logits, caches)`` so call sites match the JAX package.

Entry points:
  * ``forward``        (train / prefill / decode)
  * ``lm_loss``        (next-token cross-entropy + the MoE aux loss, the
    training objective; each pattern group checkpointed under
    ``remat``)
  * ``prefill``        (a prompt, writing fresh or reset ring / SSM
    caches)
  * ``prefill_paged``  (a prompt, or a shared-prefix tail, into pages)
  * ``verify_paged``   (S = k + 1 tokens a row at per-row positions,
    logits for every position: the speculative verify step)
  * ``decode_step``    (one token: ring caches at a shared scalar
    position, or — via ``block_tables`` — the paged pool at per-row
    positions)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, generator_on, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope,
                                       dense_init, embed_init, init_mlp,
                                       init_norm, softcap)

Params = Dict[str, Any]


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer == "mamba" and spec.mlp != "none":
            raise NotImplementedError(
                f"{cfg.name}: mamba blocks with an MLP (jamba's hybrid "
                f"layers) are not ported; they wait for the sharded "
                f"models, got mlp={spec.mlp!r}")
        if spec.mixer not in ("attn", "mla", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: the port runs self-attention, MLA and mamba "
                f"blocks only, got mixer={spec.mixer!r}")
    if cfg.num_codebooks or cfg.pos_embed not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: codebook heads and sinusoidal positions are not "
            f"ported")


# ===========================================================================
# Init
# ===========================================================================

def _init_layer(gen, spec: LayerSpec, cfg: ModelConfig, dt, dev) -> Params:
    d = cfg.d_model
    if spec.mixer == "mamba":
        return {"norm1": init_norm(d, cfg.norm, dt, device=dev),
                "mixer": ssm.init_mamba(
                    gen, d_model=d, d_inner=cfg.d_inner,
                    ssm_state=cfg.ssm_state, d_conv=cfg.d_conv,
                    dt_rank=cfg.dt_rank, dtype=dt, device=dev)}
    v_hd = cfg.v_head_dim or cfg.head_dim
    if spec.mixer == "mla":
        a = mla_mod.init_mla(
            gen, d_model=d, num_heads=cfg.num_heads, q_lora=cfg.q_lora,
            kv_lora=cfg.kv_lora, d_nope=cfg.d_nope, d_rope=cfg.d_rope,
            v_head_dim=v_hd, dtype=dt, device=dev)
    else:
        a = _init_attention(gen, cfg, v_hd, dt, dev)
    p: Params = {"norm1": init_norm(d, cfg.norm, dt, device=dev), "attn": a}
    if cfg.use_post_norm:
        p["norm1_post"] = init_norm(d, cfg.norm, dt, device=dev)
    if spec.mlp in ("dense", "moe"):
        p["norm2"] = init_norm(d, cfg.norm, dt, device=dev)
        if cfg.use_post_norm:
            p["norm2_post"] = init_norm(d, cfg.norm, dt, device=dev)
    if spec.mlp == "dense":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, gated=cfg.gated_mlp, dtype=dt,
                            device=dev)
    elif spec.mlp == "moe":
        p["moe"] = moe_mod.init_moe(
            gen, d_model=d, num_experts=cfg.num_experts,
            moe_d_ff=cfg.moe_d_ff, shared_d_ff=cfg.shared_expert_d_ff or None,
            gated=cfg.gated_mlp, dtype=dt, device=dev)
    return p


def _init_attention(gen, cfg: ModelConfig, v_hd: int, dt, dev) -> Params:
    d = cfg.d_model
    a: Params = {
        "wq": dense_init(gen, d, cfg.num_heads * cfg.head_dim, dt, device=dev),
        "wk": dense_init(gen, d, cfg.num_kv_heads * cfg.head_dim, dt,
                         device=dev),
        "wv": dense_init(gen, d, cfg.num_kv_heads * v_hd, dt, device=dev),
        "wo": dense_init(gen, cfg.num_heads * v_hd, d, dt, device=dev),
    }
    if cfg.qkv_bias:
        a["bq"] = torch.zeros((cfg.num_heads * cfg.head_dim,), dtype=dt,
                              device=dev)
        a["bk"] = torch.zeros((cfg.num_kv_heads * cfg.head_dim,), dtype=dt,
                              device=dev)
        a["bv"] = torch.zeros((cfg.num_kv_heads * v_hd,), dtype=dt,
                              device=dev)
    if cfg.qk_norm:
        a["q_norm"] = init_norm(cfg.head_dim, "rmsnorm", dt, device=dev)
        a["k_norm"] = init_norm(cfg.head_dim, "rmsnorm", dt, device=dev)
    return a


def _stack_into(dst: Params, g: int, src: Params) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _stack_into(dst[k], g, v)
        else:
            dst[k][g] = v


def _empty_stack(src: Params, n: int) -> Params:
    return {k: _empty_stack(v, n) if isinstance(v, dict)
            else torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                             device=v.device)
            for k, v in src.items()}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, dtype=None) -> Params:
    """Random params from ``generator`` (seed 0 when None) on ``device``
    (``cuda`` unless given), in ``dtype`` (``cfg.pdtype`` when None).
    Each weight is drawn in fp32 and cast, one layer at a time, so a
    full-width bf16 model never holds an fp32 copy of itself."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype if dtype is not None else cfg.pdtype
    generator = generator_on(generator, dev)
    params: Params = {"embed": embed_init(generator, cfg.vocab_size,
                                          cfg.d_model, dt, device=dev)}
    blocks: Params = {}
    for i, spec in enumerate(cfg.pattern):
        for g in range(cfg.num_groups):
            layer = _init_layer(generator, spec, cfg, dt, dev)
            if g == 0:
                blocks[f"p{i}"] = _empty_stack(layer, cfg.num_groups)
            _stack_into(blocks[f"p{i}"], g, layer)
    params["blocks"] = blocks
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm, dt, device=dev)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dt, device=dev)
    return params


# ===========================================================================
# Caches
# ===========================================================================

def init_caches(cfg: ModelConfig, batch: Optional[int] = None,
                seq_len: Optional[int] = None, dtype=None, *,
                num_pages: Optional[int] = None,
                page_size: Optional[int] = None,
                device: DeviceLike = None) -> Params:
    """Per-request ring caches by default: for each pattern position a
    ``(G, batch, span, K, hd)`` KV ring (span = ``seq_len``, or the
    window / chunk of a banded layer) or a mamba state.  Pass
    ``num_pages`` / ``page_size`` for the paged-pool variant instead
    (pages shared across requests, addressed through block tables;
    ``batch`` / ``seq_len`` are then ignored; mamba layers have no paged
    form).  An MLA layer caches its latent as one KV head of width
    ``kv_lora + d_rope`` (V: a slab of width 1 that nothing reads, as in
    the JAX package).  ``dtype`` defaults to ``cfg.kv_cache_dtype`` (int8
    adds bf16 scale slabs; an MLA latent stays bf16 instead); a mamba
    state ``h`` is fp32 whatever it is."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.kv_cache_dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    paged = page_size is not None
    g = cfg.num_groups
    caches: Params = {}
    for i, spec in enumerate(cfg.pattern):
        if paged and spec.mixer not in ("attn", "mla"):
            raise NotImplementedError(
                f"paged KV cache supports attn/mla mixers, got "
                f"{spec.mixer!r} (mamba state is per-request, not "
                f"token-paged)")
        if spec.mixer == "mla":
            # latent-cache quantisation unsupported: keep bf16 for MLA
            heads, width, v_width = 1, cfg.kv_lora + cfg.d_rope, 1
            layer_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
        else:
            heads, width, v_width = (cfg.num_kv_heads, cfg.head_dim,
                                     cfg.v_head_dim)
            layer_dtype = dtype
        if paged:
            one = attn.init_paged_kv_cache(
                num_pages * g, page_size, heads, width, v_head_dim=v_width,
                dtype=layer_dtype, device=dev)
            caches[f"p{i}"] = {k: v.reshape((g, num_pages) + v.shape[1:])
                               for k, v in one.items()}
            continue
        if spec.mixer == "mamba":
            one = ssm.init_mamba_cache(g * batch, d_inner=cfg.d_inner,
                                       ssm_state=cfg.ssm_state,
                                       d_conv=cfg.d_conv, dtype=dtype,
                                       device=dev)
        else:
            cap = (seq_len if spec.mixer == "mla" else attn.attention_span(
                spec.attn_kind, seq_len, window=cfg.window, chunk=cfg.chunk))
            one = attn.init_kv_cache(g * batch, cap, heads, width,
                                     v_head_dim=v_width, dtype=layer_dtype,
                                     device=dev)
            one["pos"] = one["pos"].repeat(g)
        caches[f"p{i}"] = {k: v.reshape((g, -1) + v.shape[1:])
                           for k, v in one.items()}
    return caches


# ===========================================================================
# Forward
# ===========================================================================

def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.query_scale is not None:
        return cfg.query_scale
    return 1.0 / math.sqrt(cfg.head_dim)


def _mixer_forward(p: Params, spec: LayerSpec, cfg: ModelConfig, x, *,
                   positions, mode: str, pos=None, cache=None,
                   block_tables=None, q_offset=None, insert_from=None,
                   prefetch=None):
    """Self-attention, MLA or mamba mixer.  Returns the mixer output; a
    ``cache`` (ring, paged or mamba state) is written in place.
    ``block_tables`` (B, M) switches the attention cache path to the
    paged pool; in decode mode ``pos`` is then per-row (B,), on the ring
    path a shared (1,) position.  ``q_offset`` (prefill) is the
    shared-prefix tail path: K/V is written at absolute positions
    q_offset.. and attention runs over the gathered pool view (resident
    prefix + tail); ``insert_from`` keeps tail writes off resident
    shared pages."""
    if spec.mixer == "mamba":
        kw = dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                  d_conv=cfg.d_conv, dt_rank=cfg.dt_rank,
                  norm_bc_dt=cfg.mamba_norm)
        if mode == "decode":
            return ssm.mamba_decode(p["mixer"], x, cache, **kw)[0]
        return ssm.mamba_forward(p["mixer"], x, cache=cache, **kw)[0]

    if spec.mixer == "mla":
        kw = dict(num_heads=cfg.num_heads, kv_lora=cfg.kv_lora,
                  d_nope=cfg.d_nope, d_rope=cfg.d_rope,
                  v_head_dim=cfg.v_head_dim or cfg.head_dim,
                  rope_theta=cfg.rope_theta)
        if mode == "decode":
            return mla_mod.mla_decode(p["attn"], x, cache, pos,
                                      block_tables=block_tables,
                                      prefetch=prefetch, **kw)[0]
        return mla_mod.mla_prefill(p["attn"], x, positions=positions,
                                   cache=cache, block_tables=block_tables,
                                   q_offset=q_offset,
                                   insert_from=insert_from, **kw)[0]

    b = x.shape[0]
    ap = p["attn"]
    q, k, v = attn.qkv_project(ap, x, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.head_dim,
                               v_head_dim=cfg.v_head_dim,
                               qk_norm=cfg.qk_norm)
    if spec.rope and cfg.pos_embed == "rope":
        rp = pos.reshape(-1, 1).expand(b, 1) if mode == "decode" else positions
        q = apply_rope(q, rp, theta=cfg.rope_theta)
        k = apply_rope(k, rp, theta=cfg.rope_theta)
    window = cfg.window if spec.attn_kind == "swa" else None
    chunk = cfg.chunk if spec.attn_kind == "chunked" else None
    kw = dict(window=window, chunk=chunk, scale=_attn_scale(cfg),
              logit_cap=cfg.attn_logit_cap)
    if mode == "decode" and block_tables is None:
        attn.cache_insert(cache, k, v, pos)
        out = attn.decode_attention(q, cache, pos, **kw)
    elif mode == "decode":
        attn.paged_cache_insert(cache, k, v, block_tables, pos)
        out = attn.paged_decode_attention(q, cache, block_tables, pos,
                                          prefetch=prefetch, **kw)
    elif block_tables is not None and q_offset is not None:
        # shared-prefix tail prefill: write the tail's K/V into the pool
        # first, then attend over the block-table gather — the resident
        # prefix pages this request mapped plus its own tail
        attn.paged_cache_prefill(cache, k, v, block_tables, start=q_offset,
                                 insert_from=insert_from)
        out = attn.paged_prefill_attention(q, cache, block_tables, q_offset,
                                           **kw)
    else:
        # whole prompt: the flash-attention kernel on the card, the
        # blocked plain path on the CPU (kernels.ops.attention)
        out = ops.attention(q, k, v, causal=True, **kw)
        if cache is not None and block_tables is not None:
            attn.paged_cache_prefill(cache, k, v, block_tables, start=0)
        elif cache is not None:
            attn.cache_prefill(cache, k, v, start=0)
    return attn.out_project(ap, out)


def _block_forward(p: Params, spec: LayerSpec, cfg: ModelConfig, h, **kw):
    """One transformer block (pre-norm, optional post-norms).  Returns
    (h, aux): an MoE MLP's load-balance loss (dispatch dropless in
    decode, tokens grouped only in train), else None."""
    out = _mixer_forward(p, spec, cfg,
                         apply_norm(p["norm1"], h, cfg.norm, cfg.norm_eps),
                         **kw)
    if cfg.use_post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm, cfg.norm_eps)
    if cfg.residual_scale is not None:
        out = out * cfg.residual_scale
    h = h + out
    aux = None
    if spec.mlp != "none":
        y = apply_norm(p["norm2"], h, cfg.norm, cfg.norm_eps)
        if spec.mlp == "moe":
            mode = kw["mode"]
            y, aux = moe_mod.moe_ffn(
                p["moe"], y, num_experts=cfg.num_experts,
                top_k=cfg.num_experts_per_tok, router_act=cfg.router_act,
                capacity_factor=cfg.capacity_factor, act=cfg.act,
                gated=cfg.gated_mlp, dropless=(mode == "decode"),
                group_tokens=cfg.moe_group_tokens if mode == "train" else 0)
        else:
            y = apply_mlp(p["mlp"], y, gated=cfg.gated_mlp, act=cfg.act)
        if cfg.use_post_norm:
            y = apply_norm(p["norm2_post"], y, cfg.norm, cfg.norm_eps)
        if cfg.residual_scale is not None:
            y = y * cfg.residual_scale
        h = h + y
    return h, aux


def embed_tokens(params: Params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int -> (B, S, D) in the compute dtype."""
    h = params["embed"][tokens.long()].to(cfg.cdtype)
    if cfg.embed_scale is not None:
        h = h * torch.tensor(cfg.embed_scale, dtype=cfg.cdtype)
    return h


def unembed(params: Params, cfg: ModelConfig, h):
    """h (B, S, D) -> logits (B, S, V); tied or untied head."""
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["head"].to(h.dtype)
    if cfg.final_logit_cap is not None:
        logits = softcap(logits, cfg.final_logit_cap)
    return logits


def forward(params: Params, cfg: ModelConfig, tokens, *, mode: str = "train",
            caches=None, pos=None, block_tables=None, q_offset=None,
            insert_from=None, prefetch=None):
    """Main entry.  mode: train | prefill | decode.

    ``caches`` are ring / mamba caches (``init_caches(cfg, batch,
    seq_len)``) unless ``block_tables`` (B, M) routes the attention
    cache path through the paged pool.  Decode ``pos`` is a shared
    scalar on the ring path and per-row (B,) on the paged one.  Prefill
    ``q_offset`` shifts the sequence to absolute positions q_offset..
    (the shared-prefix tail path); ``insert_from`` bounds which of
    those positions write the pool.  ``prefetch`` is the combined decode-step
    operand (``attention.build_decode_prefetch``), shared by every
    layer.  Returns (hidden (B, S, D) post-final-norm, caches).
    """
    h, caches, _ = _forward(params, cfg, tokens, mode=mode, caches=caches,
                            pos=pos, block_tables=block_tables,
                            q_offset=q_offset, insert_from=insert_from,
                            prefetch=prefetch)
    return h, caches


def _forward(params: Params, cfg: ModelConfig, tokens, *, mode: str,
             caches=None, pos=None, block_tables=None, q_offset=None,
             insert_from=None, prefetch=None):
    """``forward`` that also returns, in train mode, the MoE aux loss
    summed over the layers (fp32, 0 without MoE layers; None in the
    other modes): (h, caches, aux).  In train mode under ``cfg.remat``
    "full" / "full_inner" each pattern group runs under a non-reentrant
    checkpoint, as the reference's ``jax.checkpoint`` per group (the
    port's whole-prompt attention keeps no per-block state, so
    "full_inner" checkpoints as "full")."""
    _check_supported(cfg)
    dev = params["embed"].device
    positions = None
    if mode != "decode":
        b, s = tokens.shape[:2]
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        if q_offset is not None:
            off = torch.as_tensor(q_offset, device=dev).long()
            positions = positions + (off[:, None] if off.ndim == 1 else off)
    else:
        pos = torch.as_tensor(pos, device=dev).long().reshape(-1)
    h = embed_tokens(params, cfg, tokens)
    train = mode == "train"
    # the aux loss is summed in train mode only: a serving step (a CUDA
    # graph on the card) launches nothing for it
    aux = torch.zeros((), dtype=torch.float32, device=dev) if train else None
    remat = train and cfg.remat in ("full", "full_inner")
    for g in range(cfg.num_groups):
        def group(hh, g=g):
            aux_g = None
            for i, spec in enumerate(cfg.pattern):
                p = _group(params["blocks"][f"p{i}"], g)
                cache = None if caches is None else _group(caches[f"p{i}"], g)
                hh, a = _block_forward(p, spec, cfg, hh, positions=positions,
                                       mode=mode, pos=pos, cache=cache,
                                       block_tables=block_tables,
                                       q_offset=q_offset,
                                       insert_from=insert_from,
                                       prefetch=prefetch)
                if train and a is not None:
                    aux_g = a if aux_g is None else aux_g + a
            return hh, aux_g
        h, aux_g = (checkpoint(group, h, use_reentrant=False) if remat
                    else group(h))
        if aux_g is not None:
            aux = aux + aux_g
    h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    return h, caches, aux


# ===========================================================================
# Loss
# ===========================================================================

def _ce(logits, labels):
    """fp32 cross-entropy; logits (..., V), labels (...) int."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ the MoE aux loss) of ``batch``
    {"tokens", "labels"} (B, S): ``forward`` in train mode, then the
    logits in fp32, whole or, under ``cfg.logits_chunk``, in chunks of
    that many positions, each chunk's unembedding and loss
    checkpointed so only one chunk's logits are alive.  Returns (loss +
    aux_loss_coef * aux / n_moe, {"ce", "aux"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, _, aux = _forward(params, cfg, tokens, mode="train")
    if cfg.logits_chunk:
        c = cfg.logits_chunk
        s = h.shape[1]
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of "
                             f"logits_chunk {c}")

        def chunk_loss(hh, ll):
            return _ce(unembed(params, cfg, hh), ll).sum()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s, c):
            total = total + checkpoint(chunk_loss, h[:, i:i + c],
                                       labels[:, i:i + c],
                                       use_reentrant=False)
        loss = total / labels.numel()
    else:
        loss = _ce(unembed(params, cfg, h), labels).mean()
    n_moe = cfg.num_groups * sum(spec.mlp == "moe" for spec in cfg.pattern)
    return loss + cfg.aux_loss_coef * aux / max(n_moe, 1), {"ce": loss,
                                                            "aux": aux}


def _group(tree: Params, g: int) -> Params:
    """Group ``g``'s slice of a stacked params / cache tree (views)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def reset_caches(caches: Params) -> Params:
    """Empty ring / mamba caches in place, as ``init_caches`` makes
    them: every ring slot's position -1 (its k/v stay, masked out) and
    every mamba conv tail and SSM state 0.  Returns ``caches``."""
    for layer in caches.values():
        if "pos" in layer:
            layer["pos"].fill_(-1)
        else:
            layer["conv"].zero_()
            layer["h"].zero_()
    return caches


def prefill(params: Params, cfg: ModelConfig, tokens, *,
            cache_len: Optional[int] = None, caches: Optional[Params] = None):
    """Process a prompt (B, S) into fresh ring / mamba caches of
    capacity ``cache_len`` (S when None) on the params' device.  The
    caches are bf16 whatever the compute dtype, as the JAX package's
    ``prefill`` makes them (a mamba state ``h`` stays fp32).  Given
    ``caches`` (``init_caches`` at this batch, reused across prompts, as
    the JAX engine reuses its donated buffers) the prompt writes into
    them instead, after ``reset_caches``: the scan and the conv start
    from a zero state and no slot of an earlier prompt stays visible.
    Returns (next-token logits (B, 1, V), caches)."""
    b, s = tokens.shape[:2]
    if caches is None:
        caches = init_caches(cfg, b, cache_len or s, torch.bfloat16,
                             device=params["embed"].device)
    else:
        reset_caches(caches)
    h, caches = forward(params, cfg, tokens, mode="prefill", caches=caches)
    return unembed(params, cfg, h[:, -1:]), caches


def prefill_paged(params: Params, cfg: ModelConfig, tokens, caches,
                  block_tables, last_index=None, *, q_offset=None,
                  insert_from=None):
    """Prefill a prompt (or a shared-prefix tail) into pages of a shared
    pool, in place.

    tokens: (B, S) — S may include right padding (padded slots hold
    garbage K/V at positions past the live query, overwritten by decode
    inserts before they become visible).  block_tables: (B, M) page ids
    for these rows.  last_index: index of the last real token within
    ``tokens`` (default S - 1).  q_offset: absolute position of
    tokens[:, 0] — positions below it are resident pages read, not
    recomputed.  insert_from: absolute position below which the tail
    does not write the pool (those slots belong to shared pages).
    Returns (next-token logits (B, 1, V), caches).
    """
    h, caches = forward(params, cfg, tokens, mode="prefill", caches=caches,
                        block_tables=block_tables, q_offset=q_offset,
                        insert_from=insert_from)
    i = h.shape[1] - 1 if last_index is None else int(last_index)
    return unembed(params, cfg, h[:, i:i + 1]), caches


def verify_paged(params: Params, cfg: ModelConfig, tokens, caches,
                 block_tables, q_offset, *, insert_from=None):
    """Speculative-decoding verify step: S = k + 1 tokens a row (B, S)
    at per-row absolute positions ``q_offset`` (B,) through the paged
    tail-prefill path, in place; returns logits for every position,
    (B, S, V).  ``insert_from`` (scalar or (B,)) routes writes below it
    to scratch.  K/V written above a row's finally committed position
    is masked (kv_pos > q_pos) and overwritten by later inserts before
    it becomes visible.  An MoE block runs its prefill-mode capacity on
    the S tokens, as the reference does.  Returns (logits, caches)."""
    h, caches = forward(params, cfg, tokens, mode="prefill", caches=caches,
                        block_tables=block_tables, q_offset=q_offset,
                        insert_from=insert_from)
    return unembed(params, cfg, h), caches


def decode_step(params: Params, cfg: ModelConfig, token, caches, pos, *,
                block_tables=None):
    """One decode step.  token (B, 1).  Without ``block_tables`` the
    caches are ring / mamba caches and ``pos`` is the shared position of
    the token (an int, or a 1-element tensor on the params' device,
    which a captured step takes as an input and reads nothing of on the
    host).  With ``block_tables``
    (B, M) the caches are the paged pool and ``pos`` (B,) holds per-row
    positions (rows may sit at different positions); the combined
    block-table + lengths operand is built once here and shared by every
    layer's paged-attention call.
    Returns (logits (B, 1, V), caches)."""
    if block_tables is None:
        dev = params["embed"].device
        pos = (pos.to(dev).long().reshape(1) if torch.is_tensor(pos)
               else torch.full((1,), int(pos), dtype=torch.long, device=dev))
        h, caches = forward(params, cfg, token, mode="decode", caches=caches,
                            pos=pos)
        return unembed(params, cfg, h), caches
    pos = torch.as_tensor(pos, device=block_tables.device).long().reshape(-1)
    prefetch = attn.build_decode_prefetch(block_tables, pos)
    h, caches = forward(params, cfg, token, mode="decode", caches=caches,
                        pos=pos, block_tables=block_tables,
                        prefetch=prefetch)
    return unembed(params, cfg, h), caches
