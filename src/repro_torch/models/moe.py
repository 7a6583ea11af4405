"""Mixture-of-Experts FFN with grouped, capacity-bounded sort dispatch.

Port of ``repro.models.moe``, the same algorithm step for step: each
batch row is a dispatch group; its (token, choice) assignments are
sorted by expert (a stable sort, as ``jnp.argsort``), each expert keeps
the first C of its run in a ``(B, E, C, d)`` bucket, every expert runs
on its bucket (``torch.einsum``, as the JAX package runs plain
``jnp.einsum`` outside any kernel), and each kept assignment's output
is gathered back, weighted and summed over the k choices.

Capacity is per (group, expert): ``C = max(1, int(cf * S * k / E))``;
``dropless=True`` (decode) sizes C at the worst case, ``S`` (1 for a
single token), so no assignment is dropped.  Padding tokens route like
any other and set ``S``, hence ``C``, as in the JAX package.

Exactness against the JAX package:

* top-k breaks ties by the lower expert index, as ``jax.lax.top_k``
  does (a stable descending sort, then the first k): router logits are
  computed in the compute dtype before the fp32 cast, so equal
  probabilities do occur in bf16.
* Every data movement is a gather; the routing plan uses
  ``torch.searchsorted``.  No boolean-mask indexing, ``.item()`` or
  ``.nonzero()``: shapes follow (B, S) alone and nothing is read on the
  host, so a decode step that runs MoE layers can be captured as a CUDA
  graph.  The aux loss counts its density with ``index_add_`` of ones,
  exact in any order.

Covers: olmoe (64e top-8, softmax-then-topk), jamba (16e top-2),
llama4-maverick (128e top-1, sigmoid router + shared expert).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (activation, apply_mlp, dense_init,
                                       init_mlp, truncated_normal)

Params = Dict[str, Any]


def init_moe(generator, *, d_model: int, num_experts: int, moe_d_ff: int,
             shared_d_ff: Optional[int] = None, gated: bool = True,
             dtype=torch.float32, device) -> Params:
    """Router (d, E) and per-expert stacks up / gate (E, d, f) and down
    (E, f, d), each expert drawn as ``dense_init`` draws one matrix; a
    gated shared expert where ``shared_d_ff`` is given."""
    e, d, f = num_experts, d_model, moe_d_ff

    def stack_init(din, dout):
        return truncated_normal(generator, (e, din, dout),
                                scale=1.0 / math.sqrt(din), dtype=dtype,
                                device=device)

    p: Params = {"router": dense_init(generator, d, e, dtype, device=device),
                 "up": stack_init(d, f), "down": stack_init(f, d)}
    if gated:
        p["gate"] = stack_init(d, f)
    if shared_d_ff:
        p["shared"] = init_mlp(generator, d, shared_d_ff, gated=True,
                               dtype=dtype, device=device)
    return p


def top_k_lower_first(x, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties
    in the lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Params, x, *, num_experts: int, top_k: int,
          router_act: str):
    """x (B, S, d) -> (weights (B, S, k) in x's dtype, expert indices
    (B, S, k) int64, aux scalar fp32: the Switch load-balance loss)."""
    logits = (x @ params["router"].to(x.dtype)).float()
    if router_act == "softmax_topk":        # olmoe: softmax over all, then top-k
        probs = torch.softmax(logits, dim=-1)
        w, idx = top_k_lower_first(probs, top_k)
    elif router_act == "topk_softmax":      # jamba/mixtral: top-k then renorm
        top_logits, idx = top_k_lower_first(logits, top_k)
        w = torch.softmax(top_logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
    elif router_act == "sigmoid":           # llama4: sigmoid on the top-1
        top_logits, idx = top_k_lower_first(logits, top_k)
        w = torch.sigmoid(top_logits)
        probs = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(router_act)
    t = x.shape[0] * x.shape[1]
    flat = idx.reshape(-1)
    density = torch.zeros((num_experts,), dtype=torch.float32,
                          device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    density = density / (t * top_k)
    mean_prob = probs.mean(dim=(0, 1))
    aux = num_experts * torch.sum(density * mean_prob)
    return w.to(x.dtype), idx, aux


def moe_ffn(params: Params, x, *, num_experts: int, top_k: int,
            router_act: str = "softmax_topk", capacity_factor: float = 1.25,
            act: str = "silu", gated: bool = True, dropless: bool = False,
            group_tokens: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (out (B, S, d), aux_loss).

    ``group_tokens`` splits each sequence into dispatch groups of that
    many tokens where it divides S (the JAX package's GShard grouping,
    used in training)."""
    b, s, d = x.shape
    if group_tokens and s > group_tokens and s % group_tokens == 0:
        g = s // group_tokens
        out, aux = moe_ffn(params, x.reshape(b * g, group_tokens, d),
                           num_experts=num_experts, top_k=top_k,
                           router_act=router_act,
                           capacity_factor=capacity_factor, act=act,
                           gated=gated, dropless=dropless)
        return out.reshape(b, s, d), aux

    e, k = num_experts, top_k
    dev = x.device
    w, idx, aux = route(params, x, num_experts=e, top_k=k,
                        router_act=router_act)
    if dropless:
        # worst case: every token in the group picks the same expert
        cap = s if s > 1 else 1
    else:
        cap = max(1, int(capacity_factor * s * k / e))

    # ---- routing plan: assignments sorted by expert, per group --------
    idx_flat = idx.reshape(b, s * k)
    order = torch.argsort(idx_flat, dim=-1, stable=True)      # (B, S*k)
    sorted_e = torch.gather(idx_flat, 1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")   # (B, E)
    ends = torch.searchsorted(sorted_e, experts, side="right")    # (B, E)
    pos_in_e = (torch.arange(s * k, device=dev)[None]
                - torch.gather(starts, 1, sorted_e))          # (B, S*k)
    kept = pos_in_e < cap

    # ---- dispatch: tokens (sorted by expert) -> (B, E, C, d) buckets ---
    rows = torch.arange(b, device=dev)[:, None]
    gidx = starts[:, :, None] + torch.arange(cap, device=dev)[None, None]
    valid = gidx < ends[:, :, None]                            # (B, E, C)
    gflat = torch.clamp(gidx, 0, s * k - 1).reshape(b, e * cap)
    # sorted entry j holds token order[j] // k (x repeated k times)
    src = torch.gather(torch.div(order, k, rounding_mode="floor"), 1, gflat)
    buf = x[rows, src].reshape(b, e, cap, d) * valid[..., None].to(x.dtype)

    # ---- expert compute, expert-major ----------------------------------
    buf_t = buf.transpose(0, 1)                                # (E, B, C, d)
    up = torch.einsum("ebcd,edf->ebcf", buf_t, params["up"].to(x.dtype))
    if gated:
        gate = torch.einsum("ebcd,edf->ebcf", buf_t,
                            params["gate"].to(x.dtype))
        h = activation(gate, act) * up
    else:
        h = activation(up, act)
    out_e = torch.einsum("ebcf,efd->ebcd", h, params["down"].to(x.dtype))
    out_flat = out_e.transpose(0, 1).reshape(b, e * cap, d)

    # ---- combine: bucket -> sorted entry -> unsort -> sum over k -------
    bucket_of = sorted_e * cap + torch.clamp(pos_in_e, max=cap - 1)
    outs = out_flat[rows, bucket_of]                           # (B, S*k, d)
    outs = outs * kept[..., None].to(x.dtype)
    ws = torch.gather(w.reshape(b, s * k), 1, order)
    outs = outs * ws[..., None].to(x.dtype)
    inv = torch.argsort(order, dim=-1)
    out = outs[rows, inv].reshape(b, s, k, d).sum(dim=2)

    if "shared" in params:
        out = out + apply_mlp(params["shared"], x, gated=True, act=act)
    return out, aux
