"""The model multiplexer (§II.B): meta-features + cost-aware stacking
head.

    w_i(x) = softmax_i( sum_j v_ij m_j(x) / c_i )        (Eq. 5-6)

Port of ``repro.core.multiplexer``.  The backbone
producing the meta-features m(x) is modality-specific:

* images -> the paper's 4-conv CNN (``repro_torch.models.cnn``,
  ``init_image_backbone``; params under ``"net"``);
* tokens -> a 2-layer transformer probe over the prompt prefix, split
  into its trunk (tokens -> last hidden states) and its head (mean
  pool, out projection, tanh), which the token server fuses with
  Eq. 5-6 into one kernel (``ops.mux_head``).

Distillation (Eq. 8, ``distill_loss``): each model i gets a linear
read-out r_i of the meta-features that is pulled toward that model's
projected embedding e_i (``repro_torch.core.contrastive``'s distance).

Params are plain dicts of tensors with the JAX package's tree
(``repro_torch.convert`` carries them across).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.contrastive import cosine_distance
from repro_torch.device import DeviceLike, generator_on, resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.layers import dense_init, truncated_normal

Params = Dict[str, Any]
PROBE_LEN = 64          # prompt tokens the token probe reads


def init_image_backbone(generator: Optional[torch.Generator] = None, *,
                        meta_dim: int, in_ch: int = 3,
                        device: DeviceLike = None) -> Params:
    """The paper's 4-conv CNN backbone (fp32 params)."""
    return {"net": cnn_mod.init_mux_backbone(generator, meta_dim=meta_dim,
                                             in_ch=in_ch, device=device)}


def init_token_backbone(generator: Optional[torch.Generator] = None, *,
                        meta_dim: int, vocab_size: int, d_model: int = 128,
                        num_layers: int = 2,
                        device: DeviceLike = None) -> Params:
    """Tiny transformer probe over the prompt prefix (fp32 params)."""
    dev = resolve_device(device)
    generator = generator_on(generator, dev)

    def dense(i, o):
        return dense_init(generator, i, o, device=dev)

    p: Params = {"embed": truncated_normal(generator, (vocab_size, d_model),
                                           scale=0.02, dtype=torch.float32,
                                           device=dev),
                 "layers": [], "out": dense(d_model, meta_dim)}
    for _ in range(num_layers):
        p["layers"].append({
            "wqkv": dense(d_model, 3 * d_model),
            "wo": dense(d_model, d_model),
            "up": dense(d_model, 4 * d_model),
            "down": dense(4 * d_model, d_model),
        })
    return p


def token_trunk(p: Params, tokens, *, probe_len: int = PROBE_LEN,
                num_heads: int = 4) -> torch.Tensor:
    """tokens (B, S) -> the probe's last hidden states h (B, min(S,
    probe_len), d): the 2-layer causal encoder over the first
    ``probe_len`` tokens.  ``tokens`` already on the params' device (as
    the server passes them) is used in place, so the function has no
    host transfer and no host read and can be captured in a CUDA graph."""
    probe = torch.as_tensor(tokens, device=p["embed"].device)[:, :probe_len]
    h = p["embed"][probe.long()]
    b, s, d = h.shape
    nh = num_heads
    hd = d // nh
    mask = torch.ones((s, s), dtype=torch.bool, device=h.device).tril_()
    for lp in p["layers"]:
        qkv = (h @ lp["wqkv"]).reshape(b, s, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        sc = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        sc = torch.where(mask, sc, -1e30)
        att = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), v)
        h = h + att.reshape(b, s, d) @ lp["wo"]
        h = h + F.gelu(h @ lp["up"], approximate="tanh") @ lp["down"]
    return h


def _token_backbone_forward(p: Params, tokens, **static) -> torch.Tensor:
    """tokens (B, S) -> meta (B, meta_dim): the trunk, mean-pooled, out
    projection, tanh (the head ``ops.mux_head`` fuses)."""
    h = token_trunk(p, tokens, **static)
    return torch.tanh(h.mean(dim=1) @ p["out"])


def backbone_forward(params: Params, x, **static) -> torch.Tensor:
    if "net" in params:                      # image backbone
        return cnn_mod.mux_backbone_forward(params["net"], x)
    return _token_backbone_forward(params, x, **static)


def init_mux(generator: Optional[torch.Generator] = None, *,
             backbone: Params, model_names: Sequence[str],
             costs: Dict[str, float], meta_dim: int, proj_dim: int,
             device: DeviceLike = None) -> Params:
    """costs: FLOPs per inference for each zoo model (the paper's c_i),
    kept relative to the cheapest."""
    dev = resolve_device(device)
    generator = generator_on(generator, dev)
    c = torch.tensor([costs[m] for m in model_names], dtype=torch.float32,
                     device=dev)
    return {
        "backbone": backbone,
        "v": truncated_normal(generator, (len(model_names), meta_dim),
                              scale=1.0 / math.sqrt(meta_dim),
                              dtype=torch.float32, device=dev),
        "cost_rel": c / c.min(),                  # fixed, not trained
        "distill": {m: dense_init(generator, meta_dim, proj_dim, device=dev)
                    for m in model_names},
    }


def mux_forward(params: Params, x, *, cost_exponent: float = 1.0,
                **backbone_static) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights (B, N) softmax-normalised, meta (B, M)).
    logits_i = (v_i . m) / c_i^alpha, alpha = cost_exponent."""
    meta = backbone_forward(params["backbone"], x, **backbone_static)
    logits = meta @ params["v"].T                          # (B, N)
    cost = params["cost_rel"] ** cost_exponent
    return torch.softmax(logits / cost[None, :], dim=-1), meta


def distill_loss(params: Params, meta: torch.Tensor,
                 projected: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eq. 8: pull each read-out r_i(m) toward e_i (no gradient into
    e_i)."""
    names = list(params["distill"])
    total = torch.zeros((), dtype=torch.float32, device=meta.device)
    for name in names:
        r = meta @ params["distill"][name]
        r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                            min=1e-6)
        e = projected[name].detach()
        total = total + torch.mean(cosine_distance(r, e))
    return total / len(names)
