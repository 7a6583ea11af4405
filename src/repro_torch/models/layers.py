"""Core building blocks shared by the port's models.

Port of ``repro.models.layers``: pure functions over explicit parameter
dicts of tensors.  Initialisers draw from an explicit
``torch.Generator``; they give other numbers than ``jax.random`` from
the same seed, so parity tests carry JAX-initialised weights across
with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def truncated_normal(generator: torch.Generator, shape, *, scale: float,
                     dtype, device) -> torch.Tensor:
    """scale * N(0, 1) truncated to [-2, 2], drawn in fp32 then cast."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


def dense_init(generator, in_dim: int, out_dim: int, dtype=torch.float32,
               scale: Optional[float] = None, *, device) -> torch.Tensor:
    """Truncated-normal fan-in init (the standard LM init)."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    return truncated_normal(generator, (in_dim, out_dim), scale=scale,
                            dtype=dtype, device=device)


def embed_init(generator, vocab: int, dim: int, dtype=torch.float32, *,
               device) -> torch.Tensor:
    return truncated_normal(generator, (vocab, dim), scale=0.02, dtype=dtype,
                            device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight=None, *, eps: float = 1e-6, plus_one: bool = False):
    """RMSNorm.  ``plus_one`` follows gemma's (1 + w) parameterisation."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if weight is not None:
        w = weight.float()
        x = x * (1.0 + w) if plus_one else x * w
    return x.to(dtype)


def layer_norm(x, weight=None, bias=None, *, eps: float = 1e-5):
    """LayerNorm; with weight=bias=None this is OLMo's non-parametric LN."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def init_norm(dim: int, kind: str, dtype=torch.float32, *, device) -> Params:
    if kind == "rmsnorm":
        return {"w": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "rmsnorm_zero":          # gemma (1+w) parameterisation
        return {"w": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"w": torch.ones((dim,), dtype=dtype, device=device),
                "b": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "nonparametric_ln":      # OLMo
        return {}
    raise ValueError(f"unknown norm kind {kind!r}")


def apply_norm(params: Params, x, kind: str, eps: float = 1e-6):
    if kind == "rmsnorm":
        return rms_norm(x, params["w"], eps=eps, plus_one=False)
    if kind == "rmsnorm_zero":
        return rms_norm(x, params["w"], eps=eps, plus_one=True)
    if kind == "layernorm":
        return layer_norm(x, params["w"], params["b"], eps=eps)
    if kind == "nonparametric_ln":
        return layer_norm(x, None, None, eps=eps)
    raise ValueError(f"unknown norm kind {kind!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10_000.0, *, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, *, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)   # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, *, gated: bool,
             dtype=torch.float32, out_scale: Optional[float] = None,
             device) -> Params:
    p: Params = {"up": dense_init(generator, d_model, d_ff, dtype,
                                  device=device)}
    if gated:
        p["gate"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    p["down"] = dense_init(generator, d_ff, d_model, dtype, scale=out_scale,
                           device=device)
    return p


def apply_mlp(params: Params, x, *, gated: bool, act: str):
    up = x @ params["up"].to(x.dtype)
    if gated:
        gate = x @ params["gate"].to(x.dtype)
        h = activation(gate, act) * up
    else:
        h = activation(up, act)
    return h @ params["down"].to(x.dtype)


def activation(x, act: str):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    if act == "silu":
        return F.silu(x)
    if act in ("gelu", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    if act == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {act!r}")


def softcap(x, cap: float):
    """Gemma-2 style logit soft-capping."""
    return torch.tanh(x / cap) * cap
