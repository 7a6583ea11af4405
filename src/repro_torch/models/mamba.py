"""Mamba-1 selective SSM block (falcon-mamba layers).

Port of ``repro.models.mamba``.  Differences from the JAX package, by
design:

* The prefill scan goes through ``kernels.ops.selective_scan``: the
  hand-written CUDA kernel (K4) for CUDA tensors, its plain sequential
  version for CPU tensors, which autograd differentiates in training.
  K4 has no backward yet, so on the card a scan that needs a gradient
  raises ``NotImplementedError``: Mamba trains on the CPU only.  The
  JAX package's chunked associative scan is not ported, so no padding
  to a chunk multiple is needed; in fp32 the two agree to rounding, not
  bitwise.
* Caches are written **in place**: ``mamba_forward`` / ``mamba_decode``
  copy the new conv tail and SSM state into ``cache`` (the group's view
  of the stacked cache) and also return it, so call sites read as in the
  JAX package.

State cache per layer: {"conv": (B, d_conv-1, d_inner) trailing inputs
in the cache dtype, "h": (B, d_inner, ssm_state) fp32}.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm

Params = Dict[str, Any]


def init_mamba(generator, *, d_model: int, d_inner: int, ssm_state: int,
               d_conv: int, dt_rank: int, dtype=torch.float32,
               device) -> Params:
    """Random mamba-mixer params drawn from ``generator``; ``A_log`` and
    ``D`` stay fp32 whatever ``dtype`` is, as in the JAX package."""
    def draw(shape, fn):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return fn(x)

    in_proj = dense_init(generator, d_model, 2 * d_inner, dtype,
                         device=device)
    conv_w = draw((d_conv, d_inner),
                  lambda x: x.normal_(generator=generator) * 0.1).to(dtype)
    x_proj = dense_init(generator, d_inner, dt_rank + 2 * ssm_state, dtype,
                        device=device)
    dt_proj = dense_init(generator, dt_rank, d_inner, dtype, device=device)
    # dt ~ [1e-3, 1e-1] log-uniform; dt_bias = softplus^-1(dt)
    dt_init = torch.exp(draw((d_inner,), lambda x: x.uniform_(
        generator=generator)) * 5.0 - 5.0)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    a_log = torch.log(torch.arange(1, ssm_state + 1, dtype=torch.float32,
                                   device=device)).expand(d_inner, ssm_state)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias.to(dtype),
        "A_log": a_log.contiguous(),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, d_inner, d_model, dtype,
                               device=device),
    }


def init_mamba_cache(batch: int, *, d_inner: int, ssm_state: int,
                     d_conv: int, dtype=torch.bfloat16, device) -> Params:
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_inner, ssm_state), dtype=torch.float32,
                         device=device),
    }


def _ssm_inputs(params: Params, x_conv, *, dt_rank: int, ssm_state: int,
                norm_bc_dt: bool):
    """x_conv (B,S,d_in) -> dt (B,S,d_in), B_ (B,S,n), C (B,S,n) in fp32."""
    dbc = x_conv @ params["x_proj"].to(x_conv.dtype)
    dt_r = dbc[..., :dt_rank]
    b_mat = dbc[..., dt_rank:dt_rank + ssm_state].float()
    c_mat = dbc[..., dt_rank + ssm_state:].float()
    if norm_bc_dt:  # falcon-mamba stabilisation: weight-free RMSNorm on dt/B/C
        dt_r = rms_norm(dt_r, None)
        b_mat = rms_norm(b_mat, None)
        c_mat = rms_norm(c_mat, None)
    dt = dt_r @ params["dt_proj"].to(x_conv.dtype)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, b_mat, c_mat


def _causal_conv(params: Params, x, prev: Optional[torch.Tensor]):
    """Depthwise causal conv over seq.  x (B,S,d_in); prev (B,d_conv-1,d_in).
    Returns (out (B,S,d_in), the trailing d_conv-1 inputs)."""
    d_conv = params["conv_w"].shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], d_conv - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    w = params["conv_w"].to(x.dtype)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(d_conv))
    return out + params["conv_b"].to(x.dtype), xp[:, -(d_conv - 1):]


def mamba_forward(params: Params, x, *, d_inner: int, ssm_state: int,
                  d_conv: int, dt_rank: int, norm_bc_dt: bool = False,
                  cache: Params = None) -> Tuple[torch.Tensor,
                                                 Optional[Params]]:
    """Full-sequence forward.  x: (B,S,D).  With a ``cache`` the scan
    starts from ``cache["h"]`` and the conv from ``cache["conv"]``, and
    both are overwritten with the state after the sequence.  Returns
    (out, cache)."""
    xz = x @ params["in_proj"].to(x.dtype)
    x_in, z = xz[..., :d_inner], xz[..., d_inner:]
    x_conv, conv_tail = _causal_conv(params, x_in,
                                     None if cache is None else cache["conv"])
    x_conv = F.silu(x_conv)
    dt, b_mat, c_mat = _ssm_inputs(params, x_conv, dt_rank=dt_rank,
                                   ssm_state=ssm_state, norm_bc_dt=norm_bc_dt)
    a_mat = -torch.exp(params["A_log"].float())                 # (d_in, n)
    y, h_last = ops.selective_scan(x_conv, dt, b_mat, c_mat, a_mat,
                                   params["D"],
                                   None if cache is None else cache["h"])
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    if cache is not None:
        cache["conv"].copy_(conv_tail)
        cache["h"].copy_(h_last)
    return out, cache


def mamba_decode(params: Params, x, cache: Params, *, d_inner: int,
                 ssm_state: int, d_conv: int, dt_rank: int,
                 norm_bc_dt: bool = False) -> Tuple[torch.Tensor, Params]:
    """Single-token step.  x: (B,1,D).  Updates ``cache`` in place and
    returns (out, cache)."""
    xz = x @ params["in_proj"].to(x.dtype)
    x_in, z = xz[..., :d_inner], xz[..., d_inner:]
    # conv over the cached tail + current token
    xp = torch.cat([cache["conv"].to(x.dtype), x_in], dim=1)
    w = params["conv_w"].to(x.dtype)
    x_conv = (xp * w[None]).sum(dim=1, keepdim=True) + params["conv_b"].to(
        x.dtype)
    x_conv = F.silu(x_conv)
    dt, b_mat, c_mat = _ssm_inputs(params, x_conv, dt_rank=dt_rank,
                                   ssm_state=ssm_state, norm_bc_dt=norm_bc_dt)
    a_mat = -torch.exp(params["A_log"].float())
    xf = x_conv.float()
    decay = torch.exp(dt[:, 0, :, None] * a_mat[None])          # (B,d_in,n)
    h = decay * cache["h"] + (dt[:, 0] * xf[:, 0])[..., None] * b_mat[
        :, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])[:, None]
    y = y + xf * params["D"].float()[None, None]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    cache["conv"].copy_(xp[:, 1:])
    cache["h"].copy_(h)
    return out, cache
