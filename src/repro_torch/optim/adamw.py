"""AdamW, learning-rate schedules and global-norm clipping over a tree.

Port of ``repro.optim.adamw``: a pure function from (params, grads,
state) to (new params, new state, metrics); nothing is updated in place,
so a caller keeps the old tree as JAX code keeps an old array.  The
moment dtype is configurable (fp32 by default).  ``AdamWState`` keeps
the reference's field names, so checkpoints of either package carry the
same keys (``repro_torch.checkpoint.ckpt``).

The step, the learning rate and the bias corrections stay 0-dim tensors
on the params' device, so a step reads nothing back to the host; the
per-leaf arithmetic runs as ``torch._foreach_*`` ops over the leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Params             # first moment
    nu: Params             # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | constant | linear


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps`` (on ``step + 1``), then
    cosine decay to 10% of ``lr``, linear decay to 10%, or constant."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "linear":
        decay = 1.0 - 0.9 * frac
    else:  # cosine to 10%
        decay = 0.1 + 0.45 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def init(cfg: AdamWConfig, params: Params) -> AdamWState:
    mdt = _moment_dtype(cfg)
    p = tree.leaves(params)
    device = p[0].device if p else None

    def zeros(x):
        return torch.zeros(x.shape, dtype=mdt, device=x.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree.map_tree(zeros, params),
                      nu=tree.map_tree(zeros, params))


def global_norm(params: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf of a tree, in fp32."""
    norms = torch._foreach_norm([x.float() for x in tree.leaves(params)])
    return torch.linalg.vector_norm(torch.stack(norms))


def apply_updates(cfg: AdamWConfig, params: Params, grads: Params,
                  state: AdamWState
                  ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Gradients are clipped to ``clip_norm`` over the
    whole tree; weight decay applies only to leaves with ndim >= 2 (no
    decay on norms and biases).  Returns (params, state, {"grad_norm",
    "lr"})."""
    p = tree.leaves(params)
    g = [x.float() for x in tree.leaves(grads, params)]
    m = [x.float() for x in tree.leaves(state.mu, params)]
    v = [x.float() for x in tree.leaves(state.nu, params)]
    gnorm = global_norm(g)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        g = torch._foreach_mul(g, scale)

    step = state.step + 1
    lr = schedule_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    m = torch._foreach_mul(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    v = torch._foreach_mul(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
    denom = torch._foreach_sqrt(torch._foreach_div(v, b2c))
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(torch._foreach_div(m, b1c), denom)
    p32 = [x.float() for x in p]
    if cfg.weight_decay:
        decayed = [i for i, x in enumerate(p) if x.ndim >= 2]
        if decayed:
            dd = [delta[i] for i in decayed]
            torch._foreach_add_(dd, [p32[i] for i in decayed],
                                alpha=cfg.weight_decay)
    torch._foreach_mul_(delta, lr)
    new_p = [x.to(o.dtype) for x, o in zip(torch._foreach_sub(p32, delta), p)]
    mdt = _moment_dtype(cfg)
    new_state = AdamWState(step,
                           tree.unflatten(params, [x.to(mdt) for x in m]),
                           tree.unflatten(params, [x.to(mdt) for x in v]))
    return (tree.unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
