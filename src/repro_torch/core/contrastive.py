"""The paper's contrastive loss (§II.A, Eq. 1-3).

Port of ``repro.core.contrastive``.  Projected embeddings: e_i =
normalize(h_i^T g_i), a per-model linear map into a shared ``proj_dim``
space, L2-normalised (Eq. 1).

Pairwise coefficient per (i, j) model pair and sample (the paper's
three cases, as its §II.A text states them):
  * both predict correctly          -> pull together  (coef +1)
  * exactly one predicts correctly  -> push apart     (coef -1)
  * neither predicts correctly      -> no contrastive signal (coef 0)

The printed Eq. 2 also gives the both-wrong case -1, against its own
text and Fig. 4's target; the text is followed, as in the reference.

Distance: d = clip((1 - cos) / 2, eps, 1) in [0, 1], so minimising
sum coef * log(d) pulls both-correct pairs together and pushes
expertise-separating pairs apart (Fig. 4).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, generator_on, resolve_device
from repro_torch.models.layers import truncated_normal

Params = Dict[str, Any]

EPS = 1e-4


def init_projections(generator: Optional[torch.Generator],
                     embed_dims: Dict[str, int], proj_dim: int,
                     dtype=torch.float32, device: DeviceLike = None
                     ) -> Params:
    """One linear h_i per model: (embed_dim_i, proj_dim)."""
    dev = resolve_device(device)
    generator = generator_on(generator, dev)
    return {name: truncated_normal(generator, (d, proj_dim),
                                   scale=1.0 / math.sqrt(d), dtype=dtype,
                                   device=dev)
            for name, d in embed_dims.items()}


def project(proj: Params, embeddings: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Eq. 1: e_i = normalize(h_i^T g_i).  embeddings: {name: (B, d_i)}."""
    out = {}
    for name, g in embeddings.items():
        e = g @ proj[name].to(g.dtype)
        norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        out[name] = e / torch.clamp(norm, min=1e-6)
    return out


def cosine_distance(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """(1 - cos) / 2 in [0, 1]; inputs assumed L2-normalised (B, P)."""
    cos = torch.sum(e1 * e2, dim=-1)
    return torch.clamp((1.0 - cos) / 2.0, EPS, 1.0)


def _pair_masks(correct, a, b):
    ci = correct[a].to(torch.float32)
    cj = correct[b].to(torch.float32)
    return ci * cj, ci * (1 - cj) + (1 - ci) * cj     # both, exactly one


def contrastive_loss(projected: Dict[str, torch.Tensor],
                     correct: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eq. 2 over all ordered model pairs.

    projected: {name: (B, P)} L2-normalised; correct: {name: (B,) bool}.
    Returns a scalar (mean over batch and pairs).
    """
    names = list(projected)
    dev = projected[names[0]].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    pairs = 0
    for a in names:
        for b in names:
            if a == b:
                continue
            both, one = _pair_masks(correct, a, b)
            d = cosine_distance(projected[a], projected[b])
            total = total + torch.mean((both - one) * torch.log(d))
            pairs += 1
    return total / max(pairs, 1)


def pairwise_distance_matrix(projected: Dict[str, torch.Tensor]
                             ) -> torch.Tensor:
    """(N, N, B) distance tensor."""
    names = list(projected)
    return torch.stack([
        torch.stack([cosine_distance(projected[a], projected[b])
                     for b in names]) for a in names])


def separation_score(projected: Dict[str, torch.Tensor],
                     correct: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Quantitative Fig. 6 check: mean distance of pull vs push pairs.
    A well-shaped space has push_mean >> pull_mean."""
    names = list(projected)
    pull = push = pulln = pushn = 0.0
    for a in names:
        for b in names:
            if a == b:
                continue
            both, one = _pair_masks(correct, a, b)
            d = cosine_distance(projected[a], projected[b])
            pull = pull + torch.sum(both * d)
            pulln = pulln + torch.sum(both)
            push = push + torch.sum(one * d)
            pushn = pushn + torch.sum(one)
    return {"pull_mean": pull / torch.clamp(torch.as_tensor(pulln), min=1),
            "push_mean": push / torch.clamp(torch.as_tensor(pushn), min=1)}
