"""Model selection from mux weights.

Port of ``repro.core.routing.select_model``.  Bucketing, dispatch and
``multiplexed_apply`` (the single-program zoo step) come with the CNN
zoo.
"""
from __future__ import annotations

from typing import Optional

import torch


def select_model(w: torch.Tensor, costs: torch.Tensor,
                 threshold: Optional[float] = None) -> torch.Tensor:
    """Mux weights (B, N) -> model ids (B,) int32.

    threshold=None is the paper's hybrid-single policy: argmax over the
    cost-aware weights.  With a threshold: pick the *cheapest* model
    whose mux weight exceeds it; if none clears it, fall back to the
    most expensive model.
    """
    if threshold is None:
        return torch.argmax(w, dim=-1).to(torch.int32)
    order = torch.argsort(costs, stable=True)        # cheap -> expensive
    ok = w[:, order] > threshold                     # (B, N) in cost order
    first_ok = torch.argmax(ok.to(torch.int32), dim=-1)  # first True, else 0
    chosen = torch.where(ok.any(dim=-1), order[first_ok], order[-1])
    return chosen.to(torch.int32)
