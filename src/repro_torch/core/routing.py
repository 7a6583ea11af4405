"""Model selection and model-level dispatch from mux weights.

Port of ``repro.core.routing``.  The mux assigns each request a model
id; requests are bucketed per model with a fixed capacity (static
shapes), every model runs on its bucket, and results are scattered
back: the MoE dispatch pattern lifted to whole-model granularity
(``multiplexed_apply``, the single-program zoo step of
``MuxServer.serve``).  ``pad_bucket`` is the same scatter math for one
queue, which the scheduler's micro-batch former renders on the host
with numpy (``pad_bucket_host``).

Every tensor function here is device-side only: no host read of a
device value and no shape that depends on data, so ``MuxServer``'s
batch step can be captured in a CUDA graph.  Overflowed rows all
scatter into one discarded slot, ``num_models * capacity``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
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


def bucket_by_model(assign: torch.Tensor, num_models: int, capacity: int
                    ) -> Dict[str, torch.Tensor]:
    """assign: (B,) model ids.  Returns the static-shape routing plan.

    Sort-based and capacity-bounded: ``plan["slot"][b] = m * capacity +
    c`` for request b landing in bucket m at column c, or the overflow
    slot ``num_models * capacity``; ``plan["kept"]`` marks the rows that
    got a column.
    """
    b = assign.shape[0]
    order = torch.argsort(assign, stable=True)
    sorted_m = assign[order]
    first = torch.searchsorted(sorted_m, sorted_m, side="left")
    pos_in_m = torch.arange(b, device=assign.device) - first
    kept = pos_in_m < capacity
    slot_sorted = torch.where(kept, sorted_m.long() * capacity + pos_in_m,
                              num_models * capacity)
    inv = torch.argsort(order, stable=True)          # per-request view
    return {"order": order, "inv": inv, "slot": slot_sorted[inv],
            "kept": kept[inv]}


def dispatch(x: torch.Tensor, plan: Dict[str, torch.Tensor],
             num_models: int, capacity: int) -> torch.Tensor:
    """x: (B, ...) -> buckets (N, C, ...); empty columns are zeros."""
    buf = torch.zeros((num_models * capacity + 1,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    buf.index_copy_(0, plan["slot"], x)
    return buf[:num_models * capacity].reshape(
        (num_models, capacity) + tuple(x.shape[1:]))


def combine(outputs: torch.Tensor, plan: Dict[str, torch.Tensor],
            fill_value=0) -> torch.Tensor:
    """outputs: (N, C, ...) -> per-request (B, ...); dropped requests get
    ``fill_value``."""
    n, c = outputs.shape[:2]
    flat = outputs.reshape((n * c,) + tuple(outputs.shape[2:]))
    got = flat[torch.clamp(plan["slot"], 0, n * c - 1)]
    keep = plan["kept"].reshape((-1,) + (1,) * (got.dim() - 1))
    return torch.where(keep, got, torch.full_like(got, fill_value))


def pad_bucket(x: torch.Tensor, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad (k, ...) requests to one static-shape (capacity, ...) bucket:
    the scatter math of ``bucket_by_model`` / ``dispatch`` for one
    queue.  Returns (bucket (capacity, ...), valid (capacity,) bool);
    requests beyond capacity are dropped."""
    k = x.shape[0]
    plan = bucket_by_model(torch.zeros((k,), dtype=torch.int32,
                                       device=x.device), 1, capacity)
    bucket = dispatch(x, plan, 1, capacity)[0]
    # dropped rows carry the overflow slot (== capacity when n=1), so a
    # scatter into a capacity+1 buffer marks exactly the real rows
    valid = torch.zeros((capacity + 1,), dtype=torch.bool, device=x.device)
    valid.index_fill_(0, plan["slot"], True)
    return bucket, valid[:capacity]


def pad_bucket_host(xs: Sequence[Any], capacity: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy) mirror of :func:`pad_bucket` for the
    scheduler's event loop: the same bucket (row i = xs[i], zero
    padding) with no device work.  Requires k >= 1: a plain sequence
    carries no shape or dtype for an all-padding bucket."""
    k = len(xs)
    if k == 0:
        raise ValueError("pad_bucket_host requires at least one request")
    first = np.asarray(xs[0])
    bucket = np.zeros((capacity,) + first.shape, first.dtype)
    for i in range(min(k, capacity)):
        bucket[i] = np.asarray(xs[i])
    valid = np.zeros((capacity,), bool)
    valid[:min(k, capacity)] = True
    return bucket, valid


def multiplexed_apply(x: torch.Tensor, assign: torch.Tensor,
                      model_fns: Sequence[Callable[[torch.Tensor],
                                                   torch.Tensor]],
                      *, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Request-level multiplexing in one program.

    x: (B, ...) requests; assign: (B,) model ids; ``model_fns[m]`` maps
    a (C, ...) bucket to (C, out...).  Every model runs on its (possibly
    padded) bucket.  Returns (outputs (B, out...), kept (B,) bool).
    """
    n = len(model_fns)
    plan = bucket_by_model(assign, n, capacity)
    buckets = dispatch(x, plan, n, capacity)
    outputs = torch.stack([fn(buckets[m]) for m, fn in enumerate(model_fns)])
    return combine(outputs, plan), plan["kept"]
