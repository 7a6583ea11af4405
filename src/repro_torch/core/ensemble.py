"""Cost-aware stacked ensemble (Eq. 4, 6) and the multiplexing policies
of Algorithm 2.

Port of ``repro.core.ensemble``.  Two inference-time policies:
  * ``single``   — call only argmax_i w_i           (hybrid-single)
  * ``ensemble`` — average every model with w_i > T (hybrid-ensemble)

Policy *evaluation* here assumes every model's output is available: it
scores quality / cost trade-offs offline, as the paper's Table II does.
The serving path that only *executes* the selected models is
``repro_torch.core.routing`` / ``repro_torch.serving.mux_server``.
"""
from __future__ import annotations

from typing import Dict

import torch


def ensemble_logits(weights: torch.Tensor, probs_stack: torch.Tensor
                    ) -> torch.Tensor:
    """Eq. 4: y_ENS = sum_i w_i(x) f_i(x).

    weights: (B, N); probs_stack: (N, B, C) model output probabilities.
    """
    return torch.einsum("bn,nbc->bc", weights, probs_stack)


def mux_xent(weights: torch.Tensor, probs_stack: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Eq. 7: cross-entropy of the weighted ensemble prediction."""
    y = torch.clamp(ensemble_logits(weights, probs_stack), 1e-8, 1.0)
    gold = torch.gather(y, 1, labels.long()[:, None])[:, 0]
    return -torch.mean(torch.log(gold))


def select_single(weights: torch.Tensor) -> torch.Tensor:
    """Alg. 2 line 3 (argmax): (B,) model index per input."""
    return torch.argmax(weights, dim=-1)


def select_ensemble(weights: torch.Tensor, threshold: float) -> torch.Tensor:
    """Alg. 2 line 3 (threshold): (B, N) bool, at least one selected (the
    argmax where none clears the threshold)."""
    mask = weights > threshold
    fallback = torch.nn.functional.one_hot(
        torch.argmax(weights, dim=-1), weights.shape[-1]).bool()
    return torch.where(mask.any(dim=-1, keepdim=True), mask, fallback)


def policy_metrics(weights: torch.Tensor, probs_stack: torch.Tensor,
                   labels: torch.Tensor, costs: torch.Tensor, *,
                   threshold: float = 0.288) -> Dict[str, torch.Tensor]:
    """Score both policies at once (Table II quantities).

    costs: (N,) FLOPs per model.  Returns accuracy + mean FLOPs + the
    per-model call distribution for the single policy.
    """
    n, b, _ = probs_stack.shape
    labels = labels.long()
    preds = torch.argmax(probs_stack, dim=-1)               # (N, B)

    sel = select_single(weights)                            # hybrid-single
    pred_single = torch.gather(preds, 0, sel[None])[0]
    acc_single = torch.mean((pred_single == labels).float())
    flops_single = torch.mean(costs[sel])
    called = torch.zeros((n,), device=weights.device).index_add_(
        0, sel, torch.ones((b,), device=weights.device)) / b

    mask = select_ensemble(weights, threshold)             # hybrid-ensemble
    wsel = mask.to(probs_stack.dtype)
    avg = (torch.einsum("bn,nbc->bc", wsel, probs_stack)
           / wsel.sum(dim=-1, keepdim=True))
    acc_ens = torch.mean((torch.argmax(avg, dim=-1) == labels).float())
    flops_ens = torch.mean(torch.sum(wsel * costs[None, :], dim=-1))
    return {"acc_single": acc_single, "flops_single": flops_single,
            "acc_ensemble": acc_ens, "flops_ensemble": flops_ens,
            "called": called}


def oracle_metrics(probs_stack: torch.Tensor, labels: torch.Tensor,
                   costs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Upper bounds: cheapest-correct-model oracle and any-correct
    accuracy."""
    preds = torch.argmax(probs_stack, dim=-1)               # (N, B)
    correct = preds == labels.long()[None, :]               # (N, B)
    any_correct = correct.any(dim=0)
    # cheapest correct model (or the cheapest overall when none is)
    order = torch.argsort(costs, stable=True)
    first = torch.argmax(correct[order].to(torch.int32), dim=0)
    chosen = torch.where(any_correct, order[first], order[0])
    return {"acc_oracle": torch.mean(any_correct.float()),
            "flops_oracle": torch.mean(costs[chosen]),
            "correct_matrix": correct}
