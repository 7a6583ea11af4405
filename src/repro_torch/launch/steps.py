"""The LM train step.

Port of ``repro.launch.steps.make_train_step``: the loss runs on a
``cfg.compute_dtype`` cast of the (fp32) params, gradients flow back to
the fp32 leaves, ``cfg.microbatches`` > 1 accumulates gradients over
equal slices of the batch (loss and gradients / m, metrics averaged),
and AdamW (``repro_torch.optim.adamw.apply_updates``) ends the step.
The step runs eagerly.  Not ported here: the reference's abstract
input specs and prefill / decode step builders, which serve its
sharded dry-run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

Params = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def make_loss_and_grads(cfg: ModelConfig
                        ) -> Callable[[Params, Dict[str, torch.Tensor]],
                                      Tuple[torch.Tensor, Metrics, Params]]:
    """``(params, batch) -> (loss, {"ce", "aux"}, grads)``: ``lm_loss`` on
    the params cast to ``cfg.cdtype`` and its gradient with respect to
    every leaf of ``params`` (zeros for a leaf the loss does not
    reach), in the leaves' own dtype."""
    def loss_and_grads(params: Params, batch):
        live = [x.detach().requires_grad_() for x in tree.leaves(params)]
        cast = tree.unflatten(params, [x.to(cfg.cdtype) for x in live])
        loss, metrics = tf.lm_loss(cast, cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(live, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, grads))
    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``:
    one AdamW step on ``batch`` {"tokens", "labels"} (B, S); metrics
    {"loss", "ce", "aux", "grad_norm", "lr"} as 0-dim tensors."""
    m = max(cfg.microbatches, 1)
    loss_and_grads = make_loss_and_grads(cfg)

    def train_step(params: Params, opt_state: adamw.AdamWState, batch):
        if m == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % m:
                raise ValueError(f"batch {b} does not split into {m} "
                                 f"microbatches")
            n = b // m
            loss, grads, mets = 0.0, None, []
            for i in range(m):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, met, g = loss_and_grads(params, mb)
                g = [x.float() for x in tree.leaves(g, params)]
                if grads is None:
                    grads = g
                else:
                    torch._foreach_add_(grads, g)
                loss = loss + l
                mets.append(met)
            torch._foreach_div_(grads, m)
            grads = tree.unflatten(params, grads)
            loss = loss / m
            metrics = {k: torch.stack([x[k] for x in mets]).mean()
                       for k in mets[0]}
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step
