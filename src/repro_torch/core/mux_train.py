"""Algorithm 1, the paper's two-phase learning procedure.

Port of ``repro.core.mux_train``.

Phase 1 (lines 3-10): train every zoo model jointly with
    L_i = L_ce(y_hat_i, y) + lambda_cnt * L_cnt(y_hat, y)
where L_cnt couples the models through their projected embeddings.

Phase 2 (lines 11-19): freeze the zoo; train the multiplexer with
    L = L_mux(y_ENS, y) + lambda_distill * sum_i L_distill(m, e_i).

Plain functions on dict params, as in the reference, with gradients
from ``torch.autograd.grad`` over the tree's leaves (the reference's
``jax.value_and_grad``) and updates from ``repro_torch.optim.adamw``.
The reference's contract is fp32, and the convolutions' backward runs
after the forward has returned, so the full-fp32 scope of the zoo's
convolutions (``models.cnn.fp32_convs``) is held open across the
backward too (:func:`loss_and_grads`): cuDNN reads its TF32 switch when
each backward convolution launches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core import contrastive as cnt
from repro_torch.core import ensemble as ens
from repro_torch.core import multiplexer as mux_mod
from repro_torch.device import DeviceLike, generator_on, resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.optim import adamw

Params = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]
OnStep = Callable[[int, Metrics], None]


def loss_and_grads(loss_fn: Callable, params: Params, *args
                   ) -> Tuple[torch.Tensor, Metrics, Params]:
    """``loss_fn(params, *args) -> (loss, metrics)`` and the gradient of
    the loss with respect to every leaf of ``params`` (zeros for a leaf
    the loss does not reach), forward and backward inside the zoo's
    full-fp32 convolution scope."""
    live = [x.detach().requires_grad_() for x in tree.leaves(params)]
    with cnn_mod.fp32_convs():
        loss, metrics = loss_fn(tree.unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, grads))


def opt_config(exp_cfg, total_steps: int) -> adamw.AdamWConfig:
    """Algorithm 1's optimiser for both phases: AdamW at ``exp_cfg.lr``,
    20 warm-up steps, cosine decay over ``total_steps``, clipping at 1."""
    return adamw.AdamWConfig(lr=exp_cfg.lr, weight_decay=1e-4,
                             warmup_steps=20, total_steps=total_steps,
                             clip_norm=1.0)


# ---------------------------------------------------------------------------
# Zoo state
# ---------------------------------------------------------------------------

def init_zoo_state(generator: Optional[torch.Generator], exp_cfg, *,
                   device: DeviceLike = None) -> Params:
    """{"zoo": the named CNNs, "proj": one h_i per model (Eq. 1)}."""
    generator = generator_on(generator, resolve_device(device))
    zoo = cnn_mod.init_zoo(generator, num_classes=exp_cfg.num_classes,
                           names=exp_cfg.zoo, device=device)
    dims = {n: cnn_mod.ZOO_SPECS[n]["embed_dim"] for n in exp_cfg.zoo}
    proj = cnt.init_projections(generator, dims, exp_cfg.proj_dim,
                                device=device)
    return {"zoo": zoo, "proj": proj}


def zoo_apply(state: Params, images, names: Sequence[str]):
    """-> (probs_stack (N, B, C), embeddings {n: (B, d)}, logits {n})."""
    logits, embeds = {}, {}
    for n in names:
        logits[n], embeds[n] = cnn_mod.cnn_forward(
            state["zoo"][n], images,
            convs_per_stage=cnn_mod.ZOO_SPECS[n].get("convs_per_stage", 1))
    probs = torch.stack([torch.softmax(logits[n], dim=-1) for n in names])
    return probs, embeds, logits


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def zoo_loss(state: Params, batch, exp_cfg) -> Tuple[torch.Tensor, Metrics]:
    names = list(exp_cfg.zoo)
    _, embeds, logits = zoo_apply(state, batch["image"], names)
    y = batch["label"].long()
    ce = sum(-torch.mean(torch.gather(F.log_softmax(logits[n], dim=-1), 1,
                                      y[:, None]))
             for n in names) / len(names)
    projected = cnt.project(state["proj"], embeds)
    correct = {n: torch.argmax(logits[n], dim=-1) == y for n in names}
    l_cnt = cnt.contrastive_loss(projected, correct)
    loss = ce + exp_cfg.contrastive_coef * l_cnt
    return loss, {"ce": ce, "cnt": l_cnt}


def zoo_train_step(state: Params, opt_state: adamw.AdamWState, batch,
                   exp_cfg, opt_cfg: adamw.AdamWConfig):
    loss, metrics, grads = loss_and_grads(zoo_loss, state, batch, exp_cfg)
    state, opt_state, om = adamw.apply_updates(opt_cfg, state, grads,
                                               opt_state)
    return state, opt_state, {**metrics, **om, "loss": loss}


def _cycle(batches: List[Dict], steps: int):
    """The batches in order, round and round, ``steps`` of them."""
    if not batches:
        raise ValueError("no training batches")
    step = 0
    while step < steps:
        for batch in batches:
            step += 1
            yield step, batch
            if step >= steps:
                return


def train_zoo(generator: Optional[torch.Generator], exp_cfg,
              batches: List[Dict], *, contrastive: bool = True,
              log_every: int = 50, verbose: bool = False,
              device: DeviceLike = None,
              on_step: Optional[OnStep] = None) -> Params:
    """Phase 1 driver: ``exp_cfg.zoo_steps`` steps over ``batches``.
    With contrastive=False this is the ablation baseline (plain
    independent training).  ``on_step(step, metrics)`` is called after
    each step is enqueued."""
    cfg = exp_cfg if contrastive else dataclasses.replace(
        exp_cfg, contrastive_coef=0.0)
    state = init_zoo_state(generator, cfg, device=device)
    opt_cfg = opt_config(cfg, cfg.zoo_steps)
    opt_state = adamw.init(opt_cfg, state)
    for step, batch in _cycle(batches, cfg.zoo_steps):
        state, opt_state, m = zoo_train_step(state, opt_state, batch, cfg,
                                             opt_cfg)
        if on_step is not None:
            on_step(step, m)
        if verbose and step % log_every == 0:
            print(f"  zoo step {step}: loss={float(m['loss']):.4f} "
                  f"ce={float(m['ce']):.4f} cnt={float(m['cnt']):.4f}")
    return state


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

def init_mux_state(generator: Optional[torch.Generator], exp_cfg, *,
                   names: Sequence[str] = None,
                   device: DeviceLike = None) -> Params:
    names = list(names or exp_cfg.zoo)
    generator = generator_on(generator, resolve_device(device))
    backbone = mux_mod.init_image_backbone(generator,
                                           meta_dim=exp_cfg.meta_dim,
                                           device=device)
    costs = exp_cfg.costs()
    return mux_mod.init_mux(generator, backbone=backbone, model_names=names,
                            costs={n: costs[n] for n in names},
                            meta_dim=exp_cfg.meta_dim,
                            proj_dim=exp_cfg.proj_dim, device=device)


def mux_loss(trainable: Params, cost_rel: torch.Tensor, zoo_state: Params,
             batch, exp_cfg, names: Sequence[str],
             objective: str = "ensemble") -> Tuple[torch.Tensor, Metrics]:
    """Eq. 7 (``"ensemble"``) or the mobile/cloud detector's BCE
    (``"offload"``), plus the distillation term (Eq. 8).  The zoo is
    frozen: it runs without autograd."""
    mux_params = {**trainable, "cost_rel": cost_rel}
    label = batch["label"].long()
    with torch.no_grad():
        probs, embeds, logits = zoo_apply(zoo_state, batch["image"], names)
        projected = cnt.project(zoo_state["proj"], embeds)
    weights, meta = mux_mod.mux_forward(mux_params, batch["image"])
    if objective == "offload":
        # paper §III.B mobile/cloud mux: a binary detector of inputs the
        # FIRST (mobile) model solves — route local iff w[:, 0] >= 0.5
        mobile_ok = (torch.argmax(logits[names[0]], dim=-1) == label).float()
        p_local = torch.clamp(weights[:, 0], 1e-6, 1 - 1e-6)
        # class-balanced BCE: mobile-correct is the majority class (the
        # easy inputs); without re-weighting the detector collapses to
        # "always local" and misses the hard tail the cloud should get
        pos = torch.clamp(mobile_ok.mean(), 0.05, 0.95)
        l_mux = -torch.mean(mobile_ok * torch.log(p_local) / pos
                            + (1 - mobile_ok) * torch.log1p(-p_local)
                            / (1 - pos)) / 2
    else:
        l_mux = ens.mux_xent(weights, probs, label)
    l_dst = mux_mod.distill_loss(mux_params, meta, projected)
    return (l_mux + exp_cfg.distill_coef * l_dst,
            {"mux": l_mux, "distill": l_dst})


def mux_train_step(trainable: Params, cost_rel: torch.Tensor,
                   opt_state: adamw.AdamWState, zoo_state: Params, batch,
                   exp_cfg, opt_cfg: adamw.AdamWConfig,
                   names: Sequence[str], objective: str = "ensemble"):
    loss, metrics, grads = loss_and_grads(mux_loss, trainable, cost_rel,
                                          zoo_state, batch, exp_cfg, names,
                                          objective)
    trainable, opt_state, om = adamw.apply_updates(opt_cfg, trainable, grads,
                                                   opt_state)
    return trainable, opt_state, {**metrics, **om, "loss": loss}


def train_mux(generator: Optional[torch.Generator], exp_cfg,
              zoo_state: Params, batches: List[Dict], *,
              names: Sequence[str] = None, log_every: int = 50,
              verbose: bool = False, objective: str = "ensemble",
              device: DeviceLike = None,
              on_step: Optional[OnStep] = None) -> Params:
    """Phase 2 driver: ``exp_cfg.mux_steps`` steps over ``batches``, for
    any subset of the zoo (e.g. the mobile/cloud pair).  ``cost_rel`` is
    fixed, not trained."""
    names = tuple(names or exp_cfg.zoo)
    trainable = init_mux_state(generator, exp_cfg, names=names,
                               device=device)
    cost_rel = trainable.pop("cost_rel")
    opt_cfg = opt_config(exp_cfg, exp_cfg.mux_steps)
    opt_state = adamw.init(opt_cfg, trainable)
    for step, batch in _cycle(batches, exp_cfg.mux_steps):
        trainable, opt_state, m = mux_train_step(
            trainable, cost_rel, opt_state, zoo_state, batch, exp_cfg,
            opt_cfg, names, objective)
        if on_step is not None:
            on_step(step, m)
        if verbose and step % log_every == 0:
            print(f"  mux step {step}: loss={float(m['loss']):.4f} "
                  f"mux={float(m['mux']):.4f} "
                  f"distill={float(m['distill']):.4f}")
    return {**trainable, "cost_rel": cost_rel}
