"""Shared state of the paper's results: train the zoo and both
multiplexers once (Algorithm 1), keep them in a cache of the port's own,
and hand each table or figure runner the pieces it needs.

Port of ``benchmarks/common.py``'s training and evaluation half.  The
runners measure the same system the tests exercise: no parallel
implementation.  Data and params are drawn from seeded
``torch.Generator``s on the run's device; they are other numbers than
the JAX package's from the same seed, so the cache holds states the
port trained (``results/torch_bench_state/<scale>/`` unless
``REPRO_TORCH_BENCH_STATE`` names another directory), never the JAX
package's ``results/bench_state``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.paper_mux import MuxExperimentConfig
from repro_torch.configs.paper_mux import config as full_config
from repro_torch.core import mux_train
from repro_torch.core.multiplexer import mux_forward
from repro_torch.data.synthetic import image_dataset, make_templates
from repro_torch.device import DeviceLike, resolve_device

STATE_DIR = os.environ.get("REPRO_TORCH_BENCH_STATE",
                           "results/torch_bench_state")
SCALES = ("smoke", "std", "full")


def _scale(scale: Optional[str]) -> str:
    scale = scale or os.environ.get("REPRO_BENCH_SCALE", "std")
    if scale not in SCALES:
        raise ValueError(f"scale {scale!r} is not one of {SCALES}")
    return scale


def bench_config(scale: Optional[str] = None) -> MuxExperimentConfig:
    """``full`` is the paper's ``config()``; ``std`` (the default, or
    ``REPRO_BENCH_SCALE``) and ``smoke`` are the reference's cuts for a
    CPU core: enough steps for the zoo's accuracy ordering to emerge,
    small enough to finish in minutes."""
    scale = _scale(scale)
    if scale == "full":
        return full_config()
    if scale == "smoke":
        return dataclasses.replace(full_config(), train_samples=1024,
                                   eval_samples=512, batch_size=64,
                                   zoo_steps=60, mux_steps=60)
    return dataclasses.replace(full_config(), train_samples=3072,
                               eval_samples=2048, batch_size=96,
                               zoo_steps=200, mux_steps=150)


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_data(cfg, device: torch.device):
    """(train batches, eval batches): templates and training images from
    one generator seeded ``cfg.seed``, the eval images from another
    (``cfg.seed + 1``), on ``device``."""
    gen = generator(cfg.seed, device)
    templates = make_templates(gen, num_classes=cfg.num_classes,
                               image_size=cfg.image_size, device=device)
    train_b = image_dataset(gen, templates, num_samples=cfg.train_samples,
                            batch=cfg.batch_size)
    eval_b = image_dataset(generator(cfg.seed + 1, device), templates,
                           num_samples=cfg.eval_samples,
                           batch=cfg.batch_size)
    return train_b, eval_b


def _cached(path: Optional[str], like_fn, train_fn):
    """Restore ``path`` into ``like_fn()``'s tree, or train and save."""
    if path is not None and os.path.exists(path):
        return ckpt.restore(path, like_fn())
    state = train_fn()
    if path is not None:
        ckpt.save(path, state)
    return state


def get_state(*, contrastive: bool = True, scale: Optional[str] = None,
              device: DeviceLike = None,
              cache_dir: Optional[str] = STATE_DIR,
              verbose: bool = True,
              on_step: Optional[Callable[[str, int, Dict], None]] = None
              ) -> Dict[str, Any]:
    """{cfg, scale, device, zoo_state, mux_all, mux_pair, train_b, eval_b,
    train_s} at ``bench_config(scale)``.  Each trained piece is restored
    from ``cache_dir/<scale>/`` when there, else trained and saved
    (``cache_dir=None``: always trained, nothing saved).  The ablation
    (``contrastive=False``) trains its zoo only: Fig. 6 is the one
    reader of it.  ``on_step(stage, step, metrics)`` sees every training
    step, ``stage`` being ``zoo_cnt`` / ``zoo_nocnt``, ``mux_all`` or
    ``mux_pair``."""
    scale = _scale(scale)
    cfg = bench_config(scale)
    dev = resolve_device(device)
    tag = "cnt" if contrastive else "nocnt"
    train_b, eval_b = make_data(cfg, dev)
    base = 3 * (cfg.seed + (0 if contrastive else 1))

    def path(name):
        return (None if cache_dir is None
                else os.path.join(cache_dir, scale, f"{name}_{tag}.npz"))

    def hook(stage):
        return (None if on_step is None
                else lambda step, m: on_step(stage, step, m))

    t0 = time.time()
    zoo_state = _cached(
        path("zoo"),
        lambda: mux_train.init_zoo_state(generator(base, dev), cfg,
                                         device=dev),
        lambda: mux_train.train_zoo(generator(base, dev), cfg, train_b,
                                    contrastive=contrastive,
                                    verbose=verbose, device=dev,
                                    on_step=hook(f"zoo_{tag}")))
    state = {"cfg": cfg, "scale": scale, "device": dev,
             "zoo_state": zoo_state, "train_b": train_b, "eval_b": eval_b}
    if contrastive:
        pair = (cfg.mobile_model, cfg.cloud_model)
        for key, names, objective, seed in (
                ("mux_all", None, "ensemble", base + 1),
                ("mux_pair", pair, "offload", base + 2)):
            state[key] = _cached(
                path(key),
                lambda: mux_train.init_mux_state(generator(seed, dev), cfg,
                                                 names=names, device=dev),
                lambda: mux_train.train_mux(generator(seed, dev), cfg,
                                            zoo_state, train_b, names=names,
                                            objective=objective,
                                            verbose=verbose, device=dev,
                                            on_step=hook(key)))
    state["train_s"] = time.time() - t0
    return state


@torch.no_grad()
def eval_zoo(state) -> Dict[str, Any]:
    """Per-model accuracy, the correctness matrix and both muxes' weights
    over the eval set, as numpy arrays."""
    cfg = state["cfg"]
    names = list(cfg.zoo)
    rows: Dict[str, List[torch.Tensor]] = {k: [] for k in (
        "correct", "labels", "probs", "weights_all", "weights_pair",
        "hardness")}
    for b in state["eval_b"]:
        probs, _, logits = mux_train.zoo_apply(state["zoo_state"],
                                               b["image"], names)
        label = b["label"].long()
        rows["correct"].append(torch.stack(
            [torch.argmax(logits[n], dim=-1) == label for n in names]))
        rows["labels"].append(b["label"])
        rows["probs"].append(probs)
        rows["weights_all"].append(mux_forward(state["mux_all"],
                                               b["image"])[0])
        rows["weights_pair"].append(mux_forward(state["mux_pair"],
                                                b["image"])[0])
        rows["hardness"].append(b["hardness"])
    axis = {"correct": 1, "probs": 1}
    out = {k: torch.cat(v, dim=axis.get(k, 0)).cpu().numpy()
           for k, v in rows.items()}
    return {"names": names, **out}


def emit(name: str, us_per_call: float, derived: str) -> None:
    """The benchmarks' CSV contract: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}")
