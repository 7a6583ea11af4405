"""Fig. 3 / Fig. 6, quantitatively.

Port of ``benchmarks/fig6_separation.py``.  Fig. 3 claims raw
embeddings of correct and incorrect predictions overlap; Fig. 6 that
the contrastive loss separates them into Venn-style expertise regions.
Without a t-SNE plot this reports the measurable version: the mean
cosine distance of push pairs against pull pairs, with and without the
contrastive loss (the ablation); the ratio is >> 1 only with the loss.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import contrastive as cnt
from repro_torch.core import mux_train
from repro_torch.paper import common


@torch.no_grad()
def _separation(state):
    names = list(state["cfg"].zoo)
    pull, push = [], []
    for b in state["eval_b"]:
        _, embeds, logits = mux_train.zoo_apply(state["zoo_state"],
                                                b["image"], names)
        projected = cnt.project(state["zoo_state"]["proj"], embeds)
        label = b["label"].long()
        correct = {n: torch.argmax(logits[n], dim=-1) == label
                   for n in names}
        s = cnt.separation_score(projected, correct)
        pull.append(float(s["pull_mean"]))
        push.append(float(s["push_mean"]))
    return float(np.mean(pull)), float(np.mean(push))


def run(state=None, ablation=None):
    """``ablation``: the zoo trained without the contrastive loss
    (``common.get_state(contrastive=False)`` at ``state``'s scale and
    device unless given)."""
    t0 = time.time()
    state = state or common.get_state()
    pull_c, push_c = _separation(state)
    ablation = ablation or common.get_state(
        contrastive=False, scale=state.get("scale"), device=state["device"])
    pull_a, push_a = _separation(ablation)
    us = (time.time() - t0) * 1e6

    print("\n# Fig.6 — embedding separation (push vs pull pair distance)")
    print("setup,pull_mean,push_mean,ratio")
    print(f"contrastive,{pull_c:.4f},{push_c:.4f},"
          f"{push_c / max(pull_c, 1e-6):.2f}")
    print(f"ablation_no_contrastive,{pull_a:.4f},{push_a:.4f},"
          f"{push_a / max(pull_a, 1e-6):.2f}")
    common.emit("fig6_separation", us,
                f"ratio_contrastive={push_c / max(pull_c, 1e-6):.2f}"
                f" ratio_ablation={push_a / max(pull_a, 1e-6):.2f}")
    return {"contrastive": (pull_c, push_c), "ablation": (pull_a, push_a)}


if __name__ == "__main__":
    run()
