"""Table II: cloud-API multiplexing over the six-model zoo.

Port of ``benchmarks/table2_cloud_api.py``.  Per-model FLOPs, accuracy
and called share; hybrid-single (argmax, Alg. 2) and hybrid-ensemble
(threshold, Alg. 2) rows; the compute-saving factor largest_model_flops
/ hybrid_flops (the paper claims 2.85x) and the accuracy against the
best single model (the paper claims +4.55pp).
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import ensemble as ens
from repro_torch.paper import common


def run(state=None):
    state = state or common.get_state()
    cfg = state["cfg"]
    t0 = time.time()
    ev = common.eval_zoo(state)
    names = ev["names"]
    costs = cfg.costs()
    carr = torch.tensor([costs[n] for n in names], dtype=torch.float32)

    probs = torch.from_numpy(ev["probs"])
    labels = torch.from_numpy(ev["labels"])
    m = ens.policy_metrics(torch.from_numpy(ev["weights_all"]), probs,
                           labels, carr, threshold=cfg.ensemble_threshold)
    o = {k: v.numpy() for k, v in
         ens.oracle_metrics(probs, labels, carr).items()}
    us = (time.time() - t0) * 1e6 / len(ev["labels"])

    print("\n# Table II — cloud API multiplexing")
    print("model,flops,accuracy_pct,called_pct")
    for i, n in enumerate(names):
        print(f"{n},{costs[n]:.3g},{float(ev['correct'][i].mean()) * 100:.2f},"
              f"{float(m['called'][i]) * 100:.2f}")
    best_acc = max(float(ev["correct"][i].mean()) for i in range(len(names)))
    largest = max(costs.values())
    acc_s, fl_s = float(m["acc_single"]), float(m["flops_single"])
    acc_e, fl_e = float(m["acc_ensemble"]), float(m["flops_ensemble"])
    print(f"hybrid-single,{fl_s:.3g},{acc_s * 100:.2f},100")
    print(f"hybrid-ensemble,{fl_e:.3g},{acc_e * 100:.2f},100")
    print(f"# oracle (cheapest-correct): "
          f"acc={float(o['acc_oracle']) * 100:.2f} "
          f"flops={float(o['flops_oracle']):.3g}")
    saving = largest / max(fl_s, 1.0)
    common.emit(
        "table2_cloud_api", us,
        f"saving_factor={saving:.2f}x acc_single={acc_s * 100:.2f}%"
        f" acc_ens={acc_e * 100:.2f}% best_single={best_acc * 100:.2f}%")
    return {"saving_factor": saving, "acc_single": acc_s,
            "acc_ensemble": acc_e, "best_single_acc": best_acc,
            "flops_single": fl_s, "called": m["called"].numpy(),
            "oracle": o}


if __name__ == "__main__":
    run()
