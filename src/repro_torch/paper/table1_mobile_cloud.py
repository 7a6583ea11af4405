"""Table I: mobile-only / cloud-only / hybrid rows.

Port of ``benchmarks/table1_mobile_cloud.py``.  ``zoo_xs`` plays
mobilenet_v2 (mobile), ``zoo_m`` resnext101_32x8d (cloud), and the pair
mux the offloading multiplexer.  Latency and energy come from the
paper's own cost decomposition (Eq. 9-13) with Jetson-TX2 / GTX1080Ti /
Ookla constants, driven by the measured accuracy, local fraction and
FLOPs.  Also reports the paper's true-negative-rate framing (the
detection rate of locally solvable inputs).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import offload
from repro_torch.models.cnn import mux_flops
from repro_torch.paper import common


def run(state=None):
    state = state or common.get_state()
    cfg = state["cfg"]
    t0 = time.time()
    ev = common.eval_zoo(state)
    names = ev["names"]
    mi, ci = names.index(cfg.mobile_model), names.index(cfg.cloud_model)
    costs = cfg.costs()

    acc_mobile = float(ev["correct"][mi].mean())
    acc_cloud = float(ev["correct"][ci].mean())

    # pair-mux decision: weights_pair[:, 0] is the mobile model
    local = ev["weights_pair"][:, 0] >= cfg.offload_threshold
    pred_correct = np.where(local, ev["correct"][mi], ev["correct"][ci])
    acc_hybrid = float(pred_correct.mean())
    local_frac = float(local.mean())

    # of the inputs the mobile model solves, how many stay local?
    tnr = float((local & ev["correct"][mi]).sum()
                / max(ev["correct"][mi].sum(), 1))

    rows = offload.table1(
        cfg, mobile_acc=acc_mobile, cloud_acc=acc_cloud,
        hybrid_acc=acc_hybrid, local_fraction=local_frac,
        mobile_flops=costs[cfg.mobile_model],
        cloud_flops=costs[cfg.cloud_model],
        mux_flops=mux_flops(image_size=cfg.image_size,
                            meta_dim=cfg.meta_dim))
    us = (time.time() - t0) * 1e6 / len(local)

    print("\n# Table I — mobile/cloud collaborative inference")
    print("setup,flops,latency_ms,mobile_energy_mJ,local_pct,accuracy_pct")
    for name, r in rows.items():
        print(f"{name},{r.flops:.3g},{r.latency_s * 1e3:.3f},"
              f"{r.mobile_energy_j * 1e3:.2f},{r.local_fraction * 100:.0f},"
              f"{r.accuracy * 100:.2f}")
    print(f"# mux TNR (local-solvable detection rate): {tnr:.3f}")

    gain = (acc_hybrid - acc_mobile) * 100
    common.emit("table1_mobile_cloud", us,
                f"hybrid_acc={acc_hybrid * 100:.2f}%"
                f" mobile_gain={gain:.2f}pp local={local_frac * 100:.0f}%"
                f" tnr={tnr:.3f}")
    return {"rows": rows, "acc_hybrid": acc_hybrid, "acc_mobile": acc_mobile,
            "acc_cloud": acc_cloud, "local_fraction": local_frac, "tnr": tnr}


if __name__ == "__main__":
    run()
