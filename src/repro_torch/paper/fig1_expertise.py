"""Fig. 1: the cross-model expertise matrix.

Port of ``benchmarks/fig1_expertise.py``.  Entry (i, j) = % of eval
inputs model i predicts correctly that model j does NOT.  The paper's
headline cell: alexnet (worst) still solves 2.8% of what resnext101
(best) misses, the existence proof for beating the best model by
multiplexing.  Reported here for the zoo, with the smallest-solves-
what-the-largest-misses cell.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.paper import common


def run(state=None):
    state = state or common.get_state()
    t0 = time.time()
    ev = common.eval_zoo(state)
    names, correct = ev["names"], ev["correct"]
    n = len(names)
    matrix = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            matrix[i, j] = float((correct[i] & ~correct[j]).mean()) * 100
    us = (time.time() - t0) * 1e6 / max(correct.shape[1], 1)

    print("\n# Fig.1 — % solved by row-model that column-model misses")
    print("model," + ",".join(names))
    for i, nm in enumerate(names):
        print(nm + "," + ",".join(f"{matrix[i, j]:.2f}" for j in range(n)))
    small_vs_big = matrix[0, -1]
    common.emit("fig1_expertise", us,
                f"smallest_solves_what_largest_misses_pct={small_vs_big:.2f}")
    return {"matrix": matrix, "names": names,
            "small_vs_big_pct": small_vs_big}


if __name__ == "__main__":
    run()
