"""Mobile⇄cloud collaborative inference cost model (§III.B, Eq. 9-13).

Port of ``repro.core.offload`` (numpy only, unchanged).

No Jetson board or radio is measured: latency & energy are derived from
the paper's own cost currency: FLOPs / device-throughput for compute,
bytes / link-rate for communication, power x time for energy — the same
analytical decomposition the paper uses to explain Table I.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class OffloadCosts:
    latency_s: float
    mobile_energy_j: float
    flops: float
    local_fraction: float
    accuracy: float


def _comm_seconds(cfg, payload_bytes: float) -> float:
    return payload_bytes * 8 / cfg.uplink_bps + 128 * 8 / cfg.downlink_bps


def mobile_only(cfg, *, mobile_flops: float, accuracy: float) -> OffloadCosts:
    """Eq. 9."""
    t = mobile_flops / cfg.mobile_flops_per_s
    return OffloadCosts(t, t * cfg.mobile_w, mobile_flops, 1.0, accuracy)


def cloud_only(cfg, *, cloud_flops: float, accuracy: float) -> OffloadCosts:
    """Eq. 10."""
    t_comm = _comm_seconds(cfg, cfg.upload_bytes)
    t_cloud = cloud_flops / cfg.cloud_flops_per_s
    energy = t_comm * (cfg.mobile_w + cfg.net_w)        # radio + idle board
    return OffloadCosts(t_comm + t_cloud, energy, cloud_flops, 0.0, accuracy)


def hybrid(cfg, *, mux_flops: float, mobile_flops: float, cloud_flops: float,
           local_fraction: float, accuracy: float) -> OffloadCosts:
    """Eq. 11-13: weighted average of the local and offloaded paths."""
    t_mux = mux_flops / cfg.mobile_flops_per_s
    # local path (Eq. 11)
    t_local = t_mux + mobile_flops / cfg.mobile_flops_per_s
    e_local = t_local * cfg.mobile_w
    # offload path (Eq. 12)
    t_comm = _comm_seconds(cfg, cfg.upload_bytes)
    t_cloud = t_mux + t_comm + cloud_flops / cfg.cloud_flops_per_s
    e_cloud = t_mux * cfg.mobile_w + t_comm * (cfg.mobile_w + cfg.net_w)
    # Eq. 13
    p = local_fraction
    latency = p * t_local + (1 - p) * t_cloud
    energy = p * e_local + (1 - p) * e_cloud
    flops = mux_flops + p * mobile_flops + (1 - p) * cloud_flops
    return OffloadCosts(latency, energy, flops, p, accuracy)


def table1(cfg, *, mobile_acc: float, cloud_acc: float, hybrid_acc: float,
           local_fraction: float, mobile_flops: float, cloud_flops: float,
           mux_flops: float) -> Dict[str, OffloadCosts]:
    """Assemble the three Table I rows."""
    return {
        "mobile-only": mobile_only(cfg, mobile_flops=mobile_flops,
                                   accuracy=mobile_acc),
        "cloud-only": cloud_only(cfg, cloud_flops=cloud_flops,
                                 accuracy=cloud_acc),
        "hybrid": hybrid(cfg, mux_flops=mux_flops, mobile_flops=mobile_flops,
                         cloud_flops=cloud_flops,
                         local_fraction=local_fraction, accuracy=hybrid_acc),
    }
