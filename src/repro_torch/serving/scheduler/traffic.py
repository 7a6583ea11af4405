"""Open-loop traffic generation: Poisson and bursty arrival processes.

A copy of ``repro.serving.scheduler.traffic``.

Serving systems are evaluated open-loop — arrivals do not wait for
completions, so queueing delay shows up honestly (closed-loop drivers
hide it; see the coordinated-omission literature).  ``arrival_times``
produces a deterministic arrival schedule; ``replay`` plays it against
a scheduler in real time (or scaled time) and returns the futures.

Patterns:
  * poisson — exponential inter-arrivals at ``rate`` req/s.
  * bursty  — two-state modulated Poisson (on/off): dwell times are
    exponential; the on/off rates keep a burst_factor**2 ratio but are
    jointly scaled so the long-run mean rate equals ``rate`` (with
    equal mean dwell, mean rate is the average of the two state
    rates), so bursty and Poisson runs at the same ``rate`` offer the
    same load and differ only in variance.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Callable, List, Sequence

import numpy as np


@dataclasses.dataclass
class TrafficConfig:
    rate: float                   # mean arrival rate, requests / second
    num_requests: int
    pattern: str = "poisson"      # "poisson" | "bursty"
    burst_factor: float = 4.0     # on-rate multiplier for bursty traffic
    burst_dwell_s: float = 0.05   # mean dwell in each on/off state
    seed: int = 0


def arrival_times(cfg: TrafficConfig) -> np.ndarray:
    """Deterministic (seeded) arrival offsets in seconds, shape (n,)."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.pattern == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate, size=cfg.num_requests)
        return np.cumsum(gaps)
    if cfg.pattern != "bursty":
        raise ValueError(f"unknown traffic pattern: {cfg.pattern!r}")
    times: List[float] = []
    t = 0.0
    on = True
    state_end = rng.exponential(cfg.burst_dwell_s)
    bf = cfg.burst_factor
    scale = 2.0 / (bf + 1.0 / bf)       # (r_on + r_off) / 2 == rate
    r_on, r_off = cfg.rate * bf * scale, cfg.rate / bf * scale
    while len(times) < cfg.num_requests:
        rate = r_on if on else r_off
        t_next = t + rng.exponential(1.0 / rate)
        if t_next >= state_end:
            t = state_end
            state_end = t + rng.exponential(cfg.burst_dwell_s)
            on = not on
            continue
        t = t_next
        times.append(t)
    return np.asarray(times)


async def replay(submit: Callable[[Any], Any],
                 samples: Sequence[Any], times: np.ndarray,
                 *, speed: float = 1.0) -> List["asyncio.Future"]:
    """Open-loop replay: submit samples at their scheduled offsets.

    ``submit`` must be non-blocking — either the handle surface
    (``PagedLLMScheduler.submit``, returning a GenerationHandle) or the
    future-returning compat shim (``submit_nowait``); ``speed`` > 1
    compresses the schedule (2.0 = twice as fast).  Returns the
    per-request futures in submission order.
    """
    t0 = time.monotonic()
    futures: List[asyncio.Future] = []
    for x, t_arr in zip(samples, times):
        delay = float(t_arr) / speed - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        res = submit(x)
        futures.append(res.future if hasattr(res, "future") else res)
    return futures
