"""Periodic gauge sampling into the tracer's ring buffer.

A copy of ``repro.serving.observability.gauges``, trimmed to the
in-process paged backends the port has (no host-tier pools, no cluster
hosts).  ``sample_gauges(tracer, sched)`` takes one snapshot of the
serving stack's live state — pool pages in use / peak / shared / COW
headroom (``PagePool.stats()`` as surfaced by ``backend.stats()``),
logit-cache hit rate, prewarm residents, queue depth, and inflight
device calls / chunk tasks — and records it as Chrome counter events,
so Perfetto renders resource pressure on the same timeline as the
request spans.  The scheduler lifecycle runs it on a timer
(``Tracer.gauge_interval_s``) while the tracer is enabled; tests call
it directly for a deterministic single sample.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.serving.observability.tracer import Tracer

#: PagePool.stats() series worth a counter track (total pool size is
#: static, so plotting it would just flatten the axis)
POOL_SERIES = ("pages_in_use", "peak_pages_in_use", "shared_pages",
               "num_free", "cow_headroom")


def prewarm_residents(backend) -> Optional[int]:
    """Resident prewarmed-logit entries on a backend's engine; None
    when the backend has no engine surface."""
    engine = getattr(backend, "engine", None)
    if engine is None:
        return None
    prewarmed = getattr(engine, "_prewarmed", None)
    return len(prewarmed) if prewarmed is not None else None


def sample_gauges(tracer: Tracer, sched, t: Optional[float] = None) -> None:
    """Record one gauge sample for every backend of ``sched``."""
    if not tracer.enabled:
        return
    if t is None:
        t = tracer.clock()
    prefilling = getattr(sched, "_prefilling", None)   # paged path only
    slots = getattr(sched, "slots", None)
    for m, backend in enumerate(sched.backends):
        st = backend.stats()
        name = st.get("name", f"model{m}")
        pool = st.get("pool")
        if pool:
            tracer.counter(f"{name}:pool",
                           {k: pool[k] for k in POOL_SERIES if k in pool},
                           t=t)
        hits = st.get("logit_cache_hits")
        if hits is not None:
            misses = st.get("logit_cache_misses", 0)
            total = hits + misses
            tracer.counter(f"{name}:logit_cache",
                           {"hits": hits, "misses": misses,
                            "hit_rate": hits / total if total else 0.0}, t=t)
        load = {"queued": sched.queues[m].live_depth(),
                "inflight": backend.capacity().inflight}
        if prefilling is not None:
            load["prefilling"] = len(prefilling[m])
            load["inflight_chunks"] = getattr(sched, "_inflight_chunks", 0)
        if slots is not None:
            load["decoding"] = len(slots[m])
        tracer.counter(f"{name}:load", load, t=t)
        residents = prewarm_residents(backend)
        if residents is not None:
            tracer.counter(f"{name}:prewarm", {"residents": residents}, t=t)
