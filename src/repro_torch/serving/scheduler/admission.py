"""Mux-scored admission: the probe runs once per arrival tick.

A copy of ``repro.serving.scheduler.admission``.  The paper's
multiplexer is the admission controller: the lightweight probe
(``MuxServer.probe_weights``: the image backbone and K2's meta form on
the card) scores the request against the whole zoo, the selection
policy (argmax, or thresholded hybrid when ``MuxServerConfig.threshold``
is set) picks a model, and the request joins that model's queue with
its Eq. 14 cost already metered.

Admission accepts a *list* of requests so a bursty arrival tick can be
scored in one probe call; the common case is a singleton.  Probes run
at ONE fixed batch shape: arrivals are chunked and padded to
``probe_batch`` rows (``routing.pad_bucket_host``), and selection runs
on the padded weights before slicing, so the probe and select graphs
captured at warmup are replayed for every burst size and never
captured anew on the event loop.

Capacity comes from the backends: the per-model service-time estimate
is the metrics registry's EMA scaled by the work already ahead of the
request — queued requests (in whole buckets, from
``backend.capacity().decode_batch``) plus device calls in flight on
the backend's executors — so a deep queue degrades sooner than an
idle one with the same EMA.

With ``deadline_degrade=True`` (off by default), admission checks the
selected model's estimate against the request's remaining SLO budget
and, when the selection cannot meet the deadline, re-routes to the
cheapest model whose estimate still fits — or the cheapest model
outright when none fits (the MDInference policy).
``shed_on_overload=True`` adds hard load shedding on top: when even
the degraded choice cannot meet the budget, the request fails fast
with :class:`BudgetExceeded` (status ``BUDGET_EXCEEDED``) instead of
queueing a certain SLO miss behind everyone else.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import routing
from repro_torch.serving.backend import to_host
from repro_torch.serving.scheduler.batcher import ModelQueue
from repro_torch.serving.scheduler.metrics import SchedulerMetrics
from repro_torch.serving.scheduler.request import BUDGET_EXCEEDED, Request


class BudgetExceeded(RuntimeError):
    """Hard load shed: no model — selected or degraded — can meet the
    request's remaining SLO budget, so admission fails it fast rather
    than queueing a certain miss.  ``status`` rides on the exception
    and ``finish_reason`` on the request/FINISHED event."""

    status = BUDGET_EXCEEDED.upper()


class AdmissionController:
    """Scores arrivals with the mux probe and enqueues per model."""

    def __init__(self, server, queues: Sequence[ModelQueue],
                 metrics: SchedulerMetrics,
                 clock: Callable[[], float], probe_batch: int = 1,
                 deadline_degrade: bool = False,
                 backends: Optional[Sequence] = None,
                 shed_on_overload: bool = False):
        self.server = server
        self.queues = list(queues)
        self.metrics = metrics
        self.clock = clock
        self.probe_batch = probe_batch
        self.deadline_degrade = deadline_degrade
        self.backends = list(backends) if backends is not None else None
        self.shed_on_overload = shed_on_overload
        # hoisted once: a per-request device->host transfer on the
        # event loop is exactly what this module exists to avoid
        self._costs_host = to_host(server.costs)
        # serving signature (shape, dtype), seeded by warmup or the
        # first successful admission; the static-shape buckets serve
        # exactly one signature, so a mismatched request must fail at
        # admission — not poison the micro-batch it lands in
        self._signature = None

    def score(self, xs: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """Probe + select at the fixed probe shape.

        Returns (weights (k, N), assign (k,)).  This is THE admission
        scoring path — reference checks must go through it
        (``MuxScheduler.reference_assignment``), since a row's result
        is only reproducible at the padded probe batch.
        """
        sigs = [(np.asarray(x).shape, np.asarray(x).dtype) for x in xs]
        if self._signature is not None:
            for sig in sigs:
                if sig != self._signature:
                    raise ValueError(
                        f"request signature {sig} does not match the "
                        f"serving signature {self._signature}")
        ws: List[np.ndarray] = []
        assigns: List[np.ndarray] = []
        for i in range(0, len(xs), self.probe_batch):
            chunk = list(xs[i:i + self.probe_batch])
            bucket, _ = routing.pad_bucket_host(chunk, self.probe_batch)
            w = self.server.probe_weights(bucket)        # (C, N) on device
            assign = to_host(self.server.select(w))      # fixed (C, N) too
            ws.append(to_host(w)[:len(chunk)])
            assigns.append(assign[:len(chunk)])
        if self._signature is None:      # only commit after success
            self._signature = sigs[0]
        return np.concatenate(ws), np.concatenate(assigns)

    def service_estimate(self, model_id: int) -> Optional[float]:
        """Queue-depth-aware service-time estimate for one model:
        the per-model EMA scaled by (1 + batches of work ahead), where
        the work ahead is the model's live queue in whole buckets plus
        device calls in flight on its backend.  None until the model
        has completed at least one request — the policy only degrades
        on evidence, never speculatively."""
        ema = self.metrics.service_estimate(model_id)
        if ema is None:
            return None
        ahead = 0.0
        if self.backends is not None:
            cap = self.backends[model_id].capacity()
            rows = max(1, cap.decode_batch)
            ahead = (-(-self.queues[model_id].live_depth() // rows)
                     + cap.inflight)
        return ema * (1.0 + ahead)

    def degrade_for_deadline(self, req: Request, model_id: int,
                             now: float) -> int:
        """MDInference-style deadline degrade: if the selected model's
        estimated service time exceeds the request's remaining SLO
        budget, re-route to the cheapest model whose estimate fits the
        budget (the cheapest model outright when none does)."""
        est = self.service_estimate(model_id)
        budget = req.deadline_t - now
        if est is None or est <= budget:
            return model_id
        fits = [m for m in range(len(self._costs_host))
                if (self.service_estimate(m) or 0.0) <= budget]
        pool = fits if fits else list(range(len(self._costs_host)))
        new_m = min(pool, key=lambda m: self._costs_host[m])
        if new_m != model_id:
            self.metrics.on_degrade(req, model_id, new_m)
        return new_m

    def _shed(self, req: Request, model_id: int, now: float) -> bool:
        """Hard load shedding: fail the request fast when even the
        (possibly degraded) selection cannot meet its budget.  Returns
        True when the request was shed — it never reaches a queue; its
        future already carries BudgetExceeded."""
        if not self.shed_on_overload:
            return False
        est = self.service_estimate(model_id)
        budget = req.deadline_t - now
        if est is None or est <= budget:
            return False
        exc = BudgetExceeded(
            f"request {req.rid} cannot meet its SLO: remaining budget "
            f"{budget * 1e3:.1f}ms < estimated service "
            f"{est * 1e3:.1f}ms on model {model_id} (the cheapest "
            f"admissible choice); shedding instead of queueing a "
            f"certain miss")
        if req.fail(exc, now, reason=BUDGET_EXCEEDED):
            self.metrics.on_shed(req)
            self.metrics.on_fail(req)
        return True

    def admit(self, requests: List[Request]) -> None:
        """Score + enqueue.  Synchronous: the probe is the paper's
        "very light-weight" CNN — cheap by design.  A request shed by
        the overload policy is failed here (its future resolves with
        BudgetExceeded) and never enqueued; the rest of its batch
        admits normally."""
        if not requests:
            return
        w, assign = self.score([r.x for r in requests])
        costs = self._costs_host
        now = self.clock()
        for i, req in enumerate(requests):
            req.weights = w[i]
            m = int(assign[i])
            if self.deadline_degrade:
                m = self.degrade_for_deadline(req, m, now)
                if self._shed(req, m, now):
                    continue
            req.model_id = m
            req.flops = float(costs[req.model_id])
            self.queues[req.model_id].push(req, now)
            self.metrics.on_admit(req)
