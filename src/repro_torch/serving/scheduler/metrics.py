"""Metrics registry for the serving runtime.

A copy of ``repro.serving.scheduler.metrics`` without what only the
disaggregated backend feeds (KV-transfer timings).

Counts every lifecycle transition and keeps latency reservoirs so a
snapshot can report the serving numbers that matter for the paper's
cloud story: throughput, p50/p99 queue + service + total latency,
time-to-first-token and inter-token latency, per-model utilization and
call fractions, micro-batch and decode-batch fill, and the Eq. 14 compute saving of
mux routing vs always calling the largest model.

The registry also keeps a per-model EMA of observed service time; the
admission controller's deadline-degrade hook (MDInference-style)
consults it — scaled by the queue depth the backends report — to
re-route requests whose remaining SLO budget the selected model cannot
meet, and its hard-shed path counts BUDGET_EXCEEDED drops here.
Backends feed per-backend executor queue waits through
``on_backend_queue_wait``.

The registry is also the tracing bridge (``bind_tracer``): every
terminal request flows through ``on_complete``/``on_fail``/
``on_cancel``, so this is where the per-request span timeline
(ADMIT/QUEUED/PREFILL/DECODE/FINISH, reconstructed from the request's
lifecycle timestamps — zero hot-path cost) and the degrade/shed
decision instants are emitted, where the flight recorder trips on
request failure or SLO violation, and where the tracer's instant
stream is consumed back into snapshot-visible counts.  Latency attribution decomposes each completed request into
queue / prefill / decode phases and keeps per-model TTFT and ITL
reservoirs alongside the global ones.
"""
from __future__ import annotations

import itertools
import random
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.observability.tracer import (NULL_TRACER,
                                                      request_track)
from repro_torch.serving.scheduler.request import Request


class LatencyReservoir:
    """Bounded uniform sample of latencies with percentile queries
    (seconds in, milliseconds out — serving dashboards speak ms).

    Vitter's Algorithm R: the first max_samples observations are kept
    verbatim; afterwards each new observation replaces a random slot
    with probability max_samples/n, so the reservoir stays a uniform
    sample of the whole stream and memory is O(max_samples) no matter
    how long the scheduler runs.  Seeded for reproducible snapshots.
    """

    def __init__(self, max_samples: int = 8192, seed: int = 0):
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._seen = 0
        self._rng = random.Random(seed)

    def add(self, seconds: float) -> None:
        self._seen += 1
        if len(self._samples) < self.max_samples:
            self._samples.append(seconds)
            return
        slot = self._rng.randrange(self._seen)
        if slot < self.max_samples:
            self._samples[slot] = seconds

    def __len__(self) -> int:
        return self._seen

    def percentile_ms(self, p: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), p) * 1e3)

    def mean_ms(self) -> float:
        if not self._samples:
            return 0.0
        return float(np.mean(self._samples) * 1e3)


class SchedulerMetrics:
    """One registry per scheduler; workers, admission and backends
    feed it."""

    SERVICE_EMA_ALPHA = 0.2     # per-model service-time estimate smoothing

    def __init__(self, costs: Sequence[float], clock=time.monotonic):
        self.clock = clock
        self.costs = [float(c) for c in costs]
        n = len(self.costs)
        self.arrived = 0
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.slo_violations = 0
        self.deadline_degraded = 0       # admission degrade-hook re-routes
        self.budget_exceeded = 0         # hard load sheds (BUDGET_EXCEEDED)
        self.batches = 0
        self.batched_requests = 0        # real rows across all buckets
        self.bucket_rows = 0             # capacity rows across all buckets
        self.per_model_completed = [0] * n
        self.per_model_busy_s = [0.0] * n
        self.flops_total = 0.0
        # every reservoir gets a distinct seed: identical latency
        # streams into same-seeded reservoirs would evict correlated
        # slots and skew cross-reservoir percentile comparisons
        self._seeds = itertools.count(1)
        self.queue_lat = self._reservoir()
        self.service_lat = self._reservoir()
        self.total_lat = self._reservoir()
        self.ttft_lat = self._reservoir()        # arrival -> first token
        self.itl_lat = self._reservoir()         # inter-token gaps
        # queue wait of requests that never completed (failed /
        # cancelled after admission) — kept OUT of queue_lat so a
        # shed-heavy run cannot report rosy queue percentiles, but
        # visible in its own snapshot keys
        self.rejected_queue_lat = self._reservoir()
        # latency attribution: end-to-end decomposed per request
        self.phase_lat = {name: self._reservoir()
                          for name in ("queue", "prefill", "decode")}
        self.ttft_by_model = [self._reservoir() for _ in range(n)]
        self.itl_by_model = [self._reservoir() for _ in range(n)]
        # time a device call waited on its backend's executor queue
        # before running (backends feed it through bind_metrics)
        self.backend_queue_wait = [self._reservoir() for _ in range(n)]
        # measured prefill-chunk stall per PAGE (seconds/page, one
        # reservoir per model): what one chunk page actually costs the
        # running decode streams.  The adaptive chunk-size policy sizes
        # chunks against this distribution once it has evidence,
        # instead of guessing a stall from the inter-token latency
        self.chunk_stall_page = [self._reservoir() for _ in range(n)]
        self._service_ema: List[Optional[float]] = [None] * n
        self.tracer = NULL_TRACER
        self.trace_instants: Dict[str, int] = {}
        self.started_t: Optional[float] = None
        self.stopped_t: Optional[float] = None
        self._elapsed_accum = 0.0       # serving time of finished runs

    def _reservoir(self) -> LatencyReservoir:
        return LatencyReservoir(seed=next(self._seeds))

    # ---- tracing bridge -----------------------------------------------
    def bind_tracer(self, tracer) -> None:
        """Attach the scheduler's tracer.  The registry both *feeds*
        it (request span timelines, flight-recorder trips) and *consumes* its instant stream into
        ``trace_instants`` for the snapshot."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.tracer.add_consumer(self._consume_event)

    def _consume_event(self, ev) -> None:
        # runs on whatever thread recorded the event: keep it to one
        # dict update, and never trace from here
        if ev[1] == "i":
            name = ev[2]
            self.trace_instants[name] = self.trace_instants.get(name, 0) + 1

    def _phase_breakdown(self, req: Request):
        """(queue, prefill, decode) seconds for a terminal request,
        from its lifecycle timestamps."""
        queue = (max(req.started_t - req.admitted_t, 0.0)
                 if req.admitted_t > 0 and req.started_t > 0 else 0.0)
        prefill = decode = 0.0
        if req.started_t > 0 and req.first_token_t > 0:
            prefill = max(req.first_token_t - req.started_t, 0.0)
            decode = max(req.finished_t - req.first_token_t, 0.0)
        return queue, prefill, decode

    def _trace_request(self, req: Request) -> None:
        """Emit the request's span timeline onto its own track.  The
        chain is reconstructed from timestamps the schedulers already
        record, so tracing adds nothing to the hot path; a request
        that failed before reaching a phase simply has a shorter
        chain."""
        tracer = self.tracer
        if not tracer.enabled:
            return
        track = request_track(req.rid)
        args = {"model": req.model_id}
        if req.admitted_t > 0:
            tracer.instant("ADMIT", track=track, args=args, t=req.admitted_t)
            if req.started_t > 0:
                tracer.span("QUEUED", track, req.admitted_t, req.started_t,
                            args)
        if req.started_t > 0 and req.first_token_t > 0:
            tracer.span("PREFILL", track, req.started_t, req.first_token_t,
                        args)
            tracer.span("DECODE", track, req.first_token_t, req.finished_t,
                        args)
        tracer.instant("FINISH", track=track, t=req.finished_t,
                       args={"model": req.model_id,
                             "reason": req.finish_reason,
                             "state": req.state.value})

    def _note_rejected(self, req: Request) -> None:
        """A failed/cancelled request's queue wait is measured here,
        not in queue_lat, whose percentiles describe served traffic.
        Requests failed before admission (admitted_t == 0) never
        queued, so they only count."""
        if req.admitted_t <= 0:
            return
        end = req.started_t if req.started_t > 0 else req.finished_t
        if end >= req.admitted_t:
            self.rejected_queue_lat.add(end - req.admitted_t)

    # ---- lifecycle ----------------------------------------------------
    # counters are cumulative across restarts, so elapsed must be too —
    # otherwise a restarted scheduler divides all-runs counts by only
    # the latest run's wall time and every rate inflates
    def on_start(self, t: float) -> None:
        self.started_t = t
        self.stopped_t = None

    def on_stop(self, t: float) -> None:
        self.stopped_t = t
        if self.started_t is not None:
            self._elapsed_accum += t - self.started_t

    # ---- feed ---------------------------------------------------------
    def on_arrival(self, req: Request) -> None:
        self.arrived += 1

    def on_admit(self, req: Request) -> None:
        self.admitted += 1

    def on_batch(self, model_id: int, batch_size: int, capacity: int) -> None:
        self.batches += 1
        self.batched_requests += batch_size
        self.bucket_rows += capacity

    def on_model_busy(self, model_id: int, seconds: float) -> None:
        self.per_model_busy_s[model_id] += seconds

    def on_complete(self, req: Request) -> None:
        self.completed += 1
        self.per_model_completed[req.model_id] += 1
        self.flops_total += req.flops
        self.queue_lat.add(req.queue_latency)
        self.service_lat.add(req.service_latency)
        self.total_lat.add(req.total_latency)
        ttft = req.ttft
        if ttft is not None:
            self.ttft_lat.add(ttft)
            if 0 <= req.model_id < len(self.ttft_by_model):
                self.ttft_by_model[req.model_id].add(ttft)
        queue, prefill, decode = self._phase_breakdown(req)
        self.phase_lat["queue"].add(queue)
        self.phase_lat["prefill"].add(prefill)
        self.phase_lat["decode"].add(decode)
        prev = self._service_ema[req.model_id]
        obs = req.service_latency
        self._service_ema[req.model_id] = (
            obs if prev is None
            else self.SERVICE_EMA_ALPHA * obs
            + (1.0 - self.SERVICE_EMA_ALPHA) * prev)
        if req.missed_deadline():
            self.slo_violations += 1
            self.tracer.trip("slo_violation")
        self._trace_request(req)

    def on_fail(self, req: Request) -> None:
        self.failed += 1
        self._note_rejected(req)
        self._trace_request(req)
        self.tracer.trip("request_failed")

    def on_cancel(self, req: Request) -> None:
        self.cancelled += 1
        self._note_rejected(req)
        self._trace_request(req)

    def on_degrade(self, req: Request, from_model: int, to_model: int) -> None:
        self.deadline_degraded += 1
        self.tracer.instant("degrade", args={"rid": req.rid,
                                             "from": from_model,
                                             "to": to_model})

    def on_shed(self, req: Request) -> None:
        """One hard load shed (BUDGET_EXCEEDED); the accompanying
        on_fail keeps the arrived == completed+failed+cancelled books
        closed — this counter is the policy-level why."""
        self.budget_exceeded += 1
        self.tracer.instant("shed", args={"rid": req.rid})

    def on_decode_gap(self, model_id: int, seconds: float) -> None:
        """One inter-token gap from the continuous-decode loop."""
        self.itl_lat.add(seconds)
        if 0 <= model_id < len(self.itl_by_model):
            self.itl_by_model[model_id].add(seconds)

    def on_backend_queue_wait(self, model_id: int, seconds: float) -> None:
        """Time one device call spent queued on its backend's executor
        before running (fed by ModelBackend.bind_metrics)."""
        self.backend_queue_wait[model_id].add(seconds)

    def on_chunk_stall(self, model_id: int, pages: int,
                       seconds: float) -> None:
        """One measured prefill-chunk execution: ``pages`` pages took
        ``seconds`` on the model's executor.  Recorded per page so
        chunks of different sizes feed one comparable distribution."""
        if pages > 0 and 0 <= model_id < len(self.chunk_stall_page):
            self.chunk_stall_page[model_id].add(seconds / pages)

    def chunk_stall_per_page(self, model_id: int,
                             percentile: float = 90.0) -> Optional[float]:
        """Measured seconds one chunk page stalls this model's decode
        streams (a high percentile — sizing against the tail is what
        protects SLOs); None until enough chunks ran to trust it."""
        r = self.chunk_stall_page[model_id]
        if len(r) < 5:
            return None
        return r.percentile_ms(percentile) / 1e3

    def service_estimate(self, model_id: int) -> Optional[float]:
        """EMA of observed service time for one model (seconds); None
        until that model has completed at least one request."""
        return self._service_ema[model_id]

    # ---- report -------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Valid mid-run too: before stop(), elapsed runs to now (or
        the registry clock), so live dashboards see real rates."""
        elapsed = self._elapsed_accum
        if self.started_t is not None and self.stopped_t is None:
            end = now if now is not None else self.clock()
            elapsed += end - self.started_t
        cost_max = max(self.costs) if self.costs else 0.0
        mean_flops = (self.flops_total / self.completed
                      if self.completed else 0.0)
        return {
            "arrived": self.arrived,
            "admitted": self.admitted,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "slo_violations": self.slo_violations,
            "deadline_degraded": self.deadline_degraded,
            "budget_exceeded": self.budget_exceeded,
            "elapsed_s": elapsed,
            "throughput_rps": self.completed / elapsed if elapsed else 0.0,
            "queue_p50_ms": self.queue_lat.percentile_ms(50),
            "queue_p99_ms": self.queue_lat.percentile_ms(99),
            "service_p50_ms": self.service_lat.percentile_ms(50),
            "service_p99_ms": self.service_lat.percentile_ms(99),
            "total_p50_ms": self.total_lat.percentile_ms(50),
            "total_p99_ms": self.total_lat.percentile_ms(99),
            "ttft_p50_ms": self.ttft_lat.percentile_ms(50),
            "ttft_p99_ms": self.ttft_lat.percentile_ms(99),
            "itl_p50_ms": self.itl_lat.percentile_ms(50),
            "itl_p99_ms": self.itl_lat.percentile_ms(99),
            "batches": self.batches,
            "mean_batch_fill": (self.batched_requests / self.bucket_rows
                                if self.bucket_rows else 0.0),
            "called_fraction": [c / self.completed if self.completed else 0.0
                                for c in self.per_model_completed],
            "utilization": [b / elapsed if elapsed else 0.0
                            for b in self.per_model_busy_s],
            "mean_flops": mean_flops,
            # Eq. 14: compute saved by mux routing vs always-largest
            "flops_saved_frac": (1.0 - mean_flops / cost_max
                                 if cost_max and self.completed else 0.0),
            "flops_saving_factor": (cost_max / mean_flops
                                    if mean_flops else 0.0),
            "backend_queue_p50_ms": [r.percentile_ms(50)
                                     for r in self.backend_queue_wait],
            "backend_queue_p99_ms": [r.percentile_ms(99)
                                     for r in self.backend_queue_wait],
            "chunk_stall_page_p90_ms": [r.percentile_ms(90)
                                        for r in self.chunk_stall_page],
            # rejected traffic's queue wait (failed/cancelled after
            # admission) — deliberately not mixed into queue_*_ms
            "rejected_count": len(self.rejected_queue_lat),
            "rejected_queue_p50_ms": self.rejected_queue_lat.percentile_ms(50),
            "rejected_queue_p99_ms": self.rejected_queue_lat.percentile_ms(99),
            # latency attribution: where a completed request's time went
            "phase_queue_p50_ms": self.phase_lat["queue"].percentile_ms(50),
            "phase_queue_p99_ms": self.phase_lat["queue"].percentile_ms(99),
            "phase_prefill_p50_ms":
                self.phase_lat["prefill"].percentile_ms(50),
            "phase_prefill_p99_ms":
                self.phase_lat["prefill"].percentile_ms(99),
            "phase_decode_p50_ms": self.phase_lat["decode"].percentile_ms(50),
            "phase_decode_p99_ms": self.phase_lat["decode"].percentile_ms(99),
            "ttft_p50_ms_by_model": [r.percentile_ms(50)
                                     for r in self.ttft_by_model],
            "ttft_p99_ms_by_model": [r.percentile_ms(99)
                                     for r in self.ttft_by_model],
            "itl_p50_ms_by_model": [r.percentile_ms(50)
                                    for r in self.itl_by_model],
            "itl_p99_ms_by_model": [r.percentile_ms(99)
                                    for r in self.itl_by_model],
            "trace_instants": dict(self.trace_instants),
            "trace": (self.tracer.stats() if self.tracer.enabled else None),
        }
