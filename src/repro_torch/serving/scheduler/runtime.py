"""MuxScheduler / PagedLLMScheduler — the async continuous-batching
runtimes.

A copy of ``repro.serving.scheduler.runtime`` without the worker's
background-chunk path, which only a backend with ``concurrent_prefill``
(the disaggregated one, not ported yet) takes.  MuxScheduler serves
one-shot model steps (the paper's CNN zoo) at request granularity.
PagedLLMScheduler is the token-level loop for the LLM path: per-engine
workers interleave chunked prefill (new requests run their prompt
through the device one chunk at a time, joining the running decode
batch when the first token samples) with single-token decode steps over
every running request, and free a request's pages the step it
finishes.

Both runtimes share one submission surface:

    handle = sched.submit(x, SamplingParams(...))       # GenerationHandle
    out = await handle.result()                         # one-shot
    async for ev in handle: ...                         # stream=True
    handle.cancel()                                     # abort any phase

Execution is delegated to ``repro_torch.serving.backend.ModelBackend``s,
one per model: a worker awaits ``backend.step`` /
``backend.prefill_chunk`` / ``backend.decode_batch`` and asks the
backend about admission capacity; it never touches an ``Engine`` or a
``MuxServer`` directly.

Determinism contract of the mux path: every bucket has the same static
shape (max_batch_size), so each model step replays one CUDA graph on
the card, and a request's output is bitwise equal to
``reference_output``, the same model step applied to that request alone
in a padded bucket.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.serving.backend import (InProcessBackend,
                                         InProcessMuxBackend, ModelBackend,
                                         to_host)
from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.observability import (NULL_TRACER, backend_track,
                                               prewarm_residents,
                                               request_track, sample_gauges)
from repro_torch.serving.scheduler.admission import AdmissionController
from repro_torch.serving.scheduler.batcher import (BatchingPolicy,
                                                   DecodeSlots, MicroBatcher,
                                                   ModelQueue)
from repro_torch.serving.scheduler.metrics import SchedulerMetrics
from repro_torch.serving.scheduler.request import (GenerationHandle,
                                                   Request, RequestState,
                                                   SamplingParams)


def _resolve_params(params: Optional[SamplingParams],
                    **overrides) -> SamplingParams:
    """Fold keyword-argument overrides into a SamplingParams (None
    overrides are 'keep the params value')."""
    if params is None:
        params = SamplingParams()
    updates = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(params, **updates) if updates else params


class SchedulerLifecycle:
    """Start/stop/drain + inflight-future bookkeeping shared by the
    request-level (MuxScheduler) and token-level (PagedLLMScheduler)
    runtimes.

    A subclass calls ``_init_lifecycle`` from its constructor (after
    setting ``self.metrics`` and ``self.backends``), implements
    ``_worker(m)`` as its serving loop, and may override
    ``_reclaim_stranded`` to hand back resources a no-drain stop
    leaves behind.  Everything else — worker task management, backend
    executor lifetime, graceful vs cancelled shutdown, request
    cancellation, and the inflight-future set that ``drain`` waits on
    — lives here once.
    """

    def _init_lifecycle(self, n_workers: int, clock,
                        backends: Sequence[ModelBackend] = (),
                        tracer=None) -> None:
        self.clock = clock
        self._n_workers = n_workers
        self._lc_backends = list(backends)
        # the tracer fans out to every layer: metrics emits the
        # per-request span timelines (and consumes instants back),
        # backends emit executor spans, and their
        # engines/pools emit COW/reclaim/alloc instants
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics.bind_tracer(self.tracer)
        for m, b in enumerate(self._lc_backends):
            b.bind_metrics(self.metrics, m)
            b.bind_tracer(self.tracer)
        self._gauge_task: Optional[asyncio.Task] = None
        self._events = [asyncio.Event() for _ in range(n_workers)]
        self._workers: List[asyncio.Task] = []
        self._running = False
        self._stopping = False
        self._next_rid = 0
        self._inflight: Dict[asyncio.Future, Request] = {}

    async def _worker(self, m: int) -> None:
        raise NotImplementedError

    # ---- lifecycle ----------------------------------------------------
    async def start(self) -> None:
        if self._running:
            raise RuntimeError("scheduler already started")
        self._running = True
        self._stopping = False
        for b in self._lc_backends:
            await b.start()
        self.metrics.on_start(self.clock())
        self._workers = [asyncio.ensure_future(self._worker(m))
                         for m in range(self._n_workers)]
        if self.tracer.enabled and self.tracer.gauge_interval_s > 0:
            self._gauge_task = asyncio.ensure_future(self._gauge_loop())

    async def _gauge_loop(self) -> None:
        """Periodic gauge sampling into the tracer ring while the
        scheduler runs (see observability.gauges)."""
        while True:
            sample_gauges(self.tracer, self)
            await asyncio.sleep(self.tracer.gauge_interval_s)

    async def stop(self, drain: bool = True) -> None:
        """Graceful shutdown: stop accepting, flush/finish every queued
        request, join the workers.  With drain=False, workers are
        cancelled, still-pending requests are *failed* with them (so a
        streaming consumer receives its FINISHED event rather than
        hanging on an abandoned queue), and ``_reclaim_stranded`` hands
        back whatever they held."""
        if not self._running:
            return
        self._stopping = True
        for ev in self._events:
            ev.set()
        if not drain:
            for w in self._workers:
                w.cancel()
        # return_exceptions so one dead worker can't wedge shutdown in a
        # half-stopped state; re-raise after cleanup completes
        results = await asyncio.gather(*self._workers,
                                       return_exceptions=True)
        t = self.clock()
        stopped = RuntimeError("scheduler stopped before completion")
        for fut, req in list(self._inflight.items()):
            if fut.done():
                continue
            # fail through the request so the FINISHED event reaches
            # streaming consumers; metrics count each stranding once
            if req.fail(stopped, t):
                self.metrics.on_fail(req)
            if not fut.done():          # belt: a future fail() couldn't
                fut.cancel()            # resolve must still unblock
        self._workers = []
        if self._gauge_task is not None:
            self._gauge_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._gauge_task
            self._gauge_task = None
            # one final sample so sub-interval runs still trace gauges
            sample_gauges(self.tracer, self)
        self.metrics.on_stop(self.clock())
        # backends drain their executors before the pools are touched:
        # a zombie device call must never race the reclamation below
        # (workers have joined, so nothing new can be submitted)
        for b in self._lc_backends:
            await b.stop()
        self._reclaim_stranded(self.clock())
        self._running = False
        for res in results:
            if isinstance(res, Exception):
                raise res

    def _reclaim_stranded(self, t: float) -> None:
        """Hook: reclaim resources (pages, queued requests) a no-drain
        stop stranded.  Runs after the backends have drained, so no
        zombie model step can race the reclamation.  Default: nothing
        to reclaim."""

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=not any(exc))

    async def drain(self) -> None:
        """Wait until every submitted request has completed."""
        while self._inflight:
            await asyncio.wait(list(self._inflight))

    # ---- submission bookkeeping ---------------------------------------
    def _check_accepting(self) -> None:
        if not self._running or self._stopping:
            raise RuntimeError("scheduler is not running (start() it, or "
                               "it is stopping): request rejected")

    def _next_request_id(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def _register_inflight(self, req: Request) -> None:
        self._inflight[req.future] = req
        req.future.add_done_callback(
            lambda fut: self._inflight.pop(fut, None))

    # ---- cancellation -------------------------------------------------
    def _cancel_request(self, req: Request) -> bool:
        """GenerationHandle.cancel() lands here.  The request's future
        resolves immediately (idempotently: a completion that already
        won is left alone); the owning worker notices the terminal
        state at its next sweep and releases any pages or slots it
        still holds for the request."""
        was_queued = req.state is RequestState.QUEUED
        if not req.cancel(self.clock()):
            return False
        self.metrics.on_cancel(req)
        if 0 <= req.model_id < len(self._events):
            if was_queued:
                # keep the O(1) live-depth counter honest: this entry
                # stays in the heap until a drain sweeps it, but it is
                # no longer work ahead of anyone
                self.queues[req.model_id].discount_live()
            self._events[req.model_id].set()   # wake the worker to reap
        return True


@dataclasses.dataclass
class SchedulerConfig:
    max_batch_size: int = 8        # bucket capacity per model step
    max_wait_ms: float = 5.0       # flush a partial batch after this
    default_slo_ms: float = 100.0  # deadline when submit passes none
    probe_batch_size: int = 1      # admission probe shape: arrivals are
    #   padded/chunked to this so the probe is captured exactly once
    #   regardless of burst size.  1 is right for open-loop singleton
    #   submits (a bigger shape taxes every submit — the probe costs
    #   grow with batch); raise it when traffic arrives in ticks fed
    #   through submit_many
    deadline_degrade: bool = False  # MDInference-style admission hook:
    #   re-route a request to the cheapest admissible model when the
    #   selected model's estimated service time cannot meet the
    #   request's remaining SLO budget
    shed_on_overload: bool = False  # hard load shedding: when even the
    #   degraded selection cannot meet the request's SLO budget, fail
    #   it fast with BUDGET_EXCEEDED instead of queueing a certain miss
    #   (only meaningful with deadline_degrade=True)

    def policy(self) -> BatchingPolicy:
        return BatchingPolicy(max_batch_size=self.max_batch_size,
                              max_wait_ms=self.max_wait_ms)


class MuxScheduler(SchedulerLifecycle):
    """Request-level serving runtime over a MuxServer-compatible server.

    The server must expose ``probe_weights(x)``, ``select(w)``,
    ``model_step(m, bucket)``, ``costs`` and ``num_models`` — MuxServer
    does; tests may duck-type it.  Execution goes through one
    ``ModelBackend`` per zoo model (default: ``InProcessMuxBackend``
    over ``server.model_step``); pass ``backends=`` to dispatch models
    elsewhere.
    """

    def __init__(self, server, cfg: Optional[SchedulerConfig] = None,
                 clock=time.monotonic, *,
                 backends: Optional[Sequence[ModelBackend]] = None,
                 tracer=None):
        # clock parameterizes timestamps/deadlines for testability, but
        # worker waits still run on the event loop's real time — it
        # must advance with wall clock (a frozen fake clock would keep
        # max-wait flushes from ever firing)
        self.server = server
        self.cfg = cfg or SchedulerConfig()
        n = server.num_models
        if backends is None:
            backends = [InProcessMuxBackend(
                server, m, bucket_capacity=self.cfg.max_batch_size)
                for m in range(n)]
        if len(backends) != n:
            raise ValueError(f"{len(backends)} backends for {n} models")
        self.backends = list(backends)
        self.queues = [ModelQueue(m) for m in range(n)]
        self.metrics = SchedulerMetrics(to_host(server.costs).tolist(),
                                        clock=clock)
        self.batcher = MicroBatcher(self.cfg.policy())
        self.admission = AdmissionController(
            server, self.queues, self.metrics, clock,
            probe_batch=self.cfg.probe_batch_size,
            deadline_degrade=self.cfg.deadline_degrade,
            backends=self.backends,
            shed_on_overload=self.cfg.shed_on_overload)
        self._init_lifecycle(n, clock, self.backends, tracer=tracer)

    def warmup(self, sample_x) -> None:
        """Capture the probe and select graphs at the probe shape and
        every model step's at the bucket shape before traffic arrives
        (one sample, no batch dim): the counterpart of the reference's
        compiles.  Serving latency percentiles are meaningless if the
        first requests pay a capture."""
        self.admission.score([np.asarray(sample_x)])
        bucket = self._bucket(sample_x)
        for m in range(self.server.num_models):
            to_host(self.server.model_step(m, bucket))

    def _bucket(self, x):
        """One request (no batch dim) in a padded bucket, through the
        device-side ``routing.pad_bucket`` (on the CPU) — the scatter
        math whose host rendering the micro-batch former uses."""
        bucket, _ = routing.pad_bucket(
            torch.as_tensor(np.asarray(x))[None], self.cfg.max_batch_size)
        return bucket

    # ---- submission ---------------------------------------------------
    def submit(self, x, params: Optional[SamplingParams] = None, *,
               slo_ms: Optional[float] = None,
               priority: Optional[int] = None,
               stream: Optional[bool] = None) -> GenerationHandle:
        """Admit one request; returns its GenerationHandle."""
        return self.submit_many([x], params, slo_ms=slo_ms,
                                priority=priority, stream=stream)[0]

    def submit_many(self, xs, params: Optional[SamplingParams] = None, *,
                    slo_ms: Optional[float] = None,
                    priority: Optional[int] = None,
                    stream: Optional[bool] = None) -> List[GenerationHandle]:
        """Admit a batch of arrivals in one call.  Scoring is chunked
        to cfg.probe_batch_size (default 1), so to actually amortize
        the probe over a bursty arrival tick, raise probe_batch_size
        toward the tick size — ceil(k / probe_batch_size) device
        dispatches run inline on the event loop either way."""
        self._check_accepting()
        params = _resolve_params(params, slo_ms=slo_ms, priority=priority,
                                 stream=stream)
        now = self.clock()
        slo = (params.slo_ms if params.slo_ms is not None
               else self.cfg.default_slo_ms)
        loop = asyncio.get_running_loop()
        reqs = []
        for x in xs:
            req = Request(rid=self._next_request_id(), x=x, arrival_t=now,
                          deadline_t=now + slo / 1e3, params=params,
                          future=loop.create_future())
            self.metrics.on_arrival(req)
            reqs.append(req)
        try:
            self.admission.admit(reqs)
        except Exception as exc:
            # deliver through the futures (same contract as a worker
            # failure) so accounting stays closed: arrived == completed
            # + failed + cancelled, and no future is left unresolved
            t = self.clock()
            for req in reqs:
                if req.fail(exc, t):
                    self.metrics.on_fail(req)
            return [GenerationHandle(req, self) for req in reqs]
        for req in reqs:
            self._register_inflight(req)
            if not req.is_terminal:     # load-shed requests never queued
                self._events[req.model_id].set()
        return [GenerationHandle(req, self) for req in reqs]

    # ---- workers ------------------------------------------------------
    async def _worker(self, m: int) -> None:
        queue, event = self.queues[m], self._events[m]
        backend = self.backends[m]
        capacity = self.cfg.max_batch_size
        while True:
            now = self.clock()
            flush = self._stopping and len(queue) > 0
            if flush or self.batcher.ready(queue, now):
                batch = self.batcher.form(queue, now)
                if not batch:          # the drain hit only cancelled
                    continue           # leftovers: nothing to run
                self.metrics.on_batch(m, len(batch), capacity)
                for req in batch:
                    req.state = RequestState.RUNNING
                    req.started_t = now
                t0 = self.clock()
                try:
                    # form_bucket inside the try: a malformed request
                    # (e.g. mismatched shape) must fail its batch, not
                    # kill this worker and strand the model's queue
                    bucket, _valid = self.batcher.form_bucket(batch)
                    out = await backend.step(bucket)
                except Exception as exc:   # deliver, don't kill the loop
                    t1 = self.clock()
                    for req in batch:
                        if req.fail(exc, t1):
                            self.metrics.on_fail(req)
                    continue
                t1 = self.clock()
                self.metrics.on_model_busy(m, t1 - t0)
                # bucket row i is batch[i]: pad_bucket preserves order
                for i, req in enumerate(batch):
                    # one-shot path: the whole output IS the first
                    # token for TTFT purposes
                    req.first_token_t = t1
                    if req.complete(out[i], t1):
                        self.metrics.on_complete(req)
                continue
            if self._stopping:
                return
            timeout = self.batcher.time_until_ready(queue, now)
            try:
                await asyncio.wait_for(event.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            event.clear()

    # ---- determinism reference ----------------------------------------
    def reference_assignment(self, x) -> int:
        """The model id admission selects for a lone request — computed
        through the exact admission scoring path (padded probe shape),
        the only shape at which row results are stable."""
        _w, assign = self.admission.score([np.asarray(x)])
        return int(assign[0])

    def reference_output(self, x, model_id: int) -> np.ndarray:
        """The model called directly on one request, at the scheduler's
        bucket shape — the bitwise reference for scheduler outputs."""
        return to_host(self.server.model_step(model_id, self._bucket(x)))[0]

    # ---- report -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Metrics snapshot plus per-backend stats — the same
        dashboard surface the paged scheduler exposes."""
        snap = self.metrics.snapshot()
        snap["backends"] = [b.stats() for b in self.backends]
        return snap


# ===========================================================================
# Token-level continuous decode over paged engines (the LLM path)
# ===========================================================================

@dataclasses.dataclass
class PagedLLMConfig:
    max_new_tokens: int = 32        # generation budget when submit passes none
    default_slo_ms: float = 5000.0  # deadline when submit passes none
    idle_poll_s: float = 0.05       # fallback wake-up while queues are empty
    prefill_chunk_pages: int = 0    # >0: chunked prefill — the prompt runs
    #   in chunks of this many pages, one chunk interleaved per decode
    #   step, so a long prompt never head-of-line-blocks running
    #   streams; admission budgets first-chunk pages, later chunks
    #   allocate as they run.  0 = serial whole-prompt prefill.
    adaptive_chunk: bool = False    # SLO-aware chunk sizing: pick each
    #   chunk's page count per call — shrink toward min_chunk_pages when
    #   the tightest running stream's remaining deadline budget cannot
    #   absorb a base-sized prefill stall, grow toward max_chunk_pages
    #   when nothing is decoding (an idle backend should swallow prompts
    #   in the biggest compiled bites).  Needs prefill_chunk_pages > 0;
    #   the chosen size is exposed as the "chunk_pages" tracer counter.
    min_chunk_pages: int = 1        # adaptive floor
    max_chunk_pages: int = 0        # adaptive ceiling; 0 = 4x base
    chunk_slack: float = 4.0        # shrink when min stream slack <
    #   chunk_slack x (base-chunk stall estimate); grow needs the same
    #   margin over a max-sized stall
    auto_chunk_bounds: bool = False  # tune the adaptive lo/hi bounds from
    #   the MEASURED chunk-stall distribution instead of the fixed
    #   min/max above: a heavy-tailed stall tail (p90 >> p50) narrows
    #   the policy to small bites, a tight one widens it to the
    #   ceiling.  Warmup compiles the whole bound ladder, so the tuned
    #   bounds never hit the compiler mid-serve.
    lazy_decode_alloc: Optional[bool] = None  # push down to the paged
    #   engines at construction: True seals prefills with prompt-only
    #   pages and grows decode page by page (admission stops reserving
    #   the whole prompt + budget span up front); None leaves each
    #   engine as built


@dataclasses.dataclass
class _Prefilling:
    """One request mid-chunked-prefill: not yet in a decode slot, but
    holding pages (everything its backend sequence lists)."""
    req: Request
    seq: Any            # backend sequence handle (PagedSequence or mirror)
    chunks: int = 0     # chunks already run (PREFILL_CHUNK[i] span index)


class PagedLLMScheduler(SchedulerLifecycle):
    """Token-level continuous-batching runtime over per-model backends.

    Construct it from paged ``Engine``s (each is wrapped in an
    ``InProcessBackend``) or pass ``backends=`` directly.  ``select_fn``
    maps a prompt to a model id (e.g. the mux probe,
    ``MuxServer.probe``); without it requests go to the least-loaded
    backend.  One worker per backend runs the two-phase continuous
    loop:

      admit   pop queue-ordered requests while a decode slot exists
              AND the backend reports the first prefill chunk
              admissible (unique pages + copy-on-write headroom);
              ``backend.begin`` (host-side) starts the sequence and
              the request enters the prefilling roster
      chunk   run ONE page-sized prefill chunk for the earliest-
              deadline prefilling request on the backend; when the
              chunk is final the first token samples (FIRST_TOKEN,
              TTFT stops) and the request joins the *running* decode
              batch at its own position, mid-generation of the others
      step    one ``backend.decode_batch`` over every running request
              (rows at different lengths; that is the paged contract),
              emitting one TOKEN event per row
      retire  a finished request releases its pages immediately (pages
              still shared with other residents survive; exclusive
              ones are reusable by the very next admission) and
              resolves its future with prompt + generated tokens

    With ``prefill_chunk_pages=0`` the chunk phase runs the whole
    remaining prompt in one call — the serial baseline.

    Page exhaustion at admission is backpressure, not failure: the
    request stays queued until running requests retire — except
    requests that could never fit the pool, which fail fast.  A chunk
    that cannot allocate mid-prefill waits for decode frees; if
    nothing is decoding, the latest-deadline prefilling request is
    evicted (pages released, requeued) so the earliest can proceed —
    chunked admission can never deadlock the pool.

    Cancellation (``handle.cancel()``) resolves the future instantly;
    this worker releases the request's pages at its next sweep —
    queued, mid-prefill or mid-decode alike, the pool
    returns to its pre-admission unique-page count.
    """

    def __init__(self, engines: Optional[Sequence] = None,
                 cfg: Optional[PagedLLMConfig] = None,
                 *, backends: Optional[Sequence[ModelBackend]] = None,
                 select_fn: Optional[Callable[[Any], int]] = None,
                 costs: Optional[Sequence[float]] = None,
                 clock=time.monotonic, tracer=None):
        if backends is None:
            if not engines:
                raise ValueError("pass paged engines or backends")
            backends = [InProcessBackend(e) for e in engines]
        self.backends = list(backends)
        self.engines = (list(engines) if engines is not None
                        else [getattr(b, "engine", None) for b in backends])
        self.cfg = cfg or PagedLLMConfig()
        self.select_fn = select_fn
        n = len(self.backends)
        self.queues = [ModelQueue(m) for m in range(n)]
        self.slots = [DecodeSlots(b.capacity().decode_batch)
                      for b in self.backends]
        self.metrics = SchedulerMetrics(
            list(costs) if costs is not None else [1.0] * n, clock=clock)
        # token-level counters (the benchmark's acceptance evidence)
        self.decode_batches = 0
        self.mixed_admission_batches = 0   # batches mixing admit times
        self.tokens_generated = 0
        self.prefill_chunks = 0            # chunk-phase device calls
        self.interleaved_chunks = 0        # chunks run while decoding
        self.prefill_evictions = 0         # chunk-starvation evictions
        self._prefilling: List[List[_Prefilling]] = [[] for _ in range(n)]
        self._inflight_chunks = 0          # chunk tasks currently in flight
        self._dead = [False] * n    # backend died (see _worker)
        if self.cfg.lazy_decode_alloc is not None:
            for b in self.backends:
                b.set_lazy_decode_alloc(self.cfg.lazy_decode_alloc)
        self._init_lifecycle(n, clock, self.backends, tracer=tracer)

    def _chunk_tokens(self, backend: ModelBackend) -> Optional[int]:
        if self.cfg.prefill_chunk_pages <= 0:
            return None
        return self.cfg.prefill_chunk_pages * backend.capacity().page_size

    def _adaptive_chunk_pages(self, m: int) -> int:
        """SLO-aware size for the NEXT prefill chunk, in pages.

        A chunk of P pages stalls every running decode stream while it
        holds the model's executor, so the budget question is whether
        the tightest running stream — smallest remaining deadline
        budget minus its estimated remaining decode time — can absorb
        that stall.  Once enough chunks have run, the stall estimate is
        the MEASURED per-page chunk duration distribution (its p90 —
        sizing against the tail is what protects SLOs), and the policy
        picks the largest compiled size (min/base/max, the shapes
        warmup compiled) whose predicted stall still fits the slack
        with the ``chunk_slack`` safety margin.  Before that evidence
        exists it bootstraps from the old heuristic — one page costs
        about one decode step.  Idle backends (nothing decoding) take
        the ceiling; streams without inter-token evidence keep base.
        """
        cfg = self.cfg
        base = cfg.prefill_chunk_pages
        lo, hi = self._chunk_bounds(m)
        active = self.slots[m].active()
        if not active:
            return hi                   # no stream to stall
        itl_ms = self.metrics.itl_by_model[m].percentile_ms(50)
        if itl_ms <= 0:
            itl_ms = self.metrics.itl_lat.percentile_ms(50)
        if itl_ms <= 0:
            return base                 # no decode-gap evidence yet
        itl_s = itl_ms / 1e3
        now = self.clock()
        slack = min(
            (e.req.deadline_t - now)
            - (e.req.max_new_tokens - len(e.seq.tokens)) * itl_s
            for e in active)
        per_page = self.metrics.chunk_stall_per_page(m)
        if per_page is not None and per_page > 0:
            # measured policy: largest compiled size whose tail stall
            # the tightest stream can absorb (with the safety margin)
            for pages in sorted({lo, base, hi}, reverse=True):
                if cfg.chunk_slack * pages * per_page <= slack:
                    return pages
            return lo
        if slack < cfg.chunk_slack * base * itl_s:
            return lo
        if slack > cfg.chunk_slack * hi * itl_s:
            return hi
        return base

    def _chunk_bounds(self, m: int) -> Tuple[int, int]:
        """(lo, hi) page bounds the adaptive chunk policy picks inside.

        Fixed config bounds normally; with ``auto_chunk_bounds`` the
        MEASURED per-page chunk-stall distribution re-tunes them: a
        heavy tail (p90 > 2x p50 — chunk cost is unpredictable, so a
        big bite risks a tail-sized stall the slack math never priced
        in) narrows to (1, base); a tight distribution (p90 within 25%
        of p50 — the estimate is trustworthy) widens to (base, ceiling)
        so an idle-leaning backend takes the biggest compiled bites.
        In between, or before ``chunk_stall_per_page`` has evidence
        (>= 5 chunks), the config bounds stand.  Every bound returned
        here is on the warmup-compiled ladder {1, min, base, max} —
        auto-tuning must never introduce a mid-serve compile."""
        cfg = self.cfg
        base = cfg.prefill_chunk_pages
        lo = max(1, cfg.min_chunk_pages)
        hi = max(base, cfg.max_chunk_pages or 4 * base)
        if not cfg.auto_chunk_bounds:
            return lo, hi
        p50 = self.metrics.chunk_stall_per_page(m, percentile=50.0)
        p90 = self.metrics.chunk_stall_per_page(m, percentile=90.0)
        if not p50 or not p90 or p50 <= 0:
            return lo, hi
        ratio = p90 / p50
        if ratio > 2.0:
            return 1, base
        if ratio <= 1.25:
            return base, hi
        return lo, hi

    def _next_chunk_tokens(self, m: int) -> Optional[int]:
        """Token budget for the next prefill chunk: the static
        prefill_chunk_pages, or the SLO-aware adaptive size (exposed
        as the "chunk_pages" tracer counter, one series per model)."""
        backend = self.backends[m]
        if self.cfg.prefill_chunk_pages <= 0:
            return None
        if not self.cfg.adaptive_chunk:
            return self._chunk_tokens(backend)
        pages = self._adaptive_chunk_pages(m)
        if self.tracer.enabled:
            self.tracer.counter("chunk_pages", {f"m{m}": pages})
        return pages * backend.capacity().page_size

    def _reclaim_stranded(self, t: float) -> None:
        # cancel-path cleanup: sequences stranded in slots or the
        # prefilling roster by a no-drain stop must hand their pages
        # back (safe only now — the backends are drained, so no zombie
        # device call can write into reclaimed pages).  A drained stop
        # leaves both empty.
        stopped = RuntimeError("scheduler stopped before completion")
        for m, slots in enumerate(self.slots):
            backend = self.backends[m]
            for ent in self._prefilling[m]:
                backend.release(ent.seq)
                if ent.req.fail(stopped, t):
                    self.metrics.on_fail(ent.req)
            self._prefilling[m].clear()
            for e in slots.active():
                backend.release(e.seq)
                slots.retire(e)
                if e.req.fail(stopped, t):
                    self.metrics.on_fail(e.req)
            # a no-drain stop also strands never-admitted requests in
            # the queues: fail them through the normal path so request
            # state and the failed counter stay consistent
            while len(self.queues[m]):
                req = self.queues[m].pop()
                if req.fail(stopped, t):
                    self.metrics.on_fail(req)

    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Warm every backend's serving shapes (prefill at each padded
        prompt length, the decode step, chunk shapes, sharing /
        copy-on-write paths) before traffic arrives.  Control-plane:
        runs before start().  Adaptive chunk sizing also warms its
        floor/ceiling chunk shapes."""
        for backend in self.backends:
            base = self._chunk_tokens(backend)
            backend.warmup(prompt_lens, chunk_tokens=base)
            if base is not None and self.cfg.adaptive_chunk:
                ps = backend.capacity().page_size
                hi = max(self.cfg.prefill_chunk_pages,
                         self.cfg.max_chunk_pages
                         or 4 * self.cfg.prefill_chunk_pages)
                ladder = {max(1, self.cfg.min_chunk_pages), hi}
                if self.cfg.auto_chunk_bounds:
                    # the measured-bounds policy may narrow the floor to
                    # a single page (_chunk_bounds): compile it too, so
                    # the tuned ladder never hits the compiler mid-serve
                    ladder.add(1)
                for pages in sorted(ladder):
                    if pages * ps != base:
                        backend.warmup([], chunk_tokens=pages * ps)

    # ---- submission ---------------------------------------------------
    def _select(self, x) -> int:
        live = [m for m in range(len(self.backends)) if not self._dead[m]]
        if not live:
            raise RuntimeError("all backends are dead (device execution "
                               "failed); rebuild the scheduler")
        if self.select_fn is not None:
            m = int(self.select_fn(x))
            if self._dead[m]:
                raise RuntimeError(f"backend {m} is dead (decode failed)")
            return m
        # least-loaded: fewest requests queued + prefilling + running
        loads = [len(self.queues[m]) + len(self._prefilling[m])
                 + len(self.slots[m]) for m in live]
        return live[int(np.argmin(loads))]

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               max_new_tokens: Optional[int] = None,
               slo_ms: Optional[float] = None,
               seed: Optional[int] = None,
               temperature: Optional[float] = None,
               stop_tokens: Optional[Sequence[int]] = None,
               priority: Optional[int] = None,
               stream: Optional[bool] = None) -> GenerationHandle:
        """Admit one generation request; the handle's ``result()``
        resolves to the full token array (prompt + generated), its
        event stream yields per-token progress when ``stream=True``.
        ``seed`` keys the request's sampling chain when temperature > 0
        (None = engine default, i.e. identical prompts sample
        identically)."""
        self._check_accepting()
        if params is None and max_new_tokens is None:
            max_new_tokens = self.cfg.max_new_tokens   # scheduler default
        params = _resolve_params(
            params, max_new_tokens=max_new_tokens, slo_ms=slo_ms, seed=seed,
            temperature=temperature,
            stop_tokens=tuple(stop_tokens) if stop_tokens is not None
            else None,
            priority=priority, stream=stream)
        now = self.clock()
        slo = (params.slo_ms if params.slo_ms is not None
               else self.cfg.default_slo_ms)
        loop = asyncio.get_running_loop()
        req = Request(rid=self._next_request_id(),
                      x=np.asarray(prompt, np.int32),
                      arrival_t=now, deadline_t=now + slo / 1e3,
                      params=params, future=loop.create_future())
        self.metrics.on_arrival(req)
        m = self._select(req.x)
        req.model_id = m
        self.queues[m].push(req, now)
        self.metrics.on_admit(req)
        self._register_inflight(req)
        self._events[m].set()
        return GenerationHandle(req, self)

    def submit_nowait(self, prompt, *, max_new_tokens: Optional[int] = None,
                      slo_ms: Optional[float] = None,
                      seed: Optional[int] = None) -> asyncio.Future:
        """One-shot compatibility shim: the handle's raw future."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           slo_ms=slo_ms, seed=seed).future

    # ---- the two-phase continuous loop --------------------------------
    def _fits_ever(self, backend: ModelBackend, req: Request) -> bool:
        return backend.fits_ever(len(req.x), req.max_new_tokens)

    async def _worker(self, m: int) -> None:
        backend = self.backends[m]
        queue, slots, event = self.queues[m], self.slots[m], self._events[m]
        prefilling = self._prefilling[m]
        chunk_tokens = self._chunk_tokens(backend)
        while True:
            progressed = False

            # ---- admit: begin prefill (host-side) ---------------
            while (len(queue)
                   and len(slots) + len(prefilling) < slots.capacity):
                nxt = queue.peek()
                if nxt.is_terminal:         # cancelled while queued:
                    queue.pop()             # future already resolved
                    progressed = True
                    continue
                if not self._fits_ever(backend, nxt):
                    req = queue.pop()
                    cap = backend.capacity()
                    if req.fail(OutOfPages(
                            f"request needs more pages than the whole "
                            f"pool ({len(req.x)} + {req.max_new_tokens} "
                            f"tokens > {cap.num_pages * cap.page_size} "
                            f"poolable)"), self.clock()):
                        self.metrics.on_fail(req)
                    progressed = True
                    continue
                if not backend.admissible(nxt.x, nxt.max_new_tokens,
                                          chunk_tokens=chunk_tokens):
                    break                   # backpressure: await frees
                req = queue.pop()
                req.state = RequestState.PREFILLING
                req.started_t = self.clock()   # per request, not sweep
                try:
                    # host-side validation only: the shared-prefix
                    # mapping and logit-cache fast path run lazily
                    # in the first prefill chunk (see _run_chunk)
                    seq = backend.begin(
                        req.x, max_new_tokens=req.max_new_tokens,
                        seed=req.seed,
                        temperature=req.params.temperature,
                        stop_tokens=req.params.stop_tokens)
                except Exception as exc:
                    if req.fail(exc, self.clock()):
                        self.metrics.on_fail(req)
                    continue                # request-local: keep going
                progressed = True
                req.on_prefill_progress(seq.prefill_pos, self.clock())
                prefilling.append(_Prefilling(req, seq))

            # ---- chunk: one prefill chunk, earliest deadline ----
            if prefilling:
                ent = min(prefilling,
                          key=lambda e: (e.req.deadline_t, e.req.rid))
                if ent.req.is_terminal:     # cancelled mid-prefill
                    prefilling.remove(ent)
                    backend.release(ent.seq)
                    progressed = True
                else:
                    ran = await self._run_chunk(
                        m, ent, self._next_chunk_tokens(m))
                    if ran is None:         # backend died
                        return
                    progressed = progressed or ran

            # ---- step: one token for every running request ------
            # reap cancelled entries first so their pages free
            # before the batch forms (admission sees them this
            # sweep)
            for e in slots.active():
                if e.req.is_terminal:
                    backend.release(e.seq)
                    slots.retire(e)
                    progressed = True
            active = slots.active()
            if active:
                t0 = self.clock()
                # token counts BEFORE the step: every token a decode
                # call appends to a row must emit a TOKEN event
                before = [len(e.seq.tokens) for e in active]
                try:
                    await backend.decode_batch([e.seq for e in active])
                except Exception as exc:
                    victim_seq = (getattr(exc, "cow_seq", None)
                                  or getattr(exc, "grow_seq", None))
                    if (isinstance(exc, OutOfPages)
                            and victim_seq is not None
                            and backend.healthy):
                        # copy-on-write found no free page (the
                        # admission headroom raced), or a lazily
                        # allocated sequence could not grow its next
                        # decode page.  Both checks run before any
                        # device work, so the engine survives: fail
                        # only the starving sequence.
                        for e in active:
                            if e.seq is victim_seq:
                                backend.release(e.seq)
                                slots.retire(e)
                                if e.req.fail(exc, self.clock()):
                                    self.metrics.on_fail(e.req)
                                break
                        continue
                    # a failed step may leave the pool partly
                    # written (the engine marks its caches
                    # poisoned), so the backend cannot serve again
                    # — fail everything it holds and retire the
                    # worker
                    self._kill_backend(m, exc)
                    return
                t1 = self.clock()
                # count only after the step ran: the COW-failure
                # retry path above must not double-count a batch
                # that never executed
                if len({e.admit_step for e in active}) > 1:
                    self.mixed_admission_batches += 1
                self.decode_batches += 1
                self.metrics.on_batch(m, len(active), slots.capacity)
                self.metrics.on_model_busy(m, t1 - t0)
                self.tokens_generated += sum(
                    len(e.seq.tokens) - n0
                    for e, n0 in zip(active, before))
                if self.tracer.enabled:
                    self.tracer.span(
                        "DECODE_STEP", backend_track(backend.name,
                                                     "decode"),
                        t0, t1,
                        {"model": m, "batch": len(active),
                         "pages": sum(len(getattr(e.seq, "pages", ()))
                                      for e in active)})
                for e, n0 in zip(active, before):
                    new = e.seq.tokens[n0:]
                    if not e.req.is_terminal:
                        for j, tok in enumerate(new):
                            e.req.on_token(
                                int(tok),
                                e.seq.pos - len(new) + 1 + j, t1)
                    if e.last_token_t:
                        self.metrics.on_decode_gap(m,
                                                   t1 - e.last_token_t)
                    e.last_token_t = t1
                    if e.seq.done:
                        self._retire(m, e, t1)
                continue

            if progressed:
                continue
            if self._stopping and not len(queue) and not prefilling:
                return
            try:
                await asyncio.wait_for(event.wait(),
                                       self.cfg.idle_poll_s)
            except asyncio.TimeoutError:
                pass
            event.clear()

    async def _run_chunk(self, m: int, ent: _Prefilling,
                         chunk_tokens: Optional[int]) -> Optional[bool]:
        """One backend round of ``prefill_chunk`` for ``ent``.
        Returns True on progress, False on backpressure, None when the
        backend died (the worker must exit)."""
        self._inflight_chunks += 1      # gauge: chunk tasks in flight
        try:
            return await self._chunk_once(m, ent, chunk_tokens)
        finally:
            self._inflight_chunks -= 1

    async def _chunk_once(self, m: int, ent: _Prefilling,
                          chunk_tokens: Optional[int]) -> Optional[bool]:
        backend = self.backends[m]
        prefilling, slots = self._prefilling[m], self.slots[m]
        tracer = self.tracer
        t0 = self.clock()
        pos0 = ent.seq.prefill_pos
        chunk_fut = asyncio.ensure_future(
            backend.prefill_chunk(ent.seq, chunk_tokens=chunk_tokens))
        try:
            done = await asyncio.shield(chunk_fut)
        except asyncio.CancelledError:
            # no-drain stop cancelled us mid-chunk; the executor call
            # cannot be interrupted — wait it out and hand the pages
            # straight back before dying
            try:
                await chunk_fut
            except Exception:
                pass
            prefilling.remove(ent)
            backend.release(ent.seq)
            if ent.req.fail(RuntimeError("scheduler stopped before "
                                         "completion"), self.clock()):
                self.metrics.on_fail(ent.req)
            raise
        except OutOfPages as exc:
            if not backend.healthy:
                prefilling.remove(ent)
                backend.release(ent.seq)
                if ent.req.fail(exc, self.clock()):
                    self.metrics.on_fail(ent.req)
                self._kill_backend(m, exc)
                return None
            if ent.seq.prefill_pos == ent.seq.shared_prefix_len:
                # nothing computed yet: plain requeue (the admission
                # estimate raced a retire), exactly the serial path.
                # A request cancelled during the chunk await must NOT
                # be re-pushed — ModelQueue.push would overwrite its
                # CANCELLED state and resurrect it.
                prefilling.remove(ent)
                backend.release(ent.seq)
                if not ent.req.is_terminal:
                    self.queues[m].push(ent.req, self.clock())
                    tracer.instant("oop_requeue",
                                   args={"rid": ent.req.rid, "model": m})
                return False
            if not slots.active():
                # mid-prefill starvation with nothing decoding: evict
                # the latest-deadline prefilling request (release its
                # pages, requeue it) so the earliest can proceed —
                # otherwise partially-prefilled holders could deadlock
                # the pool among themselves
                victim = max((e for e in prefilling if e is not ent),
                             key=lambda e: (e.req.deadline_t, e.req.rid),
                             default=ent)
                prefilling.remove(victim)
                backend.release(victim.seq)
                if not victim.req.is_terminal:   # see requeue note above
                    self.queues[m].push(victim.req, self.clock())
                    self.prefill_evictions += 1
                    tracer.instant("prefill_eviction",
                                   args={"victim": victim.req.rid,
                                         "for": ent.req.rid, "model": m})
                return True
            return False        # decode frees are coming: retry next sweep
        except Exception as exc:
            prefilling.remove(ent)
            backend.release(ent.seq)
            if ent.req.fail(exc, self.clock()):
                self.metrics.on_fail(ent.req)
            if not backend.healthy:
                # the prefill failed on the device: the engine's
                # caches are poisoned, same terminal state as a
                # decode failure
                self._kill_backend(m, exc)
                return None
            return True         # request-local: keep serving
        self.prefill_chunks += 1
        if slots.active():
            self.interleaved_chunks += 1
        t = self.clock()
        # feed the measured stall distribution the adaptive chunk
        # policy sizes against (per page, so it transfers across sizes)
        ps = max(1, backend.capacity().page_size)
        pages_run = max(1, -(-(ent.seq.prefill_pos - pos0) // ps))
        self.metrics.on_chunk_stall(m, pages_run, t - t0)
        if tracer.enabled:
            tracer.span(f"PREFILL_CHUNK[{ent.chunks}]",
                        request_track(ent.req.rid), t0, t,
                        {"model": m, "backend": backend.name,
                         "prefill_pos": ent.seq.prefill_pos,
                         "pages": len(getattr(ent.seq, "pages", ()))})
        ent.chunks += 1
        ent.req.on_prefill_progress(ent.seq.prefill_pos, t)
        if done:
            prefilling.remove(ent)
            self._join(m, ent.req, ent.seq, self._step_of(m))
        return True

    def _step_of(self, m: int) -> int:
        # admit_step only feeds the mixed-batch evidence counter; the
        # decode-batch count is a faithful monotone stand-in
        return self.decode_batches

    def _join(self, m: int, req: Request, seq, step_idx: int) -> None:
        """Prefill finished: FIRST_TOKEN lands (TTFT stops) and the
        request joins the running decode batch."""
        t = self.clock()
        if req.is_terminal:
            # cancelled while its final chunk was on the executor: the
            # future is already resolved; joining would resurrect it
            # (state write below) and decode a dead request to the end
            self.backends[m].release(seq)
            return
        req.state = RequestState.RUNNING
        req.on_first_token(int(seq.tokens[0]), seq.prompt_len, t)
        entry = self.slots[m].join(req, seq, admit_step=step_idx)
        entry.last_token_t = t
        if seq.done:                # max_new_tokens == 1 / instant stop
            self._retire(m, entry, t)

    def _kill_backend(self, m: int, exc: BaseException) -> None:
        """Terminal backend failure (caches poisoned): free
        every page it holds, fail its running, prefilling and queued
        requests, and take it out of the selection rotation."""
        self._dead[m] = True
        backend, slots, queue = self.backends[m], self.slots[m], self.queues[m]
        t = self.clock()
        for ent in self._prefilling[m]:
            backend.release(ent.seq)
            if ent.req.fail(exc, t):
                self.metrics.on_fail(ent.req)
        self._prefilling[m].clear()
        for e in slots.active():
            backend.release(e.seq)
            slots.retire(e)
            if e.req.fail(exc, t):
                self.metrics.on_fail(e.req)
        while len(queue):
            req = queue.pop()
            if req.fail(RuntimeError(f"backend {m} died (caches lost): "
                                     f"{exc}"), self.clock()):
                self.metrics.on_fail(req)

    def _retire(self, m: int, entry, t: float) -> None:
        """Finished: release the pages *now* (exclusive pages are
        reusable by the next admission; shared ones live on with the
        sequences still mapping them) and resolve the future."""
        self.backends[m].release(entry.seq)
        self.slots[m].retire(entry)
        req = entry.req
        # per-token relative cost of the backend that served the request
        # (same units as metrics.costs, so flops_saved_frac keeps its
        # Eq. 14 meaning vs always-largest); token counts are reported
        # separately via tokens_generated
        req.flops = self.metrics.costs[m]
        reason = entry.seq.finish_reason
        out = np.concatenate([np.asarray(req.x, np.int32),
                              np.asarray(entry.seq.tokens, np.int32)])
        if req.complete(out, t, reason=reason):
            self.metrics.on_complete(req)

    # ---- report -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        bstats = [b.stats() for b in self.backends]

        def total(key):
            return sum(s.get(key, 0) for s in bstats)

        snap.update({
            "decode_batches": self.decode_batches,
            "mixed_admission_batches": self.mixed_admission_batches,
            "tokens_generated": self.tokens_generated,
            "prefill_chunks": self.prefill_chunks,
            "interleaved_chunks": self.interleaved_chunks,
            "prefill_evictions": self.prefill_evictions,
            "prefill_tokens_computed": total("prefill_tokens_computed"),
            "prefill_tokens_shared": total("prefill_tokens_shared"),
            "cow_copies": total("cow_copies"),
            "reclaimed_pages": total("reclaimed_pages"),
            "logit_cache_hits": total("logit_cache_hits"),
            "logit_cache_misses": total("logit_cache_misses"),
            "whole_prompt_prefills": total("whole_prompt_prefills"),
            # speculative decoding (spec_decode.SpeculativeBackend):
            # zeros on plain backends
            "draft_tokens": total("draft_tokens"),
            "accepted_tokens": total("accepted_tokens"),
            "spec_fallbacks": total("spec_fallbacks"),
            "pools": [s.get("pool") for s in bstats],
            "backends": bstats,
        })
        # flattened pool/cache gauges: the dashboard-facing view of
        # PagePool.stats() and the engine caches (summed over backends;
        # the per-backend breakdown stays in "backends"/"pools")
        pools = [p for p in snap["pools"] if p]
        hits, misses = snap["logit_cache_hits"], snap["logit_cache_misses"]
        snap.update({
            "pool_pages_in_use": sum(p["pages_in_use"] for p in pools),
            "pool_peak_pages_in_use": sum(p["peak_pages_in_use"]
                                          for p in pools),
            "pool_shared_pages": sum(p["shared_pages"] for p in pools),
            "pool_cow_headroom": sum(p["cow_headroom"] for p in pools),
            "logit_cache_hit_rate": (hits / (hits + misses)
                                     if hits + misses else 0.0),
            "prewarm_residents": sum(prewarm_residents(b) or 0
                                     for b in self.backends),
            "inflight_chunks": self._inflight_chunks,
        })
        return snap
