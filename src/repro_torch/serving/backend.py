"""ModelBackend — the scheduler ⇄ execution seam.

A copy of ``repro.serving.backend`` trimmed to what
``PagedLLMScheduler`` over ``InProcessBackend`` and ``MuxScheduler``
over ``InProcessMuxBackend`` call.  A backend owns
*where and how* one model's device work runs — its executors, queues
and pools — while the scheduler keeps owning *what* runs when
(admission, EDF chunk ordering, the continuous decode sweep,
cancellation).

The executor surface (all device work is ``await``-ed):

    begin(prompt, ...)        host-side admission -> a sequence handle
    await prefill_chunk(seq)  one prefill chunk; True once sealed
    await decode_batch(seqs)  one token for every running sequence
    await probe(prompt)       score/prewarm the model on one prompt
    await step(bucket)        one request-level model step (mux path)
    release(seq)              hand back everything the sequence holds
    admissible()/fits_ever()/capacity()/healthy   admission introspection

``InProcessBackend`` wraps one paged ``Engine`` on a single-thread
executor and is the verify surface speculative decoding wraps
(``spec_decode.SpeculativeBackend``); ``InProcessMuxBackend`` one
mux-zoo model (``MuxServer.model_step``) on one.  Not ported yet
(``ROADMAP.md``): ``DisaggregatedBackend``, the remote stub and its
wire protocol, and the prefix digest.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.observability.tracer import (NULL_TRACER,
                                                      backend_track)


@dataclasses.dataclass
class BackendCapacity:
    """One backend's serving capacity, as admission sees it.

    ``decode_batch`` is sequences per decode call (bucket rows on the
    mux path).  Page fields are zero for non-paged backends.
    ``inflight`` counts device calls queued or running on the
    backend's executors — the queue-depth signal the admission
    controller folds into its service-time estimates."""
    decode_batch: int
    page_size: int = 0
    num_pages: int = 0          # allocatable pages (scratch excluded)
    free_pages: int = 0
    cow_headroom: int = 0
    max_len: int = 0
    inflight: int = 0


class ModelBackend:
    """Abstract executor surface for one model.  See module docstring
    for the contract; every method below raises until an
    implementation provides it, so a scheduler driving a backend that
    lacks a surface fails loudly, not silently."""

    name: str = "backend"
    #: tracing default: the shared no-op singleton, so an unbound
    #: backend traces nothing at zero cost
    _tracer = NULL_TRACER
    #: True when prefill and decode run on independent executors, so
    #: the scheduler may leave a prefill chunk in flight while it
    #: keeps sweeping the decode batch.
    concurrent_prefill: bool = False

    # ---- lifecycle ----------------------------------------------------
    async def start(self) -> None:
        """Bring up executors/channels.  Must be restartable."""

    async def stop(self) -> None:
        """Drain and shut down executors/channels (wait for in-flight
        device work; the scheduler reclaims pool state only after)."""

    def bind_metrics(self, metrics, model_id: int) -> None:
        """Attach the scheduler's metrics registry; backends feed
        per-backend queue-wait and transfer timings through it."""
        self._metrics = metrics
        self._model_id = model_id

    def bind_tracer(self, tracer) -> None:
        """Attach the scheduler's tracer.  Backends emit one span per
        device call on their executor tracks (and KV-transfer spans,
        disaggregated); implementations that own engines/pools also
        hand the tracer down so COW/reclaim/alloc instants record."""
        self._tracer = tracer

    # ---- token-level surface ------------------------------------------
    def begin(self, prompt, *, max_new_tokens: int,
              seed: Optional[int] = None,
              temperature: Optional[float] = None,
              stop_tokens: Sequence[int] = ()) -> Any:
        raise NotImplementedError(f"{self.name} has no token-level surface")

    async def prefill_chunk(self, seq, *,
                            chunk_tokens: Optional[int] = None) -> bool:
        raise NotImplementedError(f"{self.name} has no token-level surface")

    async def decode_batch(self, seqs: Sequence) -> np.ndarray:
        raise NotImplementedError(f"{self.name} has no token-level surface")

    def release(self, seq) -> None:
        raise NotImplementedError(f"{self.name} has no token-level surface")

    async def probe(self, prompt):
        """Score one prompt on this backend's model (and, where the
        implementation supports it, prewarm caches so a follow-up
        admission of the same prompt is cheap)."""
        raise NotImplementedError(f"{self.name} has no probe surface")

    # ---- request-level surface (mux path) -----------------------------
    async def step(self, bucket) -> np.ndarray:
        raise NotImplementedError(f"{self.name} has no request-level surface")

    # ---- admission introspection --------------------------------------
    def capacity(self) -> BackendCapacity:
        raise NotImplementedError

    def admission_cost(self, prompt, max_new_tokens: int, *,
                       chunk_tokens: Optional[int] = None
                       ) -> Tuple[int, int]:
        """(pages a fresh admission allocates now, copy-on-write
        headroom to hold back).  Conservative default: the full page
        span with no sharing discount."""
        cap = self.capacity()
        p = int(np.asarray(prompt).reshape((-1,)).shape[0])
        span = p + max_new_tokens
        if chunk_tokens is not None and chunk_tokens < p:
            span = chunk_tokens
        return -(-span // cap.page_size), 0

    def admissible(self, prompt, max_new_tokens: int, *,
                   chunk_tokens: Optional[int] = None) -> bool:
        need, extra = self.admission_cost(prompt, max_new_tokens,
                                          chunk_tokens=chunk_tokens)
        cap = self.capacity()
        return need + cap.cow_headroom + extra <= cap.free_pages

    def fits_ever(self, prompt_len: int, max_new_tokens: int) -> bool:
        cap = self.capacity()
        return (-(-(prompt_len + max_new_tokens) // cap.page_size)
                <= cap.num_pages)

    def set_lazy_decode_alloc(self, enabled: bool) -> None:
        """Push the scheduler's ``lazy_decode_alloc`` policy down to the
        paged engine(s).  No-op by default: request-level backends hold
        no pages to reserve lazily."""

    @property
    def healthy(self) -> bool:
        return True

    # ---- warmup / reporting -------------------------------------------
    def warmup(self, prompt_lens: Sequence[int],
               chunk_tokens: Optional[int] = None) -> None:
        """Compile serving shapes before traffic (control-plane; runs
        before ``start``)."""

    def stats(self) -> Dict[str, Any]:
        return {"name": self.name, "healthy": self.healthy}

    # ---- shared helpers ----------------------------------------------
    def _note_queue_wait(self, seconds: float) -> None:
        m = getattr(self, "_metrics", None)
        if m is not None:
            m.on_backend_queue_wait(self._model_id, seconds)


class _ExecutorMixin:
    """One named single-thread executor + the await/queue-wait plumbing
    shared by the in-process backends.  Device calls to one executor
    serialize (the engine updates its pool tensors in place, so calls
    must never race), while calls on *different* executors — and
    different backends — overlap."""

    def _init_executors(self, names: Sequence[str]) -> None:
        self._executor_names = list(names)
        self._pools: Dict[str, Optional[ThreadPoolExecutor]] = {
            n: None for n in names}
        self._inflight = 0

    async def start(self) -> None:
        for n in self._executor_names:
            if self._pools[n] is None:
                self._pools[n] = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"{self.name}-{n}")

    async def stop(self) -> None:
        for n in self._executor_names:
            pool, self._pools[n] = self._pools[n], None
            if pool is not None:
                pool.shutdown(wait=True)

    async def _run(self, executor: str, fn, *args, op: Optional[str] = None):
        pool = self._pools[executor]
        if pool is None:
            raise RuntimeError(
                f"backend {self.name!r} is not started: no {executor} "
                f"executor (await backend.start(), or run it under a "
                f"scheduler)")
        loop = asyncio.get_running_loop()
        t_submit = time.monotonic()

        def wrapped():
            t_start = time.monotonic()
            self._note_queue_wait(t_start - t_submit)
            try:
                return fn(*args)
            finally:
                tracer = self._tracer
                if tracer.enabled:
                    # executor-occupancy span: runs on the executor
                    # thread itself, which the lock-free ring allows
                    tracer.span(op or getattr(fn, "__name__", "call"),
                                backend_track(self.name, executor),
                                t_start, time.monotonic(),
                                {"queued_ms": (t_start - t_submit) * 1e3})

        self._inflight += 1
        try:
            return await loop.run_in_executor(pool, wrapped)
        finally:
            self._inflight -= 1


def _engine_warmup(engine, prompt_lens: Sequence[int],
                   chunk_tokens: Optional[int]) -> None:
    """Warm one paged engine's serving shapes before traffic: prefill
    at each padded prompt length (plus an identical twin so the
    shared-prefix tail path and the copy-on-write decode step run when
    sharing is on), the decode step, and — chunked mode — the fixed
    chunk shape.  On a CUDA device it first captures both paged decode
    steps (plain and copy-on-write, ``Engine.capture_decode_steps``:
    their inputs touch only the scratch page), so the decode steps below
    and every served one are replays, as the reference compiles its
    jitted steps here.  PyTorch compiles nothing else ahead, but the
    first call of each shape pays the kernel builds, the library handles
    and the allocator's growth, which warmup keeps out of the first
    request.  Warmup pages always hand back; the logit cache is bypassed
    and cleared so synthetic prompts neither skip the compiles nor leave
    entries behind."""
    engine.capture_decode_steps()
    cache_cap = engine._logit_cache_cap
    engine._logit_cache_cap = 0
    try:
        if chunk_tokens is not None:
            pl = min(2 * chunk_tokens, engine.scfg.max_len - 2)
            if pl > chunk_tokens:
                try:
                    seq = engine.begin_prefill(np.zeros((pl,), np.int32),
                                               max_new_tokens=2)
                    try:
                        while not engine.prefill_chunk(
                                seq, chunk_tokens=chunk_tokens):
                            pass
                    finally:
                        engine.pool.release(seq)
                except OutOfPages:
                    pass            # pool too small: compile on first use
        for pl in sorted(set(
                min(engine.pool.pages_for(p) * engine.pool.page_size,
                    engine.scfg.max_len - 2)
                for p in prompt_lens)):
            if pl < 1:
                continue
            seq = engine.prefill_into_pages(np.zeros((pl,), np.int32),
                                            max_new_tokens=2)
            twin = None
            if engine.pool.prefix_sharing:
                try:
                    twin = engine.prefill_into_pages(
                        np.zeros((pl,), np.int32), max_new_tokens=2)
                except OutOfPages:
                    pass
            try:
                engine.decode_step_batch([seq])
                if twin is not None:
                    # the twin made the first step copy-on-write; step
                    # again on the now-private page so the plain decode
                    # step also runs during warmup rather than mid-serve
                    engine.decode_step_batch([seq])
            except OutOfPages:
                pass                # warmup COW found no free page
            finally:
                engine.pool.release(seq)
                if twin is not None:
                    engine.pool.release(twin)
    finally:
        engine._logit_cache_cap = cache_cap
        engine._logit_cache.clear()
        engine.logit_cache_hits = 0
        engine.logit_cache_misses = 0


class InProcessBackend(_ExecutorMixin, ModelBackend):
    """One paged ``Engine`` behind the backend protocol.

    Token-identical to the scheduler calling the engine directly: the
    same entry points run, serialized on one executor thread."""

    #: executor that serializes with decode: speculative verify steps
    #: (``spec_decode.SpeculativeBackend``) run there
    verify_executor = "device"

    def __init__(self, engine, name: Optional[str] = None):
        if engine.pool is None:   # not an assert: must survive python -O
            raise ValueError(
                "InProcessBackend needs a paged engine: call "
                "Engine.init_paged(num_pages=..., page_size=...) first")
        self.engine = engine
        self.name = name or f"inproc:{engine.cfg.name}"
        self._init_executors(["device"])

    @property
    def verify_engine(self):
        """The engine whose paged caches multi-token verify steps run
        against (the speculative-decoding verify surface)."""
        return self.engine

    def bind_tracer(self, tracer) -> None:
        super().bind_tracer(tracer)
        self.engine.tracer = tracer
        self.engine.trace_track = backend_track(self.name, "engine")
        self.engine.pool.tracer = tracer
        self.engine.pool.trace_track = backend_track(self.name, "pool")

    # ---- token-level ---------------------------------------------------
    def begin(self, prompt, *, max_new_tokens, seed=None, temperature=None,
              stop_tokens=()):
        return self.engine.begin_prefill(
            prompt, max_new_tokens=max_new_tokens, seed=seed,
            temperature=temperature, stop_tokens=stop_tokens)

    async def prefill_chunk(self, seq, *, chunk_tokens=None) -> bool:
        return await self._run(
            "device", lambda: self.engine.prefill_chunk(
                seq, chunk_tokens=chunk_tokens), op="prefill_chunk")

    async def decode_batch(self, seqs):
        return await self._run("device", self.engine.decode_step_batch, seqs,
                               op="decode_step")

    def release(self, seq) -> None:
        if seq.pages:
            self.engine.pool.release(seq)
        seq.pages = []

    async def probe(self, prompt):
        return await self._run("device", self.engine.prewarm_logits, prompt,
                               op="probe")

    def set_lazy_decode_alloc(self, enabled: bool) -> None:
        self.engine.set_lazy_decode_alloc(enabled)

    # ---- admission -----------------------------------------------------
    def capacity(self) -> BackendCapacity:
        pool = self.engine.pool
        return BackendCapacity(
            decode_batch=self.engine.decode_batch, page_size=pool.page_size,
            num_pages=pool.num_pages - 1,
            free_pages=pool.num_free,
            cow_headroom=pool.cow_headroom, max_len=self.engine.scfg.max_len,
            inflight=self._inflight)

    def admission_cost(self, prompt, max_new_tokens, *, chunk_tokens=None):
        return self.engine.admission_page_cost(prompt, max_new_tokens,
                                               chunk_tokens=chunk_tokens)

    def admissible(self, prompt, max_new_tokens, *, chunk_tokens=None):
        ok = super().admissible(prompt, max_new_tokens,
                                chunk_tokens=chunk_tokens)
        if not ok and self.engine.shed_prewarmed():
            # probe-prewarmed residents are a cache, not a commitment:
            # under page pressure they yield to real admissions
            ok = super().admissible(prompt, max_new_tokens,
                                    chunk_tokens=chunk_tokens)
        return ok

    @property
    def healthy(self) -> bool:
        return not self.engine.caches_poisoned

    # ---- warmup / reporting -------------------------------------------
    def warmup(self, prompt_lens, chunk_tokens=None):
        _engine_warmup(self.engine, prompt_lens, chunk_tokens)

    def prefix_digest(self, cap: int = 2048) -> List[str]:
        raise NotImplementedError(
            "prefix_digest (the cluster router's placement gossip) is not "
            "ported yet (ROADMAP.md, section 1)")

    def stats(self) -> Dict[str, Any]:
        e = self.engine
        return {
            "name": self.name, "healthy": self.healthy,
            "pool": e.pool.stats(),
            "prefill_tokens_computed": e.prefill_tokens_computed,
            "prefill_tokens_shared": e.prefill_tokens_shared,
            "cow_copies": e.cow_count,
            "reclaimed_pages": e.reclaimed_pages,
            "logit_cache_hits": e.logit_cache_hits,
            "logit_cache_misses": e.logit_cache_misses,
            "whole_prompt_prefills": e.whole_prompt_prefills,
        }


def to_host(x) -> np.ndarray:
    """A device tensor (or array-like) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class InProcessMuxBackend(_ExecutorMixin, ModelBackend):
    """One mux-zoo model (``server.model_step(m, ...)``) behind the
    backend protocol — the request-level counterpart of
    ``InProcessBackend``.  ``capacity().decode_batch`` reports the
    bucket capacity and ``inflight`` the queued device calls, which is
    what makes the admission controller's service estimates
    queue-depth-aware."""

    def __init__(self, server, model_id: int, *, bucket_capacity: int,
                 name: Optional[str] = None):
        self.server = server
        self.model_id = model_id
        self.bucket_capacity = bucket_capacity
        self.name = name or f"mux:{model_id}"
        self._init_executors(["device"])

    async def step(self, bucket) -> np.ndarray:
        return await self._run(
            "device",
            lambda: to_host(self.server.model_step(self.model_id, bucket)),
            op="step")

    async def probe(self, bucket):
        return await self._run(
            "device", lambda: to_host(self.server.probe_weights(bucket)),
            op="probe")

    def capacity(self) -> BackendCapacity:
        return BackendCapacity(decode_batch=self.bucket_capacity,
                               inflight=self._inflight)
