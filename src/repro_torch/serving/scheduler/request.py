"""Request lifecycle for the continuous-batching runtime.

A copy of ``repro.serving.scheduler.request`` without the finish
reason only the remote backends set (``BACKEND_LOST``) and the
disaggregated KV-transfer wait.

A request is one sample (one image / one prompt) moving through

    CREATED -> QUEUED -> PREFILLING | BATCHED -> RUNNING
                      -> COMPLETED | FAILED | CANCELLED

with a wall-clock timestamp recorded at every transition, so the
metrics registry can decompose end-to-end latency into queueing,
prefill (time-to-first-token), and decode time without instrumenting
the hot path twice.  Deadlines are absolute times derived from the
per-request SLO at submission; the micro-batch former orders queues by
(priority, deadline) — EDF within a priority band.

The serving surface is ``scheduler.submit(x, SamplingParams(...)) ->
GenerationHandle``: the handle streams :class:`GenerationEvent`s
(``async for ev in handle``) when ``stream=True``, resolves the
classic one-shot output through ``await handle.result()``, and aborts
the request at any phase through ``handle.cancel()``.

Terminal transitions (``complete`` / ``fail`` / ``cancel``) are
*idempotent*: the first one wins, every later call is a no-op that
returns False — so a user cancel racing a worker completion can never
double-resolve the future or double-count metrics, regardless of
worker timing.
"""
from __future__ import annotations

import asyncio
import dataclasses
import enum
from typing import Any, Optional, Tuple


class RequestState(enum.Enum):
    CREATED = "created"        # constructed, not yet scored
    QUEUED = "queued"          # admitted: sitting in a model queue
    PREFILLING = "prefilling"  # paged path: prompt chunks running
    BATCHED = "batched"        # drained into a micro-batch (mux path)
    RUNNING = "running"        # inside the model step / decode loop
    COMPLETED = "completed"    # output delivered to the future
    FAILED = "failed"          # worker raised; exception delivered
    CANCELLED = "cancelled"    # user abort; future cancelled


TERMINAL_STATES = (RequestState.COMPLETED, RequestState.FAILED,
                   RequestState.CANCELLED)

#: finish_reason for a hard load shed: admission determined the request
#: could not meet its SLO budget on any model and failed it fast
#: instead of queueing a certain miss (see admission.BudgetExceeded)
BUDGET_EXCEEDED = "budget_exceeded"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation controls, carried end to end.

    ``max_new_tokens``/``stop_tokens``/``temperature``/``seed`` shape
    the token loop (ignored by the one-shot mux path); ``priority``
    orders queues above the EDF deadline; ``slo_ms`` overrides the
    scheduler's default deadline; ``stream=True`` makes the handle's
    ``async for`` yield token events as they land (the default handle
    only resolves ``result()``)."""
    max_new_tokens: int = 32
    stop_tokens: Tuple[int, ...] = ()
    temperature: Optional[float] = None   # None = engine default
    seed: Optional[int] = None            # None = engine default chain
    priority: int = 0                     # higher = served earlier
    slo_ms: Optional[float] = None        # None = scheduler default
    stream: bool = False


class EventType(enum.Enum):
    PREFILLING = "prefilling"    # a prefill chunk landed (progress)
    FIRST_TOKEN = "first_token"  # prefill finished; TTFT clock stops
    TOKEN = "token"              # one decode token
    FINISHED = "finished"        # terminal; carries output or error


@dataclasses.dataclass
class GenerationEvent:
    """One observation of a request's progress.  ``t`` is the
    scheduler clock at emission; TTFT and inter-token gaps fall
    straight out of consecutive event timestamps."""
    type: EventType
    t: float
    token: Optional[int] = None        # FIRST_TOKEN / TOKEN
    position: Optional[int] = None     # absolute position of ``token``
    prefilled: Optional[int] = None    # PREFILLING: prompt tokens done
    prompt_len: Optional[int] = None   # PREFILLING: prompt tokens total
    output: Any = None                 # FINISHED: the full token array
    finish_reason: Optional[str] = None  # stop|length|complete|cancelled|
    #                                      error|budget_exceeded
    error: Optional[BaseException] = None  # FINISHED(error)


@dataclasses.dataclass
class Request:
    rid: int                         # monotonically increasing id
    x: Any                           # one sample, shape (...) without batch dim
    arrival_t: float                 # clock() at submission
    deadline_t: float                # absolute SLO deadline (EDF key)
    state: RequestState = RequestState.CREATED
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)

    # admission results
    model_id: int = -1               # selected zoo model
    weights: Any = None              # mux weights (N,) for this request
    flops: float = 0.0               # Eq. 14 metered cost of the selection

    # lifecycle timestamps (clock() seconds; 0 = not reached)
    admitted_t: float = 0.0
    batched_t: float = 0.0
    started_t: float = 0.0
    first_token_t: float = 0.0       # TTFT = first_token_t - arrival_t
    finished_t: float = 0.0

    output: Any = None
    finish_reason: str = ""
    future: Optional[asyncio.Future] = None

    def __post_init__(self):
        # event queue only when the caller asked to stream: one-shot
        # requests must not buffer per-token events nobody will drain
        self._events: Optional[asyncio.Queue] = (
            asyncio.Queue() if self.params.stream else None)

    # ------------------------------------------------------------------
    @property
    def max_new_tokens(self) -> int:
        return self.params.max_new_tokens

    @property
    def seed(self) -> Optional[int]:
        return self.params.seed

    @property
    def priority(self) -> int:
        return self.params.priority

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def queue_latency(self) -> float:
        """Admission to model-step start."""
        return self.started_t - self.admitted_t

    @property
    def service_latency(self) -> float:
        """Model-step start to completion (includes bucket padding)."""
        return self.finished_t - self.started_t

    @property
    def total_latency(self) -> float:
        return self.finished_t - self.arrival_t

    @property
    def ttft(self) -> Optional[float]:
        """Arrival to first token (seconds); None before it lands."""
        if self.first_token_t <= 0.0:
            return None
        return self.first_token_t - self.arrival_t

    def missed_deadline(self) -> bool:
        return self.finished_t > self.deadline_t

    # ---- event plumbing ----------------------------------------------
    def emit(self, ev: GenerationEvent) -> None:
        if self._events is not None:
            self._events.put_nowait(ev)

    async def next_event(self) -> GenerationEvent:
        if self._events is None:
            raise RuntimeError(
                "request was not submitted with SamplingParams(stream=True); "
                "await handle.result() for the one-shot output")
        return await self._events.get()

    def on_prefill_progress(self, prefilled: int, t: float) -> None:
        self.emit(GenerationEvent(EventType.PREFILLING, t,
                                  prefilled=prefilled,
                                  prompt_len=len(self.x)))

    def on_first_token(self, token: int, position: int, t: float) -> None:
        self.first_token_t = t
        self.emit(GenerationEvent(EventType.FIRST_TOKEN, t, token=token,
                                  position=position))

    def on_token(self, token: int, position: int, t: float) -> None:
        self.emit(GenerationEvent(EventType.TOKEN, t, token=token,
                                  position=position))

    # ---- terminal transitions (idempotent: first one wins) -----------
    def _finish(self, state: RequestState, t: float) -> bool:
        if self.is_terminal:
            return False
        self.state = state
        self.finished_t = t
        return True

    def complete(self, output: Any, finished_t: float,
                 reason: str = "complete") -> bool:
        """Deliver the output.  Returns False (and changes nothing) if
        the request already reached a terminal state — e.g. a cancel
        raced this completion and won."""
        if not self._finish(RequestState.COMPLETED, finished_t):
            return False
        self.output = output
        self.finish_reason = reason
        if self.future is not None and not self.future.done():
            self.future.set_result(output)
        self.emit(GenerationEvent(EventType.FINISHED, finished_t,
                                  output=output, finish_reason=reason))
        return True

    def fail(self, exc: BaseException, finished_t: float,
             reason: str = "error") -> bool:
        """Deliver a failure; same first-transition-wins contract.
        ``reason`` distinguishes policy failures (the admission
        controller's BUDGET_EXCEEDED load shed) from worker errors on
        the request and its FINISHED event."""
        if not self._finish(RequestState.FAILED, finished_t):
            return False
        self.finish_reason = reason
        if self.future is not None and not self.future.done():
            self.future.set_exception(exc)
        self.emit(GenerationEvent(EventType.FINISHED, finished_t,
                                  finish_reason=reason, error=exc))
        return True

    def cancel(self, finished_t: float) -> bool:
        """User abort.  Resolves the future immediately (``await``
        raises asyncio.CancelledError); the owning worker releases any
        pages/slots it still holds at its next sweep."""
        if not self._finish(RequestState.CANCELLED, finished_t):
            return False
        self.finish_reason = "cancelled"
        if self.future is not None and not self.future.done():
            self.future.cancel()
        self.emit(GenerationEvent(EventType.FINISHED, finished_t,
                                  finish_reason="cancelled"))
        return True


class GenerationHandle:
    """The caller's view of one submitted request.

    * ``await handle.result()`` — the classic one-shot output (the full
      token array on the paged path, the model output on the mux path);
      raises the worker's exception on failure and
      ``asyncio.CancelledError`` after a cancel.
    * ``async for event in handle`` — the streaming surface (requires
      ``SamplingParams(stream=True)``): PREFILLING progress,
      FIRST_TOKEN, one TOKEN per decode step, and a final FINISHED,
      each timestamped with the scheduler clock.
    * ``handle.cancel()`` — abort at any phase: queued requests never
      allocate, mid-prefill and mid-decode requests hand every page
      back to the pool (refcounted decref) at the worker's next sweep.
    """

    def __init__(self, req: Request, scheduler):
        self._req = req
        self._scheduler = scheduler
        self._exhausted = False

    # ---- introspection ------------------------------------------------
    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def state(self) -> RequestState:
        return self._req.state

    @property
    def request(self) -> Request:
        return self._req

    @property
    def future(self) -> asyncio.Future:
        return self._req.future

    @property
    def ttft(self) -> Optional[float]:
        return self._req.ttft

    def done(self) -> bool:
        """True once the future resolved — including a no-drain stop
        cancelling it out from under the request state machine."""
        if self._req.future is not None:
            return self._req.future.done()
        return self._req.is_terminal

    # ---- the three verbs ---------------------------------------------
    async def result(self):
        """One-shot compatibility shim: await the request's output."""
        return await self._req.future

    def __await__(self):
        """The handle is awaitable: ``await sched.submit(x)`` (and
        ``asyncio.gather(*handles)``) resolves to the one-shot output,
        exactly like ``await handle.result()``."""
        return self._req.future.__await__()

    def cancel(self) -> bool:
        """Abort the request; True iff this call won the transition."""
        return self._scheduler._cancel_request(self._req)

    def __aiter__(self) -> "GenerationHandle":
        if self._req._events is None:
            raise RuntimeError(
                "handle is not streaming: submit with "
                "SamplingParams(stream=True) to iterate events")
        return self

    async def __anext__(self) -> GenerationEvent:
        if self._exhausted:
            raise StopAsyncIteration
        ev = await self._req.next_event()
        if ev.type is EventType.FINISHED:
            self._exhausted = True
        return ev
