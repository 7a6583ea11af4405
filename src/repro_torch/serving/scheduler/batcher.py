"""Per-model queues, the micro-batch former, and the decode roster.

A copy of ``repro.serving.scheduler.batcher``.  ModelQueue is a
(priority, deadline)-ordered queue of admitted requests for one zoo
model: higher SamplingParams.priority is served first, EDF breaks ties
within a band.  MicroBatcher (``MuxScheduler``'s) decides *when* a
queue is worth draining — batch full, or the oldest request has waited
max_wait_ms — and *what* to drain (up to max_batch_size requests in
queue order, silently discarding requests cancelled while they
waited), then pads the drained samples into the worker's static-shape
bucket with ``routing.pad_bucket_host``, the host rendering of the
scatter math the single-program multiplexer uses for its per-model
buckets.  DecodeSlots is the token-level loop's roster of running
generations.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Any, Deque, List, Optional, Tuple

from repro_torch.core import routing
from repro_torch.serving.scheduler.request import Request, RequestState


class ModelQueue:
    """Priority-then-deadline queue of admitted requests for one model."""

    def __init__(self, model_id: int):
        self.model_id = model_id
        self._heap: List[Tuple[int, float, int, Request]] = []
        # FIFO shadow for the max-wait flush decision: push times are
        # monotonic, so the oldest pending enqueue (req.admitted_t) is
        # at the left once drained entries are skipped — O(1) amortized
        # vs re-scanning the heap on every worker poll
        self._fifo: Deque[Request] = collections.deque()
        # count of entries still actually QUEUED, maintained
        # incrementally (push / pop-of-live / discount_live on cancel)
        # so the admission controller's queue-depth-aware estimates
        # stay O(1) per lookup even with thousands queued
        self._live = 0

    def push(self, req: Request, now: float) -> None:
        req.state = RequestState.QUEUED
        req.admitted_t = now
        # (-priority, deadline, rid): higher priority first, EDF within
        # a band, FIFO tie-break
        heapq.heappush(self._heap,
                       (-req.priority, req.deadline_t, req.rid, req))
        self._fifo.append(req)
        self._live += 1

    def pop(self) -> Request:
        req = heapq.heappop(self._heap)[3]
        if req.state is RequestState.QUEUED:
            # cancelled/failed leftovers were already discounted when
            # their terminal transition landed (discount_live)
            self._live -= 1
        return req

    def peek(self) -> Request:
        """Next-up request without draining it — the continuous-decode
        admit loop sizes its page reservation off this before
        committing to the pop."""
        return self._heap[0][3]

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def oldest_enqueue_t(self) -> Optional[float]:
        """Enqueue time of the oldest request still actually QUEUED —
        None when the heap holds only cancelled/drained leftovers."""
        fifo = self._fifo
        while fifo and fifo[0].state is not RequestState.QUEUED:
            fifo.popleft()
        return fifo[0].admitted_t if fifo else None

    def live_depth(self) -> int:
        """Requests still actually QUEUED (cancelled leftovers in the
        heap excluded) — the work-ahead signal the admission
        controller's queue-depth-aware service estimates consume.
        ``len(queue)`` deliberately keeps counting leftovers (it gates
        drain sweeps that must pop them); this must not.  O(1): the
        count is maintained by push/pop, with ``discount_live`` fed by
        the scheduler when a queued request is cancelled in place."""
        return self._live

    def discount_live(self) -> None:
        """A request that was QUEUED in this heap reached a terminal
        state without being popped (user cancel): drop it from the
        live count now rather than when a drain sweeps it out."""
        self._live = max(0, self._live - 1)


@dataclasses.dataclass
class BatchingPolicy:
    max_batch_size: int = 8     # bucket capacity (static shape)
    max_wait_ms: float = 5.0    # flush even a lone request after this


class MicroBatcher:
    """Forms static-shape micro-batches from a ModelQueue under policy."""

    def __init__(self, policy: BatchingPolicy):
        self.policy = policy

    # ---- when ---------------------------------------------------------
    def ready(self, queue: ModelQueue, now: float) -> bool:
        if len(queue) == 0:
            return False
        if len(queue) >= self.policy.max_batch_size:
            return True
        oldest = queue.oldest_enqueue_t
        if oldest is None:           # only cancelled leftovers in the heap
            return False
        return (now - oldest) * 1e3 >= self.policy.max_wait_ms

    def time_until_ready(self, queue: ModelQueue, now: float
                         ) -> Optional[float]:
        """Seconds until the max-wait flush fires; None if queue empty."""
        oldest = queue.oldest_enqueue_t
        if oldest is None:
            return None
        return max(0.0, self.policy.max_wait_ms / 1e3 - (now - oldest))

    # ---- what ---------------------------------------------------------
    def form(self, queue: ModelQueue, now: float) -> List[Request]:
        """Drain up to max_batch_size requests in queue order.
        Requests cancelled while they waited are discarded here — their
        futures were already resolved by the cancel — so a cancel never
        occupies a bucket row."""
        batch: List[Request] = []
        while len(queue) and len(batch) < self.policy.max_batch_size:
            req = queue.pop()
            if req.state is not RequestState.QUEUED:    # cancelled in queue
                continue
            req.state = RequestState.BATCHED
            req.batched_t = now
            batch.append(req)
        return batch

    def form_bucket(self, batch: List[Request]) -> Tuple[Any, Any]:
        """Stack + pad drained samples into the fixed (C, ...) bucket.
        Row i of the bucket is batch[i], so workers read outputs back by
        row.  Host-side (numpy): no device work on the event loop."""
        return routing.pad_bucket_host([req.x for req in batch],
                                       self.policy.max_batch_size)


# ---------------------------------------------------------------------------
# Token-level continuous decode (the paged LLM path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ActiveSequence:
    """One running generation: the request, its paged state, the
    decode-loop iteration at which it joined (so the benchmark can
    prove a batch mixed requests admitted at different times), and the
    timestamp of its latest token (feeds the inter-token-latency
    reservoir)."""
    req: Request
    seq: Any                      # repro_torch.serving.kv_cache.PagedSequence
    admit_step: int
    last_token_t: float = 0.0


class DecodeSlots:
    """Fixed-capacity roster of running generations for one engine —
    the token-level analogue of MicroBatcher's static bucket.  The
    device batch shape never changes (Engine.decode_step_batch pads
    inactive rows onto the scratch page); what changes *between* steps
    is membership: a new request joins the roster the moment its
    prefill lands in free pages, and a finished one leaves (freeing
    its pages) without disturbing the rest of the batch.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._active: List[ActiveSequence] = []

    def __len__(self) -> int:
        return len(self._active)

    @property
    def free_count(self) -> int:
        return self.capacity - len(self._active)

    def join(self, req: Request, seq: Any, admit_step: int) -> ActiveSequence:
        if not self.free_count:
            raise RuntimeError("no free decode slot")
        entry = ActiveSequence(req=req, seq=seq, admit_step=admit_step)
        self._active.append(entry)
        return entry

    def active(self) -> List[ActiveSequence]:
        return list(self._active)

    def retire(self, entry: ActiveSequence) -> None:
        self._active.remove(entry)

    def admit_steps(self) -> List[int]:
        return [e.admit_step for e in self._active]
