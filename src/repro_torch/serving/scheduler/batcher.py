"""Per-model queues and the decode roster.

A copy of ``repro.serving.scheduler.batcher`` without
``MicroBatcher`` and its ``BatchingPolicy`` (the request-level batch
former of ``MuxScheduler``, which comes with the CNN zoo).  ModelQueue is a (priority, deadline)-ordered queue of
admitted requests for one zoo model: higher SamplingParams.priority is
served first, EDF breaks ties within a band.  DecodeSlots is the
token-level loop's roster of running generations.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Any, Deque, List, Optional, Tuple

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
