"""Request-level tracing for the serving stack.

A copy of ``repro.serving.observability.tracer`` (pure Python; the
port imports nothing of ``repro``) without the cluster's per-host
track label and without the flight recorder: ``trip(reason)`` only
counts.

One :class:`Tracer` per scheduler records span timelines (ADMIT /
QUEUED / PREFILL_CHUNK[i] / KV_TRANSFER / DECODE_STEP / FINISH, each
carrying model/backend/page-count attributes), process-wide instant
events for scheduler decisions (degrade, shed, COW, OutOfPages
requeue, logit-cache hit, prewarm), and periodic gauge samples — all
into one bounded lock-free ring buffer.  ``tracer.export(path)``
renders the buffer as Chrome trace-event / Perfetto JSON with one
track per backend executor and one per request.

Design constraints, in order:

* **Disabled must be free.**  Hot paths hold a tracer reference and
  guard with ``if tracer.enabled:`` before taking timestamps; the
  :data:`NULL_TRACER` singleton makes every unguarded call a cheap
  no-op.  Benchmarks assert token-identical outputs traced vs
  untraced — instrumentation only reads clocks and appends to host
  buffers, it never touches RNG state or array shapes.
* **Recording is lock-free.**  Events are plain tuples written into a
  preallocated ring; slot indices come from ``itertools.count()``,
  whose ``next()`` is atomic under the GIL, so executor threads and
  the event loop record concurrently without a lock.  When the ring
  wraps, the oldest events are overwritten (``stats()["dropped"]``
  counts them); ``events()`` reconstructs chronological order.
* **Spans are recorded after the fact.**  ``span(name, track, t0,
  t1)`` takes both endpoints, so there is no per-thread span stack to
  maintain and a span costs one tuple — the caller already holds the
  two timestamps it took for metrics.
"""
from __future__ import annotations

import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# Event tuples: (seq, ph, name, track, ts, dur, args)
#   seq   — monotonically increasing record index (ring eviction order)
#   ph    — Chrome trace-event phase: "X" span, "i" instant, "C" counter
#   ts/dur — seconds on the tracer clock (export converts to µs)
#   track — "group/thread" string; export maps groups to pids and
#           threads to tids ("one track per backend executor and one
#           per request")
Event = Tuple[int, str, str, str, float, float, Optional[Dict[str, Any]]]

SPAN = "X"
INSTANT = "i"
COUNTER = "C"

#: default track for process-wide scheduler-decision instants
SCHED_TRACK = "scheduler/decisions"
#: default track group for gauge counter samples
GAUGE_TRACK = "gauges/serving"


def request_track(rid: int) -> str:
    """The per-request track: one thread per request under one
    "requests" process, zero-padded so Perfetto sorts them by rid."""
    return f"requests/req-{rid:05d}"


def backend_track(backend_name: str, executor: str) -> str:
    """The per-backend-executor track: one process per backend, one
    thread per executor (device / prefill / decode / transfer / ...)."""
    return f"backend:{backend_name}/{executor}"


class NullTracer:
    """Tracing disabled: every method is a literal no-op and
    ``enabled`` is False so hot paths skip even the timestamp reads.
    Shared as the :data:`NULL_TRACER` singleton."""

    enabled = False
    gauge_interval_s = 0.0

    def span(self, name, track, t0, t1, args=None):  # pragma: no cover
        pass

    def instant(self, name, track=SCHED_TRACK, args=None, t=None):
        pass

    def counter(self, name, values, track=GAUGE_TRACK, t=None):
        pass

    def add_consumer(self, fn):
        pass

    def trip(self, reason):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Bounded lock-free ring buffer of trace events + exporters."""

    def __init__(self, capacity: int = 1 << 16,
                 clock: Callable[[], float] = time.monotonic,
                 gauge_interval_s: float = 0.05):
        if capacity <= 0:
            raise ValueError(f"tracer capacity must be positive: {capacity}")
        self.enabled = True
        self.clock = clock
        self.capacity = int(capacity)
        self.gauge_interval_s = float(gauge_interval_s)
        self._buf: List[Optional[Event]] = [None] * self.capacity
        # itertools.count().__next__ is atomic under the GIL: executor
        # threads and the event loop claim distinct slots without a lock
        self._seq = itertools.count()
        self._consumers: List[Callable[[Event], None]] = []
        self.trips = 0                       # trip() calls

    # ---- recording ----------------------------------------------------
    def _record(self, ph: str, name: str, track: str, ts: float,
                dur: float, args: Optional[Dict[str, Any]]) -> None:
        i = next(self._seq)
        ev: Event = (i, ph, name, track, ts, dur, args)
        self._buf[i % self.capacity] = ev
        for fn in self._consumers:
            fn(ev)

    def span(self, name: str, track: str, t0: float, t1: float,
             args: Optional[Dict[str, Any]] = None) -> None:
        """One complete span [t0, t1) — recorded after the fact, so the
        caller times the operation however it already does."""
        if not self.enabled:
            return
        self._record(SPAN, name, track, t0, t1 - t0, args)

    def instant(self, name: str, track: str = SCHED_TRACK,
                args: Optional[Dict[str, Any]] = None,
                t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self._record(INSTANT, name, track,
                     t if t is not None else self.clock(), 0.0, args)

    def counter(self, name: str, values: Dict[str, Any],
                track: str = GAUGE_TRACK,
                t: Optional[float] = None) -> None:
        """One gauge sample: ``values`` series render as a stacked
        counter track in Perfetto."""
        if not self.enabled:
            return
        self._record(COUNTER, name, track,
                     t if t is not None else self.clock(), 0.0, dict(values))

    def add_consumer(self, fn: Callable[[Event], None]) -> None:
        """Register a synchronous per-event callback (the metrics
        registry consumes instants this way).  Consumers run on the
        recording thread — they must be cheap and must not trace."""
        self._consumers.append(fn)

    # ---- introspection ------------------------------------------------
    def events(self) -> List[Event]:
        """Live events in chronological (seq) order.  Racing writers
        can at worst tear one in-flight slot — the scan copies tuples,
        never mutates them."""
        evs = [ev for ev in self._buf if ev is not None]
        evs.sort(key=lambda ev: ev[0])
        return evs

    def stats(self) -> Dict[str, Any]:
        evs = [ev for ev in self._buf if ev is not None]
        recorded = max(ev[0] for ev in evs) + 1 if evs else 0
        return {
            "capacity": self.capacity,
            "recorded": recorded,
            "dropped": max(0, recorded - self.capacity),
            "consumers": len(self._consumers),
            "trips": self.trips,
        }

    # ---- Chrome trace-event / Perfetto export -------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Render events as a Chrome trace-event JSON object (the
        format both ``chrome://tracing`` and https://ui.perfetto.dev
        load).  Track strings ``group/thread`` map to one pid per
        group and one tid per thread, with process_name / thread_name
        metadata so the UI shows real names."""
        events = self.events()
        groups: Dict[str, int] = {}
        threads: Dict[Tuple[str, str], int] = {}
        for ev in events:
            group, _, thread = ev[3].partition("/")
            groups.setdefault(group, 0)
            threads.setdefault((group, thread or "main"), 0)
        for pid, group in enumerate(sorted(groups), start=1):
            groups[group] = pid
        by_group: Dict[str, List[str]] = {}
        for group, thread in threads:
            by_group.setdefault(group, []).append(thread)
        for group, names in by_group.items():
            for tid, thread in enumerate(sorted(names), start=1):
                threads[(group, thread)] = tid
        out: List[Dict[str, Any]] = []
        for group, pid in sorted(groups.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": group}})
            for thread in sorted(by_group[group]):
                out.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": threads[(group, thread)],
                            "args": {"name": thread}})
        for seq, ph, name, track, ts, dur, args in events:
            group, _, thread = track.partition("/")
            rec: Dict[str, Any] = {
                "ph": ph, "name": name, "cat": group,
                "pid": groups[group],
                "tid": threads[(group, thread or "main")],
                "ts": round(ts * 1e6, 3),
            }
            if ph == SPAN:
                rec["dur"] = round(max(dur, 0.0) * 1e6, 3)
            if ph == INSTANT:
                rec["s"] = "t"          # thread-scoped instant marker
            if args is not None:
                rec["args"] = args
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> Dict[str, Any]:
        """Write the whole buffer as Chrome trace JSON; returns the
        payload (tests schema-check it without re-reading the file)."""
        payload = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(payload, f)
        return payload

    def trip(self, reason: str) -> None:
        """Request failure / SLO violation hook of the metrics
        registry: counted in ``stats()["trips"]``."""
        if self.enabled:
            self.trips += 1


def validate_chrome_trace(payload: Any) -> List[str]:
    """Schema-check a Chrome trace-event JSON object; returns a list
    of problems (empty = valid).  Checks the envelope, per-event
    required keys, phase-specific fields, and metadata coverage —
    what chrome://tracing / Perfetto actually require to load."""
    problems: List[str] = []
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, expected object"]
    evs = payload.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list traceEvents"]
    named: set = set()
    used: set = set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} ({ph!r}) missing {key!r}")
        if ph == "M":
            if ev.get("name") == "process_name":
                named.add((ev.get("pid"), 0))
            elif ev.get("name") == "thread_name":
                named.add((ev.get("pid"), ev.get("tid")))
            continue
        if "ts" not in ev:
            problems.append(f"event {i} ({ph!r}) missing ts")
        used.add((ev.get("pid"), 0))
        used.add((ev.get("pid"), ev.get("tid")))
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)):
                problems.append(f"event {i} (X) missing numeric dur")
            elif ev["dur"] < 0:
                problems.append(f"event {i} (X) negative dur {ev['dur']}")
        elif ph == "C":
            if not isinstance(ev.get("args"), dict):
                problems.append(f"event {i} (C) needs args series dict")
        elif ph != "i":
            problems.append(f"event {i} has unknown phase {ph!r}")
    for pid_tid in sorted(used - named):
        problems.append(f"track pid/tid {pid_tid} has no metadata name")
    return problems
