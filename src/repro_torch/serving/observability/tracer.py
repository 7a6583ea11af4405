"""Tracing off: the null tracer the port's engine and page pool hold.

A copy of ``NullTracer`` / ``NULL_TRACER`` from
``repro.serving.observability.tracer``; the recording ``Tracer`` and its
exporters come with the async serving stack.
"""
from __future__ import annotations

from typing import Optional

#: default track for process-wide scheduler-decision instants
SCHED_TRACK = "scheduler/decisions"
#: default track group for gauge counter samples
GAUGE_TRACK = "gauges/serving"


class NullTracer:
    """Tracing disabled: every method is a literal no-op and
    ``enabled`` is False so hot paths skip even the timestamp reads.
    Shared as the :data:`NULL_TRACER` singleton."""

    enabled = False
    gauge_interval_s = 0.0
    flight_recorder_path: Optional[str] = None
    host: Optional[str] = None

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
