"""Request-level tracing, Perfetto export and gauge sampling for the
port's serving stack (copies of ``repro.serving.observability``; see
tracer.py for the design notes)."""
from repro_torch.serving.observability.gauges import (prewarm_residents,
                                                      sample_gauges)
from repro_torch.serving.observability.tracer import (GAUGE_TRACK,
                                                      NULL_TRACER,
                                                      SCHED_TRACK,
                                                      NullTracer, Tracer,
                                                      backend_track,
                                                      request_track,
                                                      validate_chrome_trace)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "SCHED_TRACK",
           "GAUGE_TRACK", "backend_track", "request_track",
           "validate_chrome_trace", "sample_gauges", "prewarm_residents"]
