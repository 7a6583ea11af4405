"""repro_torch.serving — the paged engine and page pool, the
multiplexed server, the scheduler-to-execution backends
(``repro_torch.serving.backend``) and the continuous-batching request
schedulers (``repro_torch.serving.scheduler``)."""
from repro_torch.serving.backend import (BackendCapacity, InProcessBackend,
                                         InProcessMuxBackend, ModelBackend)
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.kv_cache import (OutOfPages, PagePool,
                                          PagedCacheConfig, PagedSequence)
from repro_torch.serving.mux_server import MuxServer, MuxServerConfig
from repro_torch.serving.observability import (NULL_TRACER, Tracer,
                                               validate_chrome_trace)

__all__ = ["Engine", "ServeConfig", "MuxServer", "MuxServerConfig",
           "OutOfPages", "PagePool", "PagedCacheConfig", "PagedSequence",
           "ModelBackend", "BackendCapacity", "InProcessBackend",
           "InProcessMuxBackend", "Tracer", "NULL_TRACER",
           "validate_chrome_trace"]
