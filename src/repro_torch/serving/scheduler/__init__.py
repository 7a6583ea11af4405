"""repro_torch.serving.scheduler — the async token-level serving
runtime (copies of ``repro.serving.scheduler``, trimmed to
``PagedLLMScheduler``; ``MuxScheduler``, ``AdmissionController`` and
``MicroBatcher`` come with the CNN zoo).

    engine.init_paged(num_pages=512, page_size=64, decode_batch=16)
    sched = PagedLLMScheduler([engine], PagedLLMConfig(max_new_tokens=128))
    async with sched:
        handle = sched.submit(prompt, SamplingParams(stream=True))
        async for ev in handle:            # PREFILLING, FIRST_TOKEN,
            ...                            # TOKEN..., FINISHED
"""
from repro_torch.serving.scheduler.request import (EventType,
                                                   GenerationEvent,
                                                   GenerationHandle,
                                                   Request, RequestState,
                                                   SamplingParams)
from repro_torch.serving.scheduler.batcher import (ActiveSequence,
                                                   DecodeSlots, ModelQueue)
from repro_torch.serving.scheduler.metrics import (LatencyReservoir,
                                                   SchedulerMetrics)
from repro_torch.serving.scheduler.traffic import (TrafficConfig,
                                                   arrival_times, replay)
from repro_torch.serving.scheduler.runtime import (PagedLLMConfig,
                                                   PagedLLMScheduler,
                                                   SchedulerLifecycle)

__all__ = [
    "Request", "RequestState", "SamplingParams", "GenerationEvent",
    "GenerationHandle", "EventType", "ActiveSequence", "DecodeSlots",
    "ModelQueue",
    "LatencyReservoir", "SchedulerMetrics", "TrafficConfig",
    "arrival_times", "replay", "PagedLLMConfig", "PagedLLMScheduler",
    "SchedulerLifecycle",
]
