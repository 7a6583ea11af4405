"""repro_torch.serving.scheduler — the async continuous-batching
runtimes (copies of ``repro.serving.scheduler``).

The request-level runtime of the paper's image mux: requests arrive one
by one on an open loop, the mux probe scores each on arrival, a
deadline-first micro-batch former drains per-model queues into
static-shape buckets, and per-model workers drive the zoo concurrently.

    server = MuxServer(mux_params, costs, model_fns=model_fns)
    sched = MuxScheduler(server, SchedulerConfig(max_batch_size=8))
    sched.warmup(sample)                   # capture every graph first
    async with sched:
        y = await sched.submit(x).result()
    print(sched.metrics.snapshot())

The token-level runtime of LLM zoos (``PagedLLMScheduler``): engines
with paged KV pools decode one token per step for every running
request, and new requests run their prompt through prefill between
the running batch's decode steps.

    engine.init_paged(num_pages=512, page_size=64, decode_batch=16)
    sched = PagedLLMScheduler([engine], PagedLLMConfig(max_new_tokens=128))
    async with sched:
        handle = sched.submit(prompt, SamplingParams(stream=True))
        async for ev in handle:            # PREFILLING, FIRST_TOKEN,
            ...                            # TOKEN..., FINISHED
"""
from repro_torch.serving.scheduler.request import (BUDGET_EXCEEDED,
                                                   EventType,
                                                   GenerationEvent,
                                                   GenerationHandle,
                                                   Request, RequestState,
                                                   SamplingParams)
from repro_torch.serving.scheduler.batcher import (ActiveSequence,
                                                   BatchingPolicy,
                                                   DecodeSlots, MicroBatcher,
                                                   ModelQueue)
from repro_torch.serving.scheduler.admission import (AdmissionController,
                                                     BudgetExceeded)
from repro_torch.serving.scheduler.metrics import (LatencyReservoir,
                                                   SchedulerMetrics)
from repro_torch.serving.scheduler.traffic import (TrafficConfig,
                                                   arrival_times, replay)
from repro_torch.serving.scheduler.runtime import (MuxScheduler,
                                                   PagedLLMConfig,
                                                   PagedLLMScheduler,
                                                   SchedulerConfig,
                                                   SchedulerLifecycle)

__all__ = [
    "Request", "RequestState", "SamplingParams", "GenerationEvent",
    "GenerationHandle", "EventType", "BUDGET_EXCEEDED", "ActiveSequence",
    "BatchingPolicy", "DecodeSlots", "MicroBatcher", "ModelQueue",
    "AdmissionController", "BudgetExceeded", "LatencyReservoir",
    "SchedulerMetrics", "TrafficConfig", "arrival_times", "replay",
    "MuxScheduler", "PagedLLMConfig", "PagedLLMScheduler",
    "SchedulerConfig", "SchedulerLifecycle",
]
