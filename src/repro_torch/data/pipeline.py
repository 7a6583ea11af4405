"""Host-side data pipeline: deterministic, process-aware batching.

Port of ``repro.data.pipeline`` without its shardings.  Each process
draws the same global batch from a generator seeded by (seed, step) —
the reference folds the step into its key — and keeps its contiguous
slice of the batch dimension, with no communication between processes.
``process_index`` / ``process_count`` are explicit (one process, the
whole batch, unless given).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]


def step_generator(seed: int, step: int,
                   device: DeviceLike = None) -> torch.Generator:
    """A generator on ``device`` (``cuda`` unless given) seeded from
    (seed, step): one independent stream a step."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=resolve_device(device)).manual_seed(mixed)


def host_slice(global_batch: int, process_index: int,
               process_count: int) -> slice:
    """Contiguous per-process slice of the global batch dimension."""
    if process_count < 1 or global_batch % process_count:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{process_count} processes")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process {process_index} of {process_count}")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


class ShardedBatcher:
    """Wraps ``batch_fn(generator, batch_size) -> dict`` into an endless
    iterator of this process's slice of each step's global batch."""

    def __init__(self, batch_fn: Callable[[torch.Generator, int], Batch], *,
                 global_batch: int, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, device: DeviceLike = None):
        self.batch_fn = batch_fn
        self.global_batch = global_batch
        self.sl = host_slice(global_batch, process_index, process_count)
        self.seed = seed
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Batch]:
        step = 0
        while True:
            gen = step_generator(self.seed, step, self.device)
            batch = self.batch_fn(gen, self.global_batch)
            yield {name: v[self.sl] for name, v in batch.items()}
            step += 1
