"""Shape-keyed CUDA-graph capture: the port's counterpart of the shape
cache ``jax.jit`` keeps for the reference's compiled stages.

:class:`CudaGraphed` wraps a function of fixed-shape CUDA tensors.  The
first call with a new signature (the shapes, dtypes and device of the
arguments) allocates static inputs, runs the function once on the
current stream to warm it up (its kernels load, its libraries pick their
algorithms and allocate their workspaces; PyTorch keeps a cuBLAS
workspace for each stream it ran on for the life of the process, so a
side stream drawn for each capture would add one), then captures one
call into a ``torch.cuda.CUDAGraph``.  Every call copies the arguments
into that signature's static inputs, replays the graph on the current
stream and returns clones of the static outputs, which the next replay
overwrites.
The capture tallies the kernel launches its wrappers record
(``ops.tally_launches``: a captured call launches nothing), and every
replay adds that tally to ``ops.launches``, since a replay launches
what was captured.  The warm-up launches and counts as any eager call.

A step with state (the serving engine's page pool, its ring and Mamba
caches) keeps that state in the function's closure, never among the
arguments: the graph reads and writes it in place at fixed addresses,
and only the small per-step inputs are copied.  Since the warm-up runs
the function once for real, the first call of a signature runs a
stateful step twice.  Such a caller captures first with
:meth:`CudaGraphed.capture`, which warms up and captures without
replaying, at a point where the state does not matter (inputs that
touch only scratch state, or state that is reset before its use).

Capture uses ``capture_error_mode="thread_local"``: other threads may
keep launching work (prefills on a backend's executor threads) while one
thread captures.  Python's garbage collector is off, process-wide,
while any capture runs: a collection then can free another ``CUDAGraph``
(one held in a reference cycle), whose teardown is a call a capturing
stream forbids, and the capture fails.  Captures that overlap (on
different threads, or one inside another) share one count, so the
collector comes back on only when the last of them ends, and only if it
was on when the first began.  A lock covers copy, replay and clone, and
each call's stream waits for the previous call's clones, so callers on
different threads or streams never see each other's outputs.  It is CUDA-only:
any argument that is not a CUDA tensor raises, and a capture that fails
raises; nothing falls back to running the function eagerly.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops

Signature = Tuple[Tuple[Tuple[int, ...], torch.dtype, torch.device], ...]

_gc_lock = threading.Lock()
_gc_holds = 0              # captures running now, on any thread
_gc_was_on = False         # the collector's state when the first began


@contextlib.contextmanager
def _collector_held() -> Iterator[None]:
    """Python's garbage collector off, process-wide, until the last of
    the captures running at once ends; then back on if it was on when
    the first began."""
    global _gc_holds, _gc_was_on
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_on = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_on:
                gc.enable()


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]      # static: copied into each call
    outputs: Tuple[torch.Tensor, ...]     # static: overwritten each replay
    single: bool                          # fn returned one tensor
    launches: Dict[str, int]              # kernel launches of one replay
    seconds: float                        # wall time of warm-up + capture


class CudaGraphed:
    """``fn(*tensors) -> tensor | tuple of tensors``, replayed from one
    CUDA graph per argument signature."""

    def __init__(self, fn: Callable, name: str = ""):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self._graphs: Dict[Signature, _Captured] = {}
        self._lock = threading.Lock()
        self._done = None          # recorded after each call's clones

    def __call__(self, *args: torch.Tensor):
        sig, dev = self._signature(args)
        with self._lock, torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if self._done is None:
                self._done = torch.cuda.Event()
            stream.wait_event(self._done)     # the last call's clones
            entry = self._graphs.get(sig)
            if entry is None:
                entry = self._capture(sig, args)
            for dst, src in zip(entry.inputs, args):
                dst.copy_(src)
            entry.graph.replay()
            ops.add_launches(entry.launches)
            outs = tuple(o.clone() for o in entry.outputs)
            self._done.record(stream)
        return outs[0] if entry.single else outs

    def capture(self, *args: torch.Tensor) -> float:
        """Warm up and capture the signature of ``args`` without
        replaying it (a no-op if it was captured before).  Returns the
        wall seconds that signature's warm-up and capture took: the
        stall its first call would otherwise have paid."""
        sig, dev = self._signature(args)
        with self._lock, torch.cuda.device(dev):
            entry = self._graphs.get(sig)
            if entry is None:
                entry = self._capture(sig, args)
        return entry.seconds

    def replay_launches(self, *args: torch.Tensor) -> Dict[str, int]:
        """The kernel launches one replay makes for the signature of
        ``args`` (by wrapper, as ``ops.launches`` counts them); raises
        if that signature was never captured."""
        sig, _ = self._signature(args)
        return dict(self._graphs[sig].launches)

    def _signature(self, args) -> Tuple[Signature, torch.device]:
        for a in args:
            if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
                raise ValueError(
                    f"CudaGraphed({self.name}) takes CUDA tensors only, got "
                    f"{a.device if isinstance(a, torch.Tensor) else type(a)}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"CudaGraphed({self.name}): CUDA is not "
                               "available")
        sig = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        return sig, args[0].device

    def _capture(self, sig: Signature, args) -> _Captured:
        t0 = time.perf_counter()
        inputs = tuple(a.clone() for a in args)
        self.fn(*inputs)                      # warm-up, not kept
        graph = torch.cuda.CUDAGraph()
        with _collector_held(), ops.tally_launches() as tally, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.fn(*inputs)
        single = isinstance(out, torch.Tensor)
        outputs = (out,) if single else tuple(out)
        entry = _Captured(graph, inputs, outputs, single,
                          {k: n for k, n in tally.items() if n},
                          time.perf_counter() - t0)
        self._graphs[sig] = entry
        return entry
