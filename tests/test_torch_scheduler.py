"""The port's async serving stack (``PagedLLMScheduler`` over
``InProcessBackend``) against the JAX package's, and against itself.

* The JAX scheduler and the port's, over olmo-1b smoke engines built
  from the same converted fp32 weights, give identical tokens on the
  staggered mixed-length trace of
  ``tests/test_paged_decode.py::test_scheduler_continuous_decode_trace``,
  with whole-prompt and one-page chunked prefill, and a traced run
  records the same span names as the JAX scheduler's.
* Copies of the JAX package's lifecycle, backpressure and adaptive
  chunk-policy tests, run on the port.
* The ``PagePool.cow_headroom`` repair: the case hypothesis found in
  ``tests/test_pool_property.py``, made deterministic.
"""
import asyncio
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.observability import Tracer as JaxTracer
from repro.serving.scheduler import PagedLLMConfig as JaxPagedLLMConfig
from repro.serving.scheduler import PagedLLMScheduler as JaxScheduler
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serving.backend import BackendCapacity, InProcessBackend
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.kv_cache import OutOfPages, PagePool
from repro_torch.serving.observability import (Tracer, sample_gauges,
                                               validate_chrome_trace)
from repro_torch.serving.observability.tracer import COUNTER
from repro_torch.serving.scheduler import (PagedLLMConfig,
                                           PagedLLMScheduler, Request,
                                           SamplingParams)

FP32 = dict(compute_dtype="float32", param_dtype="float32",
            kv_cache_dtype="float32")
LENS = [5, 11, 17, 8]
MAX_NEW = 10
PROMPTS = [np.random.RandomState(5 + i).randint(0, 512, n).astype(np.int32)
           for i, n in enumerate(LENS)]


@pytest.fixture(scope="module")
def smoke_params():
    """olmo-1b's smoke config in fp32, JAX params and their torch copy."""
    jcfg = jax_smoke_config("olmo-1b").with_(**FP32)
    params = jtf.init_params(jcfg, jax.random.key(0))
    return jcfg, params, convert.to_torch(jax.tree.map(np.asarray, params),
                                          "cpu")


def _jax_engine(smoke_params):
    jcfg, params, _ = smoke_params
    eng = JaxEngine(jcfg, params, JaxServeConfig(max_len=64))
    eng.init_paged(num_pages=40, page_size=4, decode_batch=4)
    return eng


def _torch_engine(smoke_params):
    _, _, tparams = smoke_params
    eng = Engine(get_smoke_config("olmo-1b").with_(**FP32), tparams,
                 ServeConfig(max_len=64), device="cpu")
    eng.init_paged(num_pages=40, page_size=4, decode_batch=4)
    return eng


def _serve_trace(sched_cls, cfg_cls, engine, chunk_pages, tracer=None):
    """Two requests first; the other two join once the first two are
    decoding, so later admissions land in a running decode batch.  The
    port's engine counts its whole-prompt prefills from the end of
    warmup on (``engine.served_whole_prefills``)."""
    async def main():
        sched = sched_cls([engine], cfg_cls(max_new_tokens=MAX_NEW,
                                            prefill_chunk_pages=chunk_pages),
                          tracer=tracer)
        sched.warmup(LENS)
        warm = getattr(engine, "whole_prompt_prefills", 0)
        async with sched:
            handles = [sched.submit(p) for p in PROMPTS[:2]]
            while sched.decode_batches < 2:
                await asyncio.sleep(0.005)
            handles += [sched.submit(p) for p in PROMPTS[2:]]
            outs = await asyncio.gather(*handles)
        engine.served_whole_prefills = (
            getattr(engine, "whole_prompt_prefills", 0) - warm)
        return sched, [np.asarray(o) for o in outs]
    return asyncio.run(main())


@pytest.mark.parametrize("chunk_pages", [0, 1])
def test_scheduler_tokens_identical_to_jax(smoke_params, chunk_pages):
    jsched, want = _serve_trace(JaxScheduler, JaxPagedLLMConfig,
                                _jax_engine(smoke_params), chunk_pages)
    sched, got = _serve_trace(PagedLLMScheduler, PagedLLMConfig,
                              _torch_engine(smoke_params), chunk_pages)
    for p, w, g in zip(PROMPTS, want, got):
        assert g.shape == (len(p) + MAX_NEW,)
        np.testing.assert_array_equal(g, w)
    for snap in (jsched.snapshot(), sched.snapshot()):
        assert snap["completed"] == 4 and snap["failed"] == 0
        assert snap["mixed_admission_batches"] >= 1
        assert snap["pools"][0]["pages_in_use"] == 0
    assert sched.prefill_chunks == jsched.prefill_chunks
    # whole-prompt mode: every admission runs the flash-attention branch
    assert sched.engines[0].served_whole_prefills == (
        4 if chunk_pages == 0 else 0)


def test_traced_run_has_the_jax_span_names(smoke_params, tmp_path):
    """A traced chunked run: the same span and instant names as the JAX
    scheduler's on the same trace, a closed ADMIT -> QUEUED -> PREFILL
    -> DECODE -> FINISH chain per request, a schema-valid Chrome trace,
    and tokens identical to an untraced run."""
    jtracer, tracer = JaxTracer(), Tracer()
    _serve_trace(JaxScheduler, JaxPagedLLMConfig, _jax_engine(smoke_params),
                 2, tracer=jtracer)
    _, plain = _serve_trace(PagedLLMScheduler, PagedLLMConfig,
                            _torch_engine(smoke_params), 2)
    sched, traced = _serve_trace(PagedLLMScheduler, PagedLLMConfig,
                                 _torch_engine(smoke_params), 2,
                                 tracer=tracer)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)

    def names(tr, ph):
        return {ev[2] for ev in tr.events() if ev[1] == ph}

    assert names(tracer, "X") == names(jtracer, "X")
    assert {"DECODE_STEP", "PREFILL_CHUNK[0]", "QUEUED", "PREFILL",
            "DECODE"} <= names(tracer, "X")
    assert names(tracer, "i") == names(jtracer, "i")
    assert validate_chrome_trace(tracer.export(str(tmp_path / "t.json"))) \
        == []
    rids = {ev[3] for ev in tracer.events() if ev[2] == "FINISH"}
    assert len(rids) == len(PROMPTS)
    assert sched.snapshot()["trace"]["recorded"] > 0
    sample_gauges(tracer, sched)
    counters = {ev[2] for ev in tracer.events() if ev[1] == COUNTER}
    name = sched.backends[0].name
    assert {f"{name}:pool", f"{name}:load"} <= counters


# ---------------------------------------------------------------------------
# Lifecycle and backpressure (copies of tests/test_paged_decode.py's)
# ---------------------------------------------------------------------------

def _tiny_engine(max_len, num_pages, decode_batch=2):
    cfg = ModelConfig(name="tiny-full", arch_type="dense", num_layers=2,
                      d_model=32, d_ff=64, vocab_size=64, num_heads=4,
                      num_kv_heads=2, head_dim=8, pattern=(LayerSpec(),),
                      **FP32)
    params = tf.init_params(cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_len=max_len), device="cpu")
    eng.init_paged(num_pages=num_pages, page_size=4,
                   decode_batch=decode_batch)
    return eng


def test_stop_without_drain_reclaims_pages():
    eng = _tiny_engine(64, 20)

    async def main():
        sched = PagedLLMScheduler([eng], PagedLLMConfig(max_new_tokens=40))
        await sched.start()
        handle = sched.submit(np.zeros((8,), np.int32))
        while sched.decode_batches < 1:     # request is mid-generation
            await asyncio.sleep(0.005)
        await sched.stop(drain=False)
        assert handle.done()

    asyncio.run(main())
    assert eng.pool.pages_in_use == 0


def test_paged_lifecycle_restart_and_double_start():
    eng = _tiny_engine(32, 12)
    prompt = np.arange(5, dtype=np.int32)
    ref = eng.generate_paged(prompt, max_new_tokens=4)["tokens"]

    async def main():
        sched = PagedLLMScheduler([eng], PagedLLMConfig(max_new_tokens=4))
        await sched.start()
        with pytest.raises(RuntimeError, match="already started"):
            await sched.start()
        out1 = await sched.submit(prompt)
        await sched.stop()
        await sched.stop()                   # idempotent
        with pytest.raises(RuntimeError, match="not running"):
            sched.submit_nowait(prompt)
        async with sched:                    # restart the same instance
            out2 = await sched.submit(prompt)
        return out1, out2

    out1, out2 = asyncio.run(main())
    np.testing.assert_array_equal(out1, ref)
    np.testing.assert_array_equal(out2, ref)
    assert eng.pool.pages_in_use == 0


def test_paged_lifecycle_drain_then_cancel_mid_decode():
    eng = _tiny_engine(64, 20)

    async def main():
        sched = PagedLLMScheduler([eng], PagedLLMConfig(max_new_tokens=30))
        await sched.start()
        fut1 = sched.submit(np.zeros(4, np.int32), max_new_tokens=2).future
        await sched.drain()
        assert fut1.done() and not fut1.cancelled()
        fut2 = sched.submit(np.zeros(8, np.int32)).future
        while sched.decode_batches < 2:      # provably mid-generation
            await asyncio.sleep(0.005)
        await sched.stop(drain=False)
        assert fut2.done()
        if not fut2.cancelled():
            with pytest.raises(RuntimeError, match="stopped before"):
                fut2.result()

    asyncio.run(main())
    assert eng.pool.pages_in_use == 0


def test_scheduler_backpressure_oversized_request():
    eng = _tiny_engine(32, 6)                # 5 allocatable pages
    small = [np.random.RandomState(6 + i).randint(0, 64, 6).astype(np.int32)
             for i in range(3)]
    refs = [eng.generate_paged(p, max_new_tokens=6)["tokens"] for p in small]

    async def main():
        sched = PagedLLMScheduler([eng], PagedLLMConfig(max_new_tokens=6))
        async with sched:
            # 3 x 12 tokens = 3 pages each; the third waits for pages
            handles = [sched.submit(p) for p in small]
            too_big = sched.submit_nowait(np.zeros((26,), np.int32),
                                          max_new_tokens=6)
            outs = await asyncio.gather(*handles)
            with pytest.raises(OutOfPages):
                await too_big
        return sched, outs

    sched, outs = asyncio.run(main())
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)
    assert sched.snapshot()["pools"][0]["pages_in_use"] == 0


def test_failed_request_trips_the_tracer():
    """``Tracer.trip`` is a counter in the port (no flight recorder): a
    request the pool can never hold fails and counts one trip."""
    eng = _tiny_engine(32, 6)
    tracer = Tracer()

    async def main():
        sched = PagedLLMScheduler([eng], PagedLLMConfig(max_new_tokens=6),
                                  tracer=tracer)
        async with sched:
            with pytest.raises(OutOfPages):
                await sched.submit_nowait(np.zeros((26,), np.int32),
                                          max_new_tokens=6)
        return sched

    sched = asyncio.run(main())
    assert tracer.trips == 1
    assert sched.snapshot()["trace"]["trips"] == 1


def test_unported_backend_surfaces_raise():
    backend = InProcessBackend(_tiny_engine(32, 6))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        backend.prefix_digest()


# ---------------------------------------------------------------------------
# Adaptive chunk policy (copies of tests/test_paged_decode.py's)
# ---------------------------------------------------------------------------

class _FakeChunkBackend:
    """capacity()-only stand-in so the adaptive-chunk policy can be
    unit-tested without a device worker loop."""

    def capacity(self):
        return BackendCapacity(decode_batch=4, page_size=4, num_pages=16,
                               free_pages=16)

    def bind_metrics(self, metrics, model_id):
        pass

    def bind_tracer(self, tracer):
        pass


def _policy_sched(tracer=None, **cfg_kw):
    cfg = PagedLLMConfig(prefill_chunk_pages=2, adaptive_chunk=True,
                         min_chunk_pages=1, max_chunk_pages=8,
                         chunk_slack=4.0, **cfg_kw)
    return PagedLLMScheduler(backends=[_FakeChunkBackend()], cfg=cfg,
                             clock=lambda: 0.0, tracer=tracer)


def _join(sched, deadline_t, max_new=10, generated=0):
    req = Request(rid=1, x=None, arrival_t=0.0, deadline_t=deadline_t,
                  params=SamplingParams(max_new_tokens=max_new))
    return sched.slots[0].join(req, SimpleNamespace(tokens=[0] * generated),
                               admit_step=0)


def test_adaptive_chunk_policy_slo_slack():
    sched = _policy_sched()
    assert sched._adaptive_chunk_pages(0) == 8       # nothing decoding
    ent = _join(sched, deadline_t=0.15)
    assert sched._adaptive_chunk_pages(0) == 2       # no itl evidence yet
    for _ in range(8):
        sched.metrics.itl_by_model[0].add(0.010)
    assert sched._adaptive_chunk_pages(0) == 1       # slack 50ms < 80ms
    sched.slots[0].retire(ent)
    _join(sched, deadline_t=1.0)                     # slack 900ms -> ceiling
    assert sched._adaptive_chunk_pages(0) == 8
    ent3 = _join(sched, deadline_t=0.3)              # tightest rules: 200ms
    assert sched._adaptive_chunk_pages(0) == 2       # between -> base
    ent3.seq.tokens.extend([0] * 5)                  # 5 left: slack 250ms
    assert sched._adaptive_chunk_pages(0) == 2


def test_adaptive_chunk_policy_measured_stalls():
    sched = _policy_sched()
    ent = _join(sched, deadline_t=0.3)
    for _ in range(8):
        sched.metrics.itl_by_model[0].add(0.010)
    for _ in range(4):
        sched.metrics.on_chunk_stall(0, 2, 0.010)
    assert sched.metrics.chunk_stall_per_page(0) is None
    assert sched._adaptive_chunk_pages(0) == 2
    sched.metrics.on_chunk_stall(0, 2, 0.010)        # 5th sample
    assert sched.metrics.chunk_stall_per_page(0) == pytest.approx(0.005)
    assert sched._adaptive_chunk_pages(0) == 8       # slack 200 >= 160ms
    sched.slots[0].retire(ent)
    _join(sched, deadline_t=0.2)                     # slack 100ms -> base
    assert sched._adaptive_chunk_pages(0) == 2
    _join(sched, deadline_t=0.13)                    # slack 30ms -> floor
    assert sched._adaptive_chunk_pages(0) == 1
    _join(sched, deadline_t=0.105)                   # nothing fits: floor
    assert sched._adaptive_chunk_pages(0) == 1
    snap = sched.metrics.snapshot()
    assert snap["chunk_stall_page_p90_ms"][0] == pytest.approx(5.0)


def test_chunk_stall_measurement_guards():
    sched = _policy_sched()
    sched.metrics.on_chunk_stall(0, 0, 0.010)        # dropped
    assert len(sched.metrics.chunk_stall_page[0]) == 0
    for _ in range(6):
        sched.metrics.on_chunk_stall(0, 1, 0.0)
    assert sched.metrics.chunk_stall_per_page(0) == 0.0
    _join(sched, deadline_t=1.0)
    for _ in range(8):
        sched.metrics.itl_by_model[0].add(0.010)
    assert sched._adaptive_chunk_pages(0) == 8       # heuristic ceiling


def test_auto_chunk_bounds_follow_stall_distribution():
    sched = _policy_sched(auto_chunk_bounds=True)
    assert sched._chunk_bounds(0) == (1, 8)          # no evidence yet
    for _ in range(8):                               # heavy tail: 20x ratio
        sched.metrics.on_chunk_stall(0, 1, 0.001)
    for _ in range(2):
        sched.metrics.on_chunk_stall(0, 1, 0.020)
    assert sched._chunk_bounds(0) == (1, 2)
    assert sched._adaptive_chunk_pages(0) == 2
    tight = _policy_sched(auto_chunk_bounds=True)
    for _ in range(10):
        tight.metrics.on_chunk_stall(0, 1, 0.010)
    assert tight._chunk_bounds(0) == (2, 8)
    assert tight._adaptive_chunk_pages(0) == 8
    mid = _policy_sched(auto_chunk_bounds=True)
    for _ in range(8):
        mid.metrics.on_chunk_stall(0, 1, 0.010)
    for _ in range(2):
        mid.metrics.on_chunk_stall(0, 1, 0.015)
    assert mid._chunk_bounds(0) == (1, 8)
    fixed = _policy_sched()
    for _ in range(10):
        fixed.metrics.on_chunk_stall(0, 1, 0.001)
    fixed.metrics.on_chunk_stall(0, 1, 0.050)
    assert fixed._chunk_bounds(0) == (1, 8)


def test_auto_chunk_bounds_warmup_covers_single_page():
    class _WarmupRecorder(_FakeChunkBackend):
        def __init__(self):
            self.chunk_tokens = []

        def warmup(self, prompt_lens, chunk_tokens=None):
            self.chunk_tokens.append(chunk_tokens)

    def ladder(auto):
        b = _WarmupRecorder()
        PagedLLMScheduler(
            backends=[b], clock=lambda: 0.0,
            cfg=PagedLLMConfig(prefill_chunk_pages=2, adaptive_chunk=True,
                               min_chunk_pages=2, max_chunk_pages=8,
                               auto_chunk_bounds=auto)).warmup([8])
        return b.chunk_tokens

    assert ladder(auto=False) == [8, 32]             # base + hi (ps=4)
    assert ladder(auto=True) == [8, 4, 32]           # + the 1-page shape


def test_next_chunk_tokens_traces_counter():
    tracer = Tracer()
    sched = _policy_sched(tracer=tracer)
    assert sched._next_chunk_tokens(0) == 8 * 4      # idle -> hi pages
    _join(sched, deadline_t=0.01)
    for _ in range(8):
        sched.metrics.itl_by_model[0].add(0.010)
    assert sched._next_chunk_tokens(0) == 1 * 4      # floor, page_size=4
    counts = [e for e in tracer.events()
              if e[1] == COUNTER and e[2] == "chunk_pages"]
    assert [c[6]["m0"] for c in counts] == [8, 1]
    static = PagedLLMScheduler(backends=[_FakeChunkBackend()],
                               cfg=PagedLLMConfig(prefill_chunk_pages=2),
                               clock=lambda: 0.0)
    assert static._next_chunk_tokens(0) == 2 * 4
    off = PagedLLMScheduler(backends=[_FakeChunkBackend()],
                            cfg=PagedLLMConfig())
    assert off._next_chunk_tokens(0) is None


# ---------------------------------------------------------------------------
# cow_headroom: counted per writer, and admission refuses what it cannot back
# ---------------------------------------------------------------------------

def test_cow_headroom_counts_only_boundary_writers():
    """tests/test_pool_property.py's hypothesis case (num_pages=4: alloc
    1, share, alloc 1, grow, share, share).  After the grow, page p1 is
    interior for the grown sequence A and for the two sequences that
    share A afterwards; only B (which shared it as its boundary page)
    and A's original claim may write it, so it needs one copy, not
    three.  The JAX package's count gives 5 > num_free + pages_in_use;
    the port's gives 3: one for p1, two for A's new boundary page p3
    (three holders write it)."""
    pool = PagePool(num_pages=4, page_size=4)
    a = pool.alloc(1)                                    # alloc 1
    pool.incref(a)                                       # share A -> B
    pool.mark_cow_risk(a[-1])
    pool.alloc(1)                                        # alloc 1 (C)
    a = a + pool.alloc(1)                                # grow A
    for _ in range(2):                                   # share A twice
        pool.incref(a)
        pool.mark_cow_risk(a[-1])
    assert (pool.num_free, pool.pages_in_use) == (0, 3)
    assert pool.refcount(a[0]) == 4 and pool.refcount(a[1]) == 3
    assert pool.cow_headroom == 1 + 2
    assert pool.cow_headroom <= pool.num_free + pool.pages_in_use
    # each writer that copies away lowers the count; nothing leaks
    pool.decref([a[1]])
    assert pool.cow_headroom == 1 + 1
    for _ in range(3):                                   # p1 exclusive
        pool.decref([a[0]])
    assert pool.cow_headroom == 1


def test_admission_refuses_a_share_the_pool_cannot_back():
    """Identical prompts share a partly filled boundary page; each
    sharer may need a copy-on-write page.  With one free page the
    second holder is admitted (its copy fits) and the third is held
    back: need 0 + headroom 1 + its own 1 > 1 free."""
    eng = _tiny_engine(16, 4)                            # 3 allocatable
    backend = InProcessBackend(eng)
    prompt = np.arange(6, dtype=np.int32)                # 2 pages, 6 + 2
    first = eng.prefill_into_pages(prompt, max_new_tokens=2)
    assert backend.admissible(prompt, 2)
    second = eng.prefill_into_pages(prompt, max_new_tokens=2)
    assert eng.pool.pages_in_use == 2 and eng.pool.num_free == 1
    assert eng.pool.cow_headroom == 1
    assert not backend.admissible(prompt, 2)
    for seq in (first, second):
        while not seq.done:
            eng.decode_step_batch([seq])
        eng.pool.release(seq)
    assert eng.pool.pages_in_use == 0 and eng.pool.cow_headroom == 0
