"""The engine's decode steps as the port runs them since they became
CUDA graphs on the card (engine-owned ring / Mamba caches reused across
``generate`` calls, one operand a paged step, the copy-on-write inside
the step), against the JAX engine on the CPU.

* Two ``Engine.generate`` calls on one port engine, the second with a
  shorter prompt, each give the JAX engine's greedy tokens, on an
  attention arch and a Mamba arch; after the second prefill the reused
  caches hold what fresh ones would (no ring position or Mamba
  state of the first request survives).
* A paged step in which one row copies on write, another maps the same
  shared page without copying and one row is inactive gives the JAX
  engine's tokens, copy count and drained pool.
* Stop tokens, through ``Engine.generate_paged`` and through
  ``PagedLLMScheduler``, in both packages: the same tokens and finish
  reasons, with a stop token taken from the JAX run's own greedy output.
* On the CPU the engine builds no graph and makes no ``torch.cuda``
  call; ``CudaGraphed.capture`` refuses CPU and meta tensors.
"""
import asyncio
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import LayerSpec, ModelConfig
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.scheduler import PagedLLMConfig as JaxPagedLLMConfig
from repro.serving.scheduler import PagedLLMScheduler as JaxScheduler
from repro.serving.scheduler import SamplingParams as JaxSamplingParams
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LayerSpec as TLayerSpec
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.graphs import CudaGraphed
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.scheduler import (PagedLLMConfig,
                                           PagedLLMScheduler, SamplingParams)

MAX_LEN = 24
TINY = dict(name="tiny-graph", arch_type="dense", num_layers=2, d_model=32,
            d_ff=64, vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8,
            compute_dtype="float32", param_dtype="float32",
            kv_cache_dtype="float32")


@functools.lru_cache(maxsize=None)
def _ring_models(arch):
    """(JAX engine, port engine) over one set of fp32 smoke weights."""
    jcfg = jax_smoke_config(arch).with_(compute_dtype="float32")
    tcfg = get_smoke_config(arch).with_(compute_dtype="float32")
    jparams = jax.jit(functools.partial(jtf.init_params, jcfg))(
        jax.random.key(3))
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    return (JaxEngine(jcfg, jparams, JaxServeConfig(max_len=MAX_LEN)),
            Engine(tcfg, tparams, ServeConfig(max_len=MAX_LEN), device="cpu"))


@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b"])
def test_generate_reuses_its_caches_like_fresh_ones(arch):
    """Greedy tokens equal to the JAX engine's on both calls (exact);
    the caches after the second prefill equal a fresh prefill's
    (bitwise: the same ops on the same inputs)."""
    jeng, teng = _ring_models(arch)
    rs = np.random.RandomState(4)
    vocab = teng.cfg.vocab_size
    for p, n in ((11, 7), (5, 6)):
        prompts = rs.randint(0, vocab, (2, p)).astype(np.int32)
        want = np.asarray(jeng.generate(prompts, max_new_tokens=n)["tokens"])
        got = teng.generate(prompts, max_new_tokens=n)["tokens"].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{arch} P={p}")
    assert list(teng._rings) == [2]          # one set, reused
    caches = teng._rings[2].caches
    toks = torch.from_numpy(rs.randint(0, vocab, (2, 3)).astype(np.int32))
    ttf.prefill(teng.params, teng.cfg, toks, caches=caches)
    _, fresh = ttf.prefill(teng.params, teng.cfg, toks, cache_len=MAX_LEN)
    for name, layer in fresh.items():
        for leaf, want in layer.items():
            got = caches[name][leaf]
            if leaf in ("k", "v"):           # only the prompt's slots count
                got, want = got[:, :, :3], want[:, :, :3]
            assert torch.equal(got, want), f"{arch} {name}/{leaf}"


@functools.lru_cache(maxsize=None)
def _tiny_params():
    jcfg = ModelConfig(pattern=(LayerSpec(),), **TINY)
    params = jax.jit(functools.partial(jtf.init_params, jcfg))(
        jax.random.key(0))
    return jcfg, params, convert.to_torch(jax.tree.map(np.asarray, params),
                                          "cpu")


@pytest.fixture(scope="module")
def paged_engines():
    """A JAX and a port paged engine over the same tiny weights, shared
    by the tests below (each hands back every page it takes), so that
    the JAX side compiles each step once."""
    jcfg, params, tparams = _tiny_params()
    je = JaxEngine(jcfg, params, JaxServeConfig(max_len=32))
    te = Engine(TModelConfig(pattern=(TLayerSpec(),), **TINY), tparams,
                ServeConfig(max_len=32), device="cpu")
    for e in (je, te):
        e.init_paged(num_pages=40, page_size=4, decode_batch=4)
    return je, te


def _cow_trace(engine):
    """A and B = A's prompt (10 tokens: B maps A's partly filled
    boundary page), C another prompt (as long, so that it pads to A's
    prefill shape); one batch of three rows (the
    fourth inactive) until all are done.  The first step copies the
    boundary page for A and leaves B on the original."""
    rs = np.random.RandomState(12)
    pa = rs.randint(0, 64, 10).astype(np.int32)
    pc = rs.randint(0, 64, 11).astype(np.int32)
    before = engine.cow_count
    seqs = [engine.prefill_into_pages(p, max_new_tokens=5)
            for p in (pa, pa, pc)]
    engine.decode_step_batch(seqs)
    first_cows = engine.cow_count - before
    while not all(s.done for s in seqs):
        engine.decode_step_batch([s for s in seqs if not s.done])
    for s in seqs:
        engine.pool.release(s)
    return [list(s.tokens) for s in seqs], first_cows, \
        engine.cow_count - before


def test_paged_step_with_one_copy_on_write_matches_jax(paged_engines):
    je, te = paged_engines
    want, got = _cow_trace(je), _cow_trace(te)
    assert got == want
    assert got[1:] == (1, 1)                 # one copy, in the first step
    assert te.pool.pages_in_use == je.pool.pages_in_use == 0


def _stop_token(ref, prompt_len):
    """A token of the greedy output whose first occurrence comes after
    the first generated token, so that a run with it stops early."""
    gen = [int(t) for t in ref[prompt_len:]]
    for k, t in enumerate(gen):
        if k > 0 and t not in gen[:k]:
            return t
    raise AssertionError(f"every generated token repeats the first: {gen}")


async def _stream(sched, prompt, params):
    async with sched:
        handle = sched.submit(prompt, params)
        evs = [ev async for ev in handle]
        out = await handle
    return np.asarray(out), evs[-1].finish_reason


@pytest.mark.parametrize("path", ["generate_paged", "scheduler"])
def test_stop_tokens_match_jax(paged_engines, path):
    je, te = paged_engines
    prompt = np.random.RandomState(7).randint(0, 64, 7).astype(np.int32)
    ref = je.generate_paged(prompt, max_new_tokens=10)["tokens"]
    stop = _stop_token(ref, len(prompt))
    runs = []
    for eng, sched_cls, cfg_cls, params_cls in (
            (je, JaxScheduler, JaxPagedLLMConfig, JaxSamplingParams),
            (te, PagedLLMScheduler, PagedLLMConfig, SamplingParams)):
        if path == "generate_paged":
            r = eng.generate_paged(prompt, max_new_tokens=10,
                                   stop_tokens=(stop,))
            runs.append((np.asarray(r["tokens"]), r["finish_reason"]))
        else:
            runs.append(asyncio.run(_stream(
                sched_cls([eng], cfg_cls()), prompt,
                params_cls(max_new_tokens=10, stop_tokens=(stop,),
                           stream=True))))
        assert eng.pool.pages_in_use == 0
    (want, want_reason), (got, got_reason) = runs
    np.testing.assert_array_equal(got, want)
    assert got_reason == want_reason == "stop"
    assert len(prompt) + 1 < len(got) < len(ref)     # it stopped early
    assert int(got[-1]) == stop


def test_cpu_engine_builds_no_graph(monkeypatch):
    """Ring and paged steps run on the CPU with every CUDA-graph and
    ``torch.cuda`` entry the engine could reach made to raise."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA call on the CPU path")

    class NoGraph:
        __init__ = refuse

    monkeypatch.setattr(tengine, "CudaGraphed", NoGraph)
    for name in ("synchronize", "graph", "CUDAGraph", "Stream", "Event",
                 "current_stream", "device", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    cfg = TModelConfig(pattern=(TLayerSpec(),), **TINY)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
    out = eng.generate(np.zeros((2, 5), np.int32), max_new_tokens=3)
    assert tuple(out["tokens"].shape) == (2, 8)
    eng.init_paged(num_pages=16, page_size=4, decode_batch=2)
    assert eng.capture_decode_steps() == {} and eng.capture_s == {}
    seq = eng.prefill_into_pages(np.arange(6, dtype=np.int32),
                                 max_new_tokens=3)
    while not seq.done:
        eng.decode_step_batch([seq])
    eng.pool.release(seq)
    assert len(seq.tokens) == 3 and eng.pool.pages_in_use == 0


def test_graph_capture_takes_cuda_tensors_only():
    """``CudaGraphed.capture`` (the engine's capture before traffic)
    refuses what its replay refuses: no capture and no eager run."""
    ran = []
    graphed = CudaGraphed(lambda t: ran.append(t) or t, "step")
    for dev in ("meta", "cpu"):
        with pytest.raises((RuntimeError, ValueError)):
            graphed.capture(torch.zeros((2, 3), device=dev))
    assert not graphed._graphs and not ran


def test_capture_holds_the_garbage_collector_off(monkeypatch):
    """The captured call runs with Python's collector off (a collection
    there can tear down another graph, which a capturing stream forbids)
    and the collector is on again after it, also when the capture
    raises; the warm-up runs with it on.  The CUDA graph API is stubbed:
    there is no card here."""
    import contextlib
    import gc

    seen = []

    @contextlib.contextmanager
    def fake_graph(graph, **kw):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)

    def step(t):
        seen.append(gc.isenabled())
        if len(seen) == 4:
            raise RuntimeError("capture failed")
        return t + 1

    graphed = CudaGraphed(step, "step")
    assert gc.isenabled()
    args = (torch.zeros(3),)
    graphed._capture(("sig",), args)
    assert seen == [True, False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphed._capture(("other",), args)
    assert seen == [True, False, True, False] and gc.isenabled()


def test_overlapping_captures_keep_the_collector_off(monkeypatch):
    """Two captures that overlap, on two threads, share the collector's
    hold: when the one that began first ends, the collector stays off
    while the other still captures, and it is on again only after the
    last ends.  One capture inside another does the same, and a
    collector that was off before stays off.  The CUDA graph API is
    stubbed: there is no card here."""
    import contextlib
    import gc
    import threading

    @contextlib.contextmanager
    def fake_graph(graph, **kw):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    args = (torch.zeros(3),)

    def held(inside, go):
        calls = []

        def fn(t):
            calls.append(1)
            if len(calls) == 2:          # the capture, not the warm-up
                inside.set()
                assert go.wait(10)
            return t + 1
        return fn

    ev = {n: (threading.Event(), threading.Event()) for n in "xy"}
    threads = {n: threading.Thread(target=CudaGraphed(held(*ev[n]), n)
                                   ._capture, args=((n,), args))
               for n in "xy"}
    assert gc.isenabled()
    try:
        threads["x"].start()
        assert ev["x"][0].wait(10) and not gc.isenabled()
        threads["y"].start()
        assert ev["y"][0].wait(10)
        ev["x"][1].set()                 # the first to begin ends first
        threads["x"].join(10)
        assert not threads["x"].is_alive()
        assert not gc.isenabled()        # y still captures
        ev["y"][1].set()
        threads["y"].join(10)
        assert not threads["y"].is_alive() and gc.isenabled()
    finally:
        for inside, go in ev.values():
            go.set()

    inner = CudaGraphed(lambda t: t + 2, "inner")
    states = []

    def outer_fn(t):
        inner._capture((len(states),), (t,))
        states.append(gc.isenabled())
        return t

    CudaGraphed(outer_fn, "outer")._capture(("o",), args)
    assert states == [True, False] and gc.isenabled()
    gc.disable()
    try:
        CudaGraphed(lambda t: t + 3, "off")._capture(("off",), args)
        assert not gc.isenabled()
    finally:
        gc.enable()
