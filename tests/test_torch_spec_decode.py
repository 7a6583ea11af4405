"""Speculative multiplexed decoding in the port against the JAX
package's, and against the port's own plain greedy decode.

* ``transformer.verify_paged``: logits for every fed position and the
  pools it writes, rows at different ``q_offset``, against JAX's over
  full / swa / chunked / gqa_mixed / mla layers on fp32 pools (1e-4),
  and on olmoe's smoke model with a capacity of 1 a (row, expert), the
  full-size olmoe's at S = 5, so the verify step drops assignments that
  dropless decode keeps, as the reference's does.
* ``Engine.verify_step_batch`` picks (exact) and ``Engine.rollback_pages``
  freed counts, page lists and block tables (exact) against the JAX
  engine's on the same pool state; the pools after the verify to 1e-5.
* Lazy decode allocation: pages in use after every decode step, the
  admission cost and the ``OutOfPages`` of a sequence that cannot grow
  (``grow_seq``), against the JAX engine's.
* The in-process rows of the JAX package's matrix
  (``tests/test_spec_decode.py``), same and diverse drafter: the port's
  spec tokens equal its plain ``generate_paged`` tokens (exact, the
  reference's claim, torch against torch), and ``draft_tokens``,
  ``accepted_tokens``, ``spec_fallbacks``, ``verify_rounds`` and the
  tokens equal the JAX ``SpeculativeBackend``'s; both pools drained.
* The acceptance-EMA fallback and the k = 0 path, as the JAX tests.
* ``PagedLLMScheduler`` over a ``SpeculativeBackend`` with
  ``lazy_decode_alloc=True`` pushed down; a lazily grown sequence that
  finds no page fails alone.
"""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_paged_decode import tiny_config
from test_spec_decode import (DRAFT_K, MATRIX, MAX_LEN, MAX_NEW, drive,
                              make_spec, prompts_for)

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.kv_cache import OutOfPages as JaxOutOfPages
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import transformer as ttf
from repro_torch.serving.backend import InProcessBackend
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.observability import Tracer
from repro_torch.serving.observability.tracer import COUNTER, SPAN
from repro_torch.serving.scheduler import PagedLLMConfig, PagedLLMScheduler
from repro_torch.serving.spec_decode import SpeculativeBackend

LOGIT_TOL = dict(atol=1e-4, rtol=0)
POOL_TOL = dict(atol=1e-5, rtol=0)
COUNTERS = ("draft_tokens", "accepted_tokens", "spec_fallbacks",
            "verify_rounds")


def port_config(jcfg) -> ModelConfig:
    """The port's copy of a JAX ``ModelConfig``, field by field."""
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["pattern"] = tuple(LayerSpec(**vars(s)) for s in jcfg.pattern)
    return ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _params(variant: str, kv: str, seed: int):
    """(JAX cfg, port cfg, JAX params, port params) of ``tiny_config``:
    the port's initialiser, carried to JAX through numpy (fp32, exact)."""
    jcfg = tiny_config(variant, kv_cache_dtype=kv)
    tcfg = port_config(jcfg)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(tp))
    return jcfg, tcfg, jp, tp


def port_engine(tcfg, params, *, lazy=False, max_len=MAX_LEN, pages=60,
                span_reclaim=None, decode_batch=4):
    eng = Engine(tcfg, params, ServeConfig(max_len=max_len), device="cpu")
    eng.init_paged(num_pages=pages, page_size=4, decode_batch=decode_batch,
                   span_reclaim=(not lazy if span_reclaim is None
                                 else span_reclaim),
                   lazy_decode_alloc=lazy)
    return eng


def jax_engine(jcfg, params, *, lazy=False, max_len=MAX_LEN, pages=60,
               span_reclaim=None, decode_batch=4):
    eng = JaxEngine(jcfg, params, JaxServeConfig(max_len=max_len))
    eng.init_paged(num_pages=pages, page_size=4, decode_batch=decode_batch,
                   span_reclaim=(not lazy if span_reclaim is None
                                 else span_reclaim),
                   lazy_decode_alloc=lazy)
    return eng


def port_spec(tcfg, params, dparams, **spec_kw):
    """The port's counterpart of ``test_spec_decode.make_spec(...,
    "inproc")``: the same pools, page size, batch and draft length."""
    draft = port_engine(tcfg, dparams, lazy=True, max_len=MAX_LEN + 16,
                        pages=80)
    spec_kw.setdefault("draft_k", DRAFT_K)
    return SpeculativeBackend(InProcessBackend(port_engine(tcfg, params)),
                              draft, **spec_kw)


@functools.lru_cache(maxsize=None)
def plain_refs(variant: str, kv: str):
    """The port's plain greedy ``generate_paged`` tokens of
    ``prompts_for``'s prompts on the seed-0 weights."""
    jcfg, tcfg, _, tp = _params(variant, kv, 0)
    eng = port_engine(tcfg, tp)
    return [list(eng.generate_paged(p, max_new_tokens=MAX_NEW)["tokens"]
                 [len(p):]) for p in prompts_for(jcfg)]


def assert_drained(spec):
    stats = spec.stats()
    assert stats["draft_pool"]["pages_in_use"] == 0, stats
    assert stats["pool"]["pages_in_use"] == 0, stats


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# (a) verify_paged
# ---------------------------------------------------------------------------

def _random_pools(jcfg, tcfg, num_pages, ps, rng):
    """The same random pools in both packages (int8 pools not used)."""
    tc = ttf.init_caches(tcfg, num_pages=num_pages, page_size=ps,
                         device="cpu")
    for layer in tc.values():
        for leaf in layer.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    jc = jax.tree.map(jnp.asarray, convert.to_numpy(tc))
    return jc, tc


def _verify_both(jcfg, tcfg, jp, tp, *, b=3, s=DRAFT_K + 1, ps=4, m=6,
                 q_offset=(5, 13, 0), seed=0):
    """verify_paged on identical inputs in both packages: rows at
    different q_offset over distinct pages, the last row's table all
    scratch.  Returns (JAX logits, port logits, JAX pools, port pools)."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * m
    jc, tc = _random_pools(jcfg, tcfg, num_pages, ps, rng)
    bt = (1 + np.arange(b * m, dtype=np.int32)).reshape(b, m)
    bt[-1] = 0
    tokens = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    q_off = np.asarray(q_offset[:b], np.int32)
    jl, jc = jtf.verify_paged(jp, jcfg, jnp.asarray(tokens), jc,
                              jnp.asarray(bt), jnp.asarray(q_off))
    tl, tc = ttf.verify_paged(tp, tcfg, torch.from_numpy(tokens), tc,
                              torch.from_numpy(bt), torch.from_numpy(q_off))
    return jl, tl, jc, tc


@pytest.mark.parametrize("variant",
                         ["full", "swa", "chunked", "gqa_mixed", "mla"])
def test_verify_paged_matches_jax(variant):
    """Logits (B, S, V) for every fed position and every pool leaf,
    fp32 pools; row 2 sits at q_offset 0 on scratch pages only."""
    jcfg, tcfg, jp, tp = _params(variant, "float32", 0)
    jl, tl, jc, tc = _verify_both(jcfg, tcfg, jp, tp)
    assert tuple(tl.shape) == (3, DRAFT_K + 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    for name, layer in tc.items():
        for leaf, got in layer.items():
            np.testing.assert_allclose(got.numpy(), _np(jc[name][leaf]),
                                       **POOL_TOL, err_msg=f"{name}/{leaf}")


def test_verify_paged_moe_capacity_drops_match_jax():
    """olmoe's smoke model at capacity 1 a (row, expert) over S = 5
    tokens (``max(1, int(0.2 * 5 * 2 / 4))``, what the full-size olmoe
    gets from 64 experts, top-8, factor 1.25): logits against JAX's,
    and the drops are real (the same tokens teacher-forced through
    dropless decode steps give other logits)."""
    kw = dict(compute_dtype="float32", param_dtype="float32",
              kv_cache_dtype="float32", capacity_factor=0.2)
    jcfg = jax_smoke_config("olmoe-1b-7b").with_(**kw)
    tcfg = get_smoke_config("olmoe-1b-7b").with_(**kw)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(1),
                         device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(tp))
    jl, tl, _, _ = _verify_both(jcfg, tcfg, jp, tp, b=2, s=5, m=4,
                                q_offset=(3, 9), ps=4, seed=2)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    # row 0 through dropless decode steps on the same pools
    rng = np.random.default_rng(2)
    _, tc = _random_pools(jcfg, tcfg, 1 + 2 * 4, 4, rng)
    bt = (1 + np.arange(8, dtype=np.int32)).reshape(2, 4)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    steps = [ttf.decode_step(tp, tcfg, torch.from_numpy(tokens[:, j:j + 1]),
                             tc, torch.tensor([3 + j, 9 + j]),
                             block_tables=torch.from_numpy(bt))[0][:, 0]
             for j in range(5)]
    dropless = torch.stack(steps, 1)
    assert (dropless[0] - tl[0]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# (b) verify_step_batch and rollback_pages against the JAX engine
# ---------------------------------------------------------------------------

def _admit_both(jeng, teng, prompts, max_new):
    """The same requests admitted into both engines, then two decode
    steps; returns (JAX seqs, port seqs)."""
    js = [jeng.prefill_into_pages(p, max_new_tokens=max_new) for p in prompts]
    ts = [teng.prefill_into_pages(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(2):
        jeng.decode_step_batch(js)
        teng.decode_step_batch(ts)
    for j, t in zip(js, ts):
        assert t.tokens == j.tokens and t.pages == j.pages
    return js, ts


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_verify_step_batch_and_rollback_match_jax(kv):
    """Rows of 3, 1 and 0 drafts at width 4 (one row fed the JAX
    engine's own greedy continuation, so its drafts all match): picks
    exact, pools after the step to 1e-5 (int8 values exact, scales to
    1e-5); then ``rollback_pages`` back to each row's next position:
    freed counts, page lists, block tables and pages in use exact."""
    jcfg, tcfg, jp, tp = _params("full", kv, 0)
    jeng, teng = jax_engine(jcfg, jp, pages=40), port_engine(tcfg, tp,
                                                             pages=40)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 64, n).astype(np.int32) for n in (5, 9, 6)]
    js, ts = _admit_both(jeng, teng, prompts, 12)
    # row 0's drafts: its greedy continuation, from a scratch copy
    ref = jeng.generate_paged(np.concatenate([prompts[0], js[0].tokens]),
                              max_new_tokens=3)["tokens"][-3:]
    drafts = [list(map(int, ref)), [int(rs.randint(0, 64))], []]
    want = jeng.verify_step_batch(list(zip(js, drafts)), width=4)
    got = teng.verify_step_batch(list(zip(ts, drafts)), width=4)
    for w, g, d in zip(want, got, drafts):
        assert g.dtype == np.int32 and len(g) == len(d) + 1
        np.testing.assert_array_equal(g, np.asarray(w))
    if kv == "float32":        # an int8 pool's verify reads quantised K/V
        assert list(got[0][:3]) == drafts[0]
    # the pages the rows hold (free pages and scratch hold garbage, and
    # the JAX engine's continuation above wrote some of them)
    live = sorted({pg for t in ts for pg in t.pages})
    tc = convert.to_numpy(teng._paged_caches)
    for name, layer in tc.items():
        for leaf, g in layer.items():
            np.testing.assert_allclose(
                g[:, live], _np(jeng._paged_caches[name][leaf])[:, live],
                **POOL_TOL, err_msg=f"{name}/{leaf}")
    for j, t in zip(js, ts):
        nj = jeng.rollback_pages(j, j.pos + 1)
        nt = teng.rollback_pages(t, t.pos + 1)
        assert nt == nj > 0
        assert t.pages == j.pages
        np.testing.assert_array_equal(t.block_table, j.block_table)
        assert teng.pool.pages_in_use == jeng.pool.pages_in_use
    assert teng.rollback_pages(ts[0], ts[0].pos + 1) == 0
    for j, t in zip(js, ts):
        jeng.pool.release(j)
        teng.pool.release(t)
    assert teng.pool.pages_in_use == jeng.pool.pages_in_use == 0


def test_failed_verify_step_poisons_the_caches():
    """A verify step that fails on the device marks the pool poisoned,
    as a failed decode step does: the backend then reports unhealthy."""
    _, tcfg, _, tp = _params("full", "float32", 0)
    eng = port_engine(tcfg, tp)
    seq = eng.prefill_into_pages(np.arange(5, dtype=np.int32),
                                 max_new_tokens=4)

    def fail(packed):
        raise RuntimeError("device fault")
    eng._paged_verify = fail
    with pytest.raises(RuntimeError, match="device fault"):
        eng.verify_step_batch([(seq, [1, 2])], width=3)
    assert eng.caches_poisoned and not InProcessBackend(eng).healthy


# ---------------------------------------------------------------------------
# (c) lazy decode allocation against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,span_reclaim",
                         [("full", False), ("swa", True)])
def test_lazy_decode_alloc_pages_match_jax(variant, span_reclaim):
    """Two requests sealed with prompt + 1 tokens of pages, decoded 9
    steps together: pages in use and each page list equal the JAX
    engine's after every step (with swa's span reclaim freeing pages
    behind); the admission cost follows ``set_lazy_decode_alloc``."""
    jcfg, tcfg, jp, tp = _params(variant, "float32", 0)
    kw = dict(lazy=True, span_reclaim=span_reclaim, pages=30)
    jeng, teng = jax_engine(jcfg, jp, **kw), port_engine(tcfg, tp, **kw)
    prompts = [np.arange(7, dtype=np.int32), np.arange(3, 12, dtype=np.int32)]
    for flag in (False, True):
        for e in (jeng, teng):
            e.set_lazy_decode_alloc(flag)
        assert (teng.admission_page_cost(prompts[0], 10)
                == jeng.admission_page_cost(prompts[0], 10))
    js = [jeng.prefill_into_pages(p, max_new_tokens=10) for p in prompts]
    ts = [teng.prefill_into_pages(p, max_new_tokens=10) for p in prompts]
    assert teng.pool.pages_in_use == jeng.pool.pages_in_use == 2 + 3
    for _ in range(9):
        jeng.decode_step_batch(js)
        teng.decode_step_batch(ts)
        assert teng.pool.pages_in_use == jeng.pool.pages_in_use
        for j, t in zip(js, ts):
            assert t.pages == j.pages and t.tokens == j.tokens
    assert [len(t.pages) for t in ts] == [4, 5]     # grown page by page
    for j, t in zip(js, ts):
        jeng.pool.release(j)
        teng.pool.release(t)
    assert teng.pool.pages_in_use == 0


def test_lazy_growth_out_of_pages_tags_the_sequence():
    """A pool too small for both requests' growth: the decode step that
    cannot grow raises OutOfPages at the same step in both packages,
    tagged with the starving sequence (``grow_seq``), before any device
    work: no token appended, pages in use as JAX's."""
    jcfg, tcfg, jp, tp = _params("full", "float32", 0)
    jeng = jax_engine(jcfg, jp, lazy=True, pages=8)
    teng = port_engine(tcfg, tp, lazy=True, pages=8)
    prompts = [np.arange(7, dtype=np.int32), np.arange(5, 12, dtype=np.int32)]
    js = [jeng.prefill_into_pages(p, max_new_tokens=20) for p in prompts]
    ts = [teng.prefill_into_pages(p, max_new_tokens=20) for p in prompts]
    steps = {}
    for name, eng, seqs, exc_type in (("jax", jeng, js, JaxOutOfPages),
                                      ("port", teng, ts, OutOfPages)):
        for step in range(20):
            before = [len(s.tokens) for s in seqs]
            try:
                eng.decode_step_batch(seqs)
            except exc_type as exc:
                steps[name] = (step, seqs.index(exc.grow_seq),
                               eng.pool.pages_in_use)
                assert [len(s.tokens) for s in seqs] == before
                break
    assert steps["port"] == steps["jax"]
    assert not teng.caches_poisoned


# ---------------------------------------------------------------------------
# (d) the in-process rows of the JAX matrix
# ---------------------------------------------------------------------------

INPROC = [row for row in MATRIX if row[2] == "inproc"]


@pytest.mark.parametrize("variant,kv_dtype,backend_kind,drafter", INPROC,
                         ids=[f"{v}-{d}-{b}-{dr}" for v, d, b, dr in INPROC])
def test_spec_decode_parity(variant, kv_dtype, backend_kind, drafter):
    jcfg, tcfg, jp, tp = _params(variant, kv_dtype, 0)
    dseed = 0 if drafter == "same" else 7
    _, _, jdp, tdp = _params(variant, kv_dtype, dseed)
    prompts = prompts_for(jcfg)
    spec = port_spec(tcfg, tp, tdp)
    outs = asyncio.run(drive(spec, prompts))
    assert outs == plain_refs(variant, kv_dtype)     # the plain stream
    _, jspec = make_spec(jcfg, jp, jdp, "inproc")
    assert asyncio.run(drive(jspec, prompts)) == outs
    got, want = spec.stats(), jspec.stats()
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["draft_tokens"] > 0
    if drafter == "same":
        assert got["accepted_tokens"] == got["draft_tokens"]
    else:
        assert got["accepted_tokens"] < got["draft_tokens"]
    assert (got["draft_pool"]["peak_pages_in_use"]
            == want["draft_pool"]["peak_pages_in_use"])
    assert_drained(spec)


# ---------------------------------------------------------------------------
# (e) the acceptance-EMA fallback and the k = 0 path
# ---------------------------------------------------------------------------

def test_acceptance_ema_fallback():
    """An independent drafter whose tokens keep rejecting trips the EMA
    floor and falls back to plain decode, releasing its draft cache,
    while the stream stays the plain one."""
    jcfg, tcfg, _, tp = _params("full", "float32", 0)
    _, _, _, tdp = _params("full", "float32", 9)
    prompts = prompts_for(jcfg)
    spec = port_spec(tcfg, tp, tdp, ema_alpha=0.9, ema_floor=0.9)
    assert asyncio.run(drive(spec, prompts)) == plain_refs("full", "float32")
    stats = spec.stats()
    assert stats["spec_fallbacks"] == len(prompts)
    assert stats["accepted_tokens"] < stats["draft_tokens"]
    assert not spec._states or all(st.dseq is None
                                   for st in spec._states.values())
    assert_drained(spec)


def test_k0_degenerate_plain_decode():
    """k = 0 (a probe-routed hard input) never drafts: plain decode from
    the first sweep, no draft page ever held, no fallback counted."""
    jcfg, tcfg, _, tp = _params("full", "float32", 0)
    prompts = prompts_for(jcfg)
    spec = port_spec(tcfg, tp, tp, k_fn=lambda prompt: 0)
    assert asyncio.run(drive(spec, prompts)) == plain_refs("full", "float32")
    stats = spec.stats()
    assert stats["draft_tokens"] == stats["verify_rounds"] == 0
    assert stats["spec_fallbacks"] == 0
    assert stats["draft_pool"]["peak_pages_in_use"] == 0
    assert_drained(spec)


def test_constructor_checks():
    """The reference's refusals: no verify surface, no draft pool, a
    draft length under 1, a smaller draft batch, a draft cache shorter
    than the target's max_len + draft_k."""
    _, tcfg, _, tp = _params("full", "float32", 0)
    target = InProcessBackend(port_engine(tcfg, tp))
    draft = port_engine(tcfg, tp, lazy=True, max_len=MAX_LEN + 16)
    with pytest.raises(ValueError, match="verify surface"):
        SpeculativeBackend(SpeculativeBackend(target, draft), draft)
    with pytest.raises(ValueError, match="paged pool"):
        SpeculativeBackend(target, Engine(tcfg, tp, ServeConfig(),
                                          device="cpu"))
    with pytest.raises(ValueError, match="draft_k"):
        SpeculativeBackend(target, draft, draft_k=0)
    with pytest.raises(ValueError, match="decode_batch"):
        SpeculativeBackend(target, port_engine(tcfg, tp, lazy=True,
                                               max_len=MAX_LEN + 16,
                                               decode_batch=2))
    with pytest.raises(ValueError, match="max_len"):
        SpeculativeBackend(target, draft, draft_k=17)


# ---------------------------------------------------------------------------
# (f) PagedLLMScheduler over a SpeculativeBackend
# ---------------------------------------------------------------------------

def _serve(backend, prompts, cfg, tracer=None):
    async def main():
        sched = PagedLLMScheduler(backends=[backend], cfg=cfg, tracer=tracer)
        sched.warmup(sorted({len(p) for p in prompts}))
        async with sched:
            outs = await asyncio.gather(*[sched.submit(p) for p in prompts])
        return sched, [list(np.asarray(o)[len(p):])
                       for p, o in zip(prompts, outs)]
    return asyncio.run(main())


def test_scheduler_over_spec_backend_lazy_pushed_down():
    """``PagedLLMConfig(lazy_decode_alloc=True)`` reaches a plain
    backend's engine, and through a ``SpeculativeBackend`` its target
    too (the reference's spec backend forwards nothing: its draft
    engine is lazy by construction).  Tokens equal the plain greedy
    stream; the snapshot has the spec counters (zeros on a plain
    backend); every pool drains; the trace has the DRAFT and VERIFY
    spans and the accept_rate counter."""
    jcfg, tcfg, _, tp = _params("full", "float32", 0)
    prompts = prompts_for(jcfg)
    cfg = PagedLLMConfig(max_new_tokens=MAX_NEW, lazy_decode_alloc=True)
    plain = InProcessBackend(port_engine(tcfg, tp))
    psched, pouts = _serve(plain, prompts, cfg)
    assert plain.engine._lazy_decode_alloc
    spec = port_spec(tcfg, tp, tp)
    tracer = Tracer()
    ssched, souts = _serve(spec, prompts, cfg, tracer)
    names = {(ph, name) for _, ph, name, *_ in tracer.events()}
    assert {(SPAN, "DRAFT"), (SPAN, "VERIFY"),
            (COUNTER, "accept_rate")} <= names
    assert pouts == souts == plain_refs("full", "float32")
    psnap, ssnap = psched.snapshot(), ssched.snapshot()
    for key in ("draft_tokens", "accepted_tokens", "spec_fallbacks"):
        assert psnap[key] == 0 and key in ssnap
    assert ssnap["draft_tokens"] > 0
    assert ssnap["accepted_tokens"] == ssnap["draft_tokens"]
    assert ssnap["completed"] == len(prompts) and ssnap["failed"] == 0
    assert ssnap["tokens_generated"] == psnap["tokens_generated"]
    assert ssnap["decode_batches"] < psnap["decode_batches"]
    assert ssnap["pool_pages_in_use"] == psnap["pool_pages_in_use"] == 0
    assert_drained(spec)


def test_scheduler_fails_a_starving_lazy_sequence_alone():
    """Lazy allocation admits both requests on prompt pages alone; when
    decode cannot grow one of them, the scheduler fails that request
    (``grow_seq``) and the other completes with the plain tokens."""
    _, tcfg, _, tp = _params("full", "float32", 0)
    prompts = [np.arange(7, dtype=np.int32), np.arange(5, 12, dtype=np.int32)]
    want = port_engine(tcfg, tp).generate_paged(
        prompts[0], max_new_tokens=20)["tokens"][7:]
    backend = InProcessBackend(port_engine(tcfg, tp, pages=10))

    async def main():
        sched = PagedLLMScheduler(
            backends=[backend],
            cfg=PagedLLMConfig(max_new_tokens=20, lazy_decode_alloc=True))
        async with sched:
            outs = await asyncio.gather(*[sched.submit(p) for p in prompts],
                                        return_exceptions=True)
        return sched, outs
    sched, outs = asyncio.run(main())
    assert isinstance(outs[1], OutOfPages)
    np.testing.assert_array_equal(np.asarray(outs[0])[7:], want)
    snap = sched.snapshot()
    assert snap["completed"] == 1 and snap["failed"] == 1
    assert backend.healthy and backend.engine.pool.pages_in_use == 0
