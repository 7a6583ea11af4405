"""The port's paged Engine against the JAX package's, and against
itself.

* Greedy ``generate_paged`` tokens are identical to the JAX Engine's
  with prefix sharing on and off, on a trace where a resident sequence
  shares a page-aligned prefix with one request and its whole prompt
  with another (the boundary page then needs a copy-on-write).
* Within the port: a mixed-length ``decode_step_batch`` gives each
  request the tokens of its solo ``generate_paged``, greedy and
  sampled, and the pool drains to zero pages held.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import LayerSpec, ModelConfig
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs.base import LayerSpec as TLayerSpec
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.serving.engine import Engine, ServeConfig

CFG_KW = dict(name="tiny-engine", arch_type="dense", num_layers=2,
              d_model=32, d_ff=64, vocab_size=64, num_heads=4,
              num_kv_heads=2, head_dim=8, compute_dtype="float32",
              param_dtype="float32", kv_cache_dtype="float32")


def _engines(prefix_sharing: bool, max_len: int = 48):
    jcfg = ModelConfig(pattern=(LayerSpec(),), **CFG_KW)
    tcfg = TModelConfig(pattern=(TLayerSpec(),), **CFG_KW)
    params = jtf.init_params(jcfg, jax.random.key(0))
    tparams = convert.to_torch(jax.tree.map(np.asarray, params), "cpu")
    je = JaxEngine(jcfg, params, JaxServeConfig(max_len=max_len))
    te = Engine(tcfg, tparams, ServeConfig(max_len=max_len), device="cpu")
    for e in (je, te):
        e.init_paged(num_pages=40, page_size=4, decode_batch=4,
                     prefix_sharing=prefix_sharing)
    return je, te


def _trace(engine):
    """s1 stays resident while p2 (shares two full pages with it) and a
    repeat of s1's own prompt generate; then s1 finishes."""
    rs = np.random.RandomState(11)
    p1 = rs.randint(0, 64, 10).astype(np.int32)
    # 12 tokens: the same padded prefill shape as p1 when unshared, the
    # same tail shape as p1's repeat when shared (fewer JAX compiles)
    p2 = np.concatenate([p1[:8], rs.randint(0, 64, 4).astype(np.int32)])
    s1 = engine.prefill_into_pages(p1, max_new_tokens=7)
    engine.decode_step_batch([s1])
    out2 = engine.generate_paged(p2, max_new_tokens=6)["tokens"]
    out3 = engine.generate_paged(p1, max_new_tokens=6)["tokens"]
    while not s1.done:
        engine.decode_step_batch([s1])
    engine.pool.release(s1)
    return [np.concatenate([p1, s1.tokens]), out2, out3]


@pytest.mark.parametrize("prefix_sharing", [True, False])
def test_generate_paged_greedy_tokens_identical_to_jax(prefix_sharing):
    je, te = _engines(prefix_sharing)
    want, got = _trace(je), _trace(te)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for e in (je, te):
        assert e.pool.pages_in_use == 0
    assert te.cow_count == je.cow_count
    assert te.prefill_tokens_shared == je.prefill_tokens_shared
    if prefix_sharing:
        assert te.cow_count >= 1 and te.prefill_tokens_shared > 0
    else:
        assert te.cow_count == 0 and te.prefill_tokens_shared == 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_mixed_length_batch_matches_solo(temperature):
    """Requests at different positions decode in ONE paged batch; each
    row gets the tokens of the same request decoded alone."""
    _, te = _engines(prefix_sharing=True)
    te.scfg.temperature = temperature
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 64, n).astype(np.int32) for n in (6, 13, 3)]
    budgets = [8, 6, 9]
    refs = [te.generate_paged(p, max_new_tokens=n)["tokens"]
            for p, n in zip(prompts, budgets)]
    seqs = [te.prefill_into_pages(prompts[0], max_new_tokens=budgets[0])]
    te.decode_step_batch(seqs)
    te.decode_step_batch(seqs)          # seq 0 is 2 tokens ahead ...
    seqs += [te.prefill_into_pages(p, max_new_tokens=n)      # ... when the
             for p, n in zip(prompts[1:], budgets[1:])]      # others join
    while not all(s.done for s in seqs):
        te.decode_step_batch([s for s in seqs if not s.done])
    for s in seqs:
        te.pool.release(s)
    for p, s, want in zip(prompts, seqs, refs):
        np.testing.assert_array_equal(np.concatenate([p, s.tokens]), want)
    assert te.pool.pages_in_use == 0
    assert te.pool.peak_in_use > 0


@pytest.mark.parametrize("kv", ["float32", "int8", "bfloat16"])
def test_pool_bytes_match_jax(kv):
    """pool_bytes_per_page / _per_token count what the JAX package's
    helpers count (the port lays the pool out on the meta device)."""
    from repro.serving import kv_cache as jkv
    from repro_torch.serving import kv_cache as tkv
    kw = dict(CFG_KW, kv_cache_dtype=kv)
    jcfg = ModelConfig(pattern=(LayerSpec(), LayerSpec(attn_kind="swa")),
                       window=4, **kw)
    tcfg = TModelConfig(pattern=(TLayerSpec(), TLayerSpec(attn_kind="swa")),
                        window=4, **kw)
    assert tkv.pool_bytes_per_page(tcfg, 16) == jkv.pool_bytes_per_page(
        jcfg, 16)
    assert tkv.pool_bytes_per_token(tcfg, 16) == jkv.pool_bytes_per_token(
        jcfg, 16)
