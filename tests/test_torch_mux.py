"""The port's token-probe mux and MuxServer against the JAX package's,
with the same (converted) mux params.

mux_forward weights and meta-features agree to atol=1e-5 (fp32);
probe_weights goes through the fused head on both sides (the JAX
server's ``ops.mux_score`` on the meta-features, the port's
``ops.mux_head`` on the probe's trunk, normalize=False), for prompts
shorter and longer than the probe; the model assignments of ``select``
(argmax and thresholded) and of ``probe`` with engines attached are
identical, and ``probe`` prewarms the same logits into the selected
engines.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec, ModelConfig
from repro.core.multiplexer import init_mux as jinit_mux
from repro.core.multiplexer import init_token_backbone as jinit_backbone
from repro.core.multiplexer import mux_forward as jmux_forward
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.mux_server import MuxServer as JaxMuxServer
from repro.serving.mux_server import MuxServerConfig as JaxMuxServerConfig
from repro_torch import convert
from repro_torch.configs.base import LayerSpec as TLayerSpec
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core import multiplexer as tmux
from repro_torch.kernels import ops
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.mux_server import MuxServer, MuxServerConfig

VOCAB = 64
COSTS = [1.0, 4.0]
NAMES = ["small", "large"]


@functools.lru_cache(maxsize=None)
def _mux_params():
    def init(key):
        kb, km = jax.random.split(key)
        backbone = jinit_backbone(kb, meta_dim=8, vocab_size=VOCAB,
                                  d_model=32)
        return jinit_mux(km, backbone=backbone, model_names=NAMES,
                         costs=dict(zip(NAMES, COSTS)), meta_dim=8,
                         proj_dim=4)

    mux = jax.jit(init)(jax.random.key(2))    # one compile, not one per op
    return mux, convert.to_torch(jax.tree.map(np.asarray, mux), "cpu")


def _prompts(b=6, s=12, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s)
                                               ).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_servers():
    """The JAX servers of the split-probe cases, argmax and thresholded
    (one jit cache each across the cases)."""
    jmux, _ = _mux_params()
    fns = [lambda b: b, lambda b: b]
    return {thr: JaxMuxServer(jmux, fns, COSTS,
                              JaxMuxServerConfig(threshold=thr))
            for thr in (None, 0.5)}


@pytest.mark.parametrize("b,s", [(1, 12), (4, 12), (1, 80), (4, 80)])
def test_split_probe_matches_jax(b, s):
    """The probe split into its trunk (tokens -> h) and the fused head
    (``ops.mux_head``) against the JAX server's ``probe_weights`` and
    ``select``, for prompts shorter (S = 12) and longer (S = 80) than the
    probe's 64 tokens: weights to atol=1e-5, assignments identical.
    The server's ``probe_weights`` is that composition, and the meta
    path (``backbone_forward``) is the head's mean, projection and tanh
    of the same trunk."""
    _, tparams = _mux_params()
    bb = tparams["backbone"]
    x = _prompts(b=b, s=s, seed=20 + s + b)
    h = tmux.token_trunk(bb, torch.from_numpy(x))
    assert h.shape == (b, min(s, 64), 32)
    split = ops.mux_head(h, bb["out"], tparams["v"], tparams["cost_rel"],
                         normalize=False)
    meta = tmux.backbone_forward(bb, torch.from_numpy(x))
    torch.testing.assert_close(meta, torch.tanh(h.mean(1) @ bb["out"]),
                               rtol=0, atol=0)
    for thr, js in _jax_servers().items():
        ts = MuxServer(tparams, COSTS, MuxServerConfig(threshold=thr),
                       device="cpu")
        tw = ts.probe_weights(x)
        torch.testing.assert_close(tw, split, rtol=0, atol=0)
        jw = js.probe_weights(x)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
        np.testing.assert_array_equal(ts.select(tw).numpy(),
                                      np.asarray(js.select(jw)))


@pytest.mark.parametrize("cost_exponent", [1.0, 0.0])
def test_mux_forward_matches_jax(cost_exponent):
    jmux, tparams = _mux_params()
    x = _prompts()
    jw, jmeta = jax.jit(functools.partial(
        jmux_forward, cost_exponent=cost_exponent))(jmux, x)
    tw, tmeta = tmux.mux_forward(tparams, torch.from_numpy(x),
                                 cost_exponent=cost_exponent)
    np.testing.assert_allclose(tmeta.numpy(), np.asarray(jmeta), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


@pytest.mark.parametrize("threshold", [None, "median"])
def test_probe_weights_and_select_match_jax(threshold):
    jmux, tparams = _mux_params()
    x = _prompts(b=16, seed=1)
    fns = [lambda b: b, lambda b: b]
    probe = JaxMuxServer(jmux, fns, COSTS).probe_weights(x)
    if threshold == "median":   # a threshold that splits the batch
        threshold = float(np.median(np.asarray(probe)[:, 0]))
    js = JaxMuxServer(jmux, fns, COSTS,
                      JaxMuxServerConfig(threshold=threshold))
    ts = MuxServer(tparams, COSTS, MuxServerConfig(threshold=threshold),
                   device="cpu")
    jw, tw = js.probe_weights(x), ts.probe_weights(torch.from_numpy(x))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    ja, ta = np.asarray(js.select(jw)), ts.select(tw).numpy()
    np.testing.assert_array_equal(ta, ja)
    if threshold is not None:
        assert 0 < ta.sum() < len(ta)        # both models receive traffic


def test_probe_prewarms_selected_engines_like_jax():
    """probe with paged engines attached: identical assignments, and
    each selected engine's logit cache holds the prompt's final-token
    logits (as the JAX engines do), so the admission that follows is a
    logit-cache hit with the same first token."""
    jmux, tparams = _mux_params()
    kw = dict(name="tiny-mux-zoo", arch_type="dense", num_layers=2,
              d_model=32, d_ff=64, vocab_size=VOCAB, num_heads=4,
              num_kv_heads=2, head_dim=8, compute_dtype="float32",
              param_dtype="float32", kv_cache_dtype="float32")
    jcfg = ModelConfig(pattern=(LayerSpec(),), **kw)
    tcfg = TModelConfig(pattern=(TLayerSpec(),), **kw)
    jengines, tengines = [], []
    for i in range(2):
        params = jtf.init_params(jcfg, jax.random.key(10 + i))
        je = JaxEngine(jcfg, params, JaxServeConfig(max_len=32))
        te = Engine(tcfg, convert.to_torch(jax.tree.map(np.asarray, params),
                                           "cpu"),
                    ServeConfig(max_len=32), device="cpu")
        for e in (je, te):
            e.init_paged(num_pages=24, page_size=4, decode_batch=2,
                         logit_cache=4)
        jengines.append(je)
        tengines.append(te)
    x = _prompts(b=4, s=10, seed=3)
    fns = [lambda b: b, lambda b: b]
    w = np.asarray(JaxMuxServer(jmux, fns, COSTS).probe_weights(x))
    thr = float(np.median(w[:, 0]))
    js = JaxMuxServer(jmux, fns, COSTS, JaxMuxServerConfig(threshold=thr),
                      engines=jengines)
    ts = MuxServer(tparams, COSTS, MuxServerConfig(threshold=thr),
                   engines=tengines, device="cpu")
    jres, tres = js.probe(x), ts.probe(x)
    np.testing.assert_array_equal(tres["assign"], jres["assign"])
    np.testing.assert_allclose(tres["weights"], jres["weights"], atol=1e-5)
    for row, m in zip(x, tres["assign"]):
        je, te = jengines[int(m)], tengines[int(m)]
        key = te._prompt_key(row)
        np.testing.assert_allclose(te._logit_cache_get(key),
                                   je._logit_cache_get(key), atol=1e-4)
        seq_j = je.prefill_into_pages(row, max_new_tokens=3)
        seq_t = te.prefill_into_pages(row, max_new_tokens=3)
        assert seq_t.tokens == seq_j.tokens
        je.pool.release(seq_j)
        te.pool.release(seq_t)
    for je, te in zip(jengines, tengines):
        assert te.logit_cache_hits == je.logit_cache_hits > 0
        je.shed_prewarmed()
        te.shed_prewarmed()
        assert te.pool.pages_in_use == je.pool.pages_in_use == 0
