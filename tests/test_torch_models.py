"""The port's paged model stack against the JAX package's, on tiny
configs with the same (converted) weights.

Each case prefills a prompt into pages, then decodes teacher-forced
tokens one step at a time; the logits of every step must agree
(fp32 compute, atol=1e-4), and the pools, converted back to numpy,
must agree too.  Configs: the ``tiny_config`` variants of
tests/test_paged_decode.py x {float32, int8} KV pools, plus a tiny
codeqwen-shaped config (QKV bias, RMSNorm, untied head) and a tiny
olmo-shaped one (non-parametric LayerNorm, tied head).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec, ModelConfig
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TorchModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

LOGIT_TOL = dict(atol=1e-4, rtol=0)


def tiny_config(variant: str, kv_cache_dtype: str = "float32") -> ModelConfig:
    kw = dict(name=f"tiny-{variant}", arch_type="dense", num_layers=2,
              d_model=32, d_ff=64, vocab_size=64, num_heads=4,
              num_kv_heads=2, head_dim=8, compute_dtype="float32",
              param_dtype="float32", kv_cache_dtype=kv_cache_dtype)
    if variant == "full":
        kw["pattern"] = (LayerSpec(attn_kind="full"),)
    elif variant == "swa":
        kw["pattern"] = (LayerSpec(attn_kind="swa"),)
        kw["window"] = 6
    elif variant == "chunked":
        kw["pattern"] = (LayerSpec(attn_kind="chunked"),)
        kw["chunk"] = 5
    elif variant == "gqa_mixed":
        kw["pattern"] = (LayerSpec(attn_kind="full"),
                         LayerSpec(attn_kind="swa"))
        kw["window"] = 6
        kw["num_kv_heads"] = 1          # MQA
    elif variant == "codeqwen":
        kw.update(pattern=(LayerSpec(),), qkv_bias=True, norm="rmsnorm",
                  tie_embeddings=False, num_kv_heads=4, rope_theta=1e6)
    elif variant == "olmo":
        kw.update(pattern=(LayerSpec(),), norm="nonparametric_ln",
                  norm_eps=1e-5, tie_embeddings=True, num_kv_heads=4)
    else:
        raise ValueError(variant)
    return ModelConfig(**kw)


def torch_config(cfg: ModelConfig) -> TorchModelConfig:
    from repro_torch.configs.base import LayerSpec as TLayerSpec
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    fields["pattern"] = tuple(TLayerSpec(**vars(s)) for s in cfg.pattern)
    return TorchModelConfig(**fields)


def jax_params(cfg, seed=0):
    params = jtf.init_params(cfg, jax.random.key(seed))
    if cfg.qkv_bias:   # zero-init biases would not exercise the add
        a = params["blocks"]["p0"]["attn"]
        for i, name in enumerate(("bq", "bk", "bv")):
            a[name] = a[name] + 0.1 * jax.random.normal(
                jax.random.key(100 + i), a[name].shape)
    return params


@functools.lru_cache(maxsize=None)
def _jax_steps(cfg):
    prefill = jax.jit(lambda p, t, c, bt: jtf.prefill_paged(
        p, cfg, t, c, bt, last_index=t.shape[1] - 1))
    decode = jax.jit(lambda p, t, c, bt, pos: jtf.decode_step(
        p, cfg, t, c, pos, block_tables=bt))
    return prefill, decode


def _pool_np(caches):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x), caches)


@pytest.mark.parametrize("variant,kv", [
    (v, kv) for v in ("full", "swa", "chunked", "gqa_mixed")
    for kv in ("float32", "int8")] + [("codeqwen", "float32"),
                                      ("olmo", "float32")])
def test_prefill_then_decode_logits_and_pools_match_jax(variant, kv):
    cfg = tiny_config(variant, kv)
    tcfg = torch_config(cfg)
    params = jax_params(cfg)
    tparams = convert.to_torch(jax.tree.map(np.asarray, params), "cpu")
    b, s, p, ps = 2, 14, 6, 4
    m = -(-s // ps)
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (b, s)
                                              ).astype(np.int32)
    bt = np.arange(1, b * m + 1, dtype=np.int32).reshape(b, m)
    jc = jtf.init_caches(cfg, 0, 0, num_pages=b * m + 1, page_size=ps)
    tc = ttf.init_caches(tcfg, num_pages=b * m + 1, page_size=ps,
                         device="cpu")
    prefill, decode = _jax_steps(cfg)
    jl, jc = prefill(params, jnp.asarray(tokens[:, :p]), jc, jnp.asarray(bt))
    tl, tc = ttf.prefill_paged(tparams, tcfg, torch.from_numpy(tokens[:, :p]),
                               tc, torch.from_numpy(bt), last_index=p - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for i in range(p, s):
        pos = np.full((b,), i, np.int32)
        pos[1] = i - 1              # rows at different positions
        jl, jc = decode(params, jnp.asarray(tokens[:, i:i + 1]), jc,
                        jnp.asarray(bt), jnp.asarray(pos))
        tl, tc = ttf.decode_step(tparams, tcfg,
                                 torch.from_numpy(tokens[:, i:i + 1]), tc,
                                 torch.from_numpy(pos),
                                 block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"{variant}/{kv} pos={i}")
    want, got = _pool_np(jc), convert.to_numpy(tc)
    for name in want:
        for leaf in want[name]:
            if kv == "int8" and leaf in ("k", "v"):
                # one rounding step of the quantiser can flip on fp32 noise
                assert np.abs(got[name][leaf].astype(np.int32)
                              - want[name][leaf].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                           atol=1e-4, rtol=1e-2)


def test_shared_prefix_tail_prefill_matches_jax():
    """The q_offset / insert_from tail path: a second row maps the first
    row's resident prefix pages and prefills only its tail; logits and
    the pool (shared pages untouched) match the JAX package."""
    cfg = tiny_config("gqa_mixed")
    tcfg = torch_config(cfg)
    params = jax_params(cfg, seed=1)
    tparams = convert.to_torch(jax.tree.map(np.asarray, params), "cpu")
    ps, m = 4, 4
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 14)
                                            ).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 4]], np.int32)
    jc = jtf.init_caches(cfg, 0, 0, num_pages=8, page_size=ps)
    tc = ttf.init_caches(tcfg, num_pages=8, page_size=ps, device="cpu")
    prefill = jax.jit(functools.partial(jtf.prefill_paged, cfg=cfg),
                      static_argnames=("last_index",))
    _, jc = prefill(params, tokens=jnp.asarray(toks[:, :8]), caches=jc,
                    block_tables=jnp.asarray(bt))
    ttf.prefill_paged(tparams, tcfg, torch.from_numpy(toks[:, :8]), tc,
                      torch.from_numpy(bt))
    tail = np.zeros((1, 8), np.int32)
    tail[0, :6] = toks[0, 8:14]
    jl, jc = prefill(params, tokens=jnp.asarray(tail), caches=jc,
                     block_tables=jnp.asarray(bt), last_index=5, q_offset=7,
                     insert_from=8)
    tl, tc = ttf.prefill_paged(tparams, tcfg, torch.from_numpy(tail), tc,
                               torch.from_numpy(bt), last_index=5, q_offset=7,
                               insert_from=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want, got = _pool_np(jc), convert.to_numpy(tc)
    for name in want:
        for leaf in want[name]:
            np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                       atol=1e-5)


@pytest.mark.parametrize("kw", [{"window": 3},
                                {"chunk": 4, "logit_cap": 2.0}])
def test_masked_attention_matches_jax(kw):
    """masked_decode_attention / masked_causal_attention /
    blocked_attention (window; chunk with a logit cap) on explicit KV
    views, and attention_span; the full-causal blocked path runs in
    every prefill above."""
    rs = np.random.RandomState(6)
    b, s, t, h, k, hd = 2, 5, 12, 4, 2, 8
    q = rs.standard_normal((b, s, h, hd)).astype(np.float32)
    kk = rs.standard_normal((b, t, k, hd)).astype(np.float32)
    vv = rs.standard_normal((b, t, k, hd)).astype(np.float32)
    kv_pos = np.where(np.arange(t) < 10, np.arange(t), -1).astype(np.int32)
    pos = np.asarray([9, 4], np.int32)
    got = tattn.masked_decode_attention(torch.from_numpy(q[:, :1]),
                                        torch.from_numpy(kk),
                                        torch.from_numpy(vv),
                                        torch.from_numpy(kv_pos),
                                        torch.from_numpy(pos), **kw)
    jitted = functools.partial(jax.jit, static_argnames=tuple(kw))
    want = jitted(jattn.masked_decode_attention)(q[:, :1], kk, vv, kv_pos,
                                                 pos, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    q_pos = np.stack([np.arange(5, 10), np.arange(0, 5)]).astype(np.int32)
    got = tattn.masked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv),
        torch.from_numpy(kv_pos), torch.from_numpy(q_pos), **kw)
    want = jitted(jattn.masked_causal_attention)(q, kk, vv, kv_pos, q_pos,
                                                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for kind in ("full", "swa", "chunked"):
        assert tattn.attention_span(kind, 10, window=3, chunk=4) == \
            jattn.attention_span(kind, 10, window=3, chunk=4)
    qf = rs.standard_normal((b, t, h, hd)).astype(np.float32)
    got = tattn.blocked_attention(torch.from_numpy(qf), torch.from_numpy(kk),
                                  torch.from_numpy(vv), kv_block=4,
                                  q_block=4, **kw)
    want = jitted(functools.partial(jattn.blocked_attention, kv_block=4,
                                    q_block=4))(qf, kk, vv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
