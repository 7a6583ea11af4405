"""The port's Multi-head Latent Attention against the JAX package's.

Weights come from the JAX initialisers and cross with
``repro_torch.convert``; inputs are drawn with numpy.  Tolerances:
fp32 compute on both sides, so mixer outputs agree to 1e-5 and model
logits to 1e-4 (the blocked and the masked attention sum in other
orders); the K1 case runs bf16-free fp32 operands against the Pallas
kernel in interpret mode, 1e-5; pools agree to 1e-4 (a bf16 latent pool
to one bf16 rounding step, 2^-7 of the value, which fp32 noise can
flip).

* ``init_mla`` builds the JAX tree's keys, shapes and dtypes, and the
  converted minicpm3-4b smoke tree equals the port's ``init_params``
  tree in keys and shapes.
* ``mla_prefill`` whole prompt (ring cache written) and as a
  shared-prefix tail with ``insert_from``; ``mla_decode`` paged and
  ring.
* K1's plain version at the full MLA decode shape (H = 40 over one
  latent head, hd 288, v_dim 256) against the TPU kernel in interpret
  mode; K1's plan at that shape and, unchanged, at the served MHA ones.
* minicpm3-4b smoke: ``prefill`` / ``prefill_paged`` / ``decode_step``
  logits and pools at fp32 and under ``kv_cache_dtype="int8"`` (the
  latent pool stays bf16 in both packages), the paged ``Engine``'s
  greedy tokens (whole prompts, a shared prefix, a chunked prefill),
  and the pool's bytes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import LayerSpec
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.models import mla as jmla
from repro.models import transformer as jtf
from repro.serving import kv_cache as jkv
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_plan, scratch_floats,
                                                 split_smem_bytes,
                                                 tile_heads)
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import Engine, ServeConfig

MIX_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
POOL_TOL = dict(atol=1e-4, rtol=2 ** -7)
ARCH = "minicpm3-4b"
H100_SMS, H100_SMEM = 132, 232_448
# a small MLA mixer: 4 heads, latent 16 + rope 8, value heads of 8
MIX = dict(num_heads=4, kv_lora=16, d_nope=8, d_rope=8, v_head_dim=8,
           rope_theta=10_000.0)
D_MODEL, Q_LORA = 32, 16


@functools.lru_cache(maxsize=None)
def _mixer_params():
    """(JAX, port) params of one MLA mixer, from the JAX initialiser."""
    jp = jmla.init_mla(jax.random.key(3), d_model=D_MODEL, q_lora=Q_LORA,
                       **{k: MIX[k] for k in ("num_heads", "kv_lora",
                                              "d_nope", "d_rope",
                                              "v_head_dim")})
    return jp, convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, b, s):
    return np.random.RandomState(seed).standard_normal(
        (b, s, D_MODEL)).astype(np.float32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _latent_width():
    return MIX["kv_lora"] + MIX["d_rope"]


def test_init_mla_and_converted_tree_match_jax():
    want = jax.eval_shape(functools.partial(
        jmla.init_mla, d_model=D_MODEL, q_lora=Q_LORA,
        **{k: MIX[k] for k in ("num_heads", "kv_lora", "d_nope", "d_rope",
                               "v_head_dim")}), jax.random.key(0))
    got = tmla.init_mla(torch.Generator().manual_seed(0), d_model=D_MODEL,
                        q_lora=Q_LORA, device="cpu",
                        **{k: MIX[k] for k in ("num_heads", "kv_lora",
                                               "d_nope", "d_rope",
                                               "v_head_dim")})
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        g = flat_g[jax.tree_util.keystr(path)]
        assert tuple(g.shape) == leaf.shape and g.dtype == torch.float32
    # the whole minicpm3-4b smoke model: the converted JAX tree and the
    # port's own init_params tree hold the same leaves at the same shapes
    jcfg = jax_smoke_config(ARCH)
    jshapes = jax.eval_shape(functools.partial(jtf.init_params, jcfg),
                             jax.random.key(0))
    conv = convert.to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jshapes), "cpu")
    mine = ttf.init_params(get_smoke_config(ARCH), device="cpu",
                           dtype=torch.float32)
    conv_flat = jax.tree_util.tree_flatten_with_path(conv)[0]
    mine_flat = {jax.tree_util.keystr(p): x for p, x in
                 jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert {jax.tree_util.keystr(p) for p, _ in conv_flat} == set(mine_flat)
    for path, leaf in conv_flat:
        assert leaf.shape == mine_flat[jax.tree_util.keystr(path)].shape


def test_mla_prefill_whole_prompt_matches_jax():
    """No cache, then a ring cache of capacity 12 written in place."""
    jp, tp = _mixer_params()
    b, s = 2, 9
    x = _x(0, b, s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jc = jtf.init_layer_cache(LayerSpec(mixer="mla"), jax_smoke_config(
        ARCH).with_(kv_lora=MIX["kv_lora"], d_rope=MIX["d_rope"]), b, 12,
        jnp.float32)
    want, jc = jax.jit(functools.partial(jmla.mla_prefill, q_lora=Q_LORA,
                                         **MIX))(jp, x, positions=pos,
                                                 cache=jc)
    tc = tattn.init_kv_cache(b, 12, 1, _latent_width(), v_head_dim=1,
                             dtype=torch.float32, device="cpu")
    got, _ = tmla.mla_prefill(tp, torch.from_numpy(x),
                              positions=torch.from_numpy(pos.copy()),
                              cache=tc, **MIX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)
    nocache, _ = tmla.mla_prefill(tp, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos.copy()),
                                  **MIX)
    assert torch.equal(nocache, got)
    for leaf in ("k", "v", "pos"):
        np.testing.assert_allclose(convert.to_numpy(tc[leaf]),
                                   np.asarray(jc[leaf], np.float32),
                                   **MIX_TOL, err_msg=leaf)


def _paged_case(b, m, ps, dtype):
    jc = {"k": jnp.zeros((b * m + 1, ps, 1, _latent_width()), dtype),
          "v": jnp.zeros((b * m + 1, ps, 1, 1), dtype)}
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tc = tattn.init_paged_kv_cache(b * m + 1, ps, 1, _latent_width(),
                                   v_head_dim=1, dtype=tdt, device="cpu")
    bt = np.arange(1, b * m + 1, dtype=np.int32).reshape(b, m)
    return jc, tc, bt


def test_mla_prefill_shared_prefix_tail_matches_jax():
    """Row 0 prefills 8 tokens; the tail (positions 7..12, padded to 8)
    writes from insert_from = 8 on and attends the gathered pool."""
    jp, tp = _mixer_params()
    ps, m = 4, 4
    x = _x(1, 1, 16)
    jc, tc, bt = _paged_case(1, m, ps, jnp.float32)
    fn = jax.jit(functools.partial(jmla.mla_prefill, q_lora=Q_LORA, **MIX))
    head = np.arange(8, dtype=np.int32)[None]
    _, jc = fn(jp, x[:, :8], positions=head, cache=jc, block_tables=bt)
    tmla.mla_prefill(tp, torch.from_numpy(x[:, :8]),
                     positions=torch.from_numpy(head), cache=tc,
                     block_tables=torch.from_numpy(bt), **MIX)
    tail = np.zeros((1, 8, D_MODEL), np.float32)
    tail[0, :6] = x[0, 8:14]
    tpos = 7 + np.arange(8, dtype=np.int32)[None]
    want, jc = fn(jp, tail, positions=tpos, cache=jc, block_tables=bt,
                  q_offset=7, insert_from=8)
    got, _ = tmla.mla_prefill(tp, torch.from_numpy(tail),
                              positions=torch.from_numpy(tpos), cache=tc,
                              block_tables=torch.from_numpy(bt), q_offset=7,
                              insert_from=8, **MIX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **MIX_TOL, err_msg=leaf)


@pytest.mark.parametrize("paged", [True, False])
def test_mla_decode_matches_jax(paged):
    """Three teacher-forced decode steps after an 8-token prefill: the
    paged pool at per-row positions (row 1 one behind; K1's plain
    version with v_dim against JAX's gather path), or the ring cache at a
    shared position (v = the latent's leading kv_lora features)."""
    jp, tp = _mixer_params()
    b, ps, m = 2, 4, 4
    x = _x(2, b, 11)
    pre = np.broadcast_to(np.arange(8, dtype=np.int32), (b, 8)).copy()
    pre_fn = jax.jit(functools.partial(jmla.mla_prefill, q_lora=Q_LORA,
                                       **MIX))
    dec_fn = jax.jit(functools.partial(jmla.mla_decode, **MIX))
    if paged:
        jc, tc, bt = _paged_case(b, m, ps, jnp.float32)
        kw_j, kw_t = {"block_tables": bt}, {
            "block_tables": torch.from_numpy(bt)}
    else:
        jc = jtf.init_layer_cache(LayerSpec(mixer="mla"),
                                  jax_smoke_config(ARCH).with_(
                                      kv_lora=MIX["kv_lora"],
                                      d_rope=MIX["d_rope"]),
                                  b, 16, jnp.float32)
        tc = tattn.init_kv_cache(b, 16, 1, _latent_width(), v_head_dim=1,
                                 dtype=torch.float32, device="cpu")
        kw_j = kw_t = {}
    _, jc = pre_fn(jp, x[:, :8], positions=pre, cache=jc, **kw_j)
    tmla.mla_prefill(tp, torch.from_numpy(x[:, :8]),
                     positions=torch.from_numpy(pre), cache=tc, **kw_t,
                     **MIX)
    for i in range(8, 11):
        if paged:
            pos = np.asarray([i, i - 1], np.int32)
        else:
            pos = np.asarray([i], np.int32)
        want, jc = dec_fn(jp, x[:, i:i + 1], jc,
                          pos if paged else i, **kw_j)
        got, _ = tmla.mla_decode(tp, torch.from_numpy(x[:, i:i + 1]), tc,
                                 torch.from_numpy(pos).long(), **kw_t, **MIX)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL,
                                   err_msg=f"paged={paged} pos={i}")
    for leaf in ("k", "v"):
        np.testing.assert_allclose(convert.to_numpy(tc[leaf]),
                                   np.asarray(jc[leaf], np.float32),
                                   **MIX_TOL, err_msg=leaf)


def test_k1_plain_at_the_mla_shape_matches_pallas_kernel():
    """K1's absorbed-latent form at minicpm3-4b's widths: 40 query heads
    over ONE latent head of 288 (256 + 32), V the leading 256 features
    of the same pages, pages of 16, a length-0 row and rows that end
    inside a page; the plain version the card holds the kernel against
    equals the TPU kernel (interpret mode)."""
    rs = np.random.RandomState(7)
    h, hd, vd, ps, m = 40, 288, 256, 16, 4
    lengths = np.asarray([0, 53], np.int32)
    q = rs.standard_normal((2, h, hd)).astype(np.float32)
    pages = rs.standard_normal((2 * m + 1, ps, 1, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 3, 4], [8, 6, 7, 5]], np.int32)
    scale = 1.0 / np.sqrt(96.0)
    want = jax_paged(q, pages, pages, bt, lengths, scale=scale, v_dim=vd,
                     interpret=True)
    kp = torch.from_numpy(pages)
    got = ops.paged_attention(torch.from_numpy(q), kp, kp,
                              torch.from_numpy(bt),
                              torch.from_numpy(lengths), scale=scale,
                              v_dim=vd)
    assert tuple(got.shape) == (2, h, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert (got[0] == 0).all()


def test_k1_plan_at_the_mla_shape():
    """From shapes alone: B = 8 (and 1) rows of up to 2048 tokens at page
    64, 40 heads over one latent head of 288, v_dim 256, bf16.  Five
    head tiles of eight heads (8 x 256 = 2048 outputs a block), splits
    that cover the block table, shared memory under the 227 KB a block
    may use, blocks enough to fill the SMs, partials sized per head."""
    for b in (1, 8):
        p = paged_plan(b, 1, 40, 32, 64, 288, 256, 2, False, H100_SMS,
                       H100_SMEM)
        assert p.head_tiles == 5 and tile_heads(40, p.head_tiles) == 8
        assert p.num_splits * p.pages_per_split >= 32
        assert (p.num_splits - 1) * p.pages_per_split < 32
        assert p.tile <= p.pages_per_split * 64
        assert p.smem_bytes == split_smem_bytes(2, 8, 288, 256, 64,
                                                p.pages_per_split, p.tile,
                                                False)
        assert p.smem_bytes <= H100_SMEM
        assert scratch_floats(p, b, 1, 40, 256) == (
            b * p.num_splits * 40 * 258 if p.num_splits > 1 else 0)
    p8 = paged_plan(8, 1, 40, 32, 64, 288, 256, 2, False, H100_SMS,
                    H100_SMEM)
    assert 8 * p8.head_tiles * p8.num_splits >= 4 * H100_SMS
    # a ragged group: 9 heads of 256 -> two tiles of 5 and 4
    p9 = paged_plan(2, 1, 9, 8, 16, 288, 256, 2, False, H100_SMS, H100_SMEM)
    assert p9.head_tiles == 2 and tile_heads(9, 2) == 5


# (B, K, g, M, page, hd, vd, itemsize, int8) -> the plan before head tiles
SERVED_PLANS = {
    (8, 16, 1, 32, 64, 128, 128, 2, False): (2, 16, 64, 33808),   # olmo-1b
    (8, 32, 1, 32, 64, 128, 128, 2, False): (2, 16, 64, 33808),   # codeqwen
    (1, 16, 1, 32, 64, 128, 128, 2, False): (1, 32, 64, 33548),   # 1 row
    (8, 16, 1, 32, 64, 128, 128, 1, True): (3, 11, 128, 35604),   # int8
}


@pytest.mark.parametrize("shape", sorted(SERVED_PLANS, key=str))
def test_k1_plan_unchanged_at_the_served_shapes(shape):
    """The parent's plan (pages a split, splits, tile, shared memory) at
    each shape served before MLA, with one head tile."""
    p = paged_plan(*shape, H100_SMS, H100_SMEM)
    assert tuple(p) == SERVED_PLANS[shape] + (1,)


# ---------------------------------------------------------------------------
# the whole model and the engine, minicpm3-4b smoke
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(kv: str):
    """(JAX cfg, port cfg, JAX params, port params) at fp32 compute."""
    kw = dict(compute_dtype="float32", param_dtype="float32",
              kv_cache_dtype=kv)
    jcfg = jax_smoke_config(ARCH).with_(**kw)
    tcfg = get_smoke_config(ARCH).with_(**kw)
    jp = jax.jit(functools.partial(jtf.init_params, jcfg))(jax.random.key(1))
    return jcfg, tcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp),
                                            "cpu")


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_model_prefill_paged_and_decode_match_jax(kv):
    """prefill_paged of 6 tokens then 8 teacher-forced paged steps (rows
    at different positions), and the ring prefill + 3 ring steps:
    logits within 1e-4, pools within one bf16 step; under int8 the
    latent pool is bf16 in both packages."""
    jcfg, tcfg, jp, tp = _model(kv)
    b, s, p, ps = 2, 14, 6, 4
    m = -(-s // ps)
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, (b, s)
                                            ).astype(np.int32)
    bt = np.arange(1, b * m + 1, dtype=np.int32).reshape(b, m)
    jc = jtf.init_caches(jcfg, 0, 0, num_pages=b * m + 1, page_size=ps)
    tc = ttf.init_caches(tcfg, num_pages=b * m + 1, page_size=ps,
                         device="cpu")
    want_dt = torch.bfloat16 if kv == "int8" else torch.float32
    assert tc["p0"]["k"].dtype == want_dt and set(tc["p0"]) == {"k", "v"}
    assert jc["p0"]["k"].dtype == (jnp.bfloat16 if kv == "int8"
                                   else jnp.float32)
    assert tuple(tc["p0"]["k"].shape) == jc["p0"]["k"].shape
    jl, jc = jax.jit(lambda p_, t, c, bt_: jtf.prefill_paged(
        p_, jcfg, t, c, bt_, last_index=t.shape[1] - 1))(
            jp, jnp.asarray(toks[:, :p]), jc, jnp.asarray(bt))
    tl, tc = ttf.prefill_paged(tp, tcfg, torch.from_numpy(toks[:, :p]), tc,
                               torch.from_numpy(bt), last_index=p - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    dec = jax.jit(lambda p_, t, c, bt_, pos: jtf.decode_step(
        p_, jcfg, t, c, pos, block_tables=bt_))
    for i in range(p, s):
        pos = np.full((b,), i, np.int32)
        pos[1] = i - 1
        jl, jc = dec(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(bt),
                     jnp.asarray(pos))
        tl, tc = ttf.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                 tc, torch.from_numpy(pos),
                                 block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"{kv} pos={i}")
    want, got = _np(jc), convert.to_numpy(tc)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got["p0"][leaf], want["p0"][leaf],
                                   **POOL_TOL, err_msg=f"{kv} {leaf}")
    # the ring path: prefill into fresh bf16 rings, then ring steps
    jl, jr = jax.jit(lambda p_, t: jtf.prefill(p_, jcfg, t, cache_len=16))(
        jp, jnp.asarray(toks[:, :p]))
    tl, tr = ttf.prefill(tp, tcfg, torch.from_numpy(toks[:, :p]),
                         cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    step = jax.jit(lambda p_, t, c, pos: jtf.decode_step(p_, jcfg, t, c, pos))
    for i in range(p, p + 3):
        jl, jr = step(jp, jnp.asarray(toks[:, i:i + 1]), jr, i)
        tl, tr = ttf.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                 tr, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"{kv} ring pos={i}")
    want, got = _np(jr), convert.to_numpy(tr)
    assert tr["p0"]["k"].dtype == torch.bfloat16
    for leaf in ("k", "v", "pos"):
        np.testing.assert_allclose(got["p0"][leaf], want["p0"][leaf],
                                   **POOL_TOL, err_msg=f"{kv} ring {leaf}")


def _engines(kv: str):
    jcfg, tcfg, jp, tp = _model(kv)
    je = JaxEngine(jcfg, jp, JaxServeConfig(max_len=32))
    te = Engine(tcfg, tp, ServeConfig(max_len=32), device="cpu")
    for e in (je, te):
        e.init_paged(num_pages=40, page_size=4, decode_batch=4)
    return je, te


def _trace(engine):
    """A resident request, one sharing its first two pages, and a 16-token
    prompt admitted in chunks of 8 (``begin_prefill`` /
    ``prefill_chunk``) decoding beside them."""
    rs = np.random.RandomState(12)
    p1 = rs.randint(0, 512, 10).astype(np.int32)
    p2 = np.concatenate([p1[:8], rs.randint(0, 512, 4).astype(np.int32)])
    p3 = rs.randint(0, 512, 16).astype(np.int32)
    s1 = engine.prefill_into_pages(p1, max_new_tokens=6)
    engine.decode_step_batch([s1])
    out2 = engine.generate_paged(p2, max_new_tokens=5)["tokens"]
    s3 = engine.begin_prefill(p3, max_new_tokens=6)
    chunks = 0
    while not engine.prefill_chunk(s3, chunk_tokens=8):
        chunks += 1
    assert chunks == 1
    while not (s1.done and s3.done):
        engine.decode_step_batch([s for s in (s1, s3) if not s.done])
    for s in (s1, s3):
        engine.pool.release(s)
    return [np.concatenate([p1, s1.tokens]), out2,
            np.concatenate([p3, s3.tokens])]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_engine_greedy_tokens_identical_to_jax(kv):
    je, te = _engines(kv)
    want, got = _trace(je), _trace(te)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for e in (je, te):
        assert e.pool.pages_in_use == 0
    assert te.prefill_tokens_shared == je.prefill_tokens_shared > 0
    assert te.whole_prompt_prefills == 1


@pytest.mark.parametrize("kv", ["float32", "int8", "bfloat16"])
def test_pool_bytes_match_jax(kv):
    jcfg = jax_smoke_config(ARCH).with_(kv_cache_dtype=kv)
    tcfg = get_smoke_config(ARCH).with_(kv_cache_dtype=kv)
    assert tkv.pool_bytes_per_page(tcfg, 16) == jkv.pool_bytes_per_page(
        jcfg, 16)
    assert tkv.pool_bytes_per_token(tcfg, 16) == jkv.pool_bytes_per_token(
        jcfg, 16)
    # minicpm3-4b: (288 + 1) bf16 features a token a layer, 62 layers
    assert tkv.pool_bytes_per_token(get_config(ARCH), 64) == 289 * 2 * 62
