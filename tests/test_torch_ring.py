"""The port's ring-cache path against the JAX package: ``prefill`` +
ring ``decode_step``, ``Engine.generate`` and ``launch.serve``.

* falcon-mamba-7b smoke (Mamba blocks, K4's plain scan on the CPU),
  olmo-1b smoke (attention blocks, ring KV caches) and minicpm3-4b
  smoke (MLA blocks, ring latent caches, absorbed decode) with
  ``compute_dtype="float32"`` and the same converted weights: the
  prefill logits and each teacher-forced ring decode step's logits
  within 1e-4, and the caches after them.  Both packages keep the ring
  caches in bf16 (``prefill`` makes them so).
* ``Engine.generate`` gives the JAX engine's greedy tokens exactly.
* The ring cache functions (prefill past the capacity, insert, windowed
  decode attention, int8) against the JAX ones.
* ``python -m repro_torch.launch.serve ... --device cpu`` runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine, ServeConfig

LOGIT_TOL = dict(atol=1e-4, rtol=0)
ARCHS = ("falcon-mamba-7b", "olmo-1b", "minicpm3-4b")


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX engine, port engine) over one set of fp32 smoke weights."""
    jcfg = jax_smoke_config(arch).with_(compute_dtype="float32")
    tcfg = get_smoke_config(arch).with_(compute_dtype="float32")
    jparams = jax.jit(functools.partial(jtf.init_params, jcfg))(
        jax.random.key(1))
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(max_len=24))
    teng = Engine(tcfg, tparams, ServeConfig(max_len=24), device="cpu")
    return jeng, teng


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_ring_decode_match_jax(arch):
    jeng, teng = _models(arch)
    b, p, n = 2, 11, 6
    toks = np.random.RandomState(2).randint(
        0, teng.cfg.vocab_size, (b, p + n)).astype(np.int32)
    jl, jc = jeng._prefill(jeng.params, jnp.asarray(toks[:, :p]), None)
    tl, tc = ttf.prefill(teng.params, teng.cfg, torch.from_numpy(toks[:, :p]),
                         cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for i in range(p, p + n):
        jl, jc = jeng._decode(jeng.params, jnp.asarray(toks[:, i:i + 1]), jc,
                              i)
        tl, tc = ttf.decode_step(teng.params, teng.cfg,
                                 torch.from_numpy(toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"{arch} pos={i}")
    want, got = _f32(jc), convert.to_numpy(tc)
    for name in want:
        for leaf in want[name]:
            assert got[name][leaf].shape == want[name][leaf].shape
            # bf16 leaves: fp32 noise can flip one rounding step, at most
            # 2^-7 of the value; the mamba state h is fp32
            np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                       rtol=2 ** -7, atol=1e-4,
                                       err_msg=f"{arch} {name}/{leaf}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_identical_to_jax(arch):
    jeng, teng = _models(arch)
    # the prefill test's prompt shape: the JAX prefill compiles once
    prompts = np.random.RandomState(3).randint(
        0, teng.cfg.vocab_size, (2, 11)).astype(np.int32)
    want = jeng.generate(jnp.asarray(prompts), max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    assert got["tokens"].shape == (2, 19)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["prefill_s"] > 0 and got["decode_s"] > 0
    with pytest.raises(ValueError, match="cache capacity"):
        teng.generate(prompts, max_new_tokens=24)


def test_generate_with_temperature_is_seeded_per_row():
    """Temperature > 0 draws each row from its own seeded generator: the
    same seed gives the same tokens, a row's tokens do not depend on the
    rows beside it, and another seed gives other tokens."""
    _, teng = _models("falcon-mamba-7b")
    prompts = np.random.RandomState(4).randint(
        0, teng.cfg.vocab_size, (2, 5)).astype(np.int32)

    def run(seed, rows):
        eng = Engine(teng.cfg, teng.params,
                     ServeConfig(max_len=24, temperature=1.0, seed=seed),
                     device="cpu")
        return eng.generate(prompts[rows], max_new_tokens=10)["tokens"]

    a = run(0, [0, 1])
    assert torch.equal(a, run(0, [0, 1]))
    assert torch.equal(a[:1], run(0, [0]))
    assert not torch.equal(a, run(1, [0, 1]))


def test_sampled_tokens_depend_on_the_request_seed():
    """Rows with the same logits at the same position but different
    request seeds draw different tokens (the paged path's per-request
    sampling); the same seed draws the same ones."""
    _, teng = _models("olmo-1b")
    logits = torch.zeros((4, 512))
    for pos in (0, 7):
        ids = teng._sample_rows(logits, [0, 1, 2, 0], [pos] * 4, [1.0] * 4)
        assert len(set(ids[:3].tolist())) > 1 and ids[0] == ids[3]


def _jax_ring(k, v, k1, v1, q, *, dtype, cap):
    """The JAX side of the ring-cache test, traced once per dtype."""
    b, _, kk, hd = k.shape
    c = jattn.init_kv_cache(b, cap, kk, hd, dtype=dtype)
    c = jattn.cache_prefill(c, k, v, start=0)
    c = jattn.cache_prefill(c, k[:, :2], v[:, :2], start=9)
    c = jattn.cache_insert(c, k1, v1, 11)
    outs = [jattn.decode_attention(q, c, 11, window=w) for w in (None, 4)]
    return c, outs


def test_ring_cache_functions_match_jax():
    """cache_prefill past the capacity (only the trailing tokens survive,
    at slots position % capacity) and at an offset, cache_insert, and
    windowed decode attention over the ring; bf16 and int8 rings."""
    rs = np.random.RandomState(5)
    b, cap, kk, hd, h = 2, 6, 2, 8, 4
    k = rs.standard_normal((b, 9, kk, hd)).astype(np.float32)
    v = rs.standard_normal((b, 9, kk, hd)).astype(np.float32)
    k1 = rs.standard_normal((b, 1, kk, hd)).astype(np.float32)
    v1 = rs.standard_normal((b, 1, kk, hd)).astype(np.float32)
    q = rs.standard_normal((b, 1, h, hd)).astype(np.float32)
    for dtype, tdtype in ((jnp.bfloat16, torch.bfloat16),
                          (jnp.int8, torch.int8)):
        # one jit for the JAX sequence (one compile, not one per op)
        jc, jouts = jax.jit(functools.partial(_jax_ring, dtype=dtype,
                                              cap=cap))(k, v, k1, v1, q)
        tc = tattn.init_kv_cache(b, cap, kk, hd, dtype=tdtype, device="cpu")
        tattn.cache_prefill(tc, *map(torch.from_numpy, (k, v)), start=0)
        tattn.cache_prefill(tc, *map(torch.from_numpy, (k[:, :2], v[:, :2])),
                            start=9)
        tattn.cache_insert(tc, *map(torch.from_numpy, (k1, v1)), 11)
        want, got = _f32(jc), convert.to_numpy(tc)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        for leaf in want:
            np.testing.assert_allclose(got[leaf], want[leaf], atol=1e-6,
                                       err_msg=f"{dtype} {leaf}")
        for window, jo in zip((None, 4), jouts):
            to = tattn.decode_attention(torch.from_numpy(q), tc, 11,
                                        window=window)
            # int8: the port dequantises in fp32, the JAX package writes a
            # bf16 product (one bf16 rounding of each k/v element)
            tol = 1e-5 if dtype == jnp.bfloat16 else 2e-2
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=tol,
                                       err_msg=f"{dtype} window={window}")


def test_paged_caches_refuse_mamba_and_unported_mixers_raise():
    cfg = get_smoke_config("falcon-mamba-7b")
    with pytest.raises(NotImplementedError, match="paged"):
        ttf.init_caches(cfg, num_pages=4, page_size=4, device="cpu")
    for spec in (LayerSpec(mixer="cross_attn"),
                 LayerSpec(mixer="mamba", mlp="moe"),
                 LayerSpec(mixer="mamba", mlp="dense")):
        bad = ModelConfig(name="bad", arch_type="dense", num_layers=1,
                          d_model=8, d_ff=8, vocab_size=8, pattern=(spec,))
        with pytest.raises(NotImplementedError):
            ttf.init_params(bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--prompt-len", "6", "--tokens", "4"])
    assert tuple(res["tokens"].shape) == (2, 10)
    assert res["tokens"].device.type == "cpu"
    assert "generated (2, 10)" in capsys.readouterr().out
