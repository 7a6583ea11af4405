"""K4 and the Mamba-1 block of the port against the JAX package.

* The plain selective scan (``repro_torch.kernels.ref.selective_scan_ref``)
  against the JAX reference (y and h_final) and the interpret-mode
  Pallas kernel, on the JAX sweep's three shapes (2e-5, as
  tests/test_kernels.py holds the kernel); an off-tile shape, a start
  state carried across two halves, and the per-token recurrence.
* ``mamba_forward`` (with and without a cache) and ``mamba_decode``
  against the JAX functions at falcon-mamba-7b smoke widths, on the same
  (converted) fp32 weights.  The JAX forward runs a chunked associative
  scan, the port a sequential one: they agree to fp32 rounding (2e-5 on
  the outputs and the state).
* Dispatch: a CPU tensor gets the plain scan and counts no launch; any
  other tensor goes to the kernel path, which refuses it here.
* ``convert`` carries falcon-mamba params and ring caches across with
  their shapes and dtypes (fp32 ``A_log`` / ``D``, bf16 conv cache).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro.models import mamba as jssm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.models import mamba as tssm
from repro_torch.models import transformer as ttf

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)


def _scan_inputs(b, s, d, n, seed=0, h0=False):
    """numpy fp32 scan operands, distributed as in the JAX sweep."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((b, s, d)))).astype(np.float32)
    bm = rs.standard_normal((b, s, n)).astype(np.float32)
    cm = rs.standard_normal((b, s, n)).astype(np.float32)
    am = -np.exp(rs.standard_normal((d, n)) * 0.5).astype(np.float32)
    dv = rs.standard_normal((d,)).astype(np.float32)
    out = [x, dt, bm, cm, am, dv]
    if h0:
        out.append(rs.standard_normal((b, d, n)).astype(np.float32))
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,d,n,chunk,bd", [
    (2, 128, 64, 16, 64, 32),
    (1, 256, 128, 8, 128, 128),
    (2, 64, 32, 4, 32, 32),
])
def test_plain_scan_matches_jax_reference_and_pallas(b, s, d, n, chunk, bd):
    inp = _scan_inputs(b, s, d, n)
    y, h = ref.selective_scan_ref(*_t(*inp))
    jy, jh = jref.selective_scan_ref(*inp)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)
    py = pallas_scan(*inp, chunk=chunk, block_d=bd, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **SCAN_TOL)


def test_plain_scan_off_tile_and_carried_state_match_jax():
    """S and d_in off every tile; scanning two halves with the first
    half's h_final as the second's h0 equals one scan of the whole."""
    inp = _scan_inputs(2, 37, 20, 5, seed=1)
    y, h = ref.selective_scan_ref(*_t(*inp))
    jy, jh = jref.selective_scan_ref(*inp)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)
    x, dt, bm, cm, am, dv = _t(*inp)
    y1, h1 = ref.selective_scan_ref(x[:, :17], dt[:, :17], bm[:, :17],
                                    cm[:, :17], am, dv)
    y2, h2 = ref.selective_scan_ref(x[:, 17:], dt[:, 17:], bm[:, 17:],
                                    cm[:, 17:], am, dv, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), np.asarray(jy),
                               **SCAN_TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh), **SCAN_TOL)


def test_plain_scan_matches_decode_chain():
    """The scan from a nonzero start state == the per-token recurrence
    run step by step in JAX (tests/test_kernels.py's decode chain)."""
    x, dt, bm, cm, am, dv, h0 = _scan_inputs(1, 32, 16, 4, seed=2, h0=True)
    y, hf = ref.selective_scan_ref(*_t(x, dt, bm, cm, am, dv, h0))
    h = jnp.asarray(h0)
    outs = []
    for t in range(x.shape[1]):
        decay = jnp.exp(dt[:, t, :, None] * am[None])
        h = decay * h + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :]
        outs.append(jnp.einsum("bdn,bn->bd", h, cm[:, t]) + x[:, t] * dv)
    np.testing.assert_allclose(y.numpy(), np.asarray(jnp.stack(outs, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h), atol=1e-5)


def test_ops_scan_on_cpu_is_plain_and_counts_nothing():
    inp = _t(*_scan_inputs(1, 9, 12, 3, seed=3, h0=True))
    before = dict(ops.launches)
    y, h = ops.selective_scan(*inp)
    wy, wh = ref.selective_scan_ref(*inp)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert ops.launches == before


def test_cuda_scan_never_falls_back_to_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses it here (no CUDA) instead of computing elsewhere; the
    launch counter does not move."""
    before = dict(ops.launches)
    x = torch.zeros((1, 4, 8), device="meta")
    bm = torch.zeros((1, 4, 2), device="meta")
    a = torch.zeros((8, 2), device="meta")
    d = torch.zeros((8,), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        ops.selective_scan(x, x, bm, bm, a, d)
    cpu = [torch.zeros(t.shape) for t in (x, x, bm, bm, a, d)]
    with pytest.raises((RuntimeError, ValueError)):
        selective_scan_cuda(*cpu)
    assert ops.launches == before


def _mamba_kw(cfg):
    return dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                d_conv=cfg.d_conv, dt_rank=cfg.dt_rank,
                norm_bc_dt=cfg.mamba_norm)


# The JAX functions run under jax.jit: one compile instead of one per
# eager op keeps this file quick; what they compute is the same.
@functools.lru_cache(maxsize=None)
def _jax_mamba_fns():
    cfg = jax_smoke_config("falcon-mamba-7b")
    kw = _mamba_kw(cfg)
    init = jax.jit(functools.partial(
        jssm.init_mamba, d_model=cfg.d_model,
        **{k: kw[k] for k in ("d_inner", "ssm_state", "d_conv", "dt_rank")}))
    forward = jax.jit(functools.partial(jssm.mamba_forward, chunk=8, **kw))
    decode = jax.jit(functools.partial(jssm.mamba_decode, **kw))
    return cfg, kw, init, forward, decode


def _mamba_setup(seed=0):
    cfg, kw, init, _, _ = _jax_mamba_fns()
    jp = init(jax.random.key(seed))
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, kw, jp, tp


def _random_cache(cfg, b, seed):
    rs = np.random.RandomState(seed)
    conv = jnp.asarray(rs.standard_normal((b, cfg.d_conv - 1, cfg.d_inner)),
                       jnp.bfloat16)
    h = jnp.asarray(rs.standard_normal((b, cfg.d_inner, cfg.ssm_state)),
                    jnp.float32)
    return {"conv": conv, "h": h}


def _cache_to_torch(cache):
    return convert.to_torch(jax.tree.map(np.asarray, cache), "cpu")


def _assert_cache_close(got, want):
    # the conv tail is bf16: fp32 noise in the input projection can flip
    # one rounding step, at most 2^-7 of the value; the state is fp32
    np.testing.assert_allclose(got["conv"].float().numpy(),
                               np.asarray(want["conv"], np.float32),
                               rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got["h"].numpy(), np.asarray(want["h"]),
                               **SCAN_TOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_forward_matches_jax(with_cache):
    cfg, kw, jp, tp = _mamba_setup()
    b, s = 2, 21          # S not a multiple of the JAX chunk (8): padded
    x = np.random.RandomState(4).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jcache = _random_cache(cfg, b, 5) if with_cache else None
    tcache = _cache_to_torch(jcache) if with_cache else None
    jout, jnew = _jax_mamba_fns()[3](jp, jnp.asarray(x), cache=jcache)
    tout, tnew = tssm.mamba_forward(tp, torch.from_numpy(x), cache=tcache,
                                    **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **SCAN_TOL)
    if with_cache:
        assert tnew is tcache          # written in place
        _assert_cache_close(tnew, jnew)
    else:
        assert tnew is None


def test_mamba_decode_matches_jax():
    cfg, kw, jp, tp = _mamba_setup(seed=1)
    b = 2
    jcache = _random_cache(cfg, b, 6)
    tcache = _cache_to_torch(jcache)
    xs = np.random.RandomState(7).standard_normal(
        (4, b, 1, cfg.d_model)).astype(np.float32)
    for x in xs:
        jout, jcache = _jax_mamba_fns()[4](jp, jnp.asarray(x), jcache)
        tout, tcache = tssm.mamba_decode(tp, torch.from_numpy(x), tcache,
                                         **kw)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   **SCAN_TOL)
    _assert_cache_close(tcache, jcache)


def test_convert_carries_falcon_mamba_params_and_ring_caches():
    """JAX falcon-mamba params and ring caches cross with their shapes
    and dtypes unchanged, and the port builds the same trees itself."""
    jcfg = jax_smoke_config("falcon-mamba-7b")
    tcfg = get_smoke_config("falcon-mamba-7b")
    jparams = jax.tree.map(np.asarray, jax.jit(
        functools.partial(jtf.init_params, jcfg))(jax.random.key(0)))
    tparams = convert.to_torch(jparams, "cpu")
    own = ttf.init_params(tcfg, device="cpu")
    mixer = tparams["blocks"]["p0"]["mixer"]
    assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in jflat:
        keys = [p.key for p in path]
        got, mine = tparams, own
        for k in keys:
            got, mine = got[k], mine[k]
        assert tuple(got.shape) == leaf.shape == tuple(mine.shape), keys
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), keys
        assert mine.dtype == got.dtype, keys
        np.testing.assert_array_equal(convert.to_numpy(got), leaf)

    jcache = jtf.init_caches(jcfg, 2, 16, jnp.bfloat16)
    jcache["p0"]["conv"] = jcache["p0"]["conv"] + jnp.bfloat16(0.3)
    tcache = convert.to_torch(jax.tree.map(np.asarray, jcache), "cpu")
    mine = ttf.init_caches(tcfg, 2, 16, torch.bfloat16, device="cpu")
    for name in ("conv", "h"):
        assert tuple(tcache["p0"][name].shape) == \
            tuple(jcache["p0"][name].shape) == tuple(mine["p0"][name].shape)
        assert tcache["p0"][name].dtype == mine["p0"][name].dtype
    assert tcache["p0"]["conv"].dtype == torch.bfloat16
    assert tcache["p0"]["h"].dtype == torch.float32
    np.testing.assert_array_equal(convert.to_numpy(tcache)["p0"]["conv"],
                                  np.asarray(jcache["p0"]["conv"], np.float32))
