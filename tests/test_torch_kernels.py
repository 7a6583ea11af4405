"""The port's plain kernel versions against the JAX package's oracles.

K1 (paged decode attention) and K2 (the fused mux head) run here on the
CPU, where ``repro_torch.kernels.ops`` dispatches to the plain PyTorch
version; the CUDA kernels are held against those plain versions on the
card by ``chip_smoke.py``.  Inputs are drawn with numpy and handed to
both packages.  Tolerance: fp32 atol=rtol=1e-5, also for int8 pages
(both sides dequantise in fp32); with bf16 operands 2e-2 (bf16 keeps 8
mantissa bits, and the two packages round q * scale and the softmax
output at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mux_score import mux_score as jax_mux_score
from repro.kernels.paged_attention import decode_hbm_bytes as jax_bytes
from repro.kernels.paged_attention import decode_prefetch as jax_prefetch
from repro_torch.graphs import CudaGraphed
from repro_torch.kernels import build, ops
from repro_torch.kernels.mux_score import mux_head_cuda, mux_score_cuda
from repro_torch.kernels.paged_attention import (decode_hbm_bytes,
                                                 decode_prefetch,
                                                 paged_attention_cuda)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# one compiled program per case instead of one per primitive
JAX_PAGED_REF = jax.jit(jref.paged_attention_ref,
                        static_argnames=("window", "chunk", "logit_cap"))
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _t(a):
    """numpy -> CPU tensor (bf16 via its float32 values)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _pages(rs, pages, ps, k, d):
    return rs.standard_normal((pages, ps, k, d)).astype(np.float32)


def _quantize_pages(pages):
    """Per-(slot, head) symmetric int8 + bf16 scales, like the pool's."""
    sc = np.abs(pages).max(axis=-1) / 127.0 + 1e-8
    qp = np.clip(np.round(pages / sc[..., None]), -127, 127).astype(np.int8)
    return qp, np.asarray(jnp.asarray(sc, jnp.bfloat16))


def _jax_dequant(qp, sc):
    """fp32 dequant, as the TPU kernel does it after the page load."""
    return (jnp.asarray(qp).astype(jnp.float32)
            * jnp.asarray(sc).astype(jnp.float32)[..., None])


@pytest.mark.parametrize(
    "b,h,k,hd,vd,pages,ps,m,window,chunk,cap",
    [
        (3, 4, 2, 16, 16, 10, 8, 4, None, None, None),   # GQA
        (2, 4, 1, 32, 32, 8, 4, 5, 7, None, None),       # MQA + window
        (1, 8, 2, 16, 8, 12, 8, 3, None, 6, None),       # chunked, vd != hd
        (2, 2, 2, 16, 16, 6, 16, 2, None, None, 25.0),   # softcap
    ])
def test_paged_attention_sweep(b, h, k, hd, vd, pages, ps, m, window, chunk,
                               cap):
    rs = np.random.RandomState(0)
    q = rs.standard_normal((b, h, hd)).astype(np.float32)
    kp = _pages(rs, pages, ps, k, hd)
    vp = _pages(rs, pages, ps, k, vd)
    bt = np.stack([np.random.RandomState(i).permutation(pages - 1)[:m] + 1
                   for i in range(b)]).astype(np.int32)
    lengths = np.random.RandomState(7).randint(1, m * ps + 1, size=(b,)
                                               ).astype(np.int32)
    kw = dict(window=window, chunk=chunk, logit_cap=cap)
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths), **kw)
    want = JAX_PAGED_REF(q, kp, vp, bt, lengths, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_paged_attention_v_dim_is_k_slice():
    """v_dim reads v as the leading features of the k slab (MLA)."""
    b, h, hd, ps, m, pages, vdim = 2, 4, 24, 4, 3, 8, 16
    rs = np.random.RandomState(1)
    q = rs.standard_normal((b, h, hd)).astype(np.float32)
    kp = _pages(rs, pages, ps, 1, hd)
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    lengths = np.asarray([m * ps, 5], np.int32)
    got = ops.paged_attention(_t(q), _t(kp), _t(kp), _t(bt), _t(lengths),
                              v_dim=vdim)
    want = JAX_PAGED_REF(q, kp, kp[..., :vdim], bt, lengths)
    assert tuple(got.shape) == (b, h, vdim)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


_GROUP_VARIANTS = {
    "full": {},
    "window": {"window": 9},
    "chunked": {"chunk": 16},
    "softcap": {"logit_cap": 5.0},
    "mla_vdim": {"v_dim": 8},
}


# every mask variant x page dtype at g=2, and each other group size once
_GROUP_CASES = ([(2, v, q) for v in sorted(_GROUP_VARIANTS)
                 for q in ("float32", "bf16", "int8")]
                + [(1, "full", "bf16"), (4, "window", "int8"),
                   (8, "mla_vdim", "float32"), (8, "chunked", "bf16")])


@pytest.mark.parametrize("g,variant,qtag", _GROUP_CASES)
def test_paged_attention_groups_and_page_dtypes(g, variant, qtag):
    """GQA group sizes x mask variants x page dtypes on a mixed-length
    batch with a length-0 row, against the JAX oracle fed the same
    (bf16 / fp32-dequantised int8) pages."""
    b, h, hd, ps, m = 4, 8, 16, 8, 4
    kk = h // g
    pages = 1 + b * m
    kw = dict(_GROUP_VARIANTS[variant])
    rs = np.random.RandomState(g)
    q = rs.standard_normal((b, h, hd)).astype(np.float32)
    kp = _pages(rs, pages, ps, kk, hd)
    vp = kp if variant == "mla_vdim" else _pages(rs, pages, ps, kk, hd)
    bt = np.arange(1, pages, dtype=np.int32).reshape(b, m)
    lengths = np.asarray([5, 17, 0, 32], np.int32)
    if qtag == "int8":
        kq, ks = _quantize_pages(kp)
        vq, vs = _quantize_pages(vp)
        got = ops.paged_attention(_t(q), _t(kq), _t(vq), _t(bt), _t(lengths),
                                  k_scales=_t(ks), v_scales=_t(vs), **kw)
        jk, jv = _jax_dequant(kq, ks), _jax_dequant(vq, vs)
        jq = q
        tol = F32_TOL
    elif qtag == "bf16":
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp))
        got = ops.paged_attention(*(_t(np.asarray(x)) for x in (jq, jk, jv)),
                                  _t(bt), _t(lengths), **kw)
        tol = BF16_TOL
    else:
        jq, jk, jv = q, kp, vp
        got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths),
                                  **kw)
        tol = F32_TOL
    vdim = kw.pop("v_dim", None)
    if vdim is not None:
        jv = jv[..., :vdim]
    want = JAX_PAGED_REF(jq, jk, jv, bt, lengths, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_array_equal(_np(got)[2], 0.0)


def test_paged_zero_length_rows_are_exact_zeros():
    b, h, kk, hd, ps, m = 3, 4, 2, 16, 4, 3
    pages = 1 + b * m
    rs = np.random.RandomState(3)
    q = rs.standard_normal((b, h, hd)).astype(np.float32)
    kp = _pages(rs, pages, ps, kk, hd)
    bt = np.arange(1, pages, dtype=np.int32).reshape(b, m)
    lengths = np.asarray([0, 7, 0], np.int32)
    out = _np(ops.paged_attention(_t(q), _t(kp), _t(kp), _t(bt),
                                  _t(lengths)))
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[[0, 2]], 0.0)
    assert np.abs(out[1]).max() > 0
    want = np.asarray(JAX_PAGED_REF(q, kp, kp, bt, lengths))
    np.testing.assert_allclose(out, want, **F32_TOL)


@pytest.mark.parametrize("kw", [{}, {"window": 9}, {"chunk": 16}])
def test_paged_combined_prefetch_matches_separate_operands(kw):
    """decode_prefetch packs (bt, lengths) into one (B, M+1) operand,
    equal to the JAX package's; the result is the same either way."""
    b, h, kk, hd, ps, m = 2, 8, 2, 16, 8, 4
    pages = 1 + b * m
    rs = np.random.RandomState(4)
    q = _t(rs.standard_normal((b, h, hd)).astype(np.float32))
    kp = _t(_pages(rs, pages, ps, kk, hd))
    vp = _t(_pages(rs, pages, ps, kk, hd))
    bt = np.arange(1, pages, dtype=np.int32).reshape(b, m)
    lengths = np.asarray([13, 32], np.int32)
    pf = decode_prefetch(_t(bt), _t(lengths))
    assert pf.dtype == torch.int32 and tuple(pf.shape) == (b, m + 1)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jax_prefetch(bt,
                                                                      lengths)))
    sep = ops.paged_attention(q, kp, vp, _t(bt), _t(lengths), **kw)
    comb = ops.paged_attention(q, kp, vp, pf[:, :-1], pf[:, -1],
                               prefetch=pf, **kw)
    assert torch.equal(sep, comb)


@pytest.mark.parametrize("case", [
    dict(dtype=np.float32, lengths=[32, 32]),
    dict(dtype=np.float32, lengths=[32, 1]),
    dict(dtype=np.float32, lengths=[32, 32], window=4),
    dict(dtype=np.float32, lengths=[30, 9], chunk=16),
    dict(dtype=np.float32, lengths=[32, 32], grouped=False),
    dict(dtype=np.int8, lengths=[32, 32]),
    dict(dtype=np.float32, lengths=[32, 0], v_dim=8),
])
def test_decode_hbm_bytes_matches_reference(case):
    """The port's byte model counts exactly what the JAX package's does
    (the port's kernel is always grouped: its count per query head is
    the grouped count times the group size)."""
    case = dict(case)
    dtype, lengths = case.pop("dtype"), case.pop("lengths")
    grouped = case.pop("grouped", True)
    ps, kk, hd, m, h = 8, 2, 16, 4, 8
    pages = np.zeros((9, ps, kk, hd), dtype)
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, m)
    want = jax_bytes(jnp.asarray(pages), jnp.asarray(pages), bt, lengths,
                     num_q_heads=h, grouped=grouped, **case)
    got = decode_hbm_bytes(_t(pages), _t(pages), _t(bt), lengths, **case)
    if not grouped:
        got = got * (h // kk)
    assert got == want > 0 or got == want == 0


@pytest.mark.parametrize("b,m,n,normalize", [
    (10, 64, 6, True), (300, 32, 2, True), (7, 128, 16, True),   # sweep
    (1, 32, 2, False),                                           # served
])
def test_mux_score_sweep(b, m, n, normalize):
    rs = np.random.RandomState(b)
    meta = rs.standard_normal((b, m)).astype(np.float32)
    v = rs.standard_normal((n, m)).astype(np.float32)
    c = np.arange(1.0, n + 1, dtype=np.float32)
    got = ops.mux_score(_t(meta), _t(v), _t(c), normalize=normalize)
    want = jref.mux_score_ref(meta, v, c, normalize=normalize)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(got).sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("b,s,d,m,n,normalize", [
    (1, 64, 128, 32, 2, False),                                  # served
    (3, 1, 32, 8, 2, True), (5, 17, 96, 24, 6, True),
    (2, 64, 128, 32, 16, False),
])
def test_mux_head_matches_jax_composition(b, s, d, m, n, normalize):
    """K2's head form (the probe's mean pool, out projection and tanh
    fused before Eq. 5-6) on the CPU against the JAX composition: the
    same steps in jnp into the Pallas ``mux_score`` in interpret mode."""
    rs = np.random.RandomState(100 + 7 * b + s)
    h = rs.standard_normal((b, s, d)).astype(np.float32)
    w_out = (rs.standard_normal((d, m)) / np.sqrt(d)).astype(np.float32)
    v = rs.standard_normal((n, m)).astype(np.float32)
    c = (np.arange(1.0, n + 1) ** 0.5).astype(np.float32)   # cost ** alpha
    got = ops.mux_head(_t(h), _t(w_out), _t(v), _t(c), normalize=normalize)
    meta = jnp.tanh(jnp.mean(jnp.asarray(h), 1) @ jnp.asarray(w_out))
    want = jax_mux_score(meta, jnp.asarray(v), jnp.asarray(c),
                         normalize=normalize, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(got).sum(-1), 1.0, atol=1e-5)


def test_cuda_requests_never_fall_back_to_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses it here (no CUDA) instead of computing on the CPU; the
    launch counters do not move; and the kernels cannot be built
    without nvcc."""
    before = dict(ops.launches)
    q = torch.zeros((1, 2, 8), device="meta")
    pages = torch.zeros((3, 4, 2, 8), device="meta")
    bt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    ln = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        ops.paged_attention(q, pages, pages, bt, ln)
    with pytest.raises((RuntimeError, ValueError)):
        ops.mux_score(torch.zeros((1, 4), device="meta"),
                      torch.zeros((2, 4), device="meta"),
                      torch.ones((2,), device="meta"))
    with pytest.raises((RuntimeError, ValueError)):
        paged_attention_cuda(q.to("cpu"), pages.to("cpu"), pages.to("cpu"),
                             bt.to("cpu"), ln.to("cpu"))
    h = torch.zeros((1, 3, 8))
    w_out, v, c = torch.zeros((8, 4)), torch.zeros((2, 4)), torch.ones((2,))
    with pytest.raises((RuntimeError, ValueError)):
        ops.mux_head(h.to("meta"), w_out.to("meta"), v.to("meta"),
                     c.to("meta"), normalize=False)
    with pytest.raises((RuntimeError, ValueError)):
        mux_head_cuda(h, w_out, v, c, normalize=False)
    with pytest.raises((RuntimeError, ValueError)):
        mux_score_cuda(torch.zeros((1, 4)), v, c)
    # the CUDA-graph helper takes CUDA tensors only: no eager fallback
    graphed = CudaGraphed(lambda t: ops.mux_score(t, v, c), "head")
    for dev in ("meta", "cpu"):
        with pytest.raises((RuntimeError, ValueError)):
            graphed(torch.zeros((1, 4), device=dev))
    assert not graphed._graphs            # nothing was captured
    assert ops.launches == before


def _stub_kernel(*args, counts=None, **kw):
    """A kernel wrapper's stand-in (no card here): returns its first
    operand, and counts as K3's wrapper does where it is handed counts."""
    if counts is not None:
        counts["flash_attention"] += 1
        counts["flash_attention_wgmma"] += 1
    return args[0]


_META = dict(device="meta")
WRAPPER_CALLS = {
    "mux_head": ("mux_head_cuda", "mux_score", lambda: ops.mux_head(
        torch.zeros((1, 3, 8), **_META), torch.zeros((8, 4), **_META),
        torch.zeros((2, 4), **_META), torch.ones((2,), **_META),
        normalize=False)),
    "mux_score": ("mux_score_cuda", "mux_score", lambda: ops.mux_score(
        torch.zeros((1, 4), **_META), torch.zeros((2, 4), **_META),
        torch.ones((2,), **_META))),
    "paged_attention": ("paged_attention_cuda", "paged_attention",
                        lambda: ops.paged_attention(
                            torch.zeros((1, 2, 8), **_META), None, None,
                            None, None)),
    "selective_scan": ("selective_scan_cuda", "selective_scan",
                       lambda: ops.selective_scan(
                           torch.zeros((1, 2, 4), **_META), None, None,
                           None, None, None)),
    "attention": ("flash_attention_cuda", "flash_attention",
                  lambda: ops.attention(
                      *[torch.zeros((1, 4, 2, 8), dtype=torch.bfloat16,
                                    **_META)] * 3)),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPER_CALLS))
def test_captured_launches_go_to_the_capturing_threads_tally(monkeypatch,
                                                              wrapper):
    """A wrapper called while its thread holds a tally open (a CUDA-graph
    capture, which launches nothing) adds to that tally and not to
    ``ops.launches``; the same wrapper on another thread meanwhile counts
    in ``ops.launches``; ``add_launches`` (one replay) counts the tally.
    The kernels are stubs: there is no card here."""
    import threading
    kernel, key, call = WRAPPER_CALLS[wrapper]
    monkeypatch.setattr(ops, kernel, _stub_kernel)
    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops.launches, 0))
    call()
    assert ops.launches[key] == 1
    with ops.tally_launches() as tally:
        call()
        with ops.tally_launches() as inner:    # a nested capture
            call()
        other = threading.Thread(target=call)
        other.start()
        other.join()
        call()
    assert tally[key] == 2 and inner[key] == 1
    assert ops.launches[key] == 2                 # the eager + the thread's
    ops.add_launches(tally)
    assert ops.launches[key] == 4
    assert sum(ops.launches.values()) == (8 if wrapper == "attention" else 4)


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without a CUDA compiler the build raises: nothing is faked."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
