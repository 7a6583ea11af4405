"""K3's gradient: the port's plain backward against autograd and JAX.

The TPU kernel has no VJP, so the JAX package trains through plain
attention and autodiff.  The port trains through K3 on the card, whose
backward kernel (``csrc/flash_attention_bwd.cu``) is held on the card
against ``flash_attention_bwd_plain``.  Here, on the CPU, that plain
backward (fed the plain row log-sum-exps of
``flash_attention_lse_plain``) is held against torch autograd through
``flash_attention_plain`` and against ``jax.vjp`` of the JAX oracle
``repro.kernels.ref.flash_attention_ref`` on the same numpy inputs:
causal MHA, GQA g = 4, a window, a chunk, a logit cap and MLA's hd 96 /
vd 64.  Tolerances: 2e-5 absolute plus 1e-5 relative in fp32 (the
same function summed in another order; gradients are of order 1).  The
dispatcher's autograd route (``ops.FlashAttention``) and the refusals
of the CUDA wrapper are checked without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain,
                                                 flash_bwd_plan)

ATOL, RTOL = 2e-5, 1e-5
JAX_REF = jax.jit(jref.flash_attention_ref,
                  static_argnames=("causal", "window", "chunk", "logit_cap"))

# (b, s, h, k, hd, vd, window, chunk, cap); S == T, as the backward takes
CASES = {
    "causal_mha": (2, 40, 4, 4, 16, 16, None, None, None),
    "gqa_g4": (1, 48, 8, 2, 16, 16, None, None, None),
    "window": (1, 64, 4, 2, 32, 32, 9, None, None),
    "chunk": (1, 64, 4, 1, 16, 16, None, 24, None),
    "cap": (2, 33, 4, 2, 16, 16, None, None, 5.0),
    "mla_96_64": (1, 36, 4, 4, 96, 64, None, None, None),
}


def _inputs(case, seed=0):
    b, s, h, k, hd, vd = case[:6]
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, k, hd), (b, s, k, vd),
                          (b, s, h, vd))]


def _kw(case):
    window, chunk, cap = case[6:]
    return dict(window=window, chunk=chunk, logit_cap=cap)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_bwd_plain_matches_torch_autograd(case):
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(case))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=True, **_kw(case))
    out.backward(dout)
    lse = flash_attention_lse_plain(q, k, causal=True, **_kw(case))
    got = flash_attention_bwd_plain(q, k, v, out.detach(), lse, dout,
                                    causal=True, **_kw(case))
    for g, x in zip(got, leaves):
        assert g.dtype == torch.float32 and g.shape == x.shape
        _close(g, x.grad)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_bwd_plain_matches_jax_vjp(case):
    arrs = _inputs(case)
    kw = _kw(case)
    out_j, vjp = jax.vjp(lambda q, k, v: JAX_REF(q, k, v, causal=True, **kw),
                         *(jnp.asarray(a) for a in arrs[:3]))
    want = vjp(jnp.asarray(arrs[3]))
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    lse = flash_attention_lse_plain(q, k, causal=True, **kw)
    got = flash_attention_bwd_plain(q, k, v, torch.from_numpy(
        np.array(out_j)), lse, dout, causal=True, **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_lse_normalises_the_oracle_softmax(case):
    """exp(scores - lse) over each row's visible keys sums to 1, and those
    weights applied to v give the JAX oracle's output: the row
    log-sum-exp the backward reads is the forward's normaliser."""
    arrs = _inputs(case)
    kw = _kw(case)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    b, s, h, _ = q.shape
    kk, vd = k.shape[2], v.shape[-1]
    lse = flash_attention_lse_plain(q, k, causal=True, **kw)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    from repro_torch.kernels.ref import flash_scores
    sc = flash_scores(q, k, causal=True, **kw)              # (b, kk, g, s, t)
    p = torch.exp(sc - lse.reshape(b, kk, h // kk, s, 1))
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)
    out = torch.einsum("bkgst,btkv->bskgv", p, v).reshape(b, s, h, vd)
    _close(out, JAX_REF(*(jnp.asarray(a) for a in arrs[:3]), causal=True,
                        **kw))


@pytest.mark.parametrize("shapes,match", [
    (((1, 16, 2, 16), (1, 24, 2, 16), (1, 24, 2, 16)), "S == T"),
    (((1, 16, 2, 256), (1, 16, 2, 256), (1, 16, 2, 256)), "hd <= 128"),
    (((1, 16, 2, 64), (1, 16, 2, 64), (1, 16, 2, 136)), "vd <= 128"),
    (((1, 16, 2, 20), (1, 16, 2, 20), (1, 16, 2, 16)), "multiples? of 8"),
    (((1, 16, 3, 16), (1, 16, 2, 16), (1, 16, 2, 16)), "multiple of"),
], ids=["s_ne_t", "hd_256", "vd_136", "hd_20", "heads"])
def test_bwd_refuses_what_the_kernel_does_not_take(shapes, match):
    """The plan refuses, and so does the wrapper, before any launch and
    before it asks for a card."""
    with pytest.raises(ValueError, match=match):
        flash_bwd_plan(*shapes, torch.bfloat16)
    x = [torch.zeros(sh, dtype=torch.bfloat16) for sh in shapes]
    q, k, v = x
    out = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.bfloat16)
    lse = torch.zeros((q.shape[0], q.shape[2], q.shape[1]))
    with pytest.raises(ValueError, match=match):
        flash_attention_bwd_cuda(q, k, v, out, lse, out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_cuda_raises_without_a_card(dtype):
    counts = {"flash_attention_bwd": 0}
    q = torch.zeros((1, 8, 2, 16), dtype=dtype)
    lse = torch.zeros((1, 2, 8))
    for dev in ("cpu", "meta"):
        args = [x.to(dev) for x in (q, q, q, q, lse, q)]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            flash_attention_bwd_cuda(*args, counts=counts)
    assert counts["flash_attention_bwd"] == 0


def test_ops_attention_needing_grad_goes_through_the_function(monkeypatch):
    """Off the CPU, a call that needs a gradient runs K3 with row
    log-sum-exps inside ``ops.FlashAttention``, whose backward is the
    backward kernel (both stubbed here on meta tensors: no card); a call
    without grad launches K3 alone, as the serving paths do.  Neither
    returns a result detached from autograd."""
    calls = []

    def fwd(q, k, v, *, counts=None, lse=False, **kw):
        calls.append(("fwd", lse, kw))
        counts["flash_attention"] += 1
        out = torch.empty(q.shape[:3] + (v.shape[-1],), dtype=q.dtype,
                          device=q.device)
        b, s, h = q.shape[:3]
        return (out, torch.empty((b, h, s), device=q.device)) if lse else out

    def bwd(q, k, v, out, lse, dout, *, counts=None, **kw):
        calls.append(("bwd", kw))
        counts["flash_attention_bwd"] += 1
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops.launches, 0))
    q = torch.zeros((1, 8, 4, 16), device="meta", requires_grad=True)
    k = torch.zeros((1, 8, 2, 16), device="meta", requires_grad=True)
    v = torch.zeros((1, 8, 2, 8), device="meta", requires_grad=True)
    out = ops.attention(q, k, v, causal=True, window=4, logit_cap=30.0)
    assert out.requires_grad and "FlashAttention" in type(out.grad_fn).__name__
    out.sum().backward()
    assert [c[0] for c in calls] == ["fwd", "bwd"] and calls[0][1] is True
    assert calls[1][1] == dict(causal=True, window=4, chunk=None,
                               logit_cap=30.0, scale=None)
    assert q.grad.shape == q.shape and v.grad.shape == v.shape
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 1
    assert ops.launches["flash_attention_window"] == 1
    with torch.no_grad():
        ops.attention(q, k, v, causal=True)
    assert calls[-1][:2] == ("fwd", False)
    assert ops.launches["flash_attention_bwd"] == 1


def test_ops_selective_scan_refuses_grad_off_the_cpu():
    """K4 has no backward: off the CPU a scan that needs a gradient raises
    NotImplementedError instead of returning a detached result; without
    grad it reaches the kernel's wrapper (which raises here: no card)."""
    b, s, d, n = 1, 4, 8, 2
    args = [torch.zeros(sh, device="meta") for sh in
            ((b, s, d), (b, s, d), (b, s, n), (b, s, n), (d, n), (d,))]
    args[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.selective_scan(*args)
    with torch.no_grad(), pytest.raises((RuntimeError, ValueError)):
        ops.selective_scan(*args)
    cpu = [torch.randn(a.shape) for a in args]
    cpu[0].requires_grad_()
    y, _ = ops.selective_scan(*cpu)
    y.sum().backward()
    assert cpu[0].grad is not None and torch.isfinite(cpu[0].grad).all()
