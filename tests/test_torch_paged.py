"""K1: the split plan of the port's paged decode kernel and its algorithm.

``csrc/paged_attention.cu`` cuts each (row, KV head)'s block table into
splits of ``pages_per_split`` pages (``paged_plan``, from shapes alone),
computes an exact softmax partial (m, l, unnormalised acc) per split
over the split's visible tokens, and merges the partials by log-sum-exp
in split order in a combine pass.  The CUDA kernel runs only on the
card (``chip_smoke.py`` holds it against ``paged_attention_plain``);
here the plan is checked, and a torch emulation of the kernel's
algorithm on the plan's boundaries is held against the JAX oracle
``repro.kernels.ref.paged_attention_ref`` and, on small cases, against
the Pallas kernel in interpret mode.  Inputs are drawn with numpy and
handed to both packages.  Tolerances as ``tests/test_torch_kernels.py``
states them: fp32 1e-5 (also int8 pages: both sides dequantise in
fp32), 2e-2 with bf16 operands.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_plan, scratch_floats,
                                                 split_smem_bytes)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "int8": dict(atol=1e-5,
                                                           rtol=1e-5),
       "bf16": dict(atol=2e-2, rtol=2e-2)}
JAX_REF = jax.jit(jref.paged_attention_ref,
                  static_argnames=("window", "chunk", "logit_cap"))
H100_SMS = 132
H100_SMEM = 232_448    # shared memory a block may opt into
NEG_INF = -1e30


def _plan(q, kp, vd, m, quantized, sms=H100_SMS):
    b, h, hd = q.shape
    ps, kk = kp.shape[1], kp.shape[2]
    return paged_plan(b, kk, h // kk, m, ps, hd, vd, kp.element_size(),
                      quantized, sms, H100_SMEM)


def emulate(q, kp, vp, bt, lengths, plan, *, window=None, chunk=None,
            logit_cap=None, k_scales=None, v_scales=None, v_dim=None):
    """The kernel's algorithm in torch, fp32: per (row, split) the
    visible sub-span of the split's pages, scores of the scaled q (an
    int8 K row's scale applied to its dot), the tanh cap, an exact
    softmax partial with the int8 V scale folded into P, then the
    running log-sum-exp combine in split order (one split: acc / l)."""
    b, h, hd = q.shape
    ps, kk = kp.shape[1], kp.shape[2]
    g = h // kk
    vd = v_dim or vp.shape[-1]
    m = bt.shape[1]
    split_tokens = plan.pages_per_split * ps
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, kk, g, hd)
    out = torch.zeros((b, kk, g, vd))
    for row in range(b):
        length = int(lengths[row])
        q_pos = length - 1
        lo = 0
        if window is not None:
            lo = max(lo, q_pos - window + 1)
        if chunk is not None and q_pos >= 0:
            lo = max(lo, (q_pos // chunk) * chunk)
        hi = min(length, m * ps)
        parts = []
        for s in range(plan.num_splits):
            s0 = s * split_tokens
            v0, v1 = max(lo, s0), min(hi, s0 + split_tokens, m * ps)
            if v1 <= v0:
                parts.append((torch.full((kk, g), NEG_INF),
                              torch.zeros((kk, g)), None))
                continue
            toks = torch.arange(v0, v1)
            pages, slots = bt[row, toks // ps].long(), toks % ps
            k = kp[pages, slots].float()                       # (n, kk, hd)
            v = vp[pages, slots][..., :vd].float()
            sc = torch.einsum("kgd,nkd->kgn", qf[row], k)
            if k_scales is not None:
                sc = sc * k_scales[pages, slots].float().T[:, None, :]
            if logit_cap is not None:
                sc = torch.tanh(sc / logit_cap) * logit_cap
            mx = sc.max(-1).values
            p = torch.exp(sc - mx[..., None])
            l_ = p.sum(-1)
            if v_scales is not None:
                p = p * v_scales[pages, slots].float().T[:, None, :]
            parts.append((mx, l_, torch.einsum("kgn,nkv->kgv", p, v)))
        if plan.num_splits == 1:
            mx, l_, acc = parts[0]
            if acc is not None:
                out[row] = acc / l_[..., None]
            continue
        mx = torch.full((kk, g), NEG_INF)
        den = torch.zeros((kk, g))
        num = torch.zeros((kk, g, vd))
        for m_s, l_s, acc in parts:         # running merge, split order
            if acc is None:
                continue
            m_new = torch.maximum(mx, m_s)
            c, w = torch.exp(mx - m_new), torch.exp(m_s - m_new)
            den = den * c + l_s * w
            num = num * c[..., None] + acc * w[..., None]
            mx = m_new
        out[row] = torch.where(den[..., None] > 0,
                               num / den.clamp_min(1e-30)[..., None],
                               torch.zeros(()))
    return out.reshape(b, h, vd).to(q.dtype)


def _quantize(pages):
    """Per-(slot, head) symmetric int8 + bf16 scales, like the pool's."""
    sc = np.abs(pages).max(axis=-1) / 127.0 + 1e-8
    qp = np.clip(np.round(pages / sc[..., None]), -127, 127).astype(np.int8)
    return qp, np.asarray(jnp.asarray(sc, jnp.bfloat16))


def _case(seed, lengths, h, kk, hd, ps, m, dtype, share_kv=False):
    """numpy inputs (row i maps its own shuffled pages) as JAX arrays and
    as the port's tensors; int8 pages reach JAX dequantised in fp32."""
    rs = np.random.RandomState(seed)
    need = [max(1, -(-n // ps)) for n in lengths]
    pages = 1 + sum(need)
    perm = rs.permutation(pages - 1) + 1
    bt = np.zeros((len(lengths), m), np.int32)
    off = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[off:off + n]
        off += n
    q = rs.standard_normal((len(lengths), h, hd)).astype(np.float32)
    kp = rs.standard_normal((pages, ps, kk, hd)).astype(np.float32)
    vp = kp if share_kv else rs.standard_normal((pages, ps, kk, hd)
                                                ).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    port = {"bt": torch.from_numpy(bt), "lengths": torch.from_numpy(ln)}
    if dtype == "int8":
        kq, ks = _quantize(kp)
        vq, vs = (kq, ks) if share_kv else _quantize(vp)
        jk = np.asarray(kq, np.float32) * np.asarray(ks, np.float32)[..., None]
        jv = np.asarray(vq, np.float32) * np.asarray(vs, np.float32)[..., None]
        jx = (q, jk, jv)
        port.update(q=torch.from_numpy(q), k=torch.from_numpy(kq),
                    v=torch.from_numpy(vq),
                    k_scales=torch.from_numpy(np.asarray(ks, np.float32)
                                              ).to(torch.bfloat16),
                    v_scales=torch.from_numpy(np.asarray(vs, np.float32)
                                              ).to(torch.bfloat16))
    elif dtype == "bf16":
        jx = tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
        port.update({name: torch.from_numpy(np.asarray(a, np.float32)
                                            ).to(torch.bfloat16)
                     for name, a in zip("qkv", jx)})
    else:
        jx = (q, kp, vp)
        port.update(q=torch.from_numpy(q), k=torch.from_numpy(kp),
                    v=torch.from_numpy(vp))
    return jx, (bt, ln), port


def _scales(port):
    return {k: port[k] for k in ("k_scales", "v_scales") if k in port}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

SERVED = {"olmo-1b": 16, "codeqwen1.5-7b": 32}


def test_plan_takes_shapes_only_and_covers_the_block_table():
    params = inspect.signature(paged_plan).parameters
    assert not any("len" in name for name in params)
    for b in (1, 3, 8, 64):
        for kk in (1, 4, 16, 32):
            for m in (1, 2, 5, 16, 32, 128):
                for ps, item, quant in ((16, 4, False), (64, 2, False),
                                        (64, 1, True)):
                    p = paged_plan(b, kk, 1, m, ps, 128, 128, item, quant,
                                   H100_SMS, H100_SMEM)
                    assert p.pages_per_split >= 1 and p.tile >= 1
                    assert p.num_splits * p.pages_per_split >= m
                    assert (p.num_splits - 1) * p.pages_per_split < m
                    assert p.tile <= p.pages_per_split * ps
                    assert p.smem_bytes == split_smem_bytes(
                        item, 1, 128, 128, ps, p.pages_per_split, p.tile,
                        quant)
                    assert p.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("model", sorted(SERVED))
def test_plan_fills_the_card_at_the_served_shapes(model):
    """B=8 rows, M=32 pages of 64, hd=128, bf16, MHA: blocks enough for
    every SM several times over, splits of at most 64 KB of K/V, and
    room for at least two blocks an SM."""
    h = SERVED[model]
    p = paged_plan(8, h, 1, 32, 64, 128, 128, 2, False, H100_SMS, H100_SMEM)
    assert 8 * h * p.num_splits >= 4 * H100_SMS
    assert p.pages_per_split * 64 * (128 + 128) * 2 <= 64 * 1024
    assert 2 * p.smem_bytes <= 228 * 1024
    one_row = paged_plan(1, 16, 1, 32, 64, 128, 128, 2, False, H100_SMS,
                         H100_SMEM)
    assert 16 * one_row.num_splits >= 2 * H100_SMS


def test_plan_is_cached_and_scratch_sized():
    paged_plan.cache_clear()
    args = (8, 16, 2, 32, 64, 128, 64, 2, False, H100_SMS, H100_SMEM)
    p = paged_plan(*args)
    assert paged_plan(*args) is p
    assert paged_plan.cache_info().hits == 1
    assert p.num_splits > 1
    assert scratch_floats(p, 8, 16, 2, 64) == 8 * 16 * p.num_splits * 2 * 66
    one = paged_plan(64, 16, 1, 2, 64, 128, 128, 2, False, H100_SMS,
                     H100_SMEM)
    assert one.num_splits == 1 and scratch_floats(one, 64, 16, 1, 128) == 0


def test_plan_shrinks_to_fit_shared_memory():
    """A wide group at fp32 hd=256 with big pages still fits one block."""
    p = paged_plan(1, 1, 8, 64, 64, 256, 256, 4, False, H100_SMS, H100_SMEM)
    assert p.smem_bytes <= H100_SMEM
    assert p.num_splits * p.pages_per_split >= 64


# ---------------------------------------------------------------------------
# the algorithm
# ---------------------------------------------------------------------------

# page 16, M = 128: rows of length 0, 1, ps - 1, ps, ps + 1 and 2048; the
# 17-token row sees one split and leaves the others empty; windows and
# chunks start inside splits
LONG = [0, 1, 15, 16, 17, 2048]
_EMU_CASES = [
    (1, "float32", {}), (1, "bf16", {"window": 50}),
    (1, "int8", {"chunk": 300}),
    (2, "float32", {"window": 1000}), (2, "int8", {}),
    (2, "bf16", {"logit_cap": 5.0}),
    (4, "int8", {"window": 50}), (4, "float32", {"v_dim": 8}),
    (4, "bf16", {"chunk": 300}),
    (8, "bf16", {}), (8, "float32", {"chunk": 300, "window": 1000}),
    (8, "int8", {"v_dim": 8}),
]


@pytest.mark.parametrize("g,dtype,kw", _EMU_CASES,
                         ids=[f"g{g}-{d}-{'-'.join(kw) or 'full'}"
                              for g, d, kw in _EMU_CASES])
def test_split_emulation_matches_jax_oracle(g, dtype, kw):
    h, hd, ps, m = 8, 16, 16, 128
    kk = h // g
    vdim = kw.get("v_dim")
    jx, (bt, ln), port = _case(g, LONG, h, kk, hd, ps, m, dtype,
                               share_kv=vdim is not None)
    masks = {k: kw[k] for k in ("window", "chunk", "logit_cap") if k in kw}
    jq, jk, jv = jx
    want = JAX_REF(jq, jk, jv[..., :vdim] if vdim else jv, bt, ln, **masks)
    plan = _plan(port["q"], port["k"], vdim or hd, m, dtype == "int8")
    assert plan.num_splits > 1
    got = emulate(port["q"], port["k"], port["v"], port["bt"],
                  port["lengths"], plan, v_dim=vdim, **masks, **_scales(port))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert (_np(got)[0] == 0).all()                     # the length-0 row
    # the plain version the card holds the kernel against agrees too
    plain = ops.paged_attention(port["q"], port["k"], port["v"], port["bt"],
                                port["lengths"], v_dim=vdim, **masks,
                                **_scales(port))
    np.testing.assert_allclose(_np(got), _np(plain), **TOL[dtype])


@pytest.mark.parametrize("sms", [1, 4, 132])
def test_split_emulation_any_plan(sms):
    """The same inputs under plans from one split a row (one SM) to a
    page a split: the result does not depend on where splits fall."""
    h, hd, ps, m = 4, 16, 16, 128
    jx, (bt, ln), port = _case(5, LONG, h, 2, hd, ps, m, "float32")
    want = JAX_REF(*jx, bt, ln, window=1000)
    plan = paged_plan(len(LONG), 2, 2, m, ps, hd, hd, 4, False, sms,
                      H100_SMEM)
    got = emulate(port["q"], port["k"], port["v"], port["bt"],
                  port["lengths"], plan, window=1000)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype,kw,prefetch", [
    ("float32", {"window": 20}, False),
    ("int8", {"chunk": 24}, True),
    ("bf16", {"logit_cap": 5.0}, False),
])
def test_split_emulation_matches_pallas_kernel(dtype, kw, prefetch):
    """Small cases against the TPU kernel itself (interpret mode), with
    splits of one page: lengths 0, ps - 1, ps + 1 and M * ps."""
    h, kk, hd, ps, m = 4, 2, 16, 8, 6
    lengths = [0, 7, 9, 48]
    jx, (bt, ln), port = _case(3, lengths, h, kk, hd, ps, m, dtype)
    extra = {}
    if dtype == "int8":
        extra = dict(k_scales=jnp.asarray(port["k_scales"].float().numpy(),
                                          jnp.bfloat16),
                     v_scales=jnp.asarray(port["v_scales"].float().numpy(),
                                          jnp.bfloat16))
        jk, jv = port["k"].numpy(), port["v"].numpy()
    else:
        jk, jv = jx[1], jx[2]
    pf = None
    if prefetch:
        pf = np.concatenate([bt, ln[:, None]], axis=1).astype(np.int32)
    want = jax_paged(jx[0], jk, jv, bt, ln, interpret=True, prefetch=pf,
                     **kw, **extra)
    plan = _plan(port["q"], port["k"], hd, m, dtype == "int8")
    assert plan.num_splits == m
    got = emulate(port["q"], port["k"], port["v"], port["bt"],
                  port["lengths"], plan, **kw, **_scales(port))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_cuda_path_still_raises_without_a_card():
    """No fallback: a CPU tensor handed to the kernel's wrapper raises
    (no CUDA here) and counts no launch."""
    before = dict(ops.launches)
    q = torch.zeros((1, 2, 8))
    pages = torch.zeros((3, 4, 2, 8))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.ones((1,), dtype=torch.int32)
    with pytest.raises((RuntimeError, ValueError)):
        paged_attention_cuda(q, pages, pages, bt, ln)
    assert ops.launches == before
