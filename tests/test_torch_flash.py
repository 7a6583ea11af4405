"""K3: the port's whole-prompt flash attention against the JAX package.

``flash_attention_plain`` (what both CUDA variants are held against on
the card) runs here on the CPU against the JAX oracle
``repro.kernels.ref.flash_attention_ref`` on the five sweep shapes of
``tests/test_kernels.py`` and against the Pallas kernel itself in
interpret mode.  Inputs are drawn with numpy and handed to both
packages.  Tolerances as the JAX sweep's: 2e-5 in fp32 (summation
order); 2e-2 with bf16 operands (bf16 keeps 8 mantissa bits, and the
oracle scales q in bf16 where the kernel scales it in fp32 after the
upcast).  The planning function that picks the variant (bf16: the
tensor-core ``csrc/flash_attention_sm90.cu``, fp32: the SIMT
``csrc/flash_attention.cu``) is checked here, and so is a torch
emulation of the tensor-core variant's rounding against the Pallas
kernel, so the 2e-2 tolerance is shown to cover that rounding before
any card runs it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (block_q_for,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 flash_plan,
                                                 rows_without_keys)
from repro_torch.models.attention import blocked_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JAX_REF = jax.jit(jref.flash_attention_ref,
                  static_argnames=("causal", "window", "chunk", "logit_cap"))

# (b, s, t, h, k, hd, vd, window, chunk, cap): tests/test_kernels.py's
# sweep, then a window whose first live tile holds fully masked rows
# (for queries 64..127 at window 8 the first live 32- or 64-key tile
# starts at key 32 or 0, far below what rows >= 71 may see)
SWEEP = [
    (2, 128, 128, 4, 2, 64, 64, None, None, None),     # GQA causal
    (1, 256, 256, 4, 4, 64, 64, 64, None, None),       # sliding window
    (2, 96, 96, 4, 1, 32, 32, None, None, 50.0),       # MQA + softcap
    (1, 256, 256, 8, 2, 64, 64, None, 96, None),       # chunked local
    (2, 64, 192, 4, 2, 64, 32, None, None, None),      # kv-longer + vd!=hd
]
MASKED_TILE = (1, 128, 128, 4, 1, 32, 32, 8, None, None)


def _inputs(case, dtype, seed=0):
    b, s, t, h, k, hd, vd = case[:7]
    rs = np.random.RandomState(seed)
    arrs = [rs.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, k, hd), (b, t, k, vd))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          for a in jx]
    return jx, tx


def _kw(case):
    window, chunk, cap = case[7:]
    return dict(window=window, chunk=chunk, logit_cap=cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP + [MASKED_TILE],
                         ids=["gqa", "window", "mqa_cap", "chunk",
                              "kv_longer", "masked_tile"])
def test_flash_plain_matches_jax_oracle(case, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype)
    want = JAX_REF(jq, jk, jv, causal=True, **_kw(case))
    got = flash_attention_plain(q, k, v, causal=True, **_kw(case))
    assert got.dtype == q.dtype and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", [SWEEP[0], SWEEP[4], MASKED_TILE],
                         ids=["gqa", "kv_longer", "masked_tile"])
def test_flash_plain_matches_pallas_interpret(case):
    """The Pallas kernel itself (interpret mode, 64 x 64 blocks, the
    JAX package's sweep setting), fp32: top-left causal alignment at
    T > S, GQA grouping, vd != hd, fully masked rows in a live tile."""
    (jq, jk, jv), (q, k, v) = _inputs(case, "float32", seed=1)
    want = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                     interpret=True, **_kw(case))
    got = flash_attention_plain(q, k, v, causal=True, **_kw(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case", [SWEEP[1], SWEEP[3], SWEEP[4]],
                         ids=["window", "chunk", "kv_longer"])
def test_ops_attention_on_cpu_is_blocked_attention(case):
    """On the CPU the dispatcher runs the model's blocked attention,
    exactly (the JAX dispatcher's own fallback), which agrees with the
    kernel's plain version; no launch is counted."""
    _, (q, k, v) = _inputs(case, "float32", seed=2)
    before = dict(ops.launches)
    got = ops.attention(q, k, v, causal=True, **_kw(case))
    assert torch.equal(got, blocked_attention(q, k, v, causal=True,
                                              **_kw(case)))
    np.testing.assert_allclose(
        got.numpy(), flash_attention_plain(q, k, v, **_kw(case)).numpy(),
        atol=2e-5)
    assert ops.launches == before


def test_cuda_attention_never_falls_back_to_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses it here (no CUDA) instead of computing elsewhere; the
    launch counter does not move."""
    before = dict(ops.launches)
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        ops.attention(q, q, q, causal=True)
    with pytest.raises((RuntimeError, ValueError)):
        flash_attention_cuda(q.to("cpu"), q.to("cpu"), q.to("cpu"))
    assert ops.launches == before


@pytest.mark.parametrize("s,t,causal,window,chunk", [
    (16, 16, True, 3, None), (16, 16, True, None, 5), (20, 8, True, 4, None),
    (20, 8, True, None, 6), (20, 8, True, None, None), (8, 8, False, 2, None),
    (12, 4, False, None, 4)])
def test_rows_without_keys_matches_the_mask(s, t, causal, window, chunk):
    """The wrapper's refusal test counts exactly the reference mask's
    empty rows (those the oracle would fill with a uniform softmax)."""
    qp, kp = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if chunk is not None:
        mask &= kp >= (qp // chunk) * chunk
    assert rows_without_keys(s, t, causal=causal, window=window,
                             chunk=chunk) == int((~mask.any(1)).sum())


def test_block_q_keeps_group_rows_within_the_block():
    for g in (1, 2, 3, 4, 8, 16, 64):
        for s in (1, 7, 448, 1024):
            bq = block_q_for(g, s)
            assert 1 <= bq <= s and g * bq <= 64
    assert block_q_for(1, 1024) == 64 and block_q_for(8, 1024) == 8


def test_scale_default_is_inverse_sqrt_head_dim():
    _, (q, k, v) = _inputs(SWEEP[2], "float32", seed=3)
    np.testing.assert_allclose(
        flash_attention_plain(q, k, v).numpy(),
        flash_attention_plain(q, k, v, scale=1 / math.sqrt(32)).numpy(),
        atol=0)


# ---------------------------------------------------------------------------
# the variant plan (what the wrapper launches on the card)

# the served prefills: B=1, page-padded S = T, hd = vd = 128
SERVED_S = (128, 448, 1024)


def _shapes(s, h, g, hd=128, vd=128, t=None):
    t = s if t is None else t
    return (1, s, h, hd), (1, t, h // g, hd), (1, t, h // g, vd)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("s", SERVED_S)
def test_plan_puts_bf16_on_wgmma_and_fp32_on_simt(s, g):
    """bf16 takes the tensor-core variant at every served length and GQA
    group (64 rows a block: g heads x 64 / g positions, hd and vd
    padded to 128); fp32 takes the SIMT variant, which pads inside its
    own launch."""
    shapes = _shapes(s, 32, g)
    p = flash_plan(*shapes, torch.bfloat16)
    assert (p.variant, p.group, p.width) == ("wgmma", g, 128)
    assert p.block_q * g == 64
    f = flash_plan(*shapes, torch.float32)
    assert (f.variant, f.group, f.block_q, f.width) == ("simt", g,
                                                        p.block_q, 0)


@pytest.mark.parametrize("hd,vd,width", [
    (32, 32, 64), (64, 32, 64), (64, 128, 128), (96, 128, 128),
    (128, 128, 128), (136, 128, 256), (256, 256, 256)])
def test_plan_pads_both_widths_to_one_wgmma_width(hd, vd, width):
    assert flash_plan(*_shapes(64, 4, 2, hd, vd), torch.bfloat16).width \
        == width
    assert flash_plan(*_shapes(64, 4, 2, hd - 2, vd - 1),
                      torch.float32).width == 0


@pytest.mark.parametrize("dtype,hd,vd,kw,match", [
    (torch.bfloat16, 264, 264, {}, "head dims"),
    (torch.float32, 264, 128, {}, "head dims"),
    (torch.bfloat16, 36, 36, {}, "multiples of 8"),
    (torch.bfloat16, 64, 60, {}, "multiples of 8"),
    (torch.float16, 64, 64, {}, "dtype"),
    (torch.bfloat16, 64, 64, {"window": 0}, "window"),
    (torch.bfloat16, 64, 64, {"causal": False, "window": 2}, "no key")])
def test_plan_refuses_what_neither_variant_takes(dtype, hd, vd, kw, match):
    with pytest.raises(ValueError, match=match):
        flash_plan(*_shapes(64, 4, 2, hd, vd, t=48), dtype, **kw)


def test_plan_refuses_more_q_tiles_than_the_grid_takes():
    """The wgmma variant runs its q tiles along grid.y (at most 65535)."""
    assert flash_plan(*_shapes(64 * 65535, 4, 1),
                      torch.bfloat16).variant == "wgmma"
    with pytest.raises(ValueError, match="q tiles"):
        flash_plan(*_shapes(64 * 65535 + 1, 4, 1), torch.bfloat16)


def test_plan_takes_fp32_widths_the_wgmma_variant_refuses():
    assert flash_plan(*_shapes(64, 4, 2, 36, 20), torch.float32).variant \
        == "simt"


@pytest.mark.parametrize("s", SERVED_S)
def test_wgmma_blocks_take_the_longest_q_tiles_first(s):
    """Under the causal rule the plan has the tensor-core variant's
    blocks take the q tiles from the last (the kernel reads the flag),
    which is the order of non-increasing visible keys under the mask;
    without the causal rule, and for the SIMT variant, they count up."""
    p = flash_plan(*_shapes(s, 16, 1), torch.bfloat16)
    assert p.longest_first
    qp, kp = np.arange(s)[:, None], np.arange(s)[None, :]
    live = [int((kp <= qp)[i:i + p.block_q].any(0).sum())
            for i in range(0, s, p.block_q)]
    assert live[::-1] == sorted(live, reverse=True) and live[-1] == s
    assert not flash_plan(*_shapes(s, 16, 1), torch.bfloat16,
                          causal=False).longest_first
    assert not flash_plan(*_shapes(s, 16, 1), torch.float32).longest_first


def _wgmma_rounding(q, k, v, *, window, chunk, logit_cap):
    """The tensor-core variant's rounding in plain torch: bf16 q and k
    multiplied in fp32 and the scores scaled after the product (the
    kernel's bf16 wgmma accumulates in fp32), the cap, the masks, the
    fp32 softmax numerators rounded to bf16 before P V, the fp32 row
    sums after.  Returns (B, S, H, vd) fp32."""
    b, s, h, hd = q.shape
    t, kk = k.shape[1], k.shape[2]
    g = h // kk
    sc = torch.einsum("bskgd,btkd->bkgst", q.float().reshape(b, s, kk, g, hd),
                      k.float()) * (1.0 / math.sqrt(hd))
    if logit_cap is not None:
        sc = torch.tanh(sc / logit_cap) * logit_cap
    qp, kp = torch.arange(s)[:, None], torch.arange(t)[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if chunk is not None:
        mask &= kp >= (qp // chunk) * chunk
    sc = sc.masked_fill(~mask, -math.inf)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    out = torch.einsum("bkgst,btkv->bskgv", p.to(torch.bfloat16).float(),
                       v.float()) / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, v.shape[-1])


def test_wgmma_rounding_is_within_tolerance_of_the_pallas_kernel():
    """The tensor-core variant rounds at two points the plain version
    does not (scores scaled after a bf16 product, P rounded to bf16);
    emulated here, it stays within the bf16 tolerance (2e-2) of the
    JAX Pallas kernel (interpret mode, as tests/test_kernels.py runs
    it) and of the plain version, on GQA with a window and a cap."""
    case = (1, 128, 128, 4, 2, 64, 64, 48, None, 30.0)
    (jq, jk, jv), (q, k, v) = _inputs(case, "bfloat16", seed=4)
    got = _wgmma_rounding(q, k, v, **_kw(case))
    want = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                     interpret=True, **_kw(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL["bfloat16"])
    np.testing.assert_allclose(
        got.numpy(), flash_attention_plain(q, k, v, **_kw(case)).float(),
        atol=TOL["bfloat16"])
    assert not torch.equal(got.to(torch.bfloat16),
                           flash_attention_plain(q, k, v, **_kw(case)))


@pytest.mark.parametrize("case", [
    (1, 320, 320, 4, 4, 128, 128, None, None, None),
    (1, 201, 233, 16, 2, 128, 96, None, 64, 30.0)], ids=["long", "gqa"])
def test_wgmma_rounding_meets_the_per_element_limit(case):
    """The card also holds every bf16 element of the tensor-core variant
    to 4e-3 + 2e-2 |plain| (chip_smoke.py's ``BF16_FLASH_REL``); the
    emulated rounding, cast to bf16 as the kernel stores it, meets that
    limit with room to spare."""
    _, (q, k, v) = _inputs(case, "bfloat16", seed=5)
    got = _wgmma_rounding(q, k, v, **_kw(case)).to(torch.bfloat16).float()
    want = flash_attention_plain(q, k, v, **_kw(case)).float()
    assert ((got - want).abs() / (4e-3 + 2e-2 * want.abs())).max() <= 0.5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_request_raises_without_a_card(dtype):
    """Either variant's request raises on a machine without a card: the
    wrapper on CPU tensors, the dispatcher on a non-CPU device; no
    counter moves."""
    before = dict(ops.launches)
    counts = dict.fromkeys(ops.launches, 0)
    x = torch.zeros((1, 8, 2, 64), dtype=dtype)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flash_attention_cuda(x, x, x, counts=counts)
    assert not any(counts.values())
    meta = x.to("meta")
    with pytest.raises((RuntimeError, ValueError)):
        ops.attention(meta, meta, meta, causal=True)
    assert ops.launches == before


def test_ops_counts_each_launch_on_its_variant(monkeypatch):
    """The dispatcher hands its counters to the wrapper, which counts a
    launch once in ``flash_attention`` and once under the variant it
    launched (on the card, chip_smoke's K3 phase checks that count); the
    dispatcher adds none itself.  The kernel is replaced by a stub:
    there is no card here."""
    handed = []

    def stub(q, k, v, *, counts=None, **kw):
        handed.append(counts)
        return q

    monkeypatch.setattr(ops, "flash_attention_cuda", stub)
    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops.launches, 0))
    for dtype in (torch.bfloat16, torch.bfloat16, torch.float32):
        x = torch.zeros((1, 4, 2, 8), dtype=dtype, device="meta")
        ops.attention(x, x, x, causal=True)
    assert len(handed) == 3 and all(c is ops.launches for c in handed)
    assert set(ops.launches) >= {"flash_attention", "flash_attention_wgmma",
                                 "flash_attention_simt"}
    assert not any(ops.launches.values())
