"""K3: the port's whole-prompt flash attention against the JAX package.

``flash_attention_plain`` (what ``csrc/flash_attention.cu`` is held
against on the card) runs here on the CPU against the JAX oracle
``repro.kernels.ref.flash_attention_ref`` on the five sweep shapes of
``tests/test_kernels.py`` and against the Pallas kernel itself in
interpret mode.  Inputs are drawn with numpy and handed to both
packages.  Tolerances as the JAX sweep's: 2e-5 in fp32 (summation
order); 2e-2 with bf16 operands (bf16 keeps 8 mantissa bits, and the
oracle scales q in bf16 where the kernel scales it in fp32 after the
upcast).
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
