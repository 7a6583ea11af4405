"""K4: the algorithm of the port's selective-scan kernel.

``csrc/selective_scan.cu`` runs each channel's n states 8 a lane on
n_pad / 8 lanes, walks time in one pass, in runs of ``R`` = 4 steps
whose decays are ``2 ** (dt * A log2 e)`` (``ex2`` on a pre-scaled A),
and sums y over a channel's lanes once a run by a transpose-reduce.
The CUDA kernel runs only on the card (``chip_smoke.py`` holds it
against ``selective_scan_ref``); here its constants and names are
checked against the source, and a torch emulation of its algorithm is
held against the JAX oracle ``repro.kernels.ref.selective_scan_ref``
and, on two small cases, against the Pallas kernel in interpret mode.
Inputs are drawn with numpy and handed to both packages.  Tolerance:
2e-5 absolute + 2e-5 relative in fp32, as the JAX sweep holds the TPU
kernel and ``chip_smoke.py`` holds K4.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as k4

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
R = 4                        # csrc kRun: time steps in flight a thread
S = 8                        # csrc kStatesPerLane
LOG2E = 1.4426950408889634
JAX_REF = jax.jit(jref.selective_scan_ref)
CSRC = Path(k4.__file__).resolve().parents[1] / "csrc" / "selective_scan.cu"


def _scan_inputs(b, s, d, n, seed=0, h0=False):
    """numpy fp32 scan operands, distributed as in the JAX sweep."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((b, s, d)))).astype(np.float32)
    bm = rs.standard_normal((b, s, n)).astype(np.float32)
    cm = rs.standard_normal((b, s, n)).astype(np.float32)
    am = -np.exp(rs.standard_normal((d, n)) * 0.5).astype(np.float32)
    dv = rs.standard_normal((d,)).astype(np.float32)
    return [x, dt, bm, cm, am, dv] + (
        [rs.standard_normal((b, d, n)).astype(np.float32)] if h0 else [])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **SCAN_TOL)


def lanes_for(n: int) -> int:
    """Lanes a channel occupies (the source's ``launch_lanes``): n
    rounded up to a power of two >= 8, over 8 states a lane."""
    n_pad = S
    while n_pad < n:
        n_pad *= 2
    return n_pad // S


def run_step(lane: int, lanes: int) -> int:
    """The step of a run whose y lane ``lane`` stores first (the
    source's ``run_step``)."""
    if lanes == 1:
        return 0
    if lanes == 2:
        return 2 * (lane & 1)
    return 2 * (lane & 1) + ((lane >> 1) & 1)


def stored_steps(lane: int, lanes: int) -> list:
    """The steps of a run lane ``lane`` stores (the source's
    ``store_run``, with its store mask: lanes >= 4 hold copies)."""
    if lanes == 1:
        return list(range(R))
    if lanes == 2:
        return [run_step(lane, 2), run_step(lane, 2) + 1]
    return [run_step(lane, lanes)] if lane < 4 else []


# ---------------------------------------------------------------------------
# the kernel's source
# ---------------------------------------------------------------------------

def test_constants_and_names_match_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kStatesPerLane") == S
    assert const("kMaxState") == k4.MAX_STATE
    assert const("kRun") == R
    assert "n_pad / kStatesPerLane" in src           # lanes_for's rule
    assert [lanes_for(n) for n in (1, 4, 5, 8, 9, 16, 17, 33, 64)] == [
        1, 1, 1, 1, 2, 2, 4, 8, 8]
    # every kernel carries selective_scan_kernel in its name (the prefill
    # profile sums K4's rows by it)
    names = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", src)
    assert names and all("selective_scan_kernel" in nm for nm in names)
    # the C entry point takes what the wrapper passes
    sig = re.search(r'extern "C" int selective_scan_launch\(([^)]*)\)', src)
    assert len(sig.group(1).split(",")) == len(k4.ARGTYPES)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_every_step_of_a_run_is_stored_once(lanes):
    """After the transpose-reduce each step of a run is stored by exactly
    one of the channel's lanes, so y is written whole and once."""
    steps = [t for lane in range(lanes) for t in stored_steps(lane, lanes)]
    assert sorted(steps) == list(range(R))


# ---------------------------------------------------------------------------
# the kernel's algorithm, emulated in torch
# ---------------------------------------------------------------------------

def transpose_reduce(acc):
    """y of a run from the lanes' partial sums ``acc`` (..., L, R), as
    the kernel's shuffles combine them: lane pairs (xor 1) swap halves
    of the run, then (L >= 4) pairs at xor 2 swap quarters, then the
    rest of the lanes sum by xor butterflies; lane l then holds step
    2 (l & 1) + ((l >> 1) & 1).  Returns (..., R): each step's y as the
    lane that stores it holds it."""
    lanes = acc.shape[-2]
    if lanes == 1:
        return acc[..., 0, :]
    idx = torch.arange(lanes)
    b0 = (idx & 1).bool()
    a = [acc[..., r] for r in range(R)]               # each (..., L)
    w0 = torch.where(b0, a[2], a[0]) + torch.where(b0, a[0], a[2])[..., idx ^ 1]
    w1 = torch.where(b0, a[3], a[1]) + torch.where(b0, a[1], a[3])[..., idx ^ 1]
    out = [None] * R
    if lanes == 2:
        out[0], out[1] = w0[..., 0], w1[..., 0]
        out[2], out[3] = w0[..., 1], w1[..., 1]
        return torch.stack(out, -1)
    b1 = ((idx >> 1) & 1).bool()
    z = torch.where(b1, w1, w0) + torch.where(b1, w0, w1)[..., idx ^ 2]
    o = 4
    while o < lanes:
        z = z + z[..., idx ^ o]
        o *= 2
    for lane in range(4):
        out[2 * (lane & 1) + ((lane >> 1) & 1)] = z[..., lane]
    return torch.stack(out, -1)


def emulate(x, dt, bm, cm, am, dv, h0=None):
    """The kernel's algorithm in torch, fp32: each channel's states 8 a
    lane on ``lanes_for(n)`` lanes (padded states stay 0), the sequence
    padded with zero steps to whole runs (they leave h unchanged, as the
    kernel's zero-filled tile rows do), and per run of R steps the
    decays ``2 ** (dt A log2 e)`` and (dt x) B computed before the h
    chain, y through :func:`transpose_reduce` with D x entering on lane
    0.  x/dt (B, S, d), bm/cm (B, S, n), am (d, n), dv (d,), h0
    (B, d, n) or None.  Returns (y (B, S, d), h_final (B, d, n))."""
    b, length, d = x.shape
    n = bm.shape[-1]
    lanes = lanes_for(n)

    def states(t):                                # (..., n) -> (..., L, S)
        t = torch.nn.functional.pad(t, (0, S * lanes - n))
        return t.reshape(*t.shape[:-1], lanes, S)
    a2 = states(am * LOG2E)
    h = (states(h0).clone() if h0 is not None
         else torch.zeros((b, d, lanes, S)))
    pad = -length % R
    x, dt = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (x, dt))
    bq, cq = (torch.nn.functional.pad(states(t), (0, 0, 0, 0, 0, pad))
              for t in (bm, cm))
    dd0 = torch.zeros((d, lanes))
    dd0[:, 0] = dv
    ys = []
    for t0 in range(0, length + pad, R):
        e = torch.exp2(dt[:, t0:t0 + R, :, None, None] * a2)  # (B,R,d,L,S)
        u = dt[:, t0:t0 + R] * x[:, t0:t0 + R]
        ub = u[..., None, None] * bq[:, t0:t0 + R, None]
        acc = dd0 * x[:, t0:t0 + R, :, None]               # (B,R,d,L)
        for r in range(R):
            for k in range(S):
                h[..., k] = e[:, r, ..., k] * h[..., k] + ub[:, r, ..., k]
                acc[:, r] = acc[:, r] + h[..., k] * cq[:, t0 + r, None, :, k]
        ys.append(transpose_reduce(acc.permute(0, 2, 3, 1)))  # (B,d,R)
    y = (torch.cat(ys, -1).permute(0, 2, 1)[:, :length] if ys
         else torch.zeros((b, 0, d)))
    return y, h.reshape(b, d, S * lanes)[..., :n]


def _emulated(inp, h0=None):
    h0 = torch.from_numpy(h0) if isinstance(h0, np.ndarray) else h0
    return emulate(*(torch.from_numpy(a) for a in inp[:6]), h0)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_transpose_reduce_puts_each_steps_sum_on_its_lane(lanes):
    rs = np.random.RandomState(5 + lanes)
    acc = torch.from_numpy(rs.standard_normal((3, lanes, R))
                           .astype(np.float32))
    torch.testing.assert_close(transpose_reduce(acc), acc.sum(-2),
                               rtol=1e-6, atol=1e-6)


# S: empty, one step, R - 1, R + 1, a served tile (64 steps) - 1 / + 1,
# two tiles + 5
@pytest.mark.parametrize("s", [0, 1, R - 1, R + 1, 63, 65, 133])
@pytest.mark.parametrize("with_h0", [False, True])
def test_emulation_matches_oracle_by_length(s, with_h0):
    inp = _scan_inputs(2, s, 12, 16, seed=s, h0=True)
    y, h = _emulated(inp, inp[6] if with_h0 else None)
    if with_h0:     # the port's plain version, itself held against JAX
        wy, wh = ref.selective_scan_ref(*(torch.from_numpy(a) for a in inp))
    else:
        wy, wh = JAX_REF(*inp[:6])
    _close(y, wy)
    _close(h, wh)


@pytest.mark.parametrize("n", [1, 5, 16, 64])
def test_emulation_matches_oracle_by_state_size(n):
    """n = 1 and 5 (one lane, padded to 8 states), 16 (the served 2
    lanes), 64 (8 lanes: a butterfly after the transpose); 101 steps,
    with and without h0."""
    inp = _scan_inputs(1, 101, 7, n, seed=n, h0=True)
    y, h = _emulated(inp)
    jy, jh = JAX_REF(*inp[:6])
    _close(y, jy)
    _close(h, jh)
    y, h = _emulated(inp, inp[6])
    wy, wh = ref.selective_scan_ref(*(torch.from_numpy(a) for a in inp))
    _close(y, wy)
    _close(h, wh)


@pytest.mark.parametrize("cut", [1, R, 64, 77])
def test_emulation_chaining_equals_one_scan(cut):
    """Two calls, the second from the first's h_final, equal one scan of
    the whole in the JAX oracle, wherever the sequence is cut."""
    inp = _scan_inputs(2, 150, 10, 16, seed=7)
    first = [a[:, :cut] if a.ndim == 3 else a for a in inp]
    second = [a[:, cut:] if a.ndim == 3 else a for a in inp]
    y1, h1 = _emulated(first)
    y2, h2 = _emulated(second, h1)
    jy, jh = JAX_REF(*inp)
    _close(torch.cat([y1, y2], 1), jy)
    _close(h2, jh)


@pytest.mark.parametrize("with_h0", [False, True])
def test_emulation_flushes_tiny_decays_to_zero(with_h0):
    """Steps whose dt A lies far below -87 (exp below 2 ** -126, which
    ``ex2.approx.ftz`` flushes to 0): the decay is 0, exp's limit, and
    the scan still matches the oracle."""
    inp = _scan_inputs(1, 40, 9, 16, seed=3, h0=True)
    assert inp[4].max() < -0.2
    inp[1][:, ::7] = 1000.0           # dt A < -200 on every seventh step
    y, h = _emulated(inp, inp[6] if with_h0 else None)
    wy, wh = ref.selective_scan_ref(*(torch.from_numpy(a)
                                      for a in inp[:6 + with_h0]))
    _close(y, wy)
    _close(h, wh)


@pytest.mark.parametrize("with_h0", [False, True])
def test_emulation_of_bf16_x_matches_plain(with_h0):
    """bf16 x, upcast as the kernel upcasts it in registers, against the
    plain version given the bf16 tensor."""
    inp = _scan_inputs(2, 37, 16, 16, seed=13, h0=True)
    xb = torch.from_numpy(inp[0]).to(torch.bfloat16)
    rest = [torch.from_numpy(a) for a in inp[1:]]
    h0 = rest[5] if with_h0 else None
    y, h = emulate(xb.float(), *rest[:5], h0)
    wy, wh = ref.selective_scan_ref(xb, *rest[:5], h0)
    _close(y, wy)
    _close(h, wh)


@pytest.mark.parametrize("b,s,d,n,chunk,bd", [
    (2, 96, 32, 4, 32, 32),
    (1, 128, 64, 16, 64, 32),
])
def test_emulation_matches_pallas_interpret(b, s, d, n, chunk, bd):
    inp = _scan_inputs(b, s, d, n, seed=11)
    y, _ = _emulated(inp)
    py = pallas_scan(*inp, chunk=chunk, block_d=bd, interpret=True)
    _close(y, py)
