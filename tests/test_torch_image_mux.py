"""The port's image mux against the JAX package's: the CNN zoo and the
4-conv mux backbone, model-level routing, ``MuxServer.serve`` and the
continuous-batching ``MuxScheduler``, on the same inputs (numpy, seeded)
and the same params (made by the port's initialisers from a seeded
generator and carried across with ``repro_torch.convert``).

Tolerances (fp32 on both sides, convolutions in full fp32): the zoo's
logits and embeddings and the backbone's meta-features to 1e-4; routing
plans, buckets and padding exactly; ``serve``'s weights to 1e-5 and its
outputs to 1e-4, its assignments, kept rows and Eq. 14 meter exactly on
rows whose routing is not within 1e-5 of a tie; the scheduler's
assignments exactly, each output bitwise equal to the port's own
``reference_output`` and within 1e-4 of JAX's.  The JAX side runs under
``jax.jit``.
"""
import asyncio
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import routing as jrouting
from repro.core.multiplexer import init_image_backbone as jinit_image
from repro.core.multiplexer import init_mux as jinit_mux
from repro.models import cnn as jcnn
from repro.serving.mux_server import MuxServer as JaxMuxServer
from repro.serving.mux_server import MuxServerConfig as JaxMuxServerConfig
from repro.serving.scheduler import MuxScheduler as JaxMuxScheduler
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import convert
from repro_torch.configs import paper_mux
from repro_torch.core import multiplexer as tmultiplexer
from repro_torch.core import routing
from repro_torch.models import cnn
from repro_torch.serving.backend import InProcessMuxBackend
from repro_torch.serving.mux_server import MuxServer, MuxServerConfig
from repro_torch.serving.scheduler import (EventType, MuxScheduler,
                                           SamplingParams, SchedulerConfig,
                                           TrafficConfig, arrival_times,
                                           replay)
from repro_torch.serving.scheduler.admission import (AdmissionController,
                                                     BudgetExceeded)
from repro_torch.serving.scheduler.batcher import ModelQueue
from repro_torch.serving.scheduler.metrics import SchedulerMetrics
from repro_torch.serving.scheduler.request import BUDGET_EXCEEDED, Request

FEATURE_TOL = 1e-4
WEIGHT_TOL = 1e-5
ZOO = ("zoo_xxs", "zoo_xs", "zoo_s")        # bench_scheduler.py's zoo
IMAGE_SIZE = 16                             # and its image size


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _zoo():
    """The six-CNN zoo and the mux backbone (meta_dim 64) from the port's
    initialisers (a seeded generator), and their JAX copies."""
    gen = torch.Generator().manual_seed(0)
    tzoo = cnn.init_zoo(gen, device="cpu")
    tnet = cnn.init_mux_backbone(gen, meta_dim=64, device="cpu")
    return convert.to_numpy(tzoo), tzoo, convert.to_numpy(tnet), tnet


CNN_NAMES = list(jcnn.ZOO_SPECS) + ["mux_backbone"]


@pytest.mark.parametrize("name", CNN_NAMES)
def test_cnn_matches_jax(name):
    """Every zoo CNN's logits and embeddings, and the mux backbone's
    meta-features, at 32x32, B = 4, within 1e-4 of JAX's; the analytic
    FLOPs (``cnn_flops``, ``zoo_costs``, ``mux_flops``) equal."""
    jzoo, tzoo, jnet, tnet = _zoo()
    x = _images(4, 32, seed=CNN_NAMES.index(name))
    if name == "mux_backbone":
        want = np.asarray(jax.jit(jcnn.mux_backbone_forward)(jnet, x))
        got = cnn.mux_backbone_forward(tnet, torch.from_numpy(x))
        assert got.shape == (4, 64)
        np.testing.assert_allclose(got.numpy(), want, atol=FEATURE_TOL,
                                   rtol=0)
        for size in (16, 32):
            assert cnn.mux_flops(image_size=size) == jcnn.mux_flops(
                image_size=size)
        return
    cps = jcnn.ZOO_SPECS[name]["convs_per_stage"]
    want = jax.jit(functools.partial(jcnn.cnn_forward, convs_per_stage=cps))(
        jzoo[name], x)
    got = cnn.cnn_forward(tzoo[name], torch.from_numpy(x),
                          convs_per_stage=cps)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=FEATURE_TOL, rtol=0)
    spec = jcnn.ZOO_SPECS[name]
    assert cnn.cnn_flops(**spec) == jcnn.cnn_flops(**spec)
    for size in (16, 32):
        assert cnn.zoo_costs(image_size=size) == jcnn.zoo_costs(
            image_size=size)
    assert paper_mux.config().costs() == cnn.zoo_costs()


def test_init_shapes_match_jax():
    """The port's initialisers make the reference's trees: the same keys,
    shapes and dtypes (JAX's from ``jax.eval_shape``), so params carry
    across both ways; the conv biases start at zero."""
    _, tzoo, _, tnet = _zoo()
    key = jax.random.key(0)
    names = ["a", "b"]
    costs = {"a": 1.0, "b": 3.0}
    gen = torch.Generator().manual_seed(1)
    tmux = tmultiplexer.init_mux(
        gen, backbone=tmultiplexer.init_image_backbone(
            gen, meta_dim=32, device="cpu"),
        model_names=names, costs=costs, meta_dim=32, proj_dim=16,
        device="cpu")
    pairs = [
        (jax.eval_shape(lambda k: jcnn.init_zoo(k), key), tzoo),
        (jax.eval_shape(lambda k: jcnn.init_mux_backbone(k, meta_dim=64),
                        key), tnet),
        (jax.eval_shape(lambda k: jinit_mux(
            k, backbone=jinit_image(k, meta_dim=32), model_names=names,
            costs=costs, meta_dim=32, proj_dim=16), key), tmux)]
    for j, t in pairs:
        jl, jtree = jax.tree.flatten(j)
        tl, ttree = jax.tree.flatten(convert.to_numpy(t))
        assert jtree == ttree
        assert [(a.shape, a.dtype) for a in jl] == \
            [(a.shape, a.dtype) for a in tl]
    assert not any(p["b"].any() for p in tzoo["zoo_m"]["stages"])


ROUTING_CASES = {
    "balanced": (np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32), 4),
    "one_model": (np.array([1] * 8, np.int32), 8),
    "overflow": (np.array([2, 0, 2, 2, 1, 2, 0, 0], np.int32), 2),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_routing_matches_jax(case):
    """``bucket_by_model``, ``dispatch``, ``combine``, ``pad_bucket``,
    ``pad_bucket_host`` and ``multiplexed_apply`` exactly equal to JAX's:
    a balanced assignment, all rows on one model, and an overflow at
    capacity 2 (the overflowed rows dropped, zero-filled on the way
    back)."""
    assign, cap = ROUTING_CASES[case]
    n = 3
    x = np.random.default_rng(5).standard_normal((8, 4)).astype(np.float32)
    tx, ta = torch.from_numpy(x), torch.from_numpy(assign)

    jplan = jax.jit(jrouting.bucket_by_model, static_argnums=(1, 2))(
        assign, n, cap)
    plan = routing.bucket_by_model(ta, n, cap)
    for k in ("order", "inv", "slot", "kept"):
        np.testing.assert_array_equal(plan[k].numpy(), np.asarray(jplan[k]),
                                      err_msg=k)
    assert (not plan["kept"].all()) == (case == "overflow")

    jb = jax.jit(jrouting.dispatch, static_argnums=(2, 3))(x, jplan, n, cap)
    tb = routing.dispatch(tx, plan, n, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    outs = tb * 2.0 + 1.0
    np.testing.assert_array_equal(
        routing.combine(outs, plan).numpy(),
        np.asarray(jax.jit(jrouting.combine)(np.asarray(jb) * 2.0 + 1.0,
                                             jplan)))

    fns_t = [lambda b, m=m: b * float(m + 1) for m in range(n)]
    fns_j = [lambda b, m=m: b * float(m + 1) for m in range(n)]
    jout, jkept = jax.jit(lambda xx, aa: jrouting.multiplexed_apply(
        xx, aa, fns_j, capacity=cap))(x, assign)
    out, kept = routing.multiplexed_apply(tx, ta, fns_t, capacity=cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))

    k = 3
    jbucket, jvalid = jax.jit(jrouting.pad_bucket, static_argnums=1)(
        x[:k], cap)
    bucket, valid = routing.pad_bucket(tx[:k], cap)
    hbucket, hvalid = routing.pad_bucket_host(list(x[:k]), cap)
    for got_b, got_v in ((bucket.numpy(), valid.numpy()), (hbucket, hvalid)):
        np.testing.assert_array_equal(got_b, np.asarray(jbucket))
        np.testing.assert_array_equal(got_v, np.asarray(jvalid))
    ref_b, ref_v = jrouting.pad_bucket_host(list(x[:k]), cap)
    np.testing.assert_array_equal(hbucket, ref_b)
    np.testing.assert_array_equal(hvalid, ref_v)


@functools.lru_cache(maxsize=None)
def _servers():
    """bench_scheduler.py's three-model zoo at 16x16 and an image mux
    (meta_dim 32) from the port's initialisers, their JAX copies, and
    the model functions of both."""
    gen = torch.Generator().manual_seed(1)
    costs = cnn.zoo_costs(ZOO, image_size=IMAGE_SIZE)
    tzoo = cnn.init_zoo(gen, names=ZOO, device="cpu")
    tmux = tmultiplexer.init_mux(
        gen, backbone=tmultiplexer.init_image_backbone(
            gen, meta_dim=32, device="cpu"),
        model_names=list(ZOO), costs=costs, meta_dim=32, proj_dim=16,
        device="cpu")
    jzoo, jmux = convert.to_numpy(tzoo), convert.to_numpy(tmux)

    def fns(forward, zoo):
        return [lambda xs, n=n: forward(
            zoo[n], xs, convs_per_stage=jcnn.ZOO_SPECS[n]["convs_per_stage"]
        )[0] for n in ZOO]
    return (jmux, fns(jcnn.cnn_forward, jzoo), tmux,
            fns(cnn.cnn_forward, tzoo), [costs[n] for n in ZOO])


def _threshold(jmux, x):
    """A threshold on the cheapest model's weight in the widest gap
    between the middle half of its sorted values on x: a quarter to
    three quarters of the rows clear it there, the rest go to a larger
    model, and no row sits on it."""
    w = np.asarray(JaxMuxServer(jmux, [], [1.0, 1.0, 1.0]).probe_weights(x))
    w0 = np.sort(w[:, 0])
    lo = len(w0) // 4
    i = lo + int(np.argmax(np.diff(w0[lo:len(w0) - lo + 1])))
    return float((w0[i] + w0[i + 1]) / 2)


def _clear_rows(w, thr):
    """Rows whose selection is not within WEIGHT_TOL of a tie: argmax's
    top two apart, or every weight away from the threshold."""
    if thr is None:
        top = np.sort(w, axis=-1)
        return top[:, -1] - top[:, -2] > WEIGHT_TOL
    return (np.abs(w - thr) > WEIGHT_TOL).all(axis=-1)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("policy", ["argmax", "threshold"])
def test_serve_matches_jax(policy, fused):
    """``MuxServer.serve`` on B = 16 images against the JAX server's, with
    K2's meta form (``use_fused_head``) and with ``mux_forward``, under
    argmax (capacity int(1.5 * 16 / 3) = 8) and a threshold (capacity
    B): weights to 1e-5, outputs to 1e-4; assign, kept and flops equal
    on clear rows; mean_flops and called_fraction equal."""
    jmux, jfns, tmux, tfns, costs = _servers()
    x = _images(16, IMAGE_SIZE, seed=7)
    thr = None if policy == "argmax" else _threshold(jmux, x)
    jres = JaxMuxServer(jmux, jfns, costs, JaxMuxServerConfig(
        threshold=thr, use_fused_head=fused)).serve(x)
    res = MuxServer(tmux, costs, MuxServerConfig(
        threshold=thr, use_fused_head=fused), device="cpu",
        model_fns=tfns).serve(x)
    w = np.asarray(jres["weights"])
    np.testing.assert_allclose(res["weights"].numpy(), w, atol=WEIGHT_TOL,
                               rtol=0)
    clear = _clear_rows(w, thr)
    assert clear.sum() >= 15, "most rows are near-ties"
    for k in ("assign", "kept", "flops"):
        np.testing.assert_array_equal(res[k].numpy()[clear],
                                      np.asarray(jres[k])[clear], err_msg=k)
    kept = res["kept"].numpy() & clear
    np.testing.assert_allclose(res["output"].numpy()[kept],
                               np.asarray(jres["output"])[kept],
                               atol=FEATURE_TOL, rtol=0)
    assert not res["output"].numpy()[~res["kept"].numpy()].any()
    if clear.all():
        assert res["mean_flops"] == pytest.approx(jres["mean_flops"],
                                                  rel=1e-6)
        assert res["called_fraction"] == jres["called_fraction"]
    if policy == "threshold":
        assert res["kept"].all() and len(set(res["assign"].tolist())) >= 2


def test_scheduler_matches_jax():
    """The port's ``MuxScheduler`` on the CPU: 24 requests on a fixed
    Poisson schedule (400 requests/s) through admission, micro-batching
    and per-model workers.  Assignments equal JAX's
    ``reference_assignment``; each output is bitwise equal to the port's
    ``reference_output`` and within 1e-4 of JAX's."""
    jmux, jfns, tmux, tfns, costs = _servers()
    xs = _images(24, IMAGE_SIZE, seed=11)
    scfg = dict(max_batch_size=8, max_wait_ms=4.0, default_slo_ms=250.0)
    server = MuxServer(tmux, costs, device="cpu", model_fns=tfns)
    sched = MuxScheduler(server, SchedulerConfig(**scfg))
    jsched = JaxMuxScheduler(JaxMuxServer(jmux, jfns, costs),
                             JaxSchedulerConfig(**scfg))
    sched.warmup(xs[0])

    async def run():
        async with sched:
            futures = await replay(sched.submit, list(xs), arrival_times(
                TrafficConfig(rate=400.0, num_requests=len(xs), seed=0)))
            return await asyncio.gather(*futures)
    outputs = asyncio.run(run())
    for i, out in enumerate(outputs):
        m = sched.reference_assignment(xs[i])
        assert m == jsched.reference_assignment(xs[i]), f"request {i}"
        ref = sched.reference_output(xs[i], m)
        assert np.array_equal(out, ref), f"request {i}: not bitwise"
        np.testing.assert_allclose(out, jsched.reference_output(xs[i], m),
                                   atol=FEATURE_TOL, rtol=0)
    snap = sched.snapshot()
    assert snap["completed"] == len(xs) and snap["failed"] == 0
    assert sum(snap["called_fraction"]) == pytest.approx(1.0)
    assert 0.0 < snap["mean_batch_fill"] <= 1.0


class FakeServer:
    """A duck-typed server: probe weight one-hot at |x[0]|, model m
    multiplies by m + 1."""

    def __init__(self, n=3):
        self.costs = np.asarray([1.0, 2.0, 4.0][:n], np.float32)
        self._n = n

    @property
    def num_models(self):
        return self._n

    def probe_weights(self, x):
        level = np.clip(np.abs(np.asarray(x)[:, 0]).astype(int), 0,
                        self._n - 1)
        w = np.zeros((len(level), self._n), np.float32)
        w[np.arange(len(level)), level] = 1.0
        return w

    def select(self, w):
        return np.argmax(np.asarray(w), axis=-1).astype(np.int32)

    def model_step(self, m, bucket):
        return np.asarray(bucket) * float(m + 1)


def test_load_shed_fails_fast_with_budget_exceeded():
    """When no model — selected or degraded — can meet the SLO budget,
    shed_on_overload fails the request at admission with
    BUDGET_EXCEEDED; without the flag the degraded request still queues
    and serves."""
    async def run(shed):
        sched = MuxScheduler(FakeServer(), SchedulerConfig(
            max_batch_size=2, max_wait_ms=1.0, deadline_degrade=True,
            shed_on_overload=shed))
        sched.metrics._service_ema = [10.0, 10.0, 10.0]   # nobody fits 50ms
        async with sched:
            h = sched.submit(np.full(4, 2.0, np.float32),
                             SamplingParams(stream=True), slo_ms=50.0)
            evs = [ev async for ev in h]
            try:
                out, exc = await h, None
            except BudgetExceeded as e:
                out, exc = None, e
        return sched, out, exc, evs

    sched, out, exc, evs = asyncio.run(run(True))
    assert out is None and isinstance(exc, BudgetExceeded)
    assert exc.status == "BUDGET_EXCEEDED"
    assert evs[-1].type is EventType.FINISHED
    assert evs[-1].finish_reason == BUDGET_EXCEEDED
    snap = sched.metrics.snapshot()
    assert snap["budget_exceeded"] == 1 and snap["failed"] == 1
    assert snap["arrived"] == (snap["completed"] + snap["failed"]
                               + snap["cancelled"])

    sched, out, exc, _evs = asyncio.run(run(False))
    assert exc is None
    np.testing.assert_array_equal(out, np.full(4, 2.0))   # degraded to m=0
    snap = sched.metrics.snapshot()
    assert snap["budget_exceeded"] == 0 and snap["deadline_degraded"] == 1


def test_queue_depth_scales_service_estimate():
    """The admission estimate is EMA * (1 + batches of work ahead):
    queued requests count in whole buckets from the backend's capacity,
    so a deep queue degrades before an idle one."""
    server = FakeServer(n=1)
    queue = ModelQueue(0)
    metrics = SchedulerMetrics(costs=[1.0])
    assert metrics.service_estimate(0) is None
    metrics._service_ema = [0.1]
    ctrl = AdmissionController(
        server, [queue], metrics, clock=lambda: 0.0,
        backends=[InProcessMuxBackend(server, 0, bucket_capacity=2)])
    assert ctrl.service_estimate(0) == pytest.approx(0.1)
    for rid in range(4):
        queue.push(Request(rid=rid, x=np.zeros(2), arrival_t=0.0,
                           deadline_t=1.0), now=0.0)
    # 4 live requests in buckets of 2 -> 2 batches ahead
    assert ctrl.service_estimate(0) == pytest.approx(0.1 * 3)
    queue.peek().cancel(0.5)
    queue.discount_live()
    assert queue.live_depth() == 3
    assert queue.pop().is_terminal             # the cancelled leftover
    assert queue.live_depth() == 3
    assert not queue.pop().is_terminal         # a live one: discounted
    assert queue.live_depth() == 2


def test_admission_refuses_a_second_signature():
    """The buckets serve one (shape, dtype): after the first admission a
    request of another shape fails at admission, through its future."""
    async def run():
        sched = MuxScheduler(FakeServer(), SchedulerConfig(max_wait_ms=1.0))
        async with sched:
            ok = await sched.submit(np.full(4, 1.0, np.float32))
            bad = sched.submit(np.full(5, 1.0, np.float32))
            with pytest.raises(ValueError, match="serving signature"):
                await bad
        return ok, sched.metrics.snapshot()
    ok, snap = asyncio.run(run())
    np.testing.assert_array_equal(ok, np.full(4, 2.0))
    assert snap["completed"] == 1 and snap["failed"] == 1


def test_fp32_convs_restores_the_flag_across_threads():
    """``fp32_convs`` holds cuDNN's TF32 switch off while any thread is
    inside and restores it when the last one leaves."""
    before = torch.backends.cudnn.allow_tf32
    inside, release = threading.Barrier(3), threading.Event()
    seen = []

    def worker():
        with cnn.fp32_convs():
            inside.wait()
            release.wait()
            seen.append(torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        inside.wait()
        assert torch.backends.cudnn.allow_tf32 is False
        release.set()
        for t in threads:
            t.join()
        assert seen == [False, False]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_zoo_server_without_model_fns_refuses_serve():
    """A token-probe server (no ``model_fns``) has no batch step."""
    _, _, tmux, _, costs = _servers()
    server = MuxServer(tmux, costs, device="cpu")
    with pytest.raises(ValueError, match="model_fns"):
        server.serve(_images(2, IMAGE_SIZE, seed=0))
    with pytest.raises(ValueError, match="model_fns"):
        server.model_step(0, _images(2, IMAGE_SIZE, seed=0))
    with pytest.raises(ValueError, match="3 costs"):
        MuxServer(tmux, costs, device="cpu", model_fns=[lambda b: b])


def test_composed_probe_is_refused_off_the_cpu():
    """``use_fused_head=False`` is Eq. 5-6 in plain PyTorch: a server on
    a CUDA device refuses it at construction, before it touches the
    params, so the card's probe is always K2."""
    _, _, tmux, tfns, costs = _servers()
    with pytest.raises(ValueError, match="use_fused_head"):
        MuxServer(tmux, costs, MuxServerConfig(use_fused_head=False),
                  device="cuda", model_fns=tfns)
