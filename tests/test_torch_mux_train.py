"""The port's Algorithm 1 and the paper's runners against the JAX
package's: the synthetic images, the contrastive / ensemble /
distillation losses, the offload cost model, AdamW, the zoo and mux
training steps, the table and figure runners, and the checkpoints.

Setup: a three-CNN zoo (``zoo_xxs``, ``zoo_xs``, ``zoo_m``: the mobile /
cloud pair and a zoo with two convs a stage) at 16x16, batch 8, its
training state and mux params initialised by the JAX package (one
``jax.jit`` each) and carried to the port with ``repro_torch.convert``;
inputs are numpy from a seed.  The JAX functions run under ``jax.jit``.

Tolerances (fp32 on both sides; stated in each test): losses to 1e-5
relative; gradients to 1e-5 of the gradient's global norm.  Adam's
update divides by sqrt(v_hat): an entry whose gradient is tiny against
the two frameworks' gradient difference E can move by up to 2 lr
between them (its step is ~lr * sign(g)).  So each updated param is
held to 1e-6 plus lr * min(2, 4 E / sqrt(v_hat)), v_hat from the JAX
step's second moment: tight where the gradient stands clear of E,
2 lr where it does not.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmarks import common as jcommon
from benchmarks import fig1_expertise as jfig1
from benchmarks import fig6_separation as jfig6
from benchmarks import table1_mobile_cloud as jtable1
from benchmarks import table2_cloud_api as jtable2
from repro.checkpoint import ckpt as jckpt
from repro.configs import paper_mux as jpaper_mux
from repro.core import contrastive as jcnt
from repro.core import ensemble as jens
from repro.core import multiplexer as jmux
from repro.core import mux_train as jmt
from repro.core import offload as joffload
from repro.data import synthetic as jsyn
from repro.optim import adamw as jadamw
from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import paper_mux
from repro_torch.core import contrastive as cnt
from repro_torch.core import ensemble as ens
from repro_torch.core import multiplexer as tmux
from repro_torch.core import mux_train
from repro_torch.core import offload
from repro_torch.data import synthetic as syn
from repro_torch.optim import adamw
from repro_torch.paper import (common, fig1_expertise, fig6_separation,
                               table1_mobile_cloud, table2_cloud_api)

ZOO = ("zoo_xxs", "zoo_xs", "zoo_m")
PAIR = ("zoo_xs", "zoo_m")
SIZE, BATCH = 16, 8
SMALL = dict(zoo=ZOO, image_size=SIZE, batch_size=BATCH, zoo_steps=3,
             mux_steps=3, train_samples=2 * BATCH, eval_samples=2 * BATCH)
JCFG = dataclasses.replace(jpaper_mux.config(), **SMALL)
TCFG = dataclasses.replace(paper_mux.config(), **SMALL)
# the drivers' optimiser (train_zoo / train_mux) at 3 steps
OPT = dict(lr=JCFG.lr, weight_decay=1e-4, warmup_steps=20, total_steps=3,
           clip_norm=1.0)
JOPT, TOPT = jadamw.AdamWConfig(**OPT), adamw.AdamWConfig(**OPT)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of the gradient's global norm


def _np(t):
    return jax.tree.map(np.asarray, t)


def _t(t):
    return convert.to_torch(_np(t), "cpu")


def _by_path(t):
    return dict(tree.paths(convert.to_numpy(t) if _has_tensor(t) else t))


def _has_tensor(t):
    return any(isinstance(x, torch.Tensor) for x in tree.leaves(t))


@functools.lru_cache(maxsize=None)
def _init():
    """The JAX-initialised zoo state and three-model mux (one jit), and
    the pair mux cut from the same draws, as numpy trees."""
    k_zoo, k_mux = jax.random.split(jax.random.key(0))
    zoo, mux_all = jax.jit(lambda a, b: (jmt.init_zoo_state(a, JCFG),
                                         jmt.init_mux_state(b, JCFG)))(
        k_zoo, k_mux)
    zoo, mux_all = _np(zoo), _np(mux_all)
    idx = [ZOO.index(n) for n in PAIR]
    c = np.asarray([JCFG.costs()[n] for n in PAIR], np.float32)
    mux_pair = {"backbone": mux_all["backbone"], "v": mux_all["v"][idx],
                "cost_rel": c / c.min(),
                "distill": {n: mux_all["distill"][n] for n in PAIR}}
    return zoo, mux_all, mux_pair


def _batch(seed, zoo):
    """8 images from a seed; rows 0-5 labelled with the prediction of zoo
    model (row mod 3), rows 6-7 at random, so the contrastive loss sees
    pull, push and neutral pairs."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    label = rng.integers(0, 10, BATCH).astype(np.int32)
    tzoo = convert.to_torch(zoo, "cpu")
    with torch.no_grad():
        _, _, logits = mux_train.zoo_apply(tzoo, torch.from_numpy(img), ZOO)
    for i in range(6):
        label[i] = int(torch.argmax(logits[ZOO[i % 3]][i]))
    return {"image": img, "label": label,
            "hardness": rng.uniform(size=BATCH).astype(np.float32)}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() if k == "label"
            else torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_templates_match_jax_resize():
    """The port's bicubic upsampling (Keys a = -0.5, border taps
    renormalised) against ``jax.image.resize(..., "bicubic")`` on the
    same 4x4 fields, to 1e-5, at 32 and 16; ``F.interpolate``'s bicubic
    (a = -0.75, clamped taps) is off by more than 0.1 on the same field."""
    coarse = np.random.default_rng(0).standard_normal(
        (10, 4, 4, 3)).astype(np.float32)
    want = {}
    for size in (32, 16):
        want[size] = np.asarray(jax.jit(lambda c: jax.image.resize(
            c, (10, size, size, 3), "bicubic"))(coarse))
        got = syn.resize_bicubic(torch.from_numpy(coarse), size).numpy()
        np.testing.assert_allclose(got, want[size], atol=1e-5, rtol=0)
    interp = F.interpolate(torch.from_numpy(coarse).permute(0, 3, 1, 2),
                           size=(32, 32), mode="bicubic",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(interp - want[32]).max() > 0.1
    w = syn.cubic_resize_matrix(4, 32)
    assert w.shape == (32, 4)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-6)
    t = syn.make_templates(torch.Generator().manual_seed(0), image_size=16,
                           device="cpu")
    assert t.shape == (10, 16, 16, 3) and t.dtype == torch.float32


def test_composite_matches_sample_images():
    """``_composite`` fed JAX's own draws (reproduced from
    ``split(key, 7)``) equals ``sample_images``: blend, noise, the
    occluding patch for h > 0.5 and the corrupted labels for h > 0.97,
    to 1e-6; the port's ``sample_images`` draws in the same ranges."""
    b = 256
    templates = syn.make_templates(torch.Generator().manual_seed(1),
                                   image_size=SIZE, device="cpu").numpy()
    key = jax.random.key(2)
    want = jax.jit(functools.partial(jsyn.sample_images, batch=b))(
        key, templates)

    def draws(key):
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
        ri = functools.partial(jax.random.randint, shape=(b,), minval=0)
        return (ri(k1, maxval=10), jax.random.uniform(k2, (b,)),
                ri(k3, maxval=10),
                jax.random.normal(k4, (b, SIZE, SIZE, 3)),
                ri(k5, maxval=SIZE - 8), ri(k6, maxval=SIZE - 8),
                ri(k7, maxval=10))
    d = [torch.from_numpy(np.array(x)) for x in jax.jit(draws)(key)]
    hard = d[1].numpy()
    assert (hard > 0.97).any() and (hard > 0.5).mean() > 0.3
    got = syn._composite(torch.from_numpy(templates), d[0].long(), d[1],
                         d[2].long(), d[3], d[4], d[5], d[6].long())
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["label"].numpy(),
                                  np.asarray(want["label"]))
    assert (got["label"].numpy() != d[0].numpy()).any()
    np.testing.assert_array_equal(got["hardness"].numpy(),
                                  np.asarray(want["hardness"]))
    s = syn.sample_images(torch.Generator().manual_seed(3),
                          torch.from_numpy(templates), batch=b)
    assert s["image"].shape == (b, SIZE, SIZE, 3)
    assert 0 <= int(s["label"].min()) and int(s["label"].max()) < 10
    assert (s["image"] == 0).flatten(1).sum(1).max() >= 8 * 8 * 3
    fixed = syn.sample_images(torch.Generator().manual_seed(3),
                              torch.from_numpy(templates), batch=4,
                              hardness=torch.zeros(4))
    assert not (fixed["image"] == 0).any()
    ds = syn.image_dataset(torch.Generator().manual_seed(4),
                           torch.from_numpy(templates), num_samples=20,
                           batch=8)
    assert len(ds) == 2 and ds[1]["image"].shape == (8, SIZE, SIZE, 3)


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(7)
    n, b, p, c, m = 3, 16, 8, 10, 12

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    names = sorted(ZOO)       # the key order of a dict through jax.jit
    emb = {k: rng.standard_normal((b, 5 + i)).astype(np.float32)
           for i, k in enumerate(names)}
    proj = {k: rng.standard_normal((5 + i, p)).astype(np.float32)
            for i, k in enumerate(names)}
    projected = {k: unit(rng.standard_normal((b, p))).astype(np.float32)
                 for k in names}
    correct = {k: rng.uniform(size=b) < 0.5 for k in names}
    logits = rng.standard_normal((n, b, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    w = rng.dirichlet(np.ones(n), size=b).astype(np.float32)
    w[0] = [0.2, 0.3, 0.5]                   # none clears the threshold 0.6
    labels = rng.integers(0, c, b).astype(np.int32)
    costs = np.asarray([3.0, 1.0, 2.0], np.float32)
    meta = rng.standard_normal((b, m)).astype(np.float32)
    distill = {k: rng.standard_normal((m, p)).astype(np.float32)
               for k in names}
    return dict(emb=emb, proj=proj, projected=projected, correct=correct,
                probs=probs.astype(np.float32), w=w, labels=labels,
                costs=costs, meta=meta, distill=distill)


LOSS_CASES = {
    "project": (lambda m, a: m.project(a["proj"], a["emb"]), "cnt"),
    "cosine_distance": (lambda m, a: m.cosine_distance(
        a["projected"]["zoo_xxs"], a["projected"]["zoo_m"]), "cnt"),
    "contrastive_loss": (lambda m, a: m.contrastive_loss(
        a["projected"], a["correct"]), "cnt"),
    "pairwise_distance_matrix": (lambda m, a: m.pairwise_distance_matrix(
        a["projected"]), "cnt"),
    "separation_score": (lambda m, a: m.separation_score(
        a["projected"], a["correct"]), "cnt"),
    "ensemble_logits": (lambda m, a: m.ensemble_logits(a["w"], a["probs"]),
                        "ens"),
    "mux_xent": (lambda m, a: m.mux_xent(a["w"], a["probs"], a["labels"]),
                 "ens"),
    "select_single": (lambda m, a: m.select_single(a["w"]), "ens"),
    "select_ensemble": (lambda m, a: m.select_ensemble(a["w"], 0.6), "ens"),
    "policy_metrics": (lambda m, a: m.policy_metrics(
        a["w"], a["probs"], a["labels"], a["costs"], threshold=0.3), "ens"),
    "oracle_metrics": (lambda m, a: m.oracle_metrics(
        a["probs"], a["labels"], a["costs"]), "ens"),
    "distill_loss": (lambda m, a: m.distill_loss(
        {"distill": a["distill"]}, a["meta"], a["projected"]), "mux"),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_losses_match_jax(name):
    """Eq. 1-3 (``contrastive``), Eq. 4, 7 and Alg. 2's policies
    (``ensemble``) and Eq. 8 (``distill_loss``) against JAX on the same
    numpy inputs: floats to 1e-5 relative (1e-6 absolute), indices and
    masks exactly."""
    fn, mod = LOSS_CASES[name]
    a = _loss_inputs()
    jmods = {"cnt": jcnt, "ens": jens, "mux": jmux}
    tmods = {"cnt": cnt, "ens": ens, "mux": tmux}
    want = _np(jax.jit(lambda a: fn(jmods[mod], a))(a))
    got = convert.to_numpy(fn(tmods[mod], convert.to_torch(a, "cpu")))
    flat_w, flat_g = dict(tree.paths(want)), dict(tree.paths(got))
    assert flat_w.keys() == flat_g.keys()
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_offload_table1_matches_jax_exactly():
    """Eq. 9-13 (``offload.table1``): every field of the three rows equal
    to JAX's, bit for bit (numpy on both sides)."""
    kw = dict(mobile_acc=0.61, cloud_acc=0.83, hybrid_acc=0.7,
              local_fraction=0.55, mobile_flops=2.1e6, cloud_flops=8.3e7,
              mux_flops=4.4e5)
    want = joffload.table1(JCFG, **kw)
    got = offload.table1(TCFG, **kw)
    assert list(got) == list(want) == ["mobile-only", "cloud-only", "hybrid"]
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_matches_jax(schedule):
    """Three AdamW updates with clipping active (gradient norms 20-60 >
    clip 1) under each schedule (warm-up 2 of 5 steps, so the three
    steps cross into the decay), weight decay on the 2-D leaves only:
    params, moments, step, grad_norm and lr to 1e-6 (gradients equal
    on both sides, so no entry is near a sign flip); ``schedule_lr`` at
    steps 0-7 to 1e-6 (a few fp32 ulps)."""
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=5,
               schedule=schedule)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(3).astype(np.float32)}]}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 10)
                          .astype(np.float32), params) for _ in range(3)]
    jstate, tstate = jadamw.init(jcfg, params), adamw.init(
        tcfg, convert.to_torch(params, "cpu"))
    jp, tp = params, convert.to_torch(params, "cpu")
    jstep = jax.jit(functools.partial(jadamw.apply_updates, jcfg))
    for g in grads:
        jp, jstate, jm = jstep(jp, g, jstate)
        tp, tstate, tm = adamw.apply_updates(
            tcfg, tp, convert.to_torch(g, "cpu"), tstate)
        assert float(jm["grad_norm"]) > 1.0
        for want, got in ((jp, tp), (jstate.mu, tstate.mu),
                          (jstate.nu, tstate.nu), (jm, tm)):
            got = _by_path(got)
            for k, w in _by_path(_np(want)).items():
                np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
        assert int(tstate.step) == int(jstate.step)
        assert tstate.step.dtype == torch.int32
    steps = np.arange(8, dtype=np.int32)
    np.testing.assert_allclose(
        adamw.schedule_lr(tcfg, torch.from_numpy(steps)).numpy(),
        np.asarray(jax.jit(functools.partial(jadamw.schedule_lr, jcfg))(
            steps)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        float(adamw.global_norm(convert.to_torch(params, "cpu"))),
        float(jadamw.global_norm(params)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Algorithm 1: the training steps
# ---------------------------------------------------------------------------

def _recovered_grads(mu_new, mu_old):
    """The clipped gradient a step used, from its first moment:
    mu' = b1 mu + (1 - b1) g."""
    return jax.tree.map(lambda a, b: (np.asarray(a) - OPT_B1 * np.asarray(b))
                        / (1 - OPT_B1), mu_new, mu_old)


OPT_B1, OPT_B2 = JOPT.b1, JOPT.b2


def _check_step(jout, tout, t_grads, jin_opt):
    """One step of each package from the same inputs: metrics to 1e-5
    relative; the port's clipped gradients against JAX's (recovered from
    its first moment) to GRAD_TOL of the global norm; moments and params
    with the bounds of the module docstring."""
    (jp, jopt, jm), (tp, topt, tm) = jout, tout
    for k in ("loss", "grad_norm", "lr") + tuple(
            k for k in jm if k not in ("loss", "grad_norm", "lr")):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert int(topt.step) == int(jopt.step)
    scale = min(1.0, JOPT.clip_norm / float(jm["grad_norm"]))
    jg = _by_path(_np(_recovered_grads(jopt.mu, jin_opt.mu)))
    tg = {k: v * scale for k, v in _by_path(t_grads).items()}
    norm = np.sqrt(sum(float(np.sum(np.square(v))) for v in jg.values()))
    err = max(float(np.abs(tg[k] - v).max()) for k, v in jg.items())
    assert err <= GRAD_TOL * norm, (err, norm)
    e = max(err, 1e-9)
    lr = float(jm["lr"])
    step = int(jopt.step)
    jmu, jnu = _by_path(_np(jopt.mu)), _by_path(_np(jopt.nu))
    tmu, tnu = _by_path(topt.mu), _by_path(topt.nu)
    for k, want in _by_path(_np(jp)).items():
        mu_tol = (1 - OPT_B1) * e * 1.01 + 1e-9
        nu_tol = ((1 - OPT_B2) * (2 * np.abs(jg[k]) * e + e * e) * 1.01
                  + 1e-6 * np.abs(jnu[k]) + 1e-12)
        assert (np.abs(tmu[k] - jmu[k]) <= mu_tol).all(), k
        assert (np.abs(tnu[k] - jnu[k]) <= nu_tol).all(), k
        s = np.sqrt(jnu[k] / (1 - OPT_B2 ** step))
        sens = np.minimum(2.0, 4.0 * e / np.maximum(s, 1e-30))
        bound = 1e-6 + lr * sens
        diff = np.abs(_by_path(tp)[k] - want)
        assert (diff <= bound).all(), (k, float((diff - bound).max()))


def _zoo_state():
    zoo, _, _ = _init()
    return zoo


def test_zoo_train_steps_match_jax():
    """Two ``zoo_train_step``s (each from the same state in both packages:
    the initialised one, then JAX's after step 1) on two batches: loss,
    ce, cnt, grad_norm and lr; gradients; first and second moments;
    updated params (see the module docstring)."""
    zoo = _zoo_state()
    jstate, jopt = zoo, _np(jadamw.init(JOPT, zoo))
    for seed in (20, 21):
        b = _batch(seed, zoo)
        jout = _np(jmt.zoo_train_step(jstate, jopt, b, JCFG, JOPT))
        tstate, topt = _t(jstate), adamw.AdamWState(*_t(jopt))
        _, _, tgrads = mux_train.loss_and_grads(mux_train.zoo_loss, tstate,
                                                _tbatch(b), TCFG)
        tout = mux_train.zoo_train_step(tstate, topt, _tbatch(b), TCFG, TOPT)
        assert float(jout[2]["cnt"]) != 0.0
        _check_step(jout, tout, tgrads, jopt)
        jstate, jopt = jout[0], jout[1]


@pytest.mark.parametrize("objective", ["ensemble", "offload"])
def test_mux_train_steps_match_jax(objective):
    """Two ``mux_train_step``s per objective, the zoo frozen: the
    three-model mux under Eq. 7 + Eq. 8 (``"ensemble"``), the pair mux
    under the class-balanced BCE + Eq. 8 (``"offload"``); compared as
    the zoo steps are; ``cost_rel`` is not a trained leaf."""
    zoo, mux_all, mux_pair = _init()
    names = ZOO if objective == "ensemble" else PAIR
    mux = dict(mux_all if objective == "ensemble" else mux_pair)
    cost_rel = mux.pop("cost_rel")
    jtr, jopt = mux, _np(jadamw.init(JOPT, mux))
    for seed in (30, 31):
        b = _batch(seed, zoo)
        jout = _np(jmt.mux_train_step(jtr, cost_rel, jopt, zoo, b, JCFG,
                                      JOPT, names, objective))
        ttr, topt = _t(jtr), adamw.AdamWState(*_t(jopt))
        args = (torch.from_numpy(np.array(cost_rel)), _t(zoo), _tbatch(b),
                TCFG, names, objective)
        _, _, tgrads = mux_train.loss_and_grads(mux_train.mux_loss, ttr,
                                                *args)
        tout = mux_train.mux_train_step(ttr, args[0], topt, args[1],
                                        args[2], TCFG, TOPT, names,
                                        objective)
        assert "cost_rel" not in tout[0]
        _check_step(jout, tout, tgrads, jopt)
        jtr, jopt = jout[0], jout[1]


def test_drivers_cycle_batches_and_chain_steps(monkeypatch):
    """``train_zoo`` / ``train_mux`` run ``*_steps`` steps over the batch
    list in order, round and round (3 steps over 2 batches: 0, 1, 0),
    calling ``on_step`` after each, and equal the same steps chained by
    hand, bitwise; ``cost_rel`` comes back untrained; the ablation sets
    the contrastive coefficient to 0; no batches is an error."""
    zoo, mux_all, _ = _init()
    batches = [_tbatch(_batch(s, zoo)) for s in (40, 41)]
    seen = []
    real_zoo_step, real_mux_step = (mux_train.zoo_train_step,
                                    mux_train.mux_train_step)

    def zoo_step(state, opt, batch, cfg, ocfg):
        seen.append(("zoo", next(i for i, b in enumerate(batches)
                                 if b is batch), cfg.contrastive_coef))
        return real_zoo_step(state, opt, batch, cfg, ocfg)

    def mux_step(*a):
        seen.append(("mux", next(i for i, b in enumerate(batches)
                                 if b is a[4])))
        return real_mux_step(*a)
    monkeypatch.setattr(mux_train, "zoo_train_step", zoo_step)
    monkeypatch.setattr(mux_train, "mux_train_step", mux_step)
    monkeypatch.setattr(mux_train, "init_zoo_state",
                        lambda g, cfg, device=None: _t(zoo))
    monkeypatch.setattr(mux_train, "init_mux_state",
                        lambda g, cfg, names=None, device=None: _t(mux_all))
    steps = []
    state = mux_train.train_zoo(None, TCFG, batches, device="cpu",
                                on_step=lambda s, m: steps.append(s))
    ablation = mux_train.train_zoo(None, TCFG, batches, contrastive=False,
                                   device="cpu")
    trained = mux_train.train_mux(None, TCFG, state, batches, device="cpu")
    assert steps == [1, 2, 3]
    assert seen == [("zoo", 0, 0.5), ("zoo", 1, 0.5), ("zoo", 0, 0.5),
                    ("zoo", 0, 0.0), ("zoo", 1, 0.0), ("zoo", 0, 0.0),
                    ("mux", 0), ("mux", 1), ("mux", 0)]
    hand, opt = _t(zoo), adamw.init(TOPT, _t(zoo))
    for i in (0, 1, 0):
        hand, opt, _ = real_zoo_step(hand, opt, batches[i], TCFG, TOPT)
    for k, v in _by_path(hand).items():
        np.testing.assert_array_equal(_by_path(state)[k], v, err_msg=k)
    assert any((_by_path(ablation)[k] != v).any()
               for k, v in _by_path(state).items())
    np.testing.assert_array_equal(trained["cost_rel"].numpy(),
                                  mux_all["cost_rel"])
    assert set(trained) == {"backbone", "v", "distill", "cost_rel"}
    with pytest.raises(ValueError, match="no training batches"):
        mux_train.train_zoo(None, TCFG, [], device="cpu")


# ---------------------------------------------------------------------------
# the paper's runners
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _states():
    """A small untrained state in both packages: the JAX-initialised zoo
    and muxes, two eval batches of 8."""
    zoo, mux_all, mux_pair = _init()
    eval_b = [_batch(s, zoo) for s in (50, 51)]
    jstate = {"cfg": JCFG, "zoo_state": zoo, "mux_all": mux_all,
              "mux_pair": mux_pair, "eval_b": eval_b}
    tstate = {"cfg": TCFG, "device": torch.device("cpu"),
              "zoo_state": _t(zoo), "mux_all": _t(mux_all),
              "mux_pair": _t(mux_pair),
              "eval_b": [_tbatch(b) for b in eval_b]}
    return jstate, tstate


def _same(got, want, key=""):
    if isinstance(want, dict):
        assert set(want) <= set(got), key
        for k in want:
            _same(got[k], want[k], f"{key}/{k}")
    elif dataclasses.is_dataclass(want):
        _same(dataclasses.asdict(got), dataclasses.asdict(want), key)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{key}/{i}")
    elif isinstance(want, str):
        assert got == want, key
    else:
        w, g = np.asarray(want), np.asarray(got)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


RUNNERS = {"table1": (table1_mobile_cloud, jtable1),
           "table2": (table2_cloud_api, jtable2),
           "fig1": (fig1_expertise, jfig1)}


@pytest.mark.parametrize("name", list(RUNNERS) + ["fig6"])
def test_runners_match_jax(name, capsys):
    """Each runner's dict against ``benchmarks/<runner>.run(state)`` on
    the same small untrained state (floats to 1e-5 relative, counts and
    masks exactly), and the CSV rows it prints equal but for the timing
    field; Fig. 6 compares ``_separation`` (its ``run`` trains an
    ablation)."""
    jstate, tstate = _states()
    ev, jev = common.eval_zoo(tstate), jcommon.eval_zoo(jstate)
    _same(ev, jev)
    if name == "fig6":
        _same(fig6_separation._separation(tstate), jfig6._separation(jstate))
        return
    port, ref = RUNNERS[name]
    want = ref.run(jstate)
    want_out = capsys.readouterr().out
    got = port.run(tstate)
    got_out = capsys.readouterr().out
    _same(got, want)

    def rows(out):
        return [",".join(line.split(",")[:1] + line.split(",")[2:])
                if line.startswith(name) else line
                for line in out.splitlines()]
    assert rows(got_out) == rows(want_out)


def test_bench_config_scales(monkeypatch):
    """``bench_config`` at each scale equals the reference's, by argument
    or from ``REPRO_BENCH_SCALE``; an unknown scale is refused."""
    for scale in common.SCALES:
        monkeypatch.setenv("REPRO_BENCH_SCALE", scale)
        want = dataclasses.asdict(jcommon.bench_config())
        assert dataclasses.asdict(common.bench_config(scale)) == want
        assert dataclasses.asdict(common.bench_config()) == want
    with pytest.raises(ValueError, match="huge"):
        common.bench_config("huge")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoints_cross_packages(tmp_path):
    """A JAX ``ckpt.save`` of a zoo state and of an ``AdamWState`` (after
    one step: step 1, non-zero moments) restores through the port's
    ``ckpt.restore`` array-equal, into the port's own trees, and a port
    save restores through JAX's; ``.meta.json`` and ``latest_step`` as
    the reference's."""
    zoo = _zoo_state()
    b = _batch(60, zoo)
    jstate, jopt, _ = _np(jmt.zoo_train_step(
        zoo, _np(jadamw.init(JOPT, zoo)), b, JCFG, JOPT))
    like = mux_train.init_zoo_state(torch.Generator().manual_seed(0), TCFG,
                                    device="cpu")
    tlike = {"state": like, "opt": adamw.init(TOPT, like)}
    jtree = {"state": jstate, "opt": jopt}
    jckpt.save(str(tmp_path / "jax" / "step_1"), jtree, step=1)
    got = ckpt.restore(str(tmp_path / "jax" / "step_1"), tlike)
    assert isinstance(got["opt"], adamw.AdamWState)
    assert got["opt"].step.dtype == torch.int32
    want = _by_path(jtree)
    for k, v in _by_path(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert set(want) == set(_by_path(got))

    ckpt.save(str(tmp_path / "torch" / "step_2.npz"), got, step=2)
    ckpt.save(str(tmp_path / "torch" / "step_7"), got, step=7)
    back = _np(jckpt.restore(str(tmp_path / "torch" / "step_2.npz"),
                             jax.eval_shape(lambda: jtree)))
    for k, v in _by_path(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    meta = (tmp_path / "torch" / "step_2.npz.meta.json").read_text()
    assert '"step": 2' in meta and f'"num_arrays": {len(want)}' in meta
    assert ckpt.latest_step(str(tmp_path / "torch")) == \
        jckpt.latest_step(str(tmp_path / "torch")) == 7
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt.restore(str(tmp_path / "torch" / "step_2"),
                     {"state": {"proj": {"zoo_m": torch.zeros(2, 2)}}})


def test_convert_carries_namedtuples():
    """``convert.to_torch`` / ``to_numpy`` keep a NamedTuple's type and
    fields (JAX's ``AdamWState`` and the port's), where a plain tuple
    rebuild raised."""
    zoo = _zoo_state()
    jopt = jadamw.init(JOPT, zoo)
    t = convert.to_torch(jopt, "cpu")
    assert type(t) is type(jopt) and t._fields == ("step", "mu", "nu")
    assert isinstance(t.mu["proj"]["zoo_m"], torch.Tensor)
    topt = adamw.AdamWState(*t)
    back = convert.to_numpy(topt)
    assert isinstance(back, adamw.AdamWState)
    np.testing.assert_array_equal(back.nu["zoo"]["zoo_xs"]["cls"]["w"],
                                  np.asarray(jopt.nu["zoo"]["zoo_xs"]["cls"]
                                             ["w"]))
    assert convert.to_numpy((torch.ones(1), [torch.zeros(2)]))[1][0].shape \
        == (2,)


def test_get_state_trains_caches_and_restores(tmp_path, monkeypatch, capsys):
    """``get_state`` trains the zoo and both muxes at its scale, saves
    each under ``cache_dir/<scale>/``, and a second call restores them
    equal without training; the ablation trains a zoo only;
    ``python -m repro_torch.paper`` prints all four results from the
    cache (a tiny config in place of ``bench_config``'s)."""
    from repro_torch.paper import __main__ as paper_main
    tiny = dataclasses.replace(TCFG, zoo_steps=2, mux_steps=2)
    monkeypatch.setattr(common, "bench_config", lambda scale=None: tiny)
    stages = []
    first = common.get_state(scale="smoke", device="cpu",
                             cache_dir=str(tmp_path), verbose=False,
                             on_step=lambda st, s, m: stages.append((st, s)))
    assert stages == [("zoo_cnt", 1), ("zoo_cnt", 2), ("mux_all", 1),
                      ("mux_all", 2), ("mux_pair", 1), ("mux_pair", 2)]
    assert sorted(p.name for p in (tmp_path / "smoke").glob("*.npz")) == [
        "mux_all_cnt.npz", "mux_pair_cnt.npz", "zoo_cnt.npz"]
    assert len(first["train_b"]) == 2 and first["scale"] == "smoke"

    def no_training(*a, **k):
        raise AssertionError("trained although cached")
    monkeypatch.setattr(mux_train, "train_zoo", no_training)
    monkeypatch.setattr(mux_train, "train_mux", no_training)
    again = common.get_state(scale="smoke", device="cpu",
                             cache_dir=str(tmp_path))
    for key in ("zoo_state", "mux_all", "mux_pair"):
        want = _by_path(first[key])
        for k, v in _by_path(again[key]).items():
            np.testing.assert_array_equal(v, want[k], err_msg=f"{key}/{k}")
    monkeypatch.undo()
    monkeypatch.setattr(common, "bench_config", lambda scale=None: tiny)
    monkeypatch.setattr(common, "STATE_DIR", str(tmp_path))
    capsys.readouterr()
    assert paper_main.main(["--scale", "smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("# Fig.1", "# Table I", "# Table II", "# Fig.6",
                 "ablation_no_contrastive,"):
        assert line in out
    assert (tmp_path / "smoke" / "zoo_nocnt.npz").exists()
    assert not (tmp_path / "smoke" / "mux_all_nocnt.npz").exists()
