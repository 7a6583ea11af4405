"""The LM training path of the port against the JAX package.

``transformer.lm_loss`` and its gradient, ``launch.steps.make_train_step``
(one AdamW step, with and without gradient accumulation), the data
(``lm_batch``'s scan, ``host_slice``, ``ShardedBatcher``), the
``Trainer`` and ``python -m repro_torch.launch.train``.  Params come from
the port's initialiser and cross to JAX with ``convert.to_numpy``;
batches are numpy draws handed to both.  Everything runs in fp32
(``compute_dtype="float32"``) on the CPU, where ``ops.attention`` is the
model's ``blocked_attention`` and the Mamba scan its plain version, both
differentiated by autograd, as JAX differentiates the reference.

Tolerances: losses to 1e-5 relative (fp32, sums in another order);
gradients, leaf by leaf, to 1e-5 of the whole gradient's global norm
(absolute, per entry).  Adam's first step moves an entry by about
lr * sign(g), so an entry whose gradient is tiny against the two
packages' gradient difference E can move by up to 2 lr between them:
each updated param is held to 1e-6 plus lr * min(2, 4 E / sqrt(v_hat)),
v_hat from JAX's second moment (as ``tests/test_torch_mux_train.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic as tsyn
from repro_torch.data.pipeline import ShardedBatcher, host_slice
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.training.trainer import Trainer, TrainerConfig

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of the global gradient norm, per entry
B, S = 2, 16
FP32 = dict(compute_dtype="float32", param_dtype="float32")

# the smoke configs, fp32, with what each case exercises switched on
CASES = {
    "olmo-1b": ("olmo-1b", {}),
    "olmo-1b remat": ("olmo-1b", dict(remat="full")),
    # post-norms, caps, windows below S, the chunked loss
    "gemma2-27b chunked": ("gemma2-27b", dict(window=6, logits_chunk=8)),
    # the aux loss, dispatch groups of 8 tokens
    "olmoe-1b-7b": ("olmoe-1b-7b", dict(moe_group_tokens=8)),
    "minicpm3-4b": ("minicpm3-4b", {}),
    "falcon-mamba-7b": ("falcon-mamba-7b", {}),
}


def _cfgs(arch, overrides):
    kw = dict(FP32, **overrides)
    return jax_smoke_config(arch).with_(**kw), get_smoke_config(arch).with_(**kw)


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """The port's smoke params (fp32) as a numpy tree."""
    _, tcfg = _cfgs(arch, {})
    p = ttf.init_params(tcfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    return convert.to_numpy(p)


def _batch(vocab, seed=1, b=B, s=S):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _t(t):
    return convert.to_torch(t, "cpu")


def _by_path(t):
    return dict(tree.paths(convert.to_numpy(t) if any(
        isinstance(x, torch.Tensor) for x in tree.leaves(t)) else
        jax.tree.map(np.asarray, t)))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, overrides):
    jcfg, _ = _cfgs(arch, dict(overrides))
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtf.lm_loss(p, jcfg, b), has_aux=True))


def _assert_grads(got, want):
    want = _by_path(want)
    got = _by_path(got)
    assert set(got) == set(want)
    norm = np.sqrt(sum(float(np.sum(np.square(v))) for v in want.values()))
    assert norm > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * norm,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_lm_loss_and_grads_match_jax(case):
    arch, overrides = CASES[case]
    jcfg, tcfg = _cfgs(arch, overrides)
    params = _params(arch)
    batch = _batch(tcfg.vocab_size)
    (jloss, jmet), jgrads = _jax_value_and_grad(
        arch, tuple(sorted(overrides.items())))(params, batch)
    loss, met, grads = tsteps.make_loss_and_grads(tcfg)(_t(params),
                                                        _t(batch))
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7)
    if arch == "olmoe-1b-7b":
        assert float(met["aux"]) > 0
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("arch,overrides", [
    ("olmo-1b", dict(remat="full")),
    ("olmoe-1b-7b", dict(remat="full_inner", moe_group_tokens=8)),
], ids=["olmo_full", "olmoe_full_inner"])
def test_remat_changes_nothing(arch, overrides):
    """Per-group checkpointing recomputes the same fp32 ops on the CPU:
    the loss, aux and every gradient bitwise equal to no remat."""
    _, tcfg = _cfgs(arch, overrides)
    params, batch = _t(_params(arch)), _t(_batch(tcfg.vocab_size))
    runs = [tsteps.make_loss_and_grads(tcfg.with_(remat=r))(params, batch)
            for r in ("none", tcfg.remat)]
    (l0, m0, g0), (l1, m1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    for a, b in zip(tree.leaves(g0), tree.leaves(g1, g0)):
        assert torch.equal(a, b)


def test_chunked_loss_matches_whole_loss():
    """``logits_chunk`` splits only the unembedding and the CE sum: the
    same loss and gradients as the whole-sequence loss (torch against
    torch, sums in another order)."""
    _, tcfg = _cfgs("gemma2-27b", dict(window=6))
    params, batch = _t(_params("gemma2-27b")), _t(_batch(tcfg.vocab_size))
    whole = tsteps.make_loss_and_grads(tcfg)(params, batch)
    chunked = tsteps.make_loss_and_grads(tcfg.with_(logits_chunk=4))(
        params, batch)
    np.testing.assert_allclose(float(chunked[0]), float(whole[0]),
                               rtol=LOSS_RTOL)
    _assert_grads(chunked[2], whole[2])
    with pytest.raises(ValueError, match="logits_chunk"):
        tsteps.make_loss_and_grads(tcfg.with_(logits_chunk=5))(params, batch)


def test_forward_returns_what_serving_callers_expect():
    """``forward`` keeps its (h, caches) contract in every mode; only
    ``lm_loss`` reads the aux loss."""
    _, tcfg = _cfgs("olmoe-1b-7b", {})
    params = _t(_params("olmoe-1b-7b"))
    toks = torch.from_numpy(_batch(tcfg.vocab_size)["tokens"])
    for mode in ("train", "prefill"):
        out = ttf.forward(params, tcfg, toks, mode=mode)
        assert len(out) == 2 and out[0].shape == (B, S, tcfg.d_model)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, microbatches, opt):
    jcfg, _ = _cfgs(arch, dict(microbatches=microbatches))
    return jax.jit(jsteps.make_train_step(jcfg,
                                          jadamw.AdamWConfig(**dict(opt))))


@pytest.mark.parametrize("arch,m", [("olmo-1b", 1), ("olmo-1b", 2),
                                    ("olmoe-1b-7b", 2)],
                         ids=["olmo_m1", "olmo_m2", "olmoe_m2"])
def test_train_step_matches_jax(arch, m):
    """One ``make_train_step`` step from the same params, AdamW state and
    batch (4 rows): loss, ce, aux, grad_norm and lr; first moments (the
    clipped gradients); params within Adam's sign-flip bound."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg, tcfg = _cfgs(arch, dict(microbatches=m))
    params = _params(arch)
    batch = _batch(tcfg.vocab_size, seed=2, b=4)
    jopt = jadamw.init(jadamw.AdamWConfig(**opt), params)
    jp, jst, jm = _jax_step(arch, m, tuple(sorted(opt.items())))(
        params, jopt, batch)
    tcfg_opt = tadamw.AdamWConfig(**opt)
    tp_in = _t(params)
    tp, tst, tm = tsteps.make_train_step(tcfg, tcfg_opt)(
        tp_in, tadamw.init(tcfg_opt, tp_in), _t(batch))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert int(tst.step) == int(jst.step) == 1
    b1, b2 = tcfg_opt.b1, tcfg_opt.b2
    jmu, tmu = _by_path(jst.mu), _by_path(tst.mu)
    norm = float(jm["grad_norm"])
    err = max(float(np.abs(tmu[k] - v).max()) for k, v in jmu.items()) \
        / (1 - b1)
    assert err <= GRAD_TOL * max(norm, 1.0), (err, norm)
    jnu, lr = _by_path(jst.nu), float(jm["lr"])
    got = _by_path(tp)
    for k, want in _by_path(jp).items():
        s = np.sqrt(jnu[k] / (1 - b2))
        bound = 1e-6 + lr * np.minimum(2.0, 4 * max(err, 1e-9)
                                       / np.maximum(s, 1e-30))
        assert (np.abs(got[k] - want) <= bound).all(), k


def test_lm_scan_is_jax_lm_batch_on_jax_draws():
    """The port's scan over the reference's own draws (its table, first
    tokens, noise and random tokens, split from one key as ``lm_batch``
    splits it) gives the reference's tokens and labels exactly."""
    vocab, b, s = 64, 3, 50
    key = jax.random.key(5)
    want = jax.jit(functools.partial(jsyn.lm_batch, batch=b, seq_len=s,
                                     vocab_size=vocab))(key)
    _, k2, k3, k4 = jax.random.split(key, 4)
    table = jax.random.randint(jax.random.key(42), (vocab, vocab), 0, vocab)
    draws = (jax.random.randint(k2, (b, 2), 0, vocab),
             jax.random.uniform(k3, (b, s)),
             jax.random.randint(k4, (b, s), 0, vocab))
    got = tsyn.lm_scan(torch.from_numpy(np.array(table)),
                       *(torch.from_numpy(np.array(x)) for x in draws))
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_lm_batch_draws_on_the_generator_device_and_keeps_its_table():
    gen = torch.Generator().manual_seed(3)
    batch = tsyn.lm_batch(gen, batch=2, seq_len=9, vocab_size=32)
    assert batch["tokens"].shape == (2, 9)
    assert torch.equal(batch["labels"], batch["tokens"].roll(-1, dims=1))
    assert int(batch["tokens"].max()) < 32 and int(batch["tokens"].min()) >= 0
    table = tsyn.lm_table(32, 42, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (32, 32)
    assert tsyn.lm_table(32, 42, torch.device("cpu")) is table
    again = tsyn.lm_batch(torch.Generator().manual_seed(3), batch=2,
                          seq_len=9, vocab_size=32)
    assert torch.equal(again["tokens"], batch["tokens"])


def test_host_slice_and_sharded_batcher():
    assert host_slice(8, 1, 4) == slice(2, 4)
    assert host_slice(6, 0, 1) == slice(0, 6)
    for args in ((8, 0, 3), (8, 4, 4), (8, 0, 0)):
        with pytest.raises(ValueError):
            host_slice(*args)

    def batch_fn(gen, n):
        return {"x": torch.rand((n, 3), generator=gen)}
    whole = iter(ShardedBatcher(batch_fn, global_batch=4, seed=7,
                                device="cpu"))
    parts = [iter(ShardedBatcher(batch_fn, global_batch=4, seed=7,
                                 process_index=i, process_count=2,
                                 device="cpu")) for i in range(2)]
    steps = [next(whole)["x"] for _ in range(2)]
    for want in steps:
        got = torch.cat([next(p)["x"] for p in parts])
        assert torch.equal(got, want)
    assert not torch.equal(steps[0], steps[1])


def test_trainer_runs_and_checkpoints(tmp_path):
    """Three steps of the smoke olmo-1b: finite metrics every step, the
    checkpoints of steps 2 and 3 written, the last restored equal to the
    returned params; a second run from the same seed is the same."""
    _, tcfg = _cfgs("olmo-1b", {})
    tc = TrainerConfig(steps=3, batch_size=2, seq_len=16, log_every=1,
                       ckpt_every=2, ckpt_dir=str(tmp_path), seed=1)
    out = Trainer(tcfg, tc, device="cpu").run(verbose=False)
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    for h in out["history"]:
        assert all(np.isfinite(v) for v in h.values())
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert (tmp_path / "step_2.npz").exists()
    restored = ckpt.restore(str(tmp_path / "step_3.npz"), out["params"])
    for a, b in zip(tree.leaves(restored), tree.leaves(out["params"])):
        assert torch.equal(a, b)
    again = Trainer(tcfg, tc, device="cpu").run(verbose=False)
    assert again["final_loss"] == out["final_loss"]


def test_launch_train_smoke_on_cpu(capsys):
    out = ttrain.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--log-every", "1"])
    assert len(out["history"]) == 2 and np.isfinite(out["final_loss"])
    assert "final loss" in capsys.readouterr().out
