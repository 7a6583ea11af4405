"""The port's Mixture-of-Experts FFN and olmoe-1b-7b against the JAX
package's.

Function-level cases draw their weights and inputs with numpy and hand
the same arrays to both packages (``convert.to_torch`` on the port's
side); the model-level cases take the JAX initialiser's olmoe smoke
weights across with ``convert``.  Everything runs in fp32: MoE outputs
agree to 1e-5, model logits to 1e-4 (the blocked and the masked
attention sum in other orders), pools to 1e-4.

* ``route`` under all three router activations: weights, indices and
  aux loss; a router with duplicated columns over integer-valued inputs,
  whose tied logits (and probabilities) must come out in
  ``jax.lax.top_k``'s order, the lower expert first.
* ``moe_ffn`` with capacity drops, dropless (whole sequence and one
  token), a shared expert under the sigmoid router, a non-gated MLP and
  ``group_tokens``; ``init_moe``'s tree against ``jax.eval_shape`` of
  JAX's, and olmoe's converted smoke tree against the port's own.
* olmoe smoke (its config and its paged ``prefill_paged`` +
  ``decode_step``s are cases of ``test_torch_archs.py``): the paged
  ``Engine``'s greedy tokens with a shared
  prefix and a chunked prefill; ``Engine.generate`` on the ring path;
  a decode row's logits do not depend on the other rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine, ServeConfig

MOE_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
ARCH = "olmoe-1b-7b"
D, F = 32, 48


def _weights(seed, e, *, gated=True, shared=0, integer=False):
    """A numpy MoE tree in ``init_moe``'s layout."""
    rs = np.random.RandomState(seed)

    def mat(*shape):
        if integer:
            return rs.randint(-1, 2, shape).astype(np.float32)
        return (rs.standard_normal(shape) / np.sqrt(shape[-2])
                ).astype(np.float32)
    p = {"router": mat(D, e), "up": mat(e, D, F), "down": mat(e, F, D)}
    if gated:
        p["gate"] = mat(e, D, F)
    if shared:
        p["shared"] = {"up": mat(D, shared), "gate": mat(D, shared),
                       "down": mat(shared, D)}
    return p


def _x(seed, b, s, integer=False):
    rs = np.random.RandomState(seed)
    if integer:
        return rs.randint(-2, 3, (b, s, D)).astype(np.float32)
    return rs.standard_normal((b, s, D)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_route(e, k, act):
    return jax.jit(functools.partial(jmoe.route, num_experts=e, top_k=k,
                                     router_act=act))


ACTS = (("softmax_topk", 4), ("topk_softmax", 2), ("sigmoid", 1))


@pytest.mark.parametrize("act,k", ACTS)
def test_route_matches_jax(act, k):
    e = 8
    p, x = _weights(0, e), _x(1, 2, 9)
    w, idx, aux = tmoe.route(convert.to_torch(p, "cpu"), torch.from_numpy(x),
                             num_experts=e, top_k=k, router_act=act)
    jw, jidx, jaux = _jax_route(e, k, act)(p, x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    assert w.dtype == torch.float32 and idx.shape == (2, 9, k)


@pytest.mark.parametrize("act,k", ACTS)
def test_route_ties_come_out_lower_expert_first(act, k):
    """Experts 5, 9 and 14 copy expert 2's router column and expert 11
    copies expert 7's; inputs and router are small integers, so every
    logit is exact in any summation order and the copies tie exactly
    (as bf16 router logits tie on the card)."""
    e = 16
    p, x = _weights(2, e, integer=True), _x(3, 3, 11, integer=True)
    for dup in (5, 9, 14):
        p["router"][:, dup] = p["router"][:, 2]
    p["router"][:, 11] = p["router"][:, 7]
    w, idx, _ = tmoe.route(convert.to_torch(p, "cpu"), torch.from_numpy(x),
                           num_experts=e, top_k=k, router_act=act)
    jw, jidx, _ = _jax_route(e, k, act)(p, x)
    logits = x @ p["router"]
    top = np.sort(logits, axis=-1)[..., ::-1][..., :k + 1]
    assert (top[..., :-1] == top[..., 1:]).any(), "no tie reaches the top k"
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MOE_TOL)
    # ties in the port's own order: equal values keep ascending indices
    vals = torch.gather(torch.from_numpy(logits), -1, idx)
    same = vals[..., 1:] == vals[..., :-1]
    assert bool((idx[..., 1:][same] > idx[..., :-1][same]).all())


# name -> (experts, k, router, moe_ffn keywords, batch, seq, shared d_ff)
FFN_CASES = {
    "capacity drops": (4, 2, "softmax_topk", dict(capacity_factor=0.5), 2,
                       12, 0),
    "dropless": (4, 2, "softmax_topk", dict(dropless=True), 2, 12, 0),
    "dropless one token": (8, 4, "softmax_topk", dict(dropless=True), 3, 1,
                           0),
    "shared expert": (8, 1, "sigmoid", dict(capacity_factor=1.0), 2, 10, 24),
    "not gated": (4, 2, "topk_softmax", dict(gated=False, act="gelu"), 2, 9,
                  0),
    "group tokens": (4, 2, "topk_softmax", dict(group_tokens=4,
                                                capacity_factor=1.0), 2, 16,
                     0),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    e, k, act, kw, b, s, shared = FFN_CASES[case]
    p = _weights(4, e, gated=kw.get("gated", True), shared=shared)
    x = _x(5, b, s)
    kw = dict(num_experts=e, top_k=k, router_act=act, **kw)
    got, aux = tmoe.moe_ffn(convert.to_torch(p, "cpu"), torch.from_numpy(x),
                            **kw)
    want, jaux = jax.jit(functools.partial(jmoe.moe_ffn, **kw))(p, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    if case == "capacity drops":
        # C = int(0.5 * 12 * 2 / 4) = 3 of each group's 24 assignments:
        # some are dropped, so the output differs from the dropless one
        full, _ = tmoe.moe_ffn(convert.to_torch(p, "cpu"),
                               torch.from_numpy(x), num_experts=e, top_k=k,
                               router_act=act, dropless=True)
        assert not torch.allclose(full, got, atol=1e-3)


def test_init_moe_tree_matches_jax():
    kw = dict(d_model=D, num_experts=6, moe_d_ff=F, shared_d_ff=24)
    want = jax.eval_shape(functools.partial(jmoe.init_moe, **kw),
                          jax.random.key(0))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), device="cpu", **kw)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        g = flat_g[jax.tree_util.keystr(path)]
        assert tuple(g.shape) == leaf.shape and g.dtype == torch.float32
    # the whole olmoe smoke model: the expert stacks are (G, E, d, f)
    # leaves in both packages, so the converted JAX tree is the port's
    jshapes = jax.eval_shape(functools.partial(
        jtf.init_params, jax_smoke_config(ARCH)), jax.random.key(0))
    conv = convert.to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jshapes), "cpu")
    mine = ttf.init_params(get_smoke_config(ARCH), device="cpu",
                           dtype=torch.float32)
    conv_flat = jax.tree_util.tree_flatten_with_path(conv)[0]
    mine_flat = {jax.tree_util.keystr(p): x for p, x in
                 jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert {jax.tree_util.keystr(p) for p, _ in conv_flat} == set(mine_flat)
    for path, leaf in conv_flat:
        assert leaf.shape == mine_flat[jax.tree_util.keystr(path)].shape
    assert mine["blocks"]["p0"]["moe"]["up"].shape == (2, 4, 256, 256)


# ---------------------------------------------------------------------------
# olmoe smoke: the model, the paged engine and the ring path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    """(JAX cfg, port cfg, JAX params, port params) at fp32 compute."""
    kw = dict(compute_dtype="float32", param_dtype="float32",
              kv_cache_dtype="float32")
    jcfg = jax_smoke_config(ARCH).with_(**kw)
    tcfg = get_smoke_config(ARCH).with_(**kw)
    jp = jax.jit(functools.partial(jtf.init_params, jcfg))(jax.random.key(1))
    return jcfg, tcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp),
                                            "cpu")


def test_olmoe_decode_row_does_not_depend_on_other_rows():
    """One paged step of three rows, then the same step with rows 1 and 2
    at other tokens and positions: row 0's logits are unchanged (each
    row is its own dispatch group, and decode is dropless)."""
    _, tcfg, _, tp = _model()
    ps, m = 4, 4
    toks = np.random.RandomState(8).randint(1, tcfg.vocab_size, (3, 9)
                                            ).astype(np.int32)
    bt = torch.arange(1, 13, dtype=torch.int32).reshape(3, m)
    tc = ttf.init_caches(tcfg, num_pages=13, page_size=ps, device="cpu")
    ttf.prefill_paged(tp, tcfg, torch.from_numpy(toks[:, :8]), tc, bt)
    rows = []
    for other_tok, other_pos in ((toks[1:, 8], 8), ((5, 7), 3)):
        tok = torch.tensor([[toks[0, 8]], [other_tok[0]], [other_tok[1]]],
                           dtype=torch.int32)
        pos = torch.tensor([8, other_pos, other_pos])
        logits, _ = ttf.decode_step(tp, tcfg, tok, tc, pos, block_tables=bt)
        rows.append(logits[0])
    np.testing.assert_allclose(rows[0].numpy(), rows[1].numpy(), atol=1e-6,
                               rtol=0)


def _engines():
    jcfg, tcfg, jp, tp = _model()
    je = JaxEngine(jcfg, jp, JaxServeConfig(max_len=32))
    te = Engine(tcfg, tp, ServeConfig(max_len=32), device="cpu")
    for e in (je, te):
        e.init_paged(num_pages=40, page_size=4, decode_batch=4)
    return je, te


def _trace(engine):
    """A resident request, one sharing its first two pages, and a 16-token
    prompt admitted in chunks of 8 (``begin_prefill`` /
    ``prefill_chunk``: each chunk routes on its own, so C follows the
    chunk) decoding beside them."""
    rs = np.random.RandomState(12)
    p1 = rs.randint(0, 512, 10).astype(np.int32)
    p2 = np.concatenate([p1[:8], rs.randint(0, 512, 4).astype(np.int32)])
    p3 = rs.randint(0, 512, 16).astype(np.int32)
    s1 = engine.prefill_into_pages(p1, max_new_tokens=6)
    engine.decode_step_batch([s1])
    out2 = engine.generate_paged(p2, max_new_tokens=5)["tokens"]
    s3 = engine.begin_prefill(p3, max_new_tokens=6)
    chunks = 0
    while not engine.prefill_chunk(s3, chunk_tokens=8):
        chunks += 1
    assert chunks == 1
    while not (s1.done and s3.done):
        engine.decode_step_batch([s for s in (s1, s3) if not s.done])
    for s in (s1, s3):
        engine.pool.release(s)
    return [np.concatenate([p1, s1.tokens]), out2,
            np.concatenate([p3, s3.tokens])]


def test_olmoe_engine_greedy_tokens_identical_to_jax():
    je, te = _engines()
    want, got = _trace(je), _trace(te)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for e in (je, te):
        assert e.pool.pages_in_use == 0
    assert te.prefill_tokens_shared == je.prefill_tokens_shared > 0
    assert te.whole_prompt_prefills == 1


def test_olmoe_generate_ring_path_identical_to_jax():
    jcfg, tcfg, jp, tp = _model()
    prompts = np.random.RandomState(3).randint(
        0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    want = JaxEngine(jcfg, jp, JaxServeConfig(max_len=24)).generate(
        jnp.asarray(prompts), max_new_tokens=8)
    got = Engine(tcfg, tp, ServeConfig(max_len=24), device="cpu").generate(
        prompts, max_new_tokens=8)
    assert got["tokens"].shape == (2, 19)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
