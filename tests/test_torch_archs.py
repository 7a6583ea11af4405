"""Every architecture the port serves against the JAX package's: its
published and smoke configs field by field, and, for the models whose
paged path has a case of its own below, ``prefill_paged`` then
teacher-forced paged ``decode_step``s of the smoke model.

The paged cases run in fp32 with the JAX initialiser's weights taken
across by ``convert``; rows decode at different positions.  Logits
agree to 1e-4 (the blocked and the masked attention sum in other
orders), pools to 1e-4.

* gemma2-27b (post-norms, ``rmsnorm_zero``, tanh GELU, tied embeddings,
  attention and final softcaps, alternating swa / full layers, GQA
  g = 2) with its window shrunk to 4 below the 8-token prompt (two
  pages of 4), so every swa query past position 3 masks keys out.
* olmoe-1b-7b with a 6-token prompt right-padded to 8: the padding
  routes and sets C = int(1.25 * 8 * 2 / 4) = 5, so the prefill drops
  assignments, as in JAX; the decode steps are dropless.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.models import transformer as ttf

LOGIT_TOL = dict(atol=1e-4, rtol=0)
POOL_TOL = dict(atol=1e-4, rtol=1e-2)


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_config_is_the_reference_config(arch, smoke):
    got = (get_smoke_config if smoke else get_config)(arch)
    want = (jax_smoke_config if smoke else jax_config)(arch)
    fields = set(want.__dataclass_fields__)
    assert set(got.__dataclass_fields__) == fields
    for f in sorted(fields - {"pattern"}):
        assert getattr(got, f) == getattr(want, f), f
    assert [vars(s) for s in got.pattern] == [vars(s) for s in want.pattern]
    assert got.num_groups == want.num_groups


# arch -> (config overrides, prompt tokens, the prompt padded to, the
# layers' attention kinds, params seed, tokens seed)
PAGED_CASES = {
    "gemma2-27b": (dict(window=4), 8, 8, ["swa", "full"], 2, 4),
    "olmoe-1b-7b": ({}, 6, 8, ["full"], 1, 3),
}


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX cfg, port cfg, JAX params, port params): the smoke model at
    fp32 compute with ``PAGED_CASES``' overrides."""
    overrides, *_, seed, _ = PAGED_CASES[arch]
    kw = dict(compute_dtype="float32", param_dtype="float32",
              kv_cache_dtype="float32", **overrides)
    jcfg = jax_smoke_config(arch).with_(**kw)
    tcfg = get_smoke_config(arch).with_(**kw)
    jp = jax.jit(functools.partial(jtf.init_params, jcfg))(
        jax.random.key(seed))
    return jcfg, tcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp),
                                            "cpu")


@pytest.mark.parametrize("arch", sorted(PAGED_CASES))
def test_prefill_paged_and_decode_match_jax(arch):
    """The prompt (padded with zeros to its length) through
    ``prefill_paged``, then 8 teacher-forced paged steps with row 1 one
    position behind row 0: logits and every layer's pools."""
    _, p, padded_len, kinds, _, tok_seed = PAGED_CASES[arch]
    jcfg, tcfg, jp, tp = _model(arch)
    assert [s.attn_kind for s in tcfg.pattern] == kinds
    b, ps = 2, 4
    s = p + 8
    m = -(-s // ps)
    toks = np.random.RandomState(tok_seed).randint(
        1, jcfg.vocab_size, (b, s)).astype(np.int32)
    padded = np.zeros((b, padded_len), np.int32)
    padded[:, :p] = toks[:, :p]
    bt = np.arange(1, b * m + 1, dtype=np.int32).reshape(b, m)
    jc = jtf.init_caches(jcfg, 0, 0, num_pages=b * m + 1, page_size=ps)
    tc = ttf.init_caches(tcfg, num_pages=b * m + 1, page_size=ps,
                         device="cpu")
    jl, jc = jax.jit(lambda p_, t, c, bt_: jtf.prefill_paged(
        p_, jcfg, t, c, bt_, last_index=p - 1))(
            jp, jnp.asarray(padded), jc, jnp.asarray(bt))
    tl, tc = ttf.prefill_paged(tp, tcfg, torch.from_numpy(padded), tc,
                               torch.from_numpy(bt), last_index=p - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    dec = jax.jit(lambda p_, t, c, bt_, pos: jtf.decode_step(
        p_, jcfg, t, c, pos, block_tables=bt_))
    for i in range(p, s):
        pos = np.full((b,), i, np.int32)
        pos[1] = i - 1
        jl, jc = dec(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(bt),
                     jnp.asarray(pos))
        tl, tc = ttf.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                 tc, torch.from_numpy(pos),
                                 block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"pos={i}")
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jc)
    got = convert.to_numpy(tc)
    assert set(got) == set(want) == {f"p{i}" for i in range(len(kinds))}
    for layer in want:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       **POOL_TOL, err_msg=f"{layer} {leaf}")
