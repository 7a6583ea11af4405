"""gemma2-27b in the port against the JAX package: its smoke model past
the sliding window on the ring path (its config and its paged path are
cases of ``test_torch_archs.py``).

The smoke model (post-norms, ``rmsnorm_zero``, tanh GELU, tied
embeddings, attention and final softcaps, alternating swa / full layers,
GQA g = 2) runs in fp32 with its window shrunk below the prompt, so the
swa layers really mask; weights come from the JAX initialiser through
``convert``.  Logits agree to 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine, ServeConfig

LOGIT_TOL = dict(atol=1e-4, rtol=0)
ARCH = "gemma2-27b"


@functools.lru_cache(maxsize=None)
def _model(window: int):
    """(JAX cfg, port cfg, JAX params, port params): the smoke model at
    fp32 compute with ``window``."""
    kw = dict(compute_dtype="float32", param_dtype="float32",
              kv_cache_dtype="float32", window=window)
    jcfg = jax_smoke_config(ARCH).with_(**kw)
    tcfg = get_smoke_config(ARCH).with_(**kw)
    jp = jax.jit(functools.partial(jtf.init_params, jcfg))(jax.random.key(2))
    return jcfg, tcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp),
                                            "cpu")


def test_generate_past_the_window_identical_to_jax():
    """Window 8, an 11-token prompt and 8 new tokens: the swa layer's
    ring of 8 slots wraps in the prefill and again while decoding, the
    full layer's holds all 19.  The same greedy tokens as the JAX
    engine; the swa ring's size and positions are the JAX ring's."""
    jcfg, tcfg, jp, tp = _model(8)
    prompts = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    jeng = JaxEngine(jcfg, jp, JaxServeConfig(max_len=24))
    teng = Engine(tcfg, tp, ServeConfig(max_len=24), device="cpu")
    want = jeng.generate(jnp.asarray(prompts), max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    assert got["tokens"].shape == (2, 19)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    ring = teng._rings[2].caches
    assert ring["p0"]["k"].shape[2] == 8 and ring["p1"]["k"].shape[2] == 24
    # after 11 prompt tokens and 7 decode steps the swa ring holds
    # positions 10..17 at slots position % 8
    assert sorted(ring["p0"]["pos"][0].tolist()) == list(range(10, 18))
    # the prefill logits past the window agree with JAX's
    jl, _ = jeng._prefill(jeng.params, jnp.asarray(prompts), None)
    tl, _ = ttf.prefill(tp, tcfg, torch.from_numpy(prompts), cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
