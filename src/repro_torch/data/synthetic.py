"""Procedural image data with controllable hardness, and token LM
streams.

Port of ``repro.data.synthetic``.  Images (the offline stand-in for
ImageNet): each sample composites a class template with nuisances
whose strength is its hardness h ~ U[0, 1]:
  * additive noise (grows with h);
  * blending with a distractor class template (grows with h);
  * an occluding 8x8 patch (for h > 0.5);
  * label corruption for h > 0.97, the tail no model can solve.

Small zoo members resolve low-h samples; capacity buys robustness to
the nuisances, which gives the paper's expertise spectrum (Fig. 1).

Draws come from an explicit ``torch.Generator`` on the data's device,
so a dataset is made where it is used (on the card for training there).
They are other numbers than ``jax.random``'s from the same seed; the
arithmetic after the draws (``_composite``, ``lm_scan``) and the
templates' bicubic upsampling are the reference's.

Token streams (``lm_batch``): an order-2 structured stream whose
transition table, (vocab, vocab), depends only on ``table_seed``.  At a
50,304-token vocabulary the table is 10.1 GB in int32, so it is drawn
once per (vocab, table_seed, device) and kept (``lm_table``), where the
reference redraws it every call.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, generator_on, resolve_device

Batch = Dict[str, torch.Tensor]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 on |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def cubic_resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) fp32 weights of ``jax.image.resize(..., "bicubic")``
    along one axis: Keys' kernel at the half-pixel-centred sample points,
    each column renormalised to sum to one (so the taps that fall off the
    border are dropped, not clamped), zero for samples outside the input.
    ``F.interpolate(mode="bicubic")`` differs: a = -0.75, clamped taps."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs())      # (in, out)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T


def make_templates(generator: Optional[torch.Generator] = None, *,
                   num_classes: int = 10, image_size: int = 32,
                   channels: int = 3, device: DeviceLike = None
                   ) -> torch.Tensor:
    """Smooth class anchors: 4x4 normal fields upsampled bicubically to
    ``image_size``.  (classes, H, W, channels)."""
    dev = resolve_device(device)
    coarse = torch.randn((num_classes, 4, 4, channels),
                         generator=generator_on(generator, dev), device=dev)
    return resize_bicubic(coarse, image_size)


def resize_bicubic(coarse: torch.Tensor, size: int) -> torch.Tensor:
    """(C, h, w, ch) -> (C, size, size, ch), ``jax.image.resize``'s
    bicubic, as one weight matrix applied along each spatial axis."""
    wy = cubic_resize_matrix(coarse.shape[1], size, coarse.device)
    wx = cubic_resize_matrix(coarse.shape[2], size, coarse.device)
    return torch.einsum("chwk,Yh,Xw->cYXk", coarse, wy, wx)


def _composite(templates: torch.Tensor, label: torch.Tensor,
               hardness: torch.Tensor, distractor_label: torch.Tensor,
               noise: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
               rand_label: torch.Tensor) -> Batch:
    """The sample from its draws: blend, noise, the occluding patch at
    (py, px) for h > 0.5, the label corruption for h > 0.97."""
    nc, h, w, _ = templates.shape
    hb = hardness[:, None, None, None]
    img = (templates[label] * (1 - 0.45 * hb)
           + templates[distractor_label] * (0.45 * hb))
    img = img + noise * (0.15 + 0.9 * hb)
    yy = torch.arange(h, device=img.device)[None, :, None]
    xx = torch.arange(w, device=img.device)[None, None, :]
    py, px = py[:, None, None], px[:, None, None]
    occ = (yy >= py) & (yy < py + 8) & (xx >= px) & (xx < px + 8)
    img = torch.where(occ[..., None] & (hb > 0.5), 0.0, img)
    label = torch.where(hardness > 0.97, (label + 1 + rand_label) % nc, label)
    return {"image": img, "label": label, "hardness": hardness}


def sample_images(generator: torch.Generator, templates: torch.Tensor, *,
                  batch: int, hardness: Optional[torch.Tensor] = None
                  ) -> Batch:
    """{image (B, H, W, ch), label (B,) int64, hardness (B,)}, drawn on
    the templates' device in the reference's order of draws."""
    nc, h, w, _ = templates.shape
    dev = templates.device

    def randint(high):
        return torch.randint(0, high, (batch,), generator=generator,
                             device=dev)
    label = randint(nc)
    if hardness is None:
        hardness = torch.rand((batch,), generator=generator, device=dev)
    distractor = randint(nc)
    noise = torch.randn((batch, h, w, templates.shape[3]),
                        generator=generator, device=dev)
    py, px = randint(h - 8), randint(w - 8)
    return _composite(templates, label, hardness, distractor, noise, py, px,
                      randint(nc))


def image_dataset(generator: torch.Generator, templates: torch.Tensor, *,
                  num_samples: int, batch: int) -> List[Batch]:
    """``num_samples // batch`` batches, drawn in order from one
    generator on the templates' device."""
    return [sample_images(generator, templates, batch=batch)
            for _ in range(num_samples // batch)]


# ---------------------------------------------------------------------------
# Token LM streams
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def lm_table(vocab_size: int, table_seed: int,
             device: torch.device) -> torch.Tensor:
    """The (vocab, vocab) int32 transition table of ``table_seed``, drawn
    on ``device`` once and kept (``lm_table.cache_clear()`` frees it)."""
    gen = torch.Generator(device=device).manual_seed(table_seed)
    return torch.randint(0, vocab_size, (vocab_size, vocab_size),
                         generator=gen, dtype=torch.int32, device=device)


def lm_draws(generator: torch.Generator, *, batch: int, seq_len: int,
             vocab_size: int, device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A batch's random draws, in the reference's order: the first two
    tokens (B, 2), the uniform noise (B, S) and the random tokens
    (B, S), on ``device`` from ``generator`` (which lives there)."""
    def randint(shape):
        return torch.randint(0, vocab_size, shape, generator=generator,
                             dtype=torch.int32, device=device)
    t0 = randint((batch, 2))
    noise = torch.rand((batch, seq_len), generator=generator, device=device)
    return t0, noise, randint((batch, seq_len))


def lm_scan(table: torch.Tensor, t0: torch.Tensor, noise: torch.Tensor,
            rand_tok: torch.Tensor, structure: float = 0.8) -> Batch:
    """The stream from its draws: token i is ``table[token i-2, token
    i-1]`` where ``noise[:, i] < structure``, else ``rand_tok[:, i]``
    (the reference's scan, one step a position); labels are the tokens
    shifted left by one, wrapping.  {"tokens", "labels"} (B, S) int32."""
    b, s = noise.shape
    vocab = table.shape[1]
    flat = table.reshape(-1)
    # int64 from here (the table's flat index outgrows int32 at a large
    # vocabulary): four launches a position
    toks = torch.empty((b, s), dtype=torch.int64, device=noise.device)
    prev2, prev1 = t0[:, 0].long(), t0[:, 1].long()
    keep, rand_tok = noise < structure, rand_tok.long()
    for i in range(s):
        tok = torch.where(keep[:, i],
                          flat[torch.add(prev1, prev2, alpha=vocab)],
                          rand_tok[:, i])
        toks[:, i] = tok
        prev2, prev1 = prev1, tok
    toks = toks.to(torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def lm_batch(generator: torch.Generator, *, batch: int, seq_len: int,
             vocab_size: int, structure: float = 0.8,
             table_seed: int = 42) -> Batch:
    """Order-2 structured token stream: the next token is a fixed
    function of the previous two with probability ``structure``, else
    uniform — a learnable, non-trivial LM task.  Drawn on the
    generator's device; the table depends only on ``table_seed`` (not on
    ``generator``), so successive batches share the structure a model can
    learn."""
    dev = torch.device(generator.device)
    table = lm_table(vocab_size, table_seed, dev)
    return lm_scan(table, *lm_draws(generator, batch=batch, seq_len=seq_len,
                                    vocab_size=vocab_size, device=dev),
                   structure=structure)
