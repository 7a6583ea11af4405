"""Carry weights and paged-cache pools between the JAX package and the
port, through numpy.

Both directions work on pytrees of nested dicts, lists, tuples and
NamedTuples (``repro_torch.tree``), so one pair of functions covers
transformer params (``tf.init_params``), the mux params (``init_mux``),
the image zoo's training state, AdamW's ``AdamWState(step, mu, nu)``
and paged-cache pools (``tf.init_caches(num_pages=, page_size=)``).
Layout: the port KEEPS the JAX package's leading group axis —
per-pattern-position layer params and cache slabs are ``(G, ...)``
stacks in both packages — so a leaf converts with its shape unchanged and the forward pass indexes
group ``g`` as a view.

Leaves on the JAX side arrive as numpy arrays (``np.asarray`` of a
JAX array is one; this module never imports JAX).  bfloat16 numpy
arrays (the ``ml_dtypes`` type JAX uses) cross as raw 16-bit words.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import map_tree


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()            # exact: every bf16 value is an fp32 value
    return t.numpy()


def to_torch(tree: Any, device: DeviceLike = None) -> Any:
    """numpy (or array-like) pytree -> the same pytree of tensors on
    ``device`` (``cuda`` unless given).  Shapes and dtypes carry over."""
    dev = resolve_device(device)
    return map_tree(lambda x: _leaf_to_torch(x, dev), tree)


def to_numpy(tree: Any) -> Any:
    """Tensor pytree -> numpy pytree (bf16 leaves widen to float32), for
    comparing the port's params or pools with the JAX package's."""
    return map_tree(_leaf_to_numpy, tree)
