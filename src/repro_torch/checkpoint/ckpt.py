"""Tree checkpointing (npz).

Port of ``repro.checkpoint.ckpt``, without its sharding argument.
Leaves are saved as path-keyed arrays: dict keys, list and tuple indices
and NamedTuple field names joined by ``/`` (``repro_torch.tree.paths``),
the reference's layout, beside a ``.meta.json``; so a file written by
either package restores in the other (model params, the zoo's training
state, ``AdamWState``, mux params).  bf16 leaves are saved as fp32,
which holds them exactly, as the reference saves its ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree


def _flatten(t: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in tree.paths(t):
        x = torch.as_tensor(leaf).detach().cpu()
        if x.dtype not in (torch.float16, torch.float32, torch.float64) \
                and x.is_floating_point():
            x = x.float()                     # bf16 / fp8 -> fp32
        flat[key] = x.numpy()
    return flat


def save(path: str, t: Any, *, step: Optional[int] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(t)
    np.savez(path, **flat)
    meta = {"step": step, "num_arrays": len(flat),
            "bytes": int(sum(v.nbytes for v in flat.values()))}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``, a tree of tensors: each
    leaf comes back with ``like``'s dtype, on ``like``'s device."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = []
    with np.load(path) as data:
        for key, leaf in tree.paths(like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} vs model "
                                 f"{tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(dtype=leaf.dtype,
                                                   device=leaf.device))
    return tree.unflatten(like, leaves)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[5:-4]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and name.endswith(".npz")]
    return max(steps) if steps else None
