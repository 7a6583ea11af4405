"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Without a GPU and without an explicit device this
    raises — the port never drops to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port's plain PyTorch path on the CPU")
    return torch.device("cuda")


def generator_on(generator: Optional[torch.Generator],
                 dev: torch.device) -> torch.Generator:
    """``generator``, or a fresh one on ``dev`` seeded 0: an initialiser
    given none draws reproducibly."""
    if generator is not None:
        return generator
    return torch.Generator(device=dev).manual_seed(0)
