"""Small CNN classifiers: the paper's model zoo, and the 4-conv
multiplexer backbone of §II (the "very light-weight mobile-friendly
CNN").

Port of ``repro.models.cnn``.  Every model exposes its pre-logits
*embedding* (the paper's g_i) beside its logits.

Layout.  Inputs stay NHWC ``(B, H, W, C)``, as in the reference, so a
scheduler's requests are the same arrays in both packages, and the
params keep the reference's tree and shapes (conv ``w`` HWIO ``(k, k,
cin, cout)``, ``b`` ``(cout,)``; dense ``w`` ``(in, out)``), so
``repro_torch.convert`` carries a zoo across unchanged.  Inside a
forward the input is viewed as NCHW in ``channels_last`` memory (a
permute of the NHWC tensor, no copy), the convolutions and pools run in
that format, and the global average pool reads it back as ``(B, C)``;
each conv's weight is permuted HWIO -> OIHW into ``channels_last`` at
the call.

Arithmetic.  The convolutions are ``F.conv2d`` (``SAME`` padding of a
3x3 stride-1 conv is ``padding=1``) and the pools ``F.max_pool2d(2)``
(a 2x2 ``VALID`` max window): the reference computes them with
``lax.conv_general_dilated`` / ``reduce_window`` outside any Pallas
kernel, so like a plain matmul they may take the library's kernels.
The reference's contract is fp32, and PyTorch would run fp32 cuDNN
convolutions in TF32; every forward here holds TF32 off for its
convolutions (:func:`fp32_convs`), scoped to the call, never by a flag
set at import.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, generator_on, resolve_device
from repro_torch.models.layers import truncated_normal

Params = Dict[str, Any]

_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = True


@contextlib.contextmanager
def fp32_convs() -> Iterator[None]:
    """Run cuDNN convolutions in full fp32 (TF32 off) while open.

    cuDNN's TF32 switch is process-wide, and the serving path runs
    forwards on several executor threads at once, so the switch is
    reference-counted: the first caller in turns it off, the last one
    out restores what it was."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                torch.backends.cudnn.allow_tf32 = _tf32_saved


def _conv_init(generator, k: int, cin: int, cout: int, *, dtype,
               device) -> Params:
    return {"w": truncated_normal(generator, (k, k, cin, cout),
                                  scale=1.0 / math.sqrt(k * k * cin),
                                  dtype=dtype, device=device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _dense_init(generator, cin: int, cout: int, *, dtype, device) -> Params:
    return {"w": truncated_normal(generator, (cin, cout),
                                  scale=1.0 / math.sqrt(cin), dtype=dtype,
                                  device=device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _nchw(x, like: torch.Tensor) -> torch.Tensor:
    """NHWC images on ``like``'s device -> an NCHW view in channels_last
    memory.  A tensor already there is used in place (no host transfer:
    the forward can be captured in a CUDA graph)."""
    x = torch.as_tensor(x, device=like.device)
    return x.permute(0, 3, 1, 2)


def _conv(p: Params, h: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 ``SAME`` conv of NCHW (channels_last) ``h``."""
    w = p["w"].to(h.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(h, w, p["b"].to(h.dtype), padding=1)


def _pool(h: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(h, 2)


def init_cnn(generator: Optional[torch.Generator] = None, *,
             widths: Sequence[int], convs_per_stage: int = 1,
             embed_dim: int = 64, num_classes: int = 10, in_ch: int = 3,
             dtype=torch.float32, device: DeviceLike = None) -> Params:
    """One zoo CNN: ``convs_per_stage`` 3x3 convs per width, then the
    embedding projection and the classifier."""
    dev = resolve_device(device)
    gen = generator_on(generator, dev)
    stages: List[Params] = []
    cin = in_ch
    for w in widths:
        for _ in range(convs_per_stage):
            stages.append(_conv_init(gen, 3, cin, w, dtype=dtype, device=dev))
            cin = w
    return {"stages": stages,
            "proj": _dense_init(gen, cin, embed_dim, dtype=dtype, device=dev),
            "cls": _dense_init(gen, embed_dim, num_classes, dtype=dtype,
                               device=dev)}


def cnn_forward(params: Params, x, *, convs_per_stage: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, H, W, C) -> (logits (B, classes), embedding (B, embed_dim))."""
    h = _nchw(x, params["proj"]["w"])
    with fp32_convs():
        for i, p in enumerate(params["stages"]):
            h = torch.relu(_conv(p, h))
            if (i + 1) % convs_per_stage == 0:
                h = _pool(h)
    h = h.mean(dim=(2, 3))                                   # global avg pool
    dt = h.dtype
    emb = torch.tanh(h @ params["proj"]["w"].to(dt)
                     + params["proj"]["b"].to(dt))
    logits = emb @ params["cls"]["w"].to(dt) + params["cls"]["b"].to(dt)
    return logits, emb


def cnn_flops(*, widths: Sequence[int], convs_per_stage: int = 1,
              image_size: int = 32, in_ch: int = 3, embed_dim: int = 64,
              num_classes: int = 10) -> float:
    """Analytical MACs*2 for one inference (the paper's cost c_i, Eq. 5)."""
    flops = 0.0
    hw = image_size
    cin = in_ch
    for w in widths:
        for _ in range(convs_per_stage):
            flops += 2.0 * hw * hw * 9 * cin * w
            cin = w
        hw //= 2
    flops += 2.0 * cin * embed_dim + 2.0 * embed_dim * num_classes
    return flops


# ---------------------------------------------------------------------------
# The default 6-model zoo (≈ alexnet ... resnext101 FLOPs spread, scaled down)
# ---------------------------------------------------------------------------

ZOO_SPECS: Dict[str, Dict[str, Any]] = {
    # name -> arch hyperparams; FLOPs grow ~ 2-4x per step, ~130x end-to-end
    "zoo_xxs": dict(widths=(8, 16), convs_per_stage=1, embed_dim=32),
    "zoo_xs": dict(widths=(16, 32), convs_per_stage=1, embed_dim=48),
    "zoo_s": dict(widths=(24, 48, 96), convs_per_stage=1, embed_dim=64),
    "zoo_m": dict(widths=(32, 64, 128), convs_per_stage=2, embed_dim=96),
    "zoo_l": dict(widths=(48, 96, 192), convs_per_stage=2, embed_dim=128),
    "zoo_xl": dict(widths=(64, 128, 256), convs_per_stage=3, embed_dim=160),
}


def init_zoo(generator: Optional[torch.Generator] = None, *,
             num_classes: int = 10, in_ch: int = 3,
             names: Sequence[str] = tuple(ZOO_SPECS),
             device: DeviceLike = None) -> Dict[str, Params]:
    """Every named zoo CNN, drawn in order from one generator."""
    dev = resolve_device(device)
    gen = generator_on(generator, dev)
    return {n: init_cnn(gen, num_classes=num_classes, in_ch=in_ch,
                        device=dev, **ZOO_SPECS[n])
            for n in names}


def zoo_forward(zoo_params: Dict[str, Params], x
                ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Run every zoo member.  Returns {name: (logits, embedding)}."""
    return {n: cnn_forward(p, x, convs_per_stage=ZOO_SPECS[n].get(
                "convs_per_stage", 1))
            for n, p in zoo_params.items()}


def zoo_costs(names: Sequence[str] = tuple(ZOO_SPECS), *,
              image_size: int = 32, num_classes: int = 10) -> Dict[str, float]:
    return {n: cnn_flops(image_size=image_size, num_classes=num_classes,
                         **ZOO_SPECS[n])
            for n in names}


# ---------------------------------------------------------------------------
# Multiplexer backbone: the paper's 4-conv lightweight CNN (§II, §III.B)
# ---------------------------------------------------------------------------

MUX_WIDTHS = (8, 16, 24, 32)


def init_mux_backbone(generator: Optional[torch.Generator] = None, *,
                      meta_dim: int = 64, in_ch: int = 3,
                      dtype=torch.float32,
                      device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    gen = generator_on(generator, dev)
    stages = []
    cin = in_ch
    for w in MUX_WIDTHS:
        stages.append(_conv_init(gen, 3, cin, w, dtype=dtype, device=dev))
        cin = w
    return {"stages": stages,
            "proj": _dense_init(gen, cin, meta_dim, dtype=dtype, device=dev)}


def mux_backbone_forward(params: Params, x) -> torch.Tensor:
    """x (B, H, W, C) -> meta-features m(x) (B, meta_dim)  [paper's m_j]."""
    h = _nchw(x, params["proj"]["w"])
    with fp32_convs():
        for p in params["stages"]:
            h = _pool(torch.relu(_conv(p, h)))
    h = h.mean(dim=(2, 3))
    dt = h.dtype
    return torch.tanh(h @ params["proj"]["w"].to(dt)
                      + params["proj"]["b"].to(dt))


def mux_flops(*, image_size: int = 32, meta_dim: int = 64,
              in_ch: int = 3) -> float:
    flops = 0.0
    hw = image_size
    cin = in_ch
    for w in MUX_WIDTHS:
        flops += 2.0 * hw * hw * 9 * cin * w
        cin = w
        hw //= 2
    return flops + 2.0 * cin * meta_dim
