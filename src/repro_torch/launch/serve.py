"""Serving launcher: one model, the ring-cache ``Engine.generate``.

Port of ``repro.launch.serve``'s single-model path.  Params are random,
drawn from a ``torch.Generator`` seeded with ``--seed`` and cast to
bf16 (as the JAX launcher casts its params); prompts are random tokens
from the same seed.

Smoke scale on the CPU:
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke \
      --device cpu
Published config on the card (the default device):
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --prompt-len 1024
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import Engine, ServeConfig


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def build_engine(arch: str, *, smoke: bool, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None) -> Engine:
    """The launcher's engine: ``arch``'s config (smoke widths with
    ``smoke``), random bf16 params from ``seed`` on ``device`` (``cuda``
    unless given)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _cast(tf.init_params(cfg, gen, device=dev, dtype=torch.bfloat16),
                   torch.bfloat16)
    return Engine(cfg, params, ServeConfig(max_len=max_len,
                                           temperature=temperature,
                                           seed=seed), device=dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    engine = build_engine(args.arch, smoke=args.smoke,
                          max_len=args.prompt_len + args.tokens + 1,
                          temperature=args.temperature, seed=args.seed,
                          device=args.device)
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, engine.cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            dtype=torch.int32)
    res = engine.generate(prompts, max_new_tokens=args.tokens)
    print(f"generated {tuple(res['tokens'].shape)} "
          f"prefill={res['prefill_s']:.2f}s decode={res['decode_s']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s)")
    return res


if __name__ == "__main__":
    main()
