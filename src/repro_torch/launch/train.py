"""Training launcher: the LM trainer on one device.

Port of ``repro.launch.train`` without its mesh (the card is one H100).
Params are random from seed 0; batches are ``lm_batch`` streams.

Smoke scale on the CPU:
  python -m repro_torch.launch.train --arch olmo-1b --smoke --steps 2 \\
      --device cpu
Published config on the card (the default device):
  python -m repro_torch.launch.train --arch olmo-1b --steps 20 --batch 2
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (batch 4, seq 64 unless given)")
    ap.add_argument("--shape", default="train_4k",
                    choices=[k for k, v in INPUT_SHAPES.items()
                             if v.kind == "train"],
                    help="the published batch and sequence without --smoke; "
                         "train_4k's global batch of 256 x 4096 does not fit "
                         "one card's activations and logits: pass --batch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (default: the shape's, or 4 with "
                         "--smoke)")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace) -> Trainer:
    """The launcher's trainer for parsed ``args``."""
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        batch, seq = args.batch or 4, args.seq or 64
    else:
        cfg = get_config(args.arch)
        shape = INPUT_SHAPES[args.shape]
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len
    tcfg = TrainerConfig(steps=args.steps, batch_size=batch, seq_len=seq,
                         log_every=args.log_every, ckpt_dir=args.ckpt_dir)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    return Trainer(cfg, tcfg, opt_cfg, device=args.device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    result = build_trainer(parse_args(argv)).run()
    print(f"final loss: {result['final_loss']:.4f}  "
          f"wall: {result['wall_s']:.1f}s")
    return result


if __name__ == "__main__":
    main()
