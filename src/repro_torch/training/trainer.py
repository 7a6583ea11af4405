"""LM pretraining loop: the train step, data, checkpoints and metrics.

Port of ``repro.training.trainer`` on one device: no mesh and no
sharding rules (the card is one H100).  Params come from a generator
seeded with ``seed``; each step's batch from a generator seeded by
(seed + 1, step), as the reference folds the step into its data key.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import step_generator
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    log_every: int = 10
    ckpt_every: int = 0               # 0 = only final
    ckpt_dir: str = ""
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            lr=3e-4, warmup_steps=min(20, tcfg.steps // 5 + 1),
            total_steps=tcfg.steps)
        self.train_step = steps_mod.make_train_step(cfg, self.opt_cfg)

    def init_state(self, generator: torch.Generator):
        params = tf.init_params(self.cfg, generator, device=self.device)
        return params, adamw.init(self.opt_cfg, params)

    def data_iter(self, seed: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless batches of ``lm_batch``, step i's drawn from a
        generator seeded by (seed, i) on the trainer's device."""
        i = 0
        while True:
            yield lm_batch(step_generator(seed, i, self.device),
                           batch=self.tcfg.batch_size,
                           seq_len=self.tcfg.seq_len,
                           vocab_size=self.cfg.vocab_size)
            i += 1

    def run(self, *, verbose: bool = True) -> Dict[str, Any]:
        """``steps`` train steps from fresh params.  Every ``log_every``
        steps and at the last, the step's metrics go into ``history`` as
        floats (a read back from the device); params are saved to
        ``ckpt_dir`` every ``ckpt_every`` steps and after the last."""
        tc = self.tcfg
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        params, opt_state = self.init_state(gen)
        history = []
        t0 = time.time()
        it = self.data_iter(tc.seed + 1)
        for step in range(tc.steps):
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                   next(it))
            if step % tc.log_every == 0 or step == tc.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                if verbose:
                    print(f"step {step:5d} loss={m['loss']:.4f} "
                          f"grad_norm={m['grad_norm']:.3f}", flush=True)
            if tc.ckpt_every and tc.ckpt_dir and step \
                    and step % tc.ckpt_every == 0:
                ckpt.save(f"{tc.ckpt_dir}/step_{step}.npz", params,
                          step=step)
        if tc.ckpt_dir:
            ckpt.save(f"{tc.ckpt_dir}/step_{tc.steps}.npz", params,
                      step=tc.steps)
        wall = time.time() - t0
        return {"params": params, "opt_state": opt_state,
                "history": history, "wall_s": wall,
                "final_loss": history[-1]["loss"] if history else None}
