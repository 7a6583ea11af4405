"""MuxServer — the paper's Fig. 2(d) cloud deployment as a serving
layer, for LLM zoos.

Port of the decomposed stages of ``repro.serving.mux_server``: a
lightweight token-probe mux scores every incoming request (the probe's
trunk, then its fused head ``ops.mux_head``: K2 on the GPU),
``select`` picks a zoo model, and ``probe`` prewarms the selected
engine's logit cache so the follow-up admission pays the prompt's
prefill once.  The reference compiles the two stages with ``jax.jit``;
on a CUDA device the port replays each as a CUDA graph
(``repro_torch.graphs``), keyed by shape as ``jax.jit``'s cache is:
the probe by (B, min(S, probe_len)), select by B.  On the CPU the same
functions (:meth:`MuxServer.probe_eager`, :meth:`MuxServer.select_eager`)
run eagerly.  ``serve`` and ``model_step`` over the single-program
``multiplexed_apply`` come with the CNN zoo.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.multiplexer import PROBE_LEN, token_trunk
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import CudaGraphed
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class MuxServerConfig:
    threshold: Optional[float] = None   # None => argmax (hybrid-single);
    #   else thresholded hybrid: cheapest model whose mux weight exceeds
    #   the threshold, falling back to the largest (routing.select_model)
    cost_exponent: float = 1.0          # Eq. 5 cost sensitivity


class MuxServer:
    """A token-probe mux over N zoo models, with optional paged engines
    (aligned with ``model_costs``) that ``probe`` prewarms.  Runs on
    ``device`` (``cuda`` unless given), where the mux params must lie."""

    def __init__(self, mux_params: Any, model_costs: Sequence[float],
                 cfg: MuxServerConfig = None,
                 engines: Optional[Sequence] = None,
                 device: DeviceLike = None):
        self.mux_params = mux_params
        self.device = resolve_device(device)
        if mux_params["v"].device.type != self.device.type:
            raise ValueError(f"mux params on {mux_params['v'].device}, "
                             f"server on {self.device}")
        self.costs = torch.as_tensor(model_costs, dtype=torch.float32,
                                     device=self.device)
        self.cfg = cfg or MuxServerConfig()
        self.engines = list(engines) if engines is not None else None
        # the config is frozen, so cost_rel ** alpha is computed once
        self.cost_pow = mux_params["cost_rel"] ** self.cfg.cost_exponent
        self._probe_graph = self._select_graph = None
        if self.device.type == "cuda":
            self._probe_graph = CudaGraphed(self.probe_eager, "probe")
            self._select_graph = CudaGraphed(self.select_eager, "select")

    @property
    def num_models(self) -> int:
        return int(self.costs.shape[0])

    def probe_eager(self, tokens: torch.Tensor) -> torch.Tensor:
        """The probe on tokens (B, S <= probe_len) already on the
        server's device: the trunk, then the fused head
        (``normalize=False``) -> weights (B, N).  The function the
        probe's CUDA graph captures."""
        bb = self.mux_params["backbone"]
        h = token_trunk(bb, tokens)
        return ops.mux_head(h, bb["out"], self.mux_params["v"],
                            self.cost_pow, normalize=False)

    def select_eager(self, w: torch.Tensor) -> torch.Tensor:
        """Weights (B, N) -> model ids (B,) under the configured policy.
        The function the select CUDA graph captures."""
        return routing.select_model(w, self.costs, self.cfg.threshold)

    def probe_weights(self, x) -> torch.Tensor:
        """Mux probe on a batch of prompts: tokens (B, S) -> weights
        (B, N).  The first ``probe_len`` tokens go to the device here,
        outside any graph; on a CUDA device the probe is a replay of its
        graph for (B, min(S, probe_len))."""
        tokens = torch.as_tensor(x)[:, :PROBE_LEN].to(self.device)
        if self._probe_graph is None:
            return self.probe_eager(tokens)
        return self._probe_graph(tokens)

    def select(self, w: torch.Tensor) -> torch.Tensor:
        """Weights (B, N) -> model ids (B,) under the configured policy;
        on a CUDA device a replay of the select graph for B."""
        if self._select_graph is None:
            return self.select_eager(w)
        return self._select_graph(w)

    def probe(self, x) -> Dict[str, Any]:
        """Score ``x`` (B, S) exactly like admission does and — when
        engines are attached — run each row's prompt through the
        *selected* engine's ``prewarm_logits``, so the follow-up
        admission of the same prompt is a zero-FLOP logit-cache hit.
        Returns {"weights" (B, N), "assign" (B,)} as numpy arrays."""
        w = self.probe_weights(x)
        assign = self.select(w).cpu().numpy()
        if self.engines is not None:
            rows = np.asarray(torch.as_tensor(x).cpu())
            for i, m in enumerate(assign):
                engine = self.engines[int(m)]
                if engine is not None:
                    engine.prewarm_logits(rows[i])
        return {"weights": w.cpu().numpy(), "assign": assign}
