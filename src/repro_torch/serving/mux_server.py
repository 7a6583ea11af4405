"""MuxServer — the paper's Fig. 2(d) cloud deployment as a serving
layer, for the CNN zoo and for LLM zoos.

Port of ``repro.serving.mux_server``.  A lightweight mux probe scores
every incoming request; requests are bucketed per selected model
(``repro_torch.core.routing``, the model-level MoE dispatch) and each
zoo model runs only its bucket.  Per-request FLOPs are metered with the
paper's Eq. 14 cost model.

The probe is modality-specific.  The image probe (the paper's 4-conv
backbone, ``"net"`` in the backbone's params) runs the backbone and
then K2's meta form, ``ops.mux_score(meta, v, cost_rel ** alpha,
normalize=False)``; the token probe runs its trunk and then K2's fused
head form (``ops.mux_head``).  ``use_fused_head=False`` is the
reference's composed ``mux_forward``: Eq. 5-6 in plain PyTorch, so it
is a CPU-only form, held against the reference in the tests; a CUDA
server refuses it, and on the card every probe goes through K2.

Entry points:
  * ``serve(x)`` — one multiplexed batch step: probe, select, dispatch,
    every zoo model (``model_fns``) on its bucket, combine;
  * ``probe_weights`` / ``select`` / ``model_step`` — the decomposed
    stages the continuous-batching ``MuxScheduler`` drives request by
    request: score on arrival, pick a model, run per-model
    micro-batches; ``probe`` also prewarms the selected engine's logit
    cache (LLM zoos), so the follow-up admission pays the prompt's
    prefill once.

The reference compiles ``_batch_step``, the probe, select and each
model function with ``jax.jit``.  On a CUDA device the port replays
each as a CUDA graph (``repro_torch.graphs``), keyed by the arguments'
signature as ``jax.jit``'s cache is keyed by shape: the batch step and
the image probe by the images' shape, the token probe by (B, min(S,
probe_len)), select by B, and each model step by its bucket's shape.
On the CPU the same functions run eagerly.  ``model_step(m, bucket)``
is the canonical model entry point: a request served through the
scheduler is bitwise equal to ``model_step`` called on that request in
a same-shape bucket, since both replay one graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.multiplexer import (PROBE_LEN, backbone_forward,
                                          mux_forward, token_trunk)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import CudaGraphed
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class MuxServerConfig:
    """Frozen: the graphs capture these, so build a new MuxServer to
    change the routing policy."""
    capacity_factor: float = 1.5        # bucket capacity = cf * B / N
    threshold: Optional[float] = None   # None => argmax (hybrid-single);
    #   else thresholded hybrid: cheapest model whose mux weight exceeds
    #   the threshold, falling back to the largest (routing.select_model)
    cost_exponent: float = 1.0          # Eq. 5 cost sensitivity
    use_fused_head: bool = True         # the probe through K2; False
    #   (the composed mux_forward) only on the CPU


class MuxServer:
    """A mux over N zoo models.  ``model_fns`` (keyword; the reference
    takes them as its second positional argument) are the models
    ``serve`` and ``model_step`` run, each mapping a (C, ...) bucket on
    the server's device to (C, out...); LLM zoos leave them out and
    attach paged ``engines`` (aligned with ``model_costs``), which
    ``probe`` prewarms.  Runs on ``device`` (``cuda`` unless given),
    where the mux params must lie."""

    def __init__(self, mux_params: Any, model_costs: Sequence[float],
                 cfg: MuxServerConfig = None,
                 engines: Optional[Sequence] = None,
                 device: DeviceLike = None, *,
                 model_fns: Optional[Sequence[Callable]] = None):
        self.mux_params = mux_params
        self.device = resolve_device(device)
        self.cfg = cfg or MuxServerConfig()
        if not self.cfg.use_fused_head and self.device.type != "cpu":
            raise ValueError("use_fused_head=False computes Eq. 5-6 with "
                             "the plain version; on "
                             f"{self.device.type} the probe is K2")
        if mux_params["v"].device.type != self.device.type:
            raise ValueError(f"mux params on {mux_params['v'].device}, "
                             f"server on {self.device}")
        self.costs = torch.as_tensor(model_costs, dtype=torch.float32,
                                     device=self.device)
        self.engines = list(engines) if engines is not None else None
        self.model_fns = list(model_fns) if model_fns is not None else None
        if self.model_fns is not None and \
                len(self.model_fns) != self.num_models:
            raise ValueError(f"{len(self.model_fns)} model_fns for "
                             f"{self.num_models} costs")
        self.image = "net" in mux_params["backbone"]
        # the config is frozen, so cost_rel ** alpha is computed once
        self.cost_pow = mux_params["cost_rel"] ** self.cfg.cost_exponent
        self._probe_graph = self._select_graph = self._step_graph = None
        self._model_graphs = None
        if self.device.type == "cuda":
            self._probe_graph = CudaGraphed(self.probe_eager, "probe")
            self._select_graph = CudaGraphed(self.select_eager, "select")
            if self.model_fns is not None:
                self._step_graph = CudaGraphed(self._batch_step, "serve")
                self._model_graphs = [CudaGraphed(fn, f"model_step[{m}]")
                                      for m, fn in enumerate(self.model_fns)]

    @property
    def num_models(self) -> int:
        return int(self.costs.shape[0])

    def graphs(self) -> Dict[str, CudaGraphed]:
        """Every CUDA graph cache of this server, by name (empty off
        CUDA): what a caller counts to see that no new signature was
        captured."""
        found = [self._probe_graph, self._select_graph, self._step_graph,
                 *(self._model_graphs or [])]
        return {g.name: g for g in found if g is not None}

    # ------------------------------------------------------------------
    def _inputs(self, x) -> torch.Tensor:
        """Requests to the server's device, outside any graph: images
        whole, prompts cut to the token probe's first ``probe_len``."""
        x = torch.as_tensor(x)
        if not self.image:
            x = x[:, :PROBE_LEN]
        return x.to(self.device)

    def probe_eager(self, x: torch.Tensor) -> torch.Tensor:
        """The probe on requests already on the server's device ->
        weights (B, N): the image backbone and K2's meta form, or the
        token trunk and K2's head form (``normalize=False`` either way),
        or, on the CPU with ``use_fused_head=False``, ``mux_forward``.
        The function the probe's CUDA graph captures."""
        bb = self.mux_params["backbone"]
        if not self.cfg.use_fused_head:
            return mux_forward(self.mux_params, x,
                               cost_exponent=self.cfg.cost_exponent)[0]
        if self.image:
            return ops.mux_score(backbone_forward(bb, x),
                                 self.mux_params["v"], self.cost_pow,
                                 normalize=False)
        return ops.mux_head(token_trunk(bb, x), bb["out"],
                            self.mux_params["v"], self.cost_pow,
                            normalize=False)

    def select_eager(self, w: torch.Tensor) -> torch.Tensor:
        """Weights (B, N) -> model ids (B,) under the configured policy.
        The function the select CUDA graph captures."""
        return routing.select_model(w, self.costs, self.cfg.threshold)

    def _batch_step(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """One multiplexed batch on the device: (output, assign, kept,
        weights, flops).  The function the serve CUDA graph captures."""
        n = self.num_models
        b = x.shape[0]
        w = self.probe_eager(x)                             # (B, N)
        assign = routing.select_model(w, self.costs, self.cfg.threshold)
        # argmax routing is roughly balanced, so cf*B/N buckets suffice;
        # thresholded selection concentrates traffic on the cheapest
        # clearing model by design, so every bucket must be able to hold
        # the whole batch or overflow would silently zero-fill outputs
        capacity = (b if self.cfg.threshold is not None
                    else max(1, int(self.cfg.capacity_factor * b / n)))
        out, kept = routing.multiplexed_apply(x, assign, self.model_fns,
                                              capacity=capacity)
        flops = self.costs[assign.long()]                   # Eq. 14 meter
        return out, assign, kept, w, flops

    def serve(self, x) -> Dict[str, Any]:
        """One multiplexed batch step on images x (B, ...): {"output",
        "assign", "kept", "weights", "flops"} (tensors on the device),
        "mean_flops" and "called_fraction" (host floats, read after the
        step)."""
        if self.model_fns is None:
            raise ValueError("serve needs the zoo's model_fns")
        x = self._inputs(x)
        step = self._step_graph or self._batch_step
        out, assign, kept, w, flops = step(x)
        counts = torch.bincount(assign.long(), minlength=self.num_models)
        b = assign.shape[0]
        return {"output": out, "assign": assign, "kept": kept, "weights": w,
                "flops": flops, "mean_flops": float(flops.mean()),
                "called_fraction": [float(c) / b for c in counts.tolist()]}

    # ---- decomposed stages for the continuous-batching scheduler -----
    def probe_weights(self, x) -> torch.Tensor:
        """Mux probe on a batch of requests (B, ...) -> weights (B, N).
        The requests go to the device here, outside any graph; on a CUDA
        device the probe is a replay of its graph for their shape."""
        x = self._inputs(x)
        if self._probe_graph is None:
            return self.probe_eager(x)
        return self._probe_graph(x)

    def select(self, w: torch.Tensor) -> torch.Tensor:
        """Weights (B, N) -> model ids (B,) under the configured policy;
        on a CUDA device a replay of the select graph for B."""
        if self._select_graph is None:
            return self.select_eager(w)
        return self._select_graph(w)

    def model_step(self, m: int, bucket) -> torch.Tensor:
        """Run model m on one static-shape bucket (C, ...) -> (C, out...),
        on the device; on a CUDA device a replay of model m's graph for
        the bucket's shape."""
        if self.model_fns is None:
            raise ValueError("model_step needs the zoo's model_fns")
        x = torch.as_tensor(bucket).to(self.device)
        if self._model_graphs is None:
            return self.model_fns[m](x)
        return self._model_graphs[m](x)

    def probe(self, x) -> Dict[str, Any]:
        """Score ``x`` (B, ...) exactly like admission does and — when
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
