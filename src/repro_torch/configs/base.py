"""Architecture configuration schema.

Every assigned architecture is expressed as a ``ModelConfig`` whose
``pattern`` (a tuple of LayerSpec) tiles the depth: e.g. gemma2 is a
(local, global) pattern repeated 23x; jamba is an 8-layer pattern
(mamba x4, attn, mamba x3 with MoE on odd positions) repeated 4x.  The
model scans over pattern *groups* with stacked params, keeping HLO size
and compile time independent of depth.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # attn | mla | mamba | cross_attn
    attn_kind: str = "full"    # full | swa | chunked     (mixer == attn)
    rope: bool = True          # False => NoPE layer (llama4 global layers)
    mlp: str = "dense"         # dense | moe | none


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    v_head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None       # sliding-window span (swa layers)
    chunk: Optional[int] = None        # chunked-local span (chunked layers)
    attn_logit_cap: Optional[float] = None
    query_scale: Optional[float] = None  # overrides 1/sqrt(head_dim)

    # norms / mlp / embeddings
    norm: str = "rmsnorm"              # rmsnorm | rmsnorm_zero | layernorm | nonparametric_ln
    norm_eps: float = 1e-6
    use_post_norm: bool = False        # gemma2 sandwich norms
    act: str = "silu"
    gated_mlp: bool = True
    pos_embed: str = "rope"            # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: Optional[float] = None     # gemma sqrt(d_model); minicpm 12
    residual_scale: Optional[float] = None  # minicpm depth scaling
    final_logit_cap: Optional[float] = None

    # MLA (minicpm3)
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0

    # mamba
    d_inner: int = 0
    ssm_state: int = 0
    d_conv: int = 4
    dt_rank: int = 0
    mamba_norm: bool = False           # falcon-mamba dt/B/C RMSNorm

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    router_act: str = "softmax_topk"
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_group_tokens: int = 0          # 0 = one dispatch group per sequence

    # multimodal stubs
    num_image_tokens: int = 0          # vlm: pre-projected patch embeddings
    num_codebooks: int = 0             # audio: parallel EnCodec streams

    # numerics / memory
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "none"                # none | full | full_inner
    # 'full' remats each layer group; 'full_inner' additionally remats
    # the attention KV-block step and the mamba chunk step, so backward
    # stores only the tiny online-softmax / SSM carries instead of the
    # stacked per-iteration probabilities / decay tensors (§Perf)
    logits_chunk: int = 0              # 0 = unchunked loss
    seq_parallel: bool = True          # Megatron-SP residual sharding (train)
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (quantized decode KV)
    microbatches: int = 1              # gradient-accumulation splits (train)

    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def num_groups(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, \
            f"{self.name}: {self.num_layers} layers not tiled by pattern {len(self.pattern)}"
        return self.num_layers // len(self.pattern)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def supports_long_context(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache."""
        return all(
            spec.mixer in ("mamba",)
            or (spec.mixer == "attn" and spec.attn_kind in ("swa", "chunked"))
            or spec.mixer == "cross_attn"
            for spec in self.pattern
        ) or self.arch_type in ("ssm", "hybrid")

    def uses_attention(self) -> bool:
        return any(s.mixer in ("attn", "mla", "cross_attn") for s in self.pattern)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
