"""olmoe-1b-7b [moe] — 64 experts, top-8, QK-norm.

16L d_model=2048 16H (kv=16, head_dim=128) expert d_ff=1024
vocab=50304.  [arXiv:2409.02060]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", arch_type="moe", source="arXiv:2409.02060",
        num_layers=16, d_model=2048, d_ff=1024, vocab_size=50_304,
        pattern=(LayerSpec(mlp="moe"),),
        num_heads=16, num_kv_heads=16, head_dim=128, qk_norm=True,
        num_experts=64, num_experts_per_tok=8, moe_d_ff=1024,
        router_act="softmax_topk",
        norm="rmsnorm", act="silu", gated_mlp=True,
        rope_theta=10_000.0, remat="full",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="olmoe-1b-7b-smoke", num_layers=2, d_model=256, d_ff=256,
        vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=64,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=256, remat="none",
    )
