"""olmo-1b [dense] — non-parametric LayerNorm, SwiGLU, tied embeddings.

16L d_model=2048 16H (kv=16, head_dim=128) d_ff=8192 vocab=50304.
[arXiv:2402.00838]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", arch_type="dense", source="arXiv:2402.00838",
        num_layers=16, d_model=2048, d_ff=8192, vocab_size=50_304,
        pattern=(LayerSpec(),),
        num_heads=16, num_kv_heads=16, head_dim=128,
        norm="nonparametric_ln", norm_eps=1e-5,
        act="silu", gated_mlp=True, tie_embeddings=True,
        rope_theta=10_000.0, remat="full",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="olmo-1b-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=64,
        remat="none",
    )
