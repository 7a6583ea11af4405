"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16, head_dim=128) d_ff=36864 vocab=256000.
[arXiv:2408.00118]
"""
import math

from repro_torch.configs.base import LayerSpec, ModelConfig

_PATTERN = (LayerSpec(mixer="attn", attn_kind="swa"),
            LayerSpec(mixer="attn", attn_kind="full"))


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", arch_type="dense", source="arXiv:2408.00118",
        num_layers=46, d_model=4608, d_ff=36864, vocab_size=256_000,
        pattern=_PATTERN,
        num_heads=32, num_kv_heads=16, head_dim=128,
        window=4096, attn_logit_cap=50.0, final_logit_cap=30.0,
        query_scale=1.0 / math.sqrt(4608 / 32),        # query_pre_attn_scalar=144
        norm="rmsnorm_zero", use_post_norm=True,
        act="gelu_tanh", gated_mlp=True,
        tie_embeddings=True, embed_scale=math.sqrt(4608),
        rope_theta=10_000.0, remat="full", logits_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="gemma2-27b-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=64,
        query_scale=1.0 / math.sqrt(64), window=32,
        embed_scale=math.sqrt(256.0), remat="none", logits_chunk=0,
    )
