"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA) + mup scaling.

62L d_model=2560 40H d_ff=6400 vocab=73448.  MLA: q_lora=768 kv_lora=256
qk_nope=64 qk_rope=32 v_head=64.  [hf:openbmb/MiniCPM3-4B]
"""
import math

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", arch_type="dense", source="hf:openbmb/MiniCPM3-4B",
        num_layers=62, d_model=2560, d_ff=6400, vocab_size=73_448,
        pattern=(LayerSpec(mixer="mla"),),
        num_heads=40, num_kv_heads=40, head_dim=96, v_head_dim=64,
        q_lora=768, kv_lora=256, d_nope=64, d_rope=32,
        norm="rmsnorm", act="silu", gated_mlp=True,
        embed_scale=12.0,                      # scale_emb
        residual_scale=1.4 / math.sqrt(62),    # scale_depth / sqrt(L)
        rope_theta=10_000.0, remat="full", logits_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="minicpm3-4b-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, num_heads=4, head_dim=96, v_head_dim=32,
        q_lora=64, kv_lora=32, d_nope=16, d_rope=16,
        residual_scale=1.4 / math.sqrt(2), remat="none", logits_chunk=0,
    )
