"""codeqwen1.5-7b [dense] — qwen1.5 architecture (QKV bias, MHA).

32L d_model=4096 32H (kv=32, head_dim=128) d_ff=13440 vocab=92416.
[hf:Qwen/CodeQwen1.5-7B]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", arch_type="dense", source="hf:Qwen/CodeQwen1.5-7B",
        num_layers=32, d_model=4096, d_ff=13_440, vocab_size=92_416,
        pattern=(LayerSpec(),),
        num_heads=32, num_kv_heads=32, head_dim=128, qkv_bias=True,
        norm="rmsnorm", act="silu", gated_mlp=True,
        rope_theta=1_000_000.0, remat="full",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="codeqwen1.5-7b-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=64,
        remat="none",
    )
