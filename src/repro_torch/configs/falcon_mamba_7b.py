"""falcon-mamba-7b [ssm] — attention-free Mamba-1 stack.

64L d_model=4096 d_inner=8192 ssm_state=16 d_conv=4 dt_rank=256
vocab=65024; weight-free RMSNorm on dt/B/C (falcon-mamba stabilisation).
[arXiv:2410.05355]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", arch_type="ssm", source="arXiv:2410.05355",
        num_layers=64, d_model=4096, d_ff=0, vocab_size=65_024,
        pattern=(LayerSpec(mixer="mamba", mlp="none"),),
        d_inner=8192, ssm_state=16, d_conv=4, dt_rank=256, mamba_norm=True,
        norm="rmsnorm", remat="full",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="falcon-mamba-7b-smoke", num_layers=2, d_model=256,
        vocab_size=512, d_inner=512, ssm_state=8, dt_rank=16, remat="none",
    )
