"""Mamba2-780m -- SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1536, attention-free, ssm_state=128, vocab=50280.
d_inner = 2 x 1536 = 3072, head_dim=64 -> 48 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,  # SSD heads = d_inner / head_dim
    n_kv_heads=0,  # attention-free
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-780m-smoke", n_layers=2, d_model=128, n_heads=4,
        vocab=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=32),
    )
