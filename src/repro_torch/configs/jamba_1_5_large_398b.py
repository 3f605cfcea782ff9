"""Jamba-1.5-Large-398B -- hybrid Mamba+attention MoE [arXiv:2403.19887; hf].

72L d_model=8192; attention every 8th layer (1:7 attn:mamba interleave),
64H (GQA kv=8); MoE 16 experts top-2 (d_ff=24576) every other layer.
NOTE (DESIGN.md Sec. 5): Jamba-1.5 uses Mamba-1 mixers; we standardize on
the Mamba-2 SSD mixer (same state size budget) across the framework.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    attn_period=8,  # layer i is attention iff i % 8 == 4 (Jamba placement)
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  every_k_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=128,
                  n_groups=8, chunk=256),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, attn_period=2,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      every_k_layers=2),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=32),
    )
