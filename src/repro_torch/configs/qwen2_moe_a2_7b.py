"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (kv=16) vocab=151936; 60 routed experts top-4
(d_ff_expert=1408) + shared expert of width 5632 (= 4 x 1408).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert width (the assigned d_ff)
    vocab=151936,
    rope_theta=1e6,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_ff_expert=1408,
        num_shared=4,
        d_ff_shared=5632,
    ),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-moe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      num_shared=1, d_ff_shared=128),
    )
