"""DeepSeek-V2-236B -- MLA + fine-grained MoE [arXiv:2405.04434; hf].

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, nope=128, rope=64),
160 routed experts top-6 (d_ff_expert=1536) + 2 shared; first layer dense
(d_ff=12288); vocab=102400.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head K/V decoded from the shared latent
    d_ff=12288,  # dense layers (first_dense) width
    vocab=102400,
    head_dim=128,
    rope_theta=1e4,
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared=2,
        d_ff_shared=3072,
        first_dense=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      num_shared=1, d_ff_shared=64, first_dense=1),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=32,
                      qk_rope_dim=16, v_head_dim=32),
    )
