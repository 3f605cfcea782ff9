"""DeepSeek-67B -- dense llama-arch GQA [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-67b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512,
    )
