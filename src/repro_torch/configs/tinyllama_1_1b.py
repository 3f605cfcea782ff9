"""TinyLlama-1.1B -- llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="tinyllama-1.1b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512,
    )
