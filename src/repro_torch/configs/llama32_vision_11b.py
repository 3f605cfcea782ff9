"""Llama-3.2-11B-Vision backbone [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; cross-attention
image layers every 5th layer.  Vision tower is a STUB: ``input_specs``
feeds precomputed patch embeddings (B, 1601, d_model).
"""
from repro_torch.configs.base import CrossAttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    cross=CrossAttnConfig(every_k_layers=5, n_context_tokens=1601),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="llama32-vision-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512,
        cross=CrossAttnConfig(every_k_layers=2, n_context_tokens=16),
    )
