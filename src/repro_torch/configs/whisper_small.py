"""Whisper-small -- encoder-decoder ASR backbone [arXiv:2212.04356; unverified].

12L (encoder) + 12L (decoder), d_model=768 12H d_ff=3072 vocab=51865.
Conv frontend is a STUB: ``input_specs`` feeds precomputed frame embeddings
(B, 1500, d_model).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,  # decoder depth; encoder depth in encdec config
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    rope_theta=1e4,  # (whisper uses learned abs pos; rope unused in enc)
    encdec=EncDecConfig(n_encoder_layers=12, n_context_tokens=1500),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-small-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512,
        encdec=EncDecConfig(n_encoder_layers=2, n_context_tokens=64),
    )
