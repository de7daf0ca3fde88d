"""llama3-405b [dense] — GQA kv=8, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8,
        d_ff=53_248, vocab_size=128_256, d_head=128,
        rope_theta=500_000.0,
        pattern=dense_pattern(),
    )
