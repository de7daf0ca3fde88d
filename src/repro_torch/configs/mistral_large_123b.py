"""mistral-large-123b [dense] — GQA kv=8 [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12_288, n_heads=96, n_kv_heads=8,
        d_ff=28_672, vocab_size=32_768, d_head=128,
        rope_theta=1_000_000.0,
        pattern=dense_pattern(),
    )
