"""qwen2-1.5b [dense] — GQA kv=2, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151_936, d_head=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        pattern=dense_pattern(), tie_embeddings=True,
    )
