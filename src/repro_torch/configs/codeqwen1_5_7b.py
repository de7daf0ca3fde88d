"""codeqwen1.5-7b [dense] — qwen1.5 arch, kv=32 (MHA) [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13_440, vocab_size=92_416, d_head=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        pattern=dense_pattern(),
    )
