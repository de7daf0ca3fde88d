"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, expert d_ff=1536
[hf:Qwen/Qwen3-235B-A22B]."""
from repro_torch.configs.base import ModelConfig, moe_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab_size=151_936, d_head=128,
        rope_theta=1_000_000.0,
        pattern=moe_pattern(),
        n_experts=128, top_k=8, moe_d_ff=1536,
    )
