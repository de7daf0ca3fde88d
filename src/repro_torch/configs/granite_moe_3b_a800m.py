"""granite-moe-3b-a800m [moe] — 40e top-8 per the assignment config field
(the HF card for granite-3.0 says 32; we follow the assignment line —
DESIGN.md §4) [hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ModelConfig, moe_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49_155, d_head=64,
        rope_theta=10_000.0,
        pattern=moe_pattern(),
        n_experts=40, top_k=8, moe_d_ff=512,
        tie_embeddings=True,
    )
