"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 every
other layer [arXiv:2403.19887]. Mamba state is O(1)/token and the 4 attention
layers hold O(seq) KV => sub-quadratic decode (long_500k eligible)."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    # Period of 8: attention at position 4 (1:7), MoE on odd positions.
    pattern = tuple(
        LayerSpec("attn" if i == 4 else "mamba",
                  "moe" if i % 2 == 1 else "mlp")
        for i in range(8))
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14_336, vocab_size=65_536, d_head=128,
        pattern=pattern,
        n_experts=16, top_k=2, moe_d_ff=14_336,
        mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
        sub_quadratic=True,
    )
