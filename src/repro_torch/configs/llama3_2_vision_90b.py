"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision scaled]. Vision tower is a STUB —
input_specs() provides precomputed patch embeddings [B, 1601, d_vision]."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28_672, vocab_size=128_256, d_head=128,
        rope_theta=500_000.0,
        pattern=(
            LayerSpec("attn", "mlp"), LayerSpec("attn", "mlp"),
            LayerSpec("attn", "mlp"), LayerSpec("attn", "mlp"),
            LayerSpec("xattn", "mlp"),
        ),
        n_vision_tokens=1601, d_vision=1280,
    )
