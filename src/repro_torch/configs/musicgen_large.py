"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. Backbone only: the EnCodec frontend is a STUB —
input_specs() provides the 4 codebook token streams directly."""
from repro_torch.configs.base import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048, d_head=64,
        rope_theta=10_000.0,
        pattern=dense_pattern(),
        n_codebooks=4,
    )
