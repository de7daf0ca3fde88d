"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, d_ff=0 [arXiv:2405.04517].

Pattern period [mLSTM, sLSTM]; blocks carry their own up/down projections
(no separate MLP). Recurrent O(1)/token state => sub-quadratic (long_500k)."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50_304,
        pattern=(LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
        xlstm_proj_factor=2.0,
        sub_quadratic=True,
    )
