"""Config system: ModelConfig (architecture), ShapeSpec (assigned input
shapes), and reduced-config derivation for CPU smoke tests. A copy of
`repro.configs.base` (pure data; the port keeps its own, importing nothing
of the reference).

Every assigned architecture is a `configs/<id>.py` exporting `config()` with
the exact published dimensions; the registry in configs/__init__.py resolves
`--arch <id>`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str     # attn | xattn | mamba | mlstm | slstm
    channel: str   # mlp | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|ssm|audio|vlm|hybrid|moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]
    d_head: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "grouped"   # grouped | global (§Perf iteration 1)
    # Mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    # xLSTM
    xlstm_proj_factor: float = 2.0
    # VLM (stub frontend supplies patch embeddings)
    n_vision_tokens: int = 0
    d_vision: int = 0
    # Audio (stub frontend supplies EnCodec codebook tokens)
    n_codebooks: int = 0
    # long-context eligibility (sub-quadratic decode state)
    sub_quadratic: bool = False
    # compute knobs (perf-tunable; see EXPERIMENTS.md §Perf)
    q_chunk: int = 512
    k_chunk: int = 1024
    mamba_chunk: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, len(self.pattern))
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, dh = self.d_model, self.head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            total = self.n_codebooks * self.vocab_size * d * 2
        if self.n_vision_tokens:
            total += self.d_vision * d
        for spec in self.pattern:
            n = 0
            if spec.mixer == "attn":
                n += d * dh * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * dh * d
            elif spec.mixer == "xattn":
                n += d * dh * self.n_heads + self.d_vision * dh * 2 * self.n_kv_heads \
                    + self.n_heads * dh * d
            elif spec.mixer == "mamba":
                di = self.mamba_expand * d
                r = -(-d // 16)
                n += d * 2 * di + di * (r + 2 * self.mamba_d_state) \
                    + r * di + di * d
            elif spec.mixer == "mlstm":
                di = int(self.xlstm_proj_factor * d)
                n += d * 2 * di + 3 * di * di + di * d
            elif spec.mixer == "slstm":
                dh_s = d // self.n_heads
                n += 4 * (d * d + self.n_heads * dh_s * dh_s) + d * d
            if spec.channel == "mlp":
                n += 3 * d * self.d_ff
            elif spec.channel == "moe":
                n += d * self.n_experts + 3 * self.n_experts * d * self.moe_d_ff
            total += n * self.n_repeats
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full_moe = 3 * self.n_experts * d * self.moe_d_ff
        act_moe = 3 * self.top_k * d * self.moe_d_ff
        n_moe_layers = sum(1 for s in self.pattern if s.channel == "moe") \
            * self.n_repeats
        return self.param_count() - n_moe_layers * (full_moe - act_moe)

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/pattern, tiny dims."""
        kv = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=len(self.pattern),
            d_model=64, n_heads=4, n_kv_heads=kv, d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            d_vision=32 if self.d_vision else 0,
            q_chunk=16, k_chunk=16, mamba_chunk=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[str]:
    """The assigned shape cells for an architecture. long_500k only for
    sub-quadratic archs (DESIGN.md §4 'Shape coverage')."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def dense_pattern() -> tuple[LayerSpec, ...]:
    return (LayerSpec("attn", "mlp"),)


def moe_pattern() -> tuple[LayerSpec, ...]:
    return (LayerSpec("attn", "moe"),)
