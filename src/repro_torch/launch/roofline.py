"""Byte and FLOP accounting of the port (counterpart of the pieces of
`repro.launch.roofline` that need no device constant and no compiler):
the scan bytes a sample family streams, the model FLOPs of an LM step
(`model_flops_for`) and the reference's analytic memory-traffic model
(`analytic_memory_bytes`, `_cache_bytes`). The reference module's device
constants, time projections and HLO parser describe its TPU and XLA and
are not carried over: the card's own bounds come from a chip run
(chip_smoke.py's bound_ms)."""
from __future__ import annotations


def scan_bytes_per_row(streamed_dtypes) -> int:
    """Bytes/row a sample-family scan streams from device memory: the sum of
    the per-row itemsizes (`torch.dtype.itemsize`) of its streamed block
    tensors. Dtype-exact and
    machine-independent. Constant blocks (the frequency table, the query
    constants) amortize to ~0 bytes/row and are excluded; pass ONLY the
    per-row streams.

    The fused layout on a 1-atom dict-encoded template: f32 values + f32
    unit + int8 strat + bool valid + int8 atom + int8 codes = 12 B/row."""
    return int(sum(d.itemsize for d in streamed_dtypes))


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int,
                    n_new: int = 1) -> float:
    """6·N·D for train; 2·N_active per generated/processed token for serve."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * n_new * global_batch   # decode


def analytic_memory_bytes(cfg, shape_kind: str, seq_len: int,
                          global_batch: int, policy: str,
                          mesh_shape: dict, attn_dp: bool = False) -> float:
    """Per-device memory traffic of one step under the reference's TPU
    fusion model (flash attention keeps score blocks on chip; elementwise
    chains fuse into their producer matmuls; parameters all-gathered per
    pass under FSDP): the reference's arithmetic unchanged, a model of its
    TPU program, not a measurement of the port on the card."""
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model = mesh_shape.get("model", 1)
    # attn_dp archs run their mixers batch-sharded over (data × model):
    # activation traffic per device drops by the model extent for those
    # tensors (~2/3 of the per-layer working set).
    act_scale = (1.0 / 3.0 + 2.0 / 3.0 / model) if attn_dp else 1.0
    p_total = cfg.param_count()
    b_param = 2.0 if policy == "lowmem" else 4.0
    b_act = 2.0
    d = cfg.d_model
    v_shard = cfg.vocab_size / model
    b_local = max(global_batch / data, 1.0)

    # big activation-sized tensors per layer that hit memory (q,k,v,out,
    # mlp h/g, residuals, norms) — flash keeps S×S blocks on chip.
    act_tensors = 12.0

    if shape_kind == "train":
        # params: sharded storage P/(data·model); per pass each device reads
        # a full model-shard (P/model) via FSDP all-gather (+ write of the
        # gathered copy). fwd + remat-fwd + bwd = 3 passes.
        param_traffic = 3 * 2 * (p_total / model) * b_param
        # optimizer: grads write + m/v read/write + param read/write on the
        # fully sharded slice
        mom = 2.0 if policy == "lowmem" else 8.0   # int8 m+v vs f32 m+v
        opt_traffic = (p_total / (data * model)) * (4 + 2 * mom + 2 * b_param)
        acts = (cfg.n_layers * act_tensors * b_local * seq_len * d * b_act
                * 2.5) * act_scale  # fwd + bwd (+remat re-reads)
        logits = 3 * b_local * seq_len * v_shard * 4.0
        return param_traffic + opt_traffic + acts + logits
    if shape_kind == "prefill":
        param_traffic = (p_total / model) * b_param
        acts = cfg.n_layers * act_tensors * b_local * seq_len * d * b_act \
            * act_scale
        cache_write = _cache_bytes(cfg, b_local, seq_len, model)
        return param_traffic + acts + cache_write
    # decode: read all (model-shard) params once + read the full cache.
    param_traffic = (p_total / model) * b_param
    cache_rw = _cache_bytes(cfg, b_local, seq_len, model)
    acts = cfg.n_layers * act_tensors * b_local * 1 * d * b_act
    return param_traffic + cache_rw + acts


def _cache_bytes(cfg, b_local: float, seq_len: int, model: int) -> float:
    """KV/state cache bytes per device (bf16), honoring seq/model sharding."""
    total = 0.0
    n_rep = cfg.n_layers // len(cfg.pattern)
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            kv_div = model if cfg.n_kv_heads % model == 0 else 1
            seq_div = 1 if kv_div > 1 else (model if seq_len % model == 0 else 1)
            total += (2 * b_local * cfg.n_kv_heads * seq_len * cfg.head_dim
                      * 2.0 / (kv_div * seq_div)) * n_rep
        elif spec.mixer == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            total += (b_local * di * cfg.mamba_d_state * 4.0 / model) * n_rep
        elif spec.mixer in ("mlstm", "slstm"):
            di = int(cfg.xlstm_proj_factor * cfg.d_model)
            dh = di // cfg.n_heads
            total += (b_local * cfg.n_heads * dh * dh * 4.0) * n_rep
    return total
