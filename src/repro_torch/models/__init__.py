"""The LM substrate's models on PyTorch (counterparts of `repro.models`).

The decoder over a repeating layer pattern (`model.DecoderLM`): RMSNorm,
rotary embeddings, GQA self-attention with KV caches, tanh-gated
cross-attention to a projected vision source, the Mamba selective scan
(`mamba.py`) and the mLSTM and sLSTM mixers (`xlstm.py`) with their
decode states, the SwiGLU MLP, the top-k routed MoE with capacity-bounded
dispatch (`moe.py`), and the audio codebooks' summed embeddings and
per-codebook heads.
"""
