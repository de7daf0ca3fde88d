"""The LM substrate's models on PyTorch (counterparts of `repro.models`).

This slice holds the decoder over attention layers: RMSNorm, rotary
embeddings, GQA self-attention with KV caches, the SwiGLU MLP, the top-k
routed MoE with capacity-bounded dispatch (`moe.py`) and
`model.DecoderLM`. Mamba, xLSTM, cross-attention and the audio codebooks
raise NotImplementedError until their slices (ROADMAP.md).
"""
