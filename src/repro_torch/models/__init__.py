"""The LM substrate's models on PyTorch (counterparts of `repro.models`).

This slice holds the dense decoder (`LayerSpec("attn", "mlp")`): RMSNorm,
rotary embeddings, GQA self-attention with KV caches, the SwiGLU MLP and
`model.DecoderLM`. MoE, Mamba, xLSTM, cross-attention and the audio
codebooks raise NotImplementedError until their slices (ROADMAP.md).
"""
