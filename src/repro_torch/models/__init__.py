"""The LM substrate's models on PyTorch (counterparts of `repro.models`).

The decoder over a repeating layer pattern (`model.DecoderLM`): RMSNorm,
rotary embeddings, GQA self-attention with KV caches, the Mamba selective
scan (`mamba.py`) and the mLSTM and sLSTM mixers (`xlstm.py`) with their
decode states, the SwiGLU MLP and the top-k routed MoE with
capacity-bounded dispatch (`moe.py`). Cross-attention and the audio
codebooks raise NotImplementedError until their slice (ROADMAP.md).
"""
