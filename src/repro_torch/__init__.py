"""PyTorch + CUDA port of the LUFFY reproduction (``repro``).

Module names mirror ``repro`` so each counterpart is easy to find. The
port imports ``torch``, numpy and the standard library only; the JAX
package stays the reference its tests hold it against.

This slice covers single-device serving of ``moe-gpt2``: gating,
dispatch with capacity drops, the expert FFN (a hand-written Hopper
kernel, ``kernels/expert_ffn.py``), combine, LayerNorm attention with a
KV cache and the tied LM head.
"""
