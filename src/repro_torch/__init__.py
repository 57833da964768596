"""PyTorch + CUDA port of the LUFFY reproduction (``repro``).

Module names mirror ``repro`` so each counterpart is easy to find. The
port imports ``torch``, numpy and the standard library only; the JAX
package stays the reference its tests hold it against.

Slice 1 serves ``moe-gpt2`` on one device: gating, dispatch with
capacity drops, the expert FFN (a hand-written Hopper kernel,
``kernels/expert_ffn.py``), combine, LayerNorm attention with a KV cache
and the tied LM head. Slice 2 trains it on one device with token
condensation (``condense/``, kernels ``similarity`` and ``condense``),
the expert FFN's backward kernel, AdamW (``optim.py``) and the adaptive
threshold (``train_lib.py``, ``launch/train.py``). Slice 3 trains it
expert-parallel over virtual ranks held by one process (``comm/``,
``dist.py``): sequence migration (``core/migration.py``), the flat or
two-phase exchange and the deduplicated hierarchical wire
(``condense/wire.py``) with its pack-quantize kernel (``kernels/pack.py``).
"""
