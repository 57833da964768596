"""Architecture registry (counterpart of ``repro/configs/__init__.py``).

The port runs ``moe-gpt2``, ``moe-transformerxl``, ``moe-bert-large``
(the paper's Table II models), ``hymba-1.5b``, the attention decoders
``olmoe-1b-7b``, ``yi-34b``, ``stablelm-12b``, ``starcoder2-15b``,
``gemma3-12b`` and ``llama4-maverick-400b-a17b`` (shared expert,
chunked-local attention), ``internvl2-2b`` (a projected prefix before
the tokens), the encoder-decoder ``seamless-m4t-large-v2`` and the
attention-free ``rwkv6-3b``: every architecture of the reference."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = ["moe_gpt2", "moe_transformerxl", "moe_bert_large", "hymba_1p5b",
         "olmoe_1b_7b", "yi_34b", "stablelm_12b", "starcoder2_15b",
         "gemma3_12b", "llama4_maverick_400b_a17b", "internvl2_2b",
         "seamless_m4t_large_v2", "rwkv6_3b"]

ALIASES = {"moe-gpt2": "moe_gpt2", "moe-transformerxl": "moe_transformerxl",
           "moe-bert-large": "moe_bert_large", "hymba-1.5b": "hymba_1p5b",
           "olmoe-1b-7b": "olmoe_1b_7b", "yi-34b": "yi_34b",
           "stablelm-12b": "stablelm_12b",
           "starcoder2-15b": "starcoder2_15b", "gemma3-12b": "gemma3_12b",
           "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
           "internvl2-2b": "internvl2_2b",
           "seamless-m4t-large-v2": "seamless_m4t_large_v2",
           "rwkv6-3b": "rwkv6_3b"}

# the reference's architectures still to port (none)
NOT_PORTED: tuple = ()


def get_config(name: str, **overrides) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not an architecture of the reference (the "
            f"port runs {', '.join(ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config(**overrides)
