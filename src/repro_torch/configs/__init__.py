"""Architecture registry (counterpart of ``repro/configs/__init__.py``).

The port runs ``moe-gpt2`` only; other architectures come with their
own slices and raise here until then."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = ["moe_gpt2"]

ALIASES = {"moe-gpt2": "moe_gpt2"}


def get_config(name: str, **overrides) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (the port runs moe-gpt2; "
            f"other archs come with the 'other architectures' slice)")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config(**overrides)
