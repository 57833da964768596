"""Architecture registry (counterpart of ``repro/configs/__init__.py``).

The port runs ``moe-gpt2`` and ``hymba-1.5b``; other architectures come
with their own slices and raise here until then."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = ["moe_gpt2", "hymba_1p5b"]

ALIASES = {"moe-gpt2": "moe_gpt2", "hymba-1.5b": "hymba_1p5b"}


def get_config(name: str, **overrides) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (the port runs "
            f"{', '.join(ALIASES)}; other archs come with their own "
            f"slices, ROADMAP Queue 1 item 8)")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config(**overrides)
