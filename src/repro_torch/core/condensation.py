"""Token condensation (paper §V), the historical import surface
(counterpart of ``repro/core/condensation.py``): re-exports of
:mod:`repro_torch.condense`."""
from __future__ import annotations

from repro_torch.condense.backends import fast_similarity
from repro_torch.condense.plan import (CondenseOutput, _components_and_reps,
                                       adaptive_threshold, condense_tokens,
                                       uncondense)

__all__ = [
    "CondenseOutput", "_components_and_reps", "adaptive_threshold",
    "condense_tokens", "fast_similarity", "uncondense",
]
