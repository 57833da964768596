"""Token condensation (paper §V; counterpart of ``repro/condense``): the
similarity backends and the condensation plan, with its cross-sublayer
reuse."""
from repro_torch.condense.backends import (available_similarity_backends,
                                           expected_measured_pairs,
                                           fast_similarity,
                                           get_similarity_backend, lsh_codes,
                                           register_similarity_backend)
from repro_torch.condense.plan import (CondenseCarry, CondensePlan,
                                       CondenseSignature, adaptive_threshold,
                                       build_condense_plan, condense_tokens,
                                       identity_condense_plan,
                                       pick_rate_bucket,
                                       similarity_quantiles, uncondense)

__all__ = [
    "CondenseCarry", "CondensePlan", "CondenseSignature",
    "adaptive_threshold", "available_similarity_backends",
    "build_condense_plan", "condense_tokens", "expected_measured_pairs",
    "fast_similarity", "get_similarity_backend", "identity_condense_plan",
    "lsh_codes", "pick_rate_bucket", "register_similarity_backend",
    "similarity_quantiles", "uncondense",
]
