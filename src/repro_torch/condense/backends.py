"""Similarity measurement for condensation (counterpart of
``repro/condense/backends.py``), the ``exact`` backend only: every
uncertain pair is measured.

Everything here runs under ``torch.no_grad()``: the similarity feeds
only comparisons and the ``s_prev`` carry, so it carries no gradient.
The functions take every condensation group at once (a leading group
axis) where the reference ``vmap``s one group at a time.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops


@torch.no_grad()
def fast_similarity(x_groups, expert_groups, s_prev: Optional[torch.Tensor],
                    s1: float, s2: float):
    """§V-A fast similarity over every group.

    x_groups: [NG, G, d]; expert_groups: [NG, G] primary expert ids;
    s_prev: [NG, G, G] similarity from the previous block (or None).
    Returns (sim [NG, G, G] f32, measured_frac [NG], the fraction of each
    group's G² pairs the backend measured). Skip rules: cross-expert
    pairs are 0, pairs with s_prev > s1 are 1, pairs with s_prev < s2
    are 0, and only the rest are measured, by K2's formula (the one the
    reference takes with ``use_kernels=True``; its own
    ``pairwise_cosine`` normalises first and decides differently at the
    margin). On the card one launch of K2's fused entry applies the rules
    and measures; on the CPU its plain version runs them op by op."""
    return kops.masked_similarity_fused(x_groups, expert_groups, s_prev,
                                        s1, s2)
