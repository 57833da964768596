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
def pairwise_cosine(x, mask):
    """[.., G, d] -> [.., G, G] similarity in [0, 1], zero where ``mask``
    is False, through kernel K2 (its plain version on the CPU). This is
    the Pallas kernel's formula, which the reference takes with
    ``use_kernels=True``; its own ``pairwise_cosine`` (normalise first)
    decides differently at the margin."""
    return kops.masked_similarity(x, mask)


@torch.no_grad()
def fast_similarity(x_groups, expert_groups, s_prev: Optional[torch.Tensor],
                    s1: float, s2: float):
    """§V-A fast similarity over every group.

    x_groups: [NG, G, d]; expert_groups: [NG, G] primary expert ids;
    s_prev: [NG, G, G] similarity from the previous block (or None).
    Returns (sim [NG, G, G] f32, measured_frac [NG], the fraction of each
    group's G² pairs the backend measured). Skip rules: cross-expert
    pairs are 0, pairs with s_prev > s1 are 1, pairs with s_prev < s2
    are 0, and only the rest are measured."""
    same_expert = expert_groups[:, :, None] == expert_groups[:, None, :]
    if s_prev is not None:
        known_hi = s_prev > s1
        uncertain = same_expert & ~known_hi & ~(s_prev < s2)
    else:
        known_hi = torch.zeros_like(same_expert)
        uncertain = same_expert
    measured = uncertain                  # the exact backend measures all
    cos = pairwise_cosine(x_groups, measured)
    zero = torch.zeros((), dtype=torch.float32, device=cos.device)
    sim = torch.where(measured, cos, zero)
    sim = torch.where(known_hi & same_expert, torch.ones_like(zero), sim)
    sim = torch.where(same_expert, sim, zero)
    measured_frac = measured.float().mean(dim=(1, 2))
    return sim, measured_frac
