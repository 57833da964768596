"""Similarity measurement for condensation (counterpart of
``repro/condense/backends.py``): the §V-A skip rules and the pluggable
backends that decide which uncertain pairs are measured.

- ``"exact"`` measures every uncertain pair;
- ``"lsh"`` hashes each token to an ``lsh_bits``-bit code, one bit per
  sign of a fixed random projection (the matrix is a host constant drawn
  from ``lsh_seed``), and measures only the uncertain pairs whose codes
  collide; the rest are declared dissimilar. Identical tokens always
  collide, random pairs with probability about ``2^-bits``.

Where the reference's backend returns a measured mask that the Pallas
K2 takes, a backend here returns the bucket codes that restrict the
measurement (None: no restriction), and one launch of K2's fused entry
applies the skip rules and the codes together. Everything runs under
``torch.no_grad()``: the similarity feeds only comparisons and the
``s_prev`` carry, so it carries no gradient. The functions take every
condensation group at once (a leading group axis) where the reference
``vmap``s one group at a time.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

# backend(x_groups [NG, G, d], *, lsh_bits, lsh_seed) -> the codes
# [NG, G] int32 that restrict the measured pairs to equal codes, or None
SimilarityBackend = Callable[..., Optional[torch.Tensor]]

SIMILARITY_BACKENDS: Dict[str, SimilarityBackend] = {}


def register_similarity_backend(name: str):
    """Decorator: register a similarity backend under ``name``."""
    def deco(fn: SimilarityBackend) -> SimilarityBackend:
        SIMILARITY_BACKENDS[name] = fn
        return fn
    return deco


def available_similarity_backends():
    return sorted(SIMILARITY_BACKENDS)


def get_similarity_backend(name: str) -> SimilarityBackend:
    try:
        return SIMILARITY_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown similarity_backend {name!r}; registered backends: "
            f"{available_similarity_backends()}") from None


@functools.lru_cache(maxsize=32)
def _lsh_projections(d: int, bits: int, seed: int) -> np.ndarray:
    """Fixed [d, bits] signed-projection matrix, a host constant: every
    rank and every call hashes alike."""
    r = np.random.default_rng(seed)
    return r.standard_normal((d, bits)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _lsh_device_constants(d: int, bits: int, seed: int, device):
    """The projection matrix and the bit weights 2^i on ``device``, copied
    there once: a copy from pageable host memory waits for the stream."""
    proj = torch.as_tensor(_lsh_projections(d, bits, seed), device=device)
    weights = torch.as_tensor(2 ** np.arange(bits), dtype=torch.int32,
                              device=device)
    return proj, weights


@torch.no_grad()
def lsh_codes(x, *, bits: int = 8, seed: int = 0):
    """[..., d] -> [...] int32 bucket codes, sum_i 2^i [x . proj_i >= 0],
    with bits clamped to [1, 30]. The projection is one f32 product,
    never TF32 on the card (a TF32 product would move signs near 0)."""
    d = x.shape[-1]
    bits = max(1, min(int(bits), 30))
    proj, weights = _lsh_device_constants(d, bits, seed, x.device)
    xf = x.float()
    if xf.device.type == "cuda":
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            p = xf @ proj
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    else:
        p = xf @ proj
    return torch.sum((p >= 0.0).to(torch.int32) * weights, dim=-1,
                     dtype=torch.int32)


@register_similarity_backend("exact")
def exact_backend(x_groups, *, lsh_bits: int = 8, lsh_seed: int = 0):
    """Measure every uncertain pair."""
    return None


@register_similarity_backend("lsh")
def lsh_backend(x_groups, *, lsh_bits: int = 8, lsh_seed: int = 0):
    """Measure only the uncertain pairs whose LSH codes collide; the codes
    also reach K2's tile-level early-out."""
    return lsh_codes(x_groups, bits=lsh_bits, seed=lsh_seed)


@torch.no_grad()
def fast_similarity(x_groups, expert_groups, s_prev: Optional[torch.Tensor],
                    s1: float, s2: float, *, backend: str = "exact",
                    lsh_bits: int = 8, lsh_seed: int = 0):
    """§V-A fast similarity over every group.

    x_groups: [NG, G, d]; expert_groups: [NG, G] primary expert ids;
    s_prev: [NG, G, G] similarity from the previous block (or None).
    Returns (sim [NG, G, G] f32, measured_frac [NG], the fraction of each
    group's G² pairs the backend measured). Skip rules: cross-expert
    pairs are 0, pairs with s_prev > s1 are 1, pairs with s_prev < s2
    are 0; of the rest the backend's pairs are measured, by K2's formula
    (the one the reference takes with ``use_kernels=True``; its own
    ``pairwise_cosine`` normalises first and decides differently at the
    margin), and the others are 0. On the card one launch of K2's fused
    entry applies the rules and the codes and measures; on the CPU its
    plain version runs them op by op."""
    code = get_similarity_backend(backend)(x_groups, lsh_bits=lsh_bits,
                                           lsh_seed=lsh_seed)
    return kops.masked_similarity_fused(x_groups, expert_groups, s_prev,
                                        s1, s2, code=code)


def expected_measured_pairs(tokens: int, group_size: int, num_experts: int,
                            *, backend: str = "exact",
                            lsh_bits: int = 8) -> float:
    """Expected pairs a backend measures on the first block (no
    similarity history yet) under uniform top-1 routing: per group, G
    diagonal pairs plus G (G - 1) / E same-expert off-diagonal pairs;
    the lsh backend scales the off-diagonal mass by the random
    bucket-collision probability 2^-bits. A host float."""
    G = group_size
    n_groups = max(1, tokens // G)
    offdiag = G * (G - 1) / max(1, num_experts)
    if backend == "lsh":
        offdiag *= 0.5 ** max(1, min(int(lsh_bits), 30))
    elif backend != "exact":
        get_similarity_backend(backend)   # raise on unknown names
    return float(n_groups * (G + offdiag))
