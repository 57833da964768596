"""The condensation decision as data (paper §V; counterpart of
``repro/condense/plan.py``), one device.

Tokens are condensed in fixed groups of ``G`` consecutive tokens; the
§V-A skip rules become masks, the similarity is kernel K2 over every
group in one launch, connected components and the highest-degree
representative (§V-B) come from ``ceil(log2 G) + 1`` rounds of min-label
propagation with pointer jumping (copied round for round: a union-find
would pick other representatives), and un-condense is kernel K3.
Everything that decides runs under ``torch.no_grad()``; only
:func:`uncondense` carries a gradient.

Ported: the ``exact`` backend and ``reuse_mode="off"``, which still
emits the reference's never-validating signature so the carry has its
shape. ``lsh`` and plan reuse raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.condense import backends as sim_backends
from repro_torch.kernels import ops as kops


class CondenseOutput(NamedTuple):
    rep_idx: torch.Tensor         # [T] int64 each token's representative
    is_rep: torch.Tensor          # [T] bool token represents itself
    sim: torch.Tensor             # [n_groups, G, G] f32 (next s_prev)
    rate: torch.Tensor            # [ranks] f32 fraction condensed
    measured_pairs: torch.Tensor  # [ranks] f32 pairs actually measured


class CondenseSignature(NamedTuple):
    """What a carried rep map would revalidate against; under
    ``condense_reuse="off"`` ``valid`` stays 0 so it never does."""
    expert: torch.Tensor          # [T] primary expert per token
    age: torch.Tensor             # [n_seq] f32
    valid: torch.Tensor           # [n_seq] f32


class CondenseCarry(NamedTuple):
    """The cross-sublayer reuse state threaded through the layer stack:
    the carried rep map (within-group positions) and its signature."""
    rep: torch.Tensor             # [T] rep position within the group
    expert: torch.Tensor          # [T]
    age: torch.Tensor             # [n_seq] f32
    valid: torch.Tensor           # [n_seq] f32


class CondensePlan(NamedTuple):
    """One sublayer's frozen condensation decision."""
    backend: str
    rep_idx: torch.Tensor         # [T] int64
    is_rep: torch.Tensor          # [T] bool
    s_next: Optional[torch.Tensor]  # [n_groups, G, G] f32
    rate: torch.Tensor            # [ranks] f32
    measured_pairs: torch.Tensor  # [ranks] f32
    signature: Optional[CondenseSignature] = None
    built: Optional[torch.Tensor] = None    # [] f32, 1 when sim was built
    reused: Optional[torch.Tensor] = None   # [] f32, 1 when reused


def identity_condense_plan(T: int, backend: str = "exact", *,
                           device, ranks: int = 1) -> CondensePlan:
    """The condense-nothing plan: every token represents itself. The T
    tokens are the ranks' in rank-major order; the rate and pair count
    are per rank ([ranks])."""
    z = torch.zeros((ranks,), dtype=torch.float32, device=device)
    return CondensePlan(backend=backend,
                        rep_idx=torch.arange(T, device=device),
                        is_rep=torch.ones((T,), dtype=torch.bool,
                                          device=device),
                        s_next=None, rate=z, measured_pairs=z)


def adaptive_threshold(l_ini, l_prev):
    """Paper Eq. (2): h_t = 1 / (1 + exp(l_norm)), in f32 tensors."""
    l_norm = (l_ini - l_prev) / torch.clamp(l_ini, min=1e-9)
    return 1.0 / (1.0 + torch.exp(l_norm))


@torch.no_grad()
def _components_and_reps(adj):
    """adj: [NG, G, G] bool symmetric. Returns rep [NG, G] int64, the
    index (within its group) each node condenses to: the highest-degree
    node of its connected component, ties to the smallest index (§V-B).
    Exactly the reference's rounds, so chains longer than they reach
    split the same way."""
    NG, G, _ = adj.shape
    dev = adj.device
    idx = torch.arange(G, device=dev)
    adj = adj | torch.eye(G, dtype=torch.bool, device=dev)
    labels = idx.expand(NG, G)
    big = torch.full((), G, dtype=labels.dtype, device=dev)
    for _ in range(max(1, math.ceil(math.log2(G)) + 1)):
        neigh_min = torch.where(adj, labels[:, None, :], big).amin(dim=2)
        labels = torch.minimum(labels, neigh_min)
        labels = labels.gather(1, labels)          # pointer jumping
    degree = adj.sum(dim=2)
    score = degree * G + (G - 1 - idx)             # larger is better
    same = labels[:, :, None] == labels[:, None, :]
    comp = torch.where(same, score[:, None, :],
                       torch.full((), -1, dtype=score.dtype, device=dev))
    return comp.argmax(dim=2)


@torch.no_grad()
def condense_tokens(x, primary_expert, threshold, *, group_size: int,
                    s_prev: Optional[torch.Tensor] = None,
                    s1: float = 0.8, s2: float = 0.2,
                    ranks: int = 1) -> CondenseOutput:
    """Condense local tokens (paper §V), every group at once.

    x: [T, d] router input; primary_expert: [T]; threshold: f32 scalar
    tensor (Eq. 2 or static); s_prev: [n_groups, G, G] carried
    similarity. The tokens are those of ``ranks`` ranks in rank-major
    order (groups never span two ranks). Returns the global rep map over
    [T]; the rate and measured pairs are per rank ([ranks])."""
    T, d = x.shape
    G = group_size
    if T % G:
        raise ValueError(f"T={T} is not a multiple of the group size {G}")
    ng = T // G
    sim, measured = sim_backends.fast_similarity(
        x.reshape(ng, G, d), primary_expert.reshape(ng, G),
        None if s_prev is None else s_prev.float(), s1, s2)
    eye = torch.eye(G, dtype=torch.bool, device=x.device)
    reps = _components_and_reps((sim >= threshold) & ~eye)
    offsets = torch.arange(ng, device=x.device)[:, None] * G
    rep_idx = (reps + offsets).reshape(T)
    is_rep = rep_idx == torch.arange(T, device=x.device)
    rate = 1.0 - torch.mean(is_rep.reshape(ranks, -1).float(), dim=1)
    pairs = torch.sum(measured.reshape(ranks, -1), dim=1) * float(G * G)
    return CondenseOutput(rep_idx, is_rep, sim, rate, pairs)


def uncondense(y, rep_idx, group_size=None):
    """y: [T, d] MoE outputs (garbage at condensed rows); each condensed
    token takes its representative's row (token_to_token, §VI), through
    kernel K3. Differentiable in y. ``group_size`` G says the map is
    group-local (every representative lies in its token's group of G, as
    :func:`condense_tokens` makes it), so the card's backward needs no
    global sort."""
    return kops.gather_rows(y, rep_idx, group_size)


@torch.no_grad()
def build_condense_plan(x, primary_expert, threshold, *, group_size: int,
                        s_prev: Optional[torch.Tensor] = None,
                        s1: float = 0.8, s2: float = 0.2,
                        backend: str = "exact",
                        carry: Optional[CondenseCarry] = None,
                        reuse_mode: str = "off",
                        ranks: int = 1) -> CondensePlan:
    """Decide one sublayer's condensation with a full similarity build.

    Under ``reuse_mode="off"`` (the one ported) a threaded ``carry``
    never revalidates, as in the reference, whose "off" pins its valid
    flag to 0; it only gives the emitted signature its shape: the
    primary experts with age and valid 0 per sequence. Without a carry
    there is no signature."""
    if backend != "exact":
        raise NotImplementedError(
            f"similarity_backend={backend!r}: the lsh backend is not "
            f"ported yet (ROADMAP Queue 1 item 4); use 'exact'")
    if reuse_mode != "off":
        raise NotImplementedError(
            f"condense_reuse={reuse_mode!r}: condense-plan reuse is not "
            f"ported yet (ROADMAP Queue 1 item 4); use 'off'")
    out = condense_tokens(x, primary_expert, threshold,
                          group_size=group_size, s_prev=s_prev, s1=s1, s2=s2,
                          ranks=ranks)
    sig = None
    if carry is not None:
        zeros = torch.zeros_like(carry.age, dtype=torch.float32)
        sig = CondenseSignature(primary_expert, zeros, zeros.clone())
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return CondensePlan(
        backend=backend, rep_idx=out.rep_idx, is_rep=out.is_rep,
        s_next=out.sim, rate=out.rate, measured_pairs=out.measured_pairs,
        signature=sig, built=one, reused=torch.zeros_like(one))
