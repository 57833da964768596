"""The condensation decision as data (paper §V; counterpart of
``repro/condense/plan.py``), one device.

Tokens are condensed in fixed groups of ``G`` consecutive tokens; the
§V-A skip rules become masks, the similarity is kernel K2 over every
group in one launch (through the backend registry of
:mod:`repro_torch.condense.backends`: ``exact`` or ``lsh``), connected
components and the highest-degree representative (§V-B) come from
``ceil(log2 G) + 1`` rounds of min-label propagation with pointer
jumping (copied round for round: a union-find would pick other
representatives), and un-condense is kernel K3. Everything that decides
runs under ``torch.no_grad()``; only :func:`uncondense` carries a
gradient.

A condense plan can be reused across MoE sublayers
(``LuffyConfig.condense_reuse``): the :class:`CondenseCarry` (the rep
map and the primary experts it was built on, with a per-sequence age and
valid flag) threads through the layer stack, and "signature" or "always"
take the carried map instead of rebuilding the similarity while it
revalidates. Host helpers for the rate bucket (:func:`pick_rate_bucket`,
:func:`similarity_quantiles`) are numpy.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
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
    """What a carried rep map revalidates against: the primary experts it
    was built on, per sequence its age (sublayers since the build) and
    valid flag; under ``condense_reuse="off"`` ``valid`` stays 0 so it
    never does."""
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
                    backend: str = "exact", lsh_bits: int = 8,
                    lsh_seed: int = 0, ranks: int = 1) -> CondenseOutput:
    """Condense local tokens (paper §V), every group at once.

    x: [T, d] router input; primary_expert: [T]; threshold: f32 scalar
    tensor (Eq. 2 or static); s_prev: [n_groups, G, G] carried
    similarity; backend: the similarity backend's name ("exact" |
    "lsh"). The tokens are those of ``ranks`` ranks in rank-major order
    (groups never span two ranks). Returns the global rep map over [T];
    the rate and measured pairs are per rank ([ranks])."""
    T, d = x.shape
    G = group_size
    if T % G:
        raise ValueError(f"T={T} is not a multiple of the group size {G}")
    ng = T // G
    sim, measured = sim_backends.fast_similarity(
        x.reshape(ng, G, d), primary_expert.reshape(ng, G),
        None if s_prev is None else s_prev.float(), s1, s2,
        backend=backend, lsh_bits=lsh_bits, lsh_seed=lsh_seed)
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
                        backend: str = "exact", lsh_bits: int = 8,
                        lsh_seed: int = 0,
                        carry: Optional[CondenseCarry] = None,
                        reuse_mode: str = "off", max_age: int = 4,
                        ranks: int = 1) -> CondensePlan:
    """Decide one sublayer's condensation: a full similarity build
    (:func:`condense_tokens`), or, when the threaded ``carry``
    revalidates, the carried rep map with the similarity history passed
    through unchanged and nothing measured.

    The carry revalidates when every sequence's valid flag is set and
    its age is under ``max_age``, and under ``reuse_mode="signature"``
    also the primary experts equal those it was built on (merged tokens
    must still share an expert); "always" skips that compare. The
    emitted signature has age ``age + 1`` after a reuse and 0 after a
    build, and valid 1 unless the mode is "off". Under "off" every
    emitted flag is 0, so a carry threaded through the stack never
    revalidates and nothing is asked of the device; under the other
    modes the decision is one host bool a sublayer, so one device sync
    (which waits for the work queued before it) that picks the branch
    and skips K2 and the component rounds on a reuse. The reuse
    machinery needs a similarity history to pass through, so it engages
    only when both ``carry`` and ``s_prev`` are given (the train forward
    threads both whenever condensation is on); a carry without history
    gives a signature that never validates."""
    if reuse_mode not in ("off", "signature", "always"):
        raise ValueError(f"unknown condense_reuse {reuse_mode!r}")
    T = x.shape[0]
    G = group_size
    dev = x.device
    one = torch.ones((), dtype=torch.float32, device=dev)

    def full_build():
        return condense_tokens(x, primary_expert, threshold, group_size=G,
                               s_prev=s_prev, s1=s1, s2=s2, backend=backend,
                               lsh_bits=lsh_bits, lsh_seed=lsh_seed,
                               ranks=ranks)

    if carry is None or s_prev is None:
        out = full_build()
        sig = None
        if carry is not None:
            zeros = torch.zeros_like(carry.age, dtype=torch.float32)
            sig = CondenseSignature(primary_expert, zeros, zeros.clone())
        return CondensePlan(
            backend=backend, rep_idx=out.rep_idx, is_rep=out.is_rep,
            s_next=out.sim, rate=out.rate,
            measured_pairs=out.measured_pairs, signature=sig, built=one,
            reused=torch.zeros_like(one))

    match = False
    if reuse_mode != "off":
        ok = torch.all(carry.valid > 0.5) \
            & torch.all(carry.age < float(max_age))
        if reuse_mode == "signature":
            ok = ok & torch.all(carry.expert == primary_expert)
        match = bool(ok)
    if match:
        idx = torch.arange(T, device=dev)
        rep_idx = (idx // G) * G + carry.rep.to(idx.dtype)
        is_rep = rep_idx == idx
        rate = 1.0 - torch.mean(is_rep.reshape(ranks, -1).float(), dim=1)
        sims = s_prev.float().reshape(-1, G, G)
        pairs = torch.zeros((ranks,), dtype=torch.float32, device=dev)
        age_out = carry.age.float() + 1.0
    else:
        out = full_build()
        rep_idx, is_rep, sims = out.rep_idx, out.is_rep, out.sim
        rate, pairs = out.rate, out.measured_pairs
        age_out = torch.zeros_like(carry.age, dtype=torch.float32)
    valid_out = torch.full_like(age_out, float(reuse_mode != "off"))
    mf = one * float(match)
    return CondensePlan(
        backend=backend, rep_idx=rep_idx, is_rep=is_rep, s_next=sims,
        rate=rate, measured_pairs=pairs,
        signature=CondenseSignature(primary_expert, age_out, valid_out),
        built=one - mf, reused=mf)


def pick_rate_bucket(threshold: float, sim_quantiles, buckets) -> int:
    """Host: the largest bucket whose condensable fraction, estimated from
    observed similarity quantiles (the 11 decile values of
    :func:`similarity_quantiles`), is supportable."""
    q = np.asarray(sim_quantiles, dtype=np.float64)
    frac = float(np.mean(q >= threshold))
    best = 0
    for i, b in enumerate(buckets):
        if b <= frac + 1e-9:
            best = i
    return best


def similarity_quantiles(sim, expert_idx=None, same_expert_only: bool = True):
    """Host: the 11 decile values of the off-diagonal similarity
    distribution (for :func:`pick_rate_bucket`). sim: [..., G, G];
    expert_idx: [..., G] primary expert ids, needed when
    ``same_expert_only``: then only the off-diagonal same-expert pairs
    (the pairs condensation can merge) enter the distribution. Tensors
    are copied to the host."""
    if isinstance(sim, torch.Tensor):
        sim = sim.detach().cpu().numpy()
    if isinstance(expert_idx, torch.Tensor):
        expert_idx = expert_idx.detach().cpu().numpy()
    s = np.asarray(sim, np.float64)
    G = s.shape[-1]
    s = s.reshape(-1, s.shape[-2], G)
    off_diag = ~np.eye(G, dtype=bool)
    if same_expert_only:
        if expert_idx is None:
            raise ValueError(
                "same_expert_only=True needs expert_idx to identify "
                "same-expert pairs (or pass same_expert_only=False)")
        e = np.asarray(expert_idx).reshape(-1, G)
        mask = (e[:, :, None] == e[:, None, :]) & off_diag[None]
    else:
        mask = np.broadcast_to(off_diag[None], s.shape)
    vals = s[mask]
    if vals.size == 0:
        vals = np.zeros((1,), np.float64)
    return np.quantile(vals, np.linspace(0.0, 1.0, 11))
