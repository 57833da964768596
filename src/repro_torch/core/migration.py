"""Sequence migration (paper §IV; counterpart of
``repro/core/migration.py``): Algorithm 1 and the attention cost model.

A plan is a bijection on global sequence slots: slot ``i`` (one
sequence) moves to rank ``assign[i]`` as its ``dest_slot``-th sequence;
``perm[i] = assign[i] * n_per_dev + dest_slot[i]`` is its new global
slot. The planner is a sequential greedy over ``M * n_per_dev`` slots,
so it runs on the host, in numpy; its inputs (a few hundred numbers)
are the only values the step copies off the device for it.

Two planners, as in the reference:

- :func:`plan_migration_np`, the paper-faithful host planner in f64,
  equal to the reference's ``plan_migration_np``;
- :func:`plan_migration_jax`, the same greedy in the f32 arithmetic of
  the reference's traced planner as XLA compiles it (the attention cost
  divided by the speed as a multiply by its f32 reciprocal, ``top_k``
  ties to the lower index), so its assignments equal the ones the
  reference's train step takes, bit for bit. The train path uses it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


def t_att(B, L, d: int, speed: float):
    """Attention cost model, paper Eq. 1: (3BLd^2 + 2BL^2d) / P."""
    B = B * 1.0
    L = L * 1.0
    return (3.0 * B * L * d * d + 2.0 * B * L * L * d) / speed


def _t_att_f32(B, L, d: int, speed: float):
    """:func:`t_att` on f32 arrays, evaluated as the reference's
    compiled step evaluates it."""
    f32 = np.float32
    B = B * f32(1.0)
    L = L * f32(1.0)
    s = (f32(3.0) * B * L * f32(d) * f32(d)
         + f32(2.0) * B * L * L * f32(d))
    return s * (f32(1.0) / f32(speed))


class MigrationPlan(NamedTuple):
    assign: np.ndarray          # [n_slots] int32 destination rank
    dest_slot: np.ndarray       # [n_slots] int32 slot on that rank
    perm: np.ndarray            # [n_slots] int32 new global slot
    traffic_before: np.ndarray  # [] f32 link-cost-weighted combine rows
    traffic_after: np.ndarray   # without / with migration


def _uniform_cost(M: int, dtype):
    return np.ones((M, M), dtype) - np.eye(M, dtype=dtype)


def _weighted_traffic(counts, dest, cost):
    """sum_i sum_m counts[i, m] * cost[m, dest[i]]."""
    return (counts * np.take(cost, dest, axis=1).T).sum()


def _finalize_plan(assign, counts, n_per_dev: int, link_cost=None, *,
                   traced: bool):
    """Dest-local slots and the traffic ledger; the identity placement
    when the greedy plan would move more (weighted) rows than none."""
    n_slots, M = counts.shape
    dtype = np.float32 if traced else np.float64
    cost = _uniform_cost(M, dtype) if link_cost is None else link_cost
    home = (np.arange(n_slots) // n_per_dev).astype(assign.dtype)
    before = _weighted_traffic(counts, home, cost)
    after = _weighted_traffic(counts, assign, cost)
    if after > before:
        assign, after = home, before
    onehot = (assign[:, None] == np.arange(M)[None, :]).astype(np.int32)
    rank = onehot.cumsum(axis=0) - onehot
    dest_slot = rank[np.arange(n_slots), assign]
    perm = assign * n_per_dev + dest_slot
    return MigrationPlan(assign.astype(np.int32), dest_slot.astype(np.int32),
                         perm.astype(np.int32), np.float32(before),
                         np.float32(after))


def plan_migration_np(counts, seq_lens, n_per_dev: int, *, q: int = 3,
                      d_model: int = 1024, speed: float = 1e13,
                      link_cost: Optional[np.ndarray] = None
                      ) -> MigrationPlan:
    """Algorithm 1 on the host in f64. counts: [n_slots, M] expert copies
    of slot i hosted on rank j; seq_lens: [n_slots]. Every rank ends
    with exactly ``n_per_dev`` slots."""
    counts = np.asarray(counts)
    seq_lens = np.asarray(seq_lens)
    n_slots, M = counts.shape
    cost = _uniform_cost(M, np.float64) if link_cost is None \
        else np.asarray(link_cost, np.float64)
    cap = np.full(M, n_per_dev, np.int64)
    dev_B = np.zeros(M, np.int64)
    dev_L = np.zeros(M, np.int64)
    assign = np.full(n_slots, -1, np.int64)
    for i in np.argsort(-seq_lens, kind="stable"):   # longest first
        f = counts[i] @ cost
        cand = [int(j) for j in np.argsort(f, kind="stable")[:q]
                if cap[j] > 0]
        if not cand:
            cand = [int(np.argmax(cap))]
        best, best_growth = cand[0], None
        for j in cand:
            newL = max(dev_L[j], seq_lens[i])
            growth = (t_att(dev_B[j] + 1, newL, d_model, speed)
                      - t_att(dev_B[j], dev_L[j], d_model, speed))
            # zero-added-padding tie-break (the reference's)
            growth -= 1e-5 * abs(growth) * float(dev_L[j] >= seq_lens[i])
            if best_growth is None or growth < best_growth - 1e-30:
                best, best_growth = j, growth
        assign[i] = best
        cap[best] -= 1
        dev_B[best] += 1
        dev_L[best] = max(dev_L[best], seq_lens[i])
    return _finalize_plan(assign, counts, n_per_dev,
                          None if link_cost is None else cost, traced=False)


def plan_migration_jax(counts, seq_lens, n_per_dev: int, *, q: int = 3,
                       d_model: int = 1024, speed: float = 1e13,
                       link_cost: Optional[np.ndarray] = None
                       ) -> MigrationPlan:
    """The reference's traced planner, in its f32 arithmetic."""
    f32 = np.float32
    counts = np.asarray(counts, f32)
    seq_lens = np.asarray(seq_lens, f32)
    n_slots, M = counts.shape
    cost = _uniform_cost(M, f32) if link_cost is None \
        else np.asarray(link_cost, f32)
    order = np.argsort(-seq_lens, kind="stable")
    cap = np.full(M, n_per_dev, np.int32)
    dev_B = np.zeros(M, f32)
    dev_L = np.zeros(M, f32)
    assign = np.full(n_slots, -1, np.int32)
    for slot in order:
        f = (counts[slot].astype(np.float64) @ cost.astype(np.float64)
             ).astype(f32)            # integer-valued: exact in any order
        cand = np.argsort(f, kind="stable")[:q]     # top_k of -f
        cand_ok = cap[cand] > 0
        L_i = seq_lens[slot]
        newL = np.maximum(dev_L[cand], L_i)
        growth = (_t_att_f32(dev_B[cand] + f32(1.0), newL, d_model, speed)
                  - _t_att_f32(dev_B[cand], dev_L[cand], d_model, speed))
        growth = growth - f32(1e-5) * np.abs(growth) \
            * (dev_L[cand] >= L_i).astype(f32)
        growth = np.where(cand_ok, growth, f32(np.inf))
        j = int(cand[int(np.argmin(growth))]) if cand_ok.any() \
            else int(np.argmax(cap))
        cap[j] -= 1
        dev_B[j] += f32(1.0)
        dev_L[j] = max(dev_L[j], L_i)
        assign[slot] = j
    return _finalize_plan(assign, counts, n_per_dev,
                          None if link_cost is None else cost, traced=True)


def identity_plan(n_slots: int, n_per_dev: int) -> MigrationPlan:
    idx = np.arange(n_slots, dtype=np.int32)
    z = np.float32(0.0)
    return MigrationPlan(idx // n_per_dev, idx % n_per_dev, idx, z, z)


def home_plan(counts, n_per_dev: int, link_cost=None, *,
              traced: bool = True) -> MigrationPlan:
    """The keep-everything-home plan with its traffic ledger."""
    counts = np.asarray(counts, np.float32 if traced else None)
    n_slots = counts.shape[0]
    home = (np.arange(n_slots) // n_per_dev).astype(np.int32)
    if link_cost is not None:
        link_cost = np.asarray(link_cost,
                               np.float32 if traced else np.float64)
    return _finalize_plan(home, counts, n_per_dev, link_cost, traced=traced)
