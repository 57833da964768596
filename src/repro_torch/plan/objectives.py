"""Migration-planner objectives (counterpart of
``repro/plan/objectives.py``).

The migration greedy (:mod:`repro_torch.core.migration`, Algorithm 1)
ranks candidate destinations by an ``[M, M]`` per-byte link-cost matrix.
An objective decides what that matrix prices and, where the greedy cannot
optimise the true goal exactly, how to choose among candidate plans:

* ``"traffic"``: link-cost-weighted combine rows (``Topology.link_cost``;
  uniform ``1 - I`` on a flat fabric);
* ``"overlap"``: the modelled *exposed* time of the pipelined exchange.
  The greedy runs on the exposure-weighted matrix
  (:func:`exposed_link_cost`) and on traffic's, and the plan whose
  phase-decomposed exposed time (:func:`plan_exposed_ms`) is lower is
  kept, so it is never worse than traffic's in that model; on a flat
  fabric or a sync exchange it is traffic's plan;
* ``"replicate"``: traffic's plan verbatim. What it adds is placement:
  :func:`plan_expert_replicas` (called by the plan builder) puts each
  node's hottest expert on an intra-node peer's spare dispatch lane when
  the modelled relief beats the replica-consistency cost.

The train path plans on the host over numpy, in the f32 arithmetic of
the reference's compiled planner, whose plans its train step takes: the
greedy (``plan_migration_jax``), and the overlap objective's exposed-time
comparison as XLA compiles it (:func:`plan_exposed_ms`).
:func:`plan_expert_replicas` runs on the device over torch tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.topology import Topology
from repro_torch.core import migration as mig
from repro_torch.plan.estimate import replica_consistency_ms
from repro_torch.sched.cost import DEFAULT_CHUNK_OVERHEAD_MS


class ObjectiveContext(NamedTuple):
    """What an objective prices a migration against: one rank's share of
    one exchange. ``dispatch_*_ms`` are plan-invariant, ``ffn_ms`` is the
    expert stage the pipeline hides collectives under, ``chunks`` the
    pipeline depth (1 = sync), ``row_bytes`` turns the planner's row
    counts into combine bytes."""
    topo: Optional[Topology]
    ffn_ms: float = 0.0
    dispatch_intra_ms: float = 0.0
    dispatch_inter_ms: float = 0.0
    chunks: int = 1
    row_bytes: float = 4.0
    chunk_overhead_ms: float = DEFAULT_CHUNK_OVERHEAD_MS

    @property
    def hierarchical(self) -> bool:
        return self.topo is not None and self.topo.hierarchical


Objective = Callable[..., mig.MigrationPlan]
OBJECTIVES: Dict[str, Objective] = {}


def register_objective(name: str):
    def deco(fn: Objective) -> Objective:
        OBJECTIVES[name] = fn
        return fn
    return deco


def available_objectives():
    return sorted(OBJECTIVES)


def get_objective(name: str) -> Objective:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown plan_objective {name!r}; registered: "
                         f"{available_objectives()}") from None


def plan_migration_with_objective(counts, seq_lens, n_per_dev: int, *,
                                  objective: str = "traffic",
                                  ctx: Optional[ObjectiveContext] = None,
                                  q: int = 3, d_model: int = 1024,
                                  speed: float = 1e13) -> mig.MigrationPlan:
    """Algorithm 1 under the named objective, in the f32 arithmetic of
    the reference's traced planner."""
    if ctx is None:
        ctx = ObjectiveContext(topo=None)
    return get_objective(objective)(counts, seq_lens, n_per_dev, ctx=ctx,
                                    q=q, d_model=d_model, speed=speed)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

def traffic_link_cost(topo: Optional[Topology]) -> Optional[np.ndarray]:
    """``Topology.link_cost()`` when hierarchical, else None (the
    planner then prices every link alike)."""
    if topo is None or not topo.hierarchical:
        return None
    return topo.link_cost()


def exposed_link_cost(ctx: ObjectiveContext) -> np.ndarray:
    """[M, M] per-byte exposed-time cost of the chunked pipeline,
    normalised so an intra-node byte costs 1. A combine byte on a tier
    pays its link time in the boundary chunk (weight 1/n) and in every
    steady-state chunk too when that tier's dispatch stage is the
    bottleneck (weight 1); at one chunk it is ``link_cost()``."""
    topo = ctx.topo
    if topo is None or not topo.hierarchical:
        raise ValueError("the exposed-time cost needs a hierarchical "
                         "topology")
    n = max(1, int(ctx.chunks))
    f = ctx.ffn_ms / n
    per_byte = {"intra": 1e3 / topo.intra_bw, "inter": 1e3 / topo.inter_bw}
    stage0 = {"intra": ctx.dispatch_intra_ms / n,
              "inter": ctx.dispatch_inter_ms / n}
    peak = max(f, *stage0.values())
    alpha = {t: (1.0 if stage0[t] >= peak - 1e-12 else 1.0 / n)
             for t in stage0}
    ratio = (alpha["inter"] * per_byte["inter"]) \
        / max(alpha["intra"] * per_byte["intra"], 1e-30)
    dev = np.arange(topo.num_devices)
    same_node = topo.node_of(dev)[:, None] == topo.node_of(dev)[None, :]
    cost = np.where(same_node, 1.0, ratio)
    np.fill_diagonal(cost, 0.0)
    return cost.astype(np.float64)


def plan_exposed_ms(counts, assign, ctx: ObjectiveContext) -> np.float32:
    """Modelled exposed sublayer time (ms) of a plan's exchange through
    the five-stage chunked pipeline (every stage's warm-up and cool-down
    plus ``n - 1`` chunks at the bottleneck stage's rate), where
    ``counts[i, m]`` combine rows go from rank m to ``assign[i]`` and
    rows that stay on a rank cross no link. Computed as the reference's
    compiled step computes it (its HLO under jit, at chunks > 1): each
    tier's byte sum (exact: integer rows times the row bytes) times one
    folded f32 constant, ``(1 / bw) * 1e3 * (1 / n)``; the plan-invariant
    stages' sum and the overhead folded into one constant; f32 adds in
    that order."""
    f32 = np.float32
    counts = np.asarray(counts, f32)
    topo = ctx.topo
    n = max(1, int(ctx.chunks))
    o = ctx.chunk_overhead_ms / 2.0
    L = topo.devices_per_node
    src = np.arange(counts.shape[1])
    dst = np.asarray(assign)
    same_dev = src[None, :] == dst[:, None]
    same_node = (src[None, :] // L) == (dst[:, None] // L)
    c = counts * f32(ctx.row_bytes)
    xi = np.sum(np.where(same_node & ~same_dev, c, f32(0.0)), dtype=f32)
    xe = np.sum(np.where(~same_node, c, f32(0.0)), dtype=f32)
    rn = f32(1.0) / f32(n)
    ki = (f32(1.0) / f32(topo.intra_bw) * f32(1e3)) * rn
    ke = (f32(1.0) / f32(topo.inter_bw) * f32(1e3)) * rn
    s012 = (ctx.dispatch_intra_ms / n + o, ctx.dispatch_inter_ms / n + o,
            ctx.ffn_ms / n)
    s3 = xi * ki + f32(o)
    s4 = xe * ke + f32(o)
    total = (xi * ki + (f32(sum(s012)) + f32(o))) + s4
    peak = max(s3, f32(max(f32(s) for s in s012)), s4)
    return f32(total + peak * f32(n - 1))


# ---------------------------------------------------------------------------
# the objectives
# ---------------------------------------------------------------------------

@register_objective("traffic")
def traffic_objective(counts, seq_lens, n_per_dev: int, *,
                      ctx: ObjectiveContext, q: int = 3, d_model: int = 1024,
                      speed: float = 1e13) -> mig.MigrationPlan:
    """Link-cost-weighted combine rows."""
    return mig.plan_migration_jax(counts, seq_lens, n_per_dev, q=q,
                                  d_model=d_model, speed=speed,
                                  link_cost=traffic_link_cost(ctx.topo))


@register_objective("overlap")
def overlap_objective(counts, seq_lens, n_per_dev: int, *,
                      ctx: ObjectiveContext, q: int = 3, d_model: int = 1024,
                      speed: float = 1e13) -> mig.MigrationPlan:
    """The greedy on the exposure-weighted matrix and on traffic's; the
    plan with the lower modelled exposed time wins, traffic's on a tie."""
    base = traffic_objective(counts, seq_lens, n_per_dev, ctx=ctx, q=q,
                             d_model=d_model, speed=speed)
    if not ctx.hierarchical or ctx.chunks <= 1:
        return base          # nothing to hide behind: exposed == traffic
    cand = mig.plan_migration_jax(counts, seq_lens, n_per_dev, q=q,
                                  d_model=d_model, speed=speed,
                                  link_cost=exposed_link_cost(ctx))
    t_cand = plan_exposed_ms(counts, cand.assign, ctx)
    t_base = plan_exposed_ms(counts, base.assign, ctx)
    return cand if t_cand < t_base else base


# Minimum hot-expert demand, as a multiple of the mean per-expert demand,
# before a replica is considered (the reference's).
REPLICATE_SKEW_MIN = 2.0


@register_objective("replicate")
def replicate_objective(counts, seq_lens, n_per_dev: int, *,
                        ctx: ObjectiveContext, q: int = 3,
                        d_model: int = 1024,
                        speed: float = 1e13) -> mig.MigrationPlan:
    """Traffic's migration plan verbatim; the replicas are
    :func:`plan_expert_replicas`'s, which the plan builder calls."""
    return traffic_objective(counts, seq_lens, n_per_dev, ctx=ctx, q=q,
                             d_model=d_model, speed=speed)


def plan_expert_replicas(load_e: torch.Tensor, *, e_local: int,
                         topo: Topology, ffn_ms: float, d_model: int,
                         d_ff: int, bytes_per_el: int = 4) -> torch.Tensor:
    """The replica placement, ``[M]`` int32 on ``load_e``'s device: the
    global expert each rank's replica lane serves, -1 for an idle lane.

    Per node, its hottest expert (the first of equal maxima, as
    ``argmax`` of both frameworks) goes to the owner's next intra-node
    peer, ``(owner + 1) mod L`` within the node, when its demand is at
    least :data:`REPLICATE_SKEW_MIN` times the mean and the modelled
    relief, half the hot expert's share of the FFN stage, beats the
    per-step replica-consistency cost. ``load_e`` [E] f32 is the demand
    summed over every rank, so all ranks take one placement. In f32, as
    the reference's traced version; no host sync."""
    E = load_e.shape[0]
    M = E // e_local
    L, N = topo.devices_per_node, topo.num_nodes
    if M != N * L:
        raise ValueError(f"{E} experts over {e_local} a rank are {M} ranks, "
                         f"not the topology's {N} x {L}")
    dev = load_e.device
    per_node = load_e.reshape(N, L * e_local)
    hot_rel = torch.argmax(per_node, dim=1).to(torch.int32)
    hot_load = per_node.max(dim=1).values
    nodes = torch.arange(N, dtype=torch.int32, device=dev)
    hot_e = nodes * (L * e_local) + hot_rel
    total = torch.clamp(load_e.sum(), min=1.0)
    # the constants as the f32 values the compiled reference holds (XLA
    # multiplies by the reciprocal of the constant E)
    mean = total * float(np.float32(1.0) / np.float32(E))
    relief_ms = (hot_load / total) * float(np.float32(ffn_ms)) * 0.5
    cost_ms = replica_consistency_ms(1, d_model, d_ff, topo=topo,
                                     bytes_per_el=bytes_per_el)
    take = (hot_load >= REPLICATE_SKEW_MIN * mean) \
        & (relief_ms > float(np.float32(cost_ms)))
    owner = torch.div(hot_e, e_local, rounding_mode="floor")
    base = nodes * L
    host = base + torch.remainder(owner - base + 1, L)
    out = torch.full((M,), -1, dtype=torch.int32, device=dev)
    return out.index_copy(0, host.long(),
                          torch.where(take, hot_e, torch.full_like(hot_e, -1)))
