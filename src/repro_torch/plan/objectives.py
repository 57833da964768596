"""Migration-planner objectives (counterpart of
``repro/plan/objectives.py``): the registry and the ``"traffic"``
objective, which minimises link-cost-weighted combine rows. The
reference's ``"overlap"`` (the pipelined exchange's exposed time) and
``"replicate"`` (expert replicas) objectives are not ported
(``repro_torch.plan.exchange.check_ported`` raises on them, naming the
queue item that brings them).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.comm.topology import Topology
from repro_torch.core import migration as mig

Objective = Callable[..., mig.MigrationPlan]
OBJECTIVES: Dict[str, Objective] = {}


def register_objective(name: str):
    def deco(fn: Objective) -> Objective:
        OBJECTIVES[name] = fn
        return fn
    return deco


def get_objective(name: str) -> Objective:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown plan_objective {name!r}; registered: "
                         f"{sorted(OBJECTIVES)}") from None


def traffic_link_cost(topo: Optional[Topology]) -> Optional[np.ndarray]:
    """``Topology.link_cost()`` when hierarchical, else None (the
    planner then prices every link alike)."""
    if topo is None or not topo.hierarchical:
        return None
    return topo.link_cost()


@register_objective("traffic")
def _traffic(counts, seq_lens, n_per_dev: int, *, topo, q: int,
             d_model: int, speed: float):
    return mig.plan_migration_jax(counts, seq_lens, n_per_dev, q=q,
                                  d_model=d_model, speed=speed,
                                  link_cost=traffic_link_cost(topo))


def plan_migration_with_objective(counts, seq_lens, n_per_dev: int, *,
                                  objective: str = "traffic",
                                  topo: Optional[Topology] = None,
                                  q: int = 3, d_model: int = 1024,
                                  speed: float = 1e13) -> mig.MigrationPlan:
    """Algorithm 1 under the named objective, in the f32 arithmetic of
    the reference's traced planner, whose plans its train step takes."""
    return get_objective(objective)(counts, seq_lens, n_per_dev, topo=topo,
                                    q=q, d_model=d_model, speed=speed)
