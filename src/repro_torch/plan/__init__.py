"""The MoE exchange plan and its executor (counterpart of ``repro/plan``):
:func:`build_exchange_plan` turns one router output into a frozen
:class:`ExchangePlan` and :func:`execute_plan` runs it; the planner's
objectives (:mod:`~repro_torch.plan.objectives`), the analytic estimate
(:mod:`~repro_torch.plan.estimate`), the plan's byte format
(:mod:`~repro_torch.plan.serial`) and the serving templates' cache
(:mod:`~repro_torch.plan.cache`)."""
from repro_torch.plan.cache import (PlanCache, build_decode_template,
                                    build_plan_template, decode_plan_key,
                                    plan_key, precompute_decode_plans,
                                    precompute_prefill_plans,
                                    prefill_plan_key, topology_fingerprint)
from repro_torch.plan.estimate import (PlanEstimate, estimate_exchange,
                                       estimate_planning_ms,
                                       estimate_revalidate_ms,
                                       estimate_similarity_ms,
                                       replica_consistency_ms)
from repro_torch.plan.exchange import (ExchangePlan, MoEAux, PlanSignature,
                                       build_exchange_plan, execute_plan,
                                       instantiate_decode_plan,
                                       instantiate_plan, invalid_signature,
                                       next_signature, plan_static_schedule,
                                       routing_signature_matches)
from repro_torch.plan.objectives import (ObjectiveContext,
                                         available_objectives,
                                         get_objective,
                                         plan_expert_replicas,
                                         plan_migration_with_objective,
                                         register_objective)
from repro_torch.plan.serial import (FORMAT_VERSION, PlanFormatError,
                                     from_bytes, to_bytes)

__all__ = [
    "ExchangePlan", "FORMAT_VERSION", "MoEAux", "ObjectiveContext",
    "PlanCache", "PlanEstimate", "PlanFormatError", "PlanSignature",
    "available_objectives", "build_decode_template", "build_exchange_plan",
    "build_plan_template", "decode_plan_key", "estimate_exchange",
    "estimate_planning_ms", "estimate_revalidate_ms",
    "estimate_similarity_ms", "execute_plan", "from_bytes", "get_objective",
    "instantiate_decode_plan", "instantiate_plan", "invalid_signature",
    "next_signature", "plan_expert_replicas", "plan_key",
    "plan_migration_with_objective", "plan_static_schedule",
    "precompute_decode_plans", "precompute_prefill_plans",
    "prefill_plan_key", "register_objective", "replica_consistency_ms",
    "routing_signature_matches", "to_bytes", "topology_fingerprint",
]
