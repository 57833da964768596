"""Execution scheduling (counterpart of ``repro/sched``): split the MoE
exchange's static dispatch capacity into 8-aligned chunks
(:mod:`repro_torch.sched.plan`), run dispatch -> expert FFN -> combine
as a double-buffered pipeline with the collectives on a side CUDA stream
(:mod:`repro_torch.sched.pipeline`), and price the overlap analytically
(:mod:`repro_torch.sched.cost`).

The pipelined executor only reorders the sync path: chunking the
capacity axis commutes with the data-movement collectives and the
row-wise expert FFN, so ``LuffyConfig.exec_mode="pipeline"``'s forward
is the sync path's bit for bit.
"""
from repro_torch.sched.cost import (dedup_overlap_ms, optimal_chunks,
                                    overlap_ms, sync_ms)
from repro_torch.sched.pipeline import (format_schedule, pipeline_schedule,
                                        run_pipeline)
from repro_torch.sched.plan import ChunkPlan, plan_chunks, plan_unique_chunks

__all__ = [
    "ChunkPlan", "dedup_overlap_ms", "format_schedule", "optimal_chunks",
    "overlap_ms", "pipeline_schedule", "plan_chunks", "plan_unique_chunks",
    "run_pipeline", "sync_ms",
]
