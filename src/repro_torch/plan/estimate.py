"""Analytic per-phase estimates of one exchange (counterpart of
``repro/plan/estimate.py``).

:func:`estimate_exchange` prices dispatch all-to-all -> expert FFN ->
combine all-to-all on a :class:`~repro_torch.comm.Topology`: per-tier
bytes (flat wire and per-node deduplicated), bandwidth-latency phase
times and the pipelined and sync sublayer times of
:mod:`repro_torch.sched.cost`. The plan's chunk search
(``plan/exchange.py::plan_static_schedule``) reads it. Host floats on
static shapes, in the reference's order, so every field equals the
reference's. The link rates are the reference's planning defaults, not
a measurement of any device this port runs on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch.comm import dtypes as wire
from repro_torch.comm import ledger as comm_ledger
from repro_torch.comm.topology import Topology
from repro_torch.sched import cost as sched_cost


class PlanEstimate(NamedTuple):
    """Per-phase byte and time model of one exchange. ``flat_*`` bytes
    are a flat all-to-all's; the others the per-node deduplicated
    payload's (equal on a flat topology)."""
    intra_dispatch_bytes: float
    inter_dispatch_bytes: float
    flat_intra_dispatch_bytes: float
    flat_inter_dispatch_bytes: float
    intra_combine_bytes: float
    inter_combine_bytes: float
    dispatch_ms: float
    combine_ms: float
    flat_dispatch_ms: float
    ffn_ms: float
    sync_ms: float
    overlap_ms: float
    chunks: int
    # the pipelined dedup wire: the hop's inter- and intra-node phases
    # overlap within a stage
    dedup_overlap_ms: float = 0.0

    @property
    def speedup(self) -> float:
        return self.sync_ms / max(self.overlap_ms, 1e-12)


def estimate_exchange(tokens: int, top_k: int, d_model: int, *,
                      topo: Topology, r_cond: float = 0.0,
                      locality: float = 0.0, bytes_per_el: int = 4,
                      num_layers: int = 1, ffn_ms: float = 0.0,
                      chunks: Optional[int] = None, max_chunks: int = 16,
                      intra_bw: Optional[float] = None,
                      inter_bw: Optional[float] = None,
                      chunk_overhead_ms: float =
                      sched_cost.DEFAULT_CHUNK_OVERHEAD_MS,
                      wire_dtype: str = "f32") -> PlanEstimate:
    """Price one exchange of ``tokens`` x ``top_k`` dispatch rows.

    ``r_cond`` removes condensed tokens, ``locality`` scales the combine
    payload by the migration's locality gain, ``ffn_ms`` is the expert
    stage the pipeline overlaps against. ``chunks=None`` searches
    1..``max_chunks``, else the given count is priced. ``intra_bw`` /
    ``inter_bw`` override the topology's rates; ``wire_dtype`` scales
    the bytes per element by ``1 / wire_precision``."""
    wire_bpe = bytes_per_el / wire.wire_precision(d_model, wire_dtype,
                                                  bytes_per_el)
    fi, fe = comm_ledger.dispatch_bytes(
        tokens, top_k, d_model, topo=topo, r_cond=r_cond,
        bytes_per_el=wire_bpe, num_layers=num_layers, dedup=False)
    hi, he = comm_ledger.dispatch_bytes(
        tokens, top_k, d_model, topo=topo, r_cond=r_cond,
        bytes_per_el=wire_bpe, num_layers=num_layers, dedup=True)
    ci, ce = hi * (1.0 - locality), he * (1.0 - locality)
    bw_i = intra_bw if intra_bw is not None else topo.intra_bw
    bw_e = inter_bw if inter_bw is not None else topo.inter_bw

    def phase_ms(intra_bytes: float, inter_bytes: float) -> float:
        mi, me = comm_ledger.phase_messages(topo)
        return (intra_bytes / bw_i + inter_bytes / bw_e
                + mi * topo.intra_lat + me * topo.inter_lat) * 1e3

    d_ms = phase_ms(hi, he)
    c_ms = phase_ms(ci, ce)
    kw = dict(dispatch_ms=d_ms, ffn_ms=ffn_ms, combine_ms=c_ms,
              chunk_overhead_ms=chunk_overhead_ms)
    if chunks is None:
        n, t_pipe = sched_cost.optimal_chunks(topo, max_chunks=max_chunks,
                                              **kw)
    else:
        n = max(1, int(chunks))
        t_pipe = sched_cost.overlap_ms(topo, n, **kw)
    mi, me = comm_ledger.phase_messages(topo)
    t_dedup = sched_cost.dedup_overlap_ms(
        topo, n,
        dispatch_inter_ms=(he / bw_e + me * topo.inter_lat) * 1e3,
        dispatch_intra_ms=(hi / bw_i + mi * topo.intra_lat) * 1e3,
        ffn_ms=ffn_ms,
        combine_inter_ms=(ce / bw_e + me * topo.inter_lat) * 1e3,
        combine_intra_ms=(ci / bw_i + mi * topo.intra_lat) * 1e3,
        chunk_overhead_ms=chunk_overhead_ms)
    return PlanEstimate(
        intra_dispatch_bytes=hi, inter_dispatch_bytes=he,
        flat_intra_dispatch_bytes=fi, flat_inter_dispatch_bytes=fe,
        intra_combine_bytes=ci, inter_combine_bytes=ce,
        dispatch_ms=d_ms, combine_ms=c_ms,
        flat_dispatch_ms=phase_ms(fi, fe),
        ffn_ms=ffn_ms, sync_ms=sched_cost.sync_ms(topo, **kw),
        overlap_ms=t_pipe, chunks=n, dedup_overlap_ms=t_dedup)


# planning-cost model: the reference's modelled per-slot latencies of
# one migration-greedy iteration and of one signature revalidation
PLAN_STEP_US = 2.0
PLAN_DEVICE_US = 0.02
REVALIDATE_US = 1.0
REVALIDATE_PER_EL_US = 1e-3


def estimate_planning_ms(n_slots: int, M: int, *, q: int = 3,
                         step_us: float = PLAN_STEP_US) -> float:
    """Modelled wall time (ms) of one full migration replan over
    ``n_slots`` global slots and ``M`` devices: what plan reuse saves a
    revalidated sublayer."""
    return n_slots * (step_us + PLAN_DEVICE_US * M * max(1, q)) * 1e-3


def estimate_revalidate_ms(n_slots: int, M: int) -> float:
    """Modelled wall time (ms) of one routing-signature compare."""
    return (REVALIDATE_US + REVALIDATE_PER_EL_US * n_slots * (M + 1)) \
        * 1e-3


def replica_consistency_ms(n_replicas: int, d_model: int, d_ff: int, *,
                           topo: Topology,
                           bytes_per_el: int = 4) -> float:
    """Per-step price of keeping ``n_replicas`` intra-node expert
    replicas consistent: the forward fan-in of the owner's 3 FFN
    matrices plus the gradient reduce and broadcast, on the cheap
    links."""
    if topo is None or n_replicas <= 0:
        return 0.0
    w_bytes = 3.0 * float(d_model) * float(d_ff) * bytes_per_el
    return n_replicas * 3.0 * w_bytes / topo.intra_bw * 1e3


def estimate_similarity_ms(measured_pairs: float, d_model: int, *,
                           speed: float = 1e13) -> float:
    """Modelled wall time (ms) of one condensation similarity build:
    ``2·d`` multiply-adds per measured pair at ``speed``."""
    return measured_pairs * 4.0 * d_model / speed * 1e3
