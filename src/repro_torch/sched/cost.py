"""Analytic overlap pricing of the chunked pipeline (counterpart of
``repro/sched/cost.py``): host floats, the same arithmetic in the same
order as the reference's, so the prices come out equal.

One MoE sublayer run as :mod:`repro_torch.sched.pipeline`'s schedule,
dispatch / expert FFN / combine totals ``D``, ``F``, ``Cm`` split into
``n`` chunks of a 3-stage linear pipeline:

    T(n) = d + f + c + (n - 1) * max(d, f, c)

with per-chunk ``d = D/n + o``, ``f = F/n``, ``c = Cm/n + o``, ``o`` the
per-chunk collective overhead (the topology's message latencies plus a
fixed issue cost). ``n = 1`` is the sync path. The dispatch and combine
times arrive wire-priced (:func:`repro_torch.plan.estimate.
estimate_exchange`). These are the reference's planning model; they
price no device this port runs on.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.comm.ledger import chunk_latency_s
from repro_torch.comm.topology import Topology

# fixed per-chunk collective issue cost (ms), the reference's constant
DEFAULT_CHUNK_OVERHEAD_MS = 0.05


def resolve_chunk_overhead_ms(value: float = None) -> float:
    """A configured per-chunk overhead: None or <= 0 means the built-in
    constant, a positive value wins."""
    if value is None or value <= 0.0:
        return DEFAULT_CHUNK_OVERHEAD_MS
    return float(value)


def overlap_ms(topo: Topology, chunks: int, *, dispatch_ms: float,
               ffn_ms: float, combine_ms: float = 0.0,
               chunk_overhead_ms: float = DEFAULT_CHUNK_OVERHEAD_MS
               ) -> float:
    """Modelled MoE-sublayer time (ms) pipelined over ``chunks`` chunks."""
    n = max(1, int(chunks))
    o = chunk_overhead_ms + chunk_latency_s(topo) * 1e3
    d = dispatch_ms / n + o
    f = ffn_ms / n
    c = combine_ms / n + (o if combine_ms > 0.0 else 0.0)
    return d + f + c + (n - 1) * max(d, f, c)


def dedup_overlap_ms(topo: Topology, chunks: int, *,
                     dispatch_inter_ms: float, dispatch_intra_ms: float,
                     ffn_ms: float, combine_inter_ms: float = 0.0,
                     combine_intra_ms: float = 0.0,
                     chunk_overhead_ms: float = DEFAULT_CHUNK_OVERHEAD_MS
                     ) -> float:
    """Modelled MoE-sublayer time (ms) of the pipelined dedup wire: a
    chunk's inter-node hop and the previous chunk's intra-node fan-out
    overlap, so a stage costs ``max(inter, intra)/n + o`` and the minor
    phase is paid once at the fill. ``n = 1`` is :func:`sync_ms` of the
    phase sums."""
    n = max(1, int(chunks))
    o = chunk_overhead_ms + chunk_latency_s(topo) * 1e3
    d = max(dispatch_inter_ms, dispatch_intra_ms) / n + o
    has_c = (combine_inter_ms + combine_intra_ms) > 0.0
    c = (max(combine_inter_ms, combine_intra_ms) / n + o) if has_c else 0.0
    f = ffn_ms / n
    fill = (min(dispatch_inter_ms, dispatch_intra_ms)
            + min(combine_inter_ms, combine_intra_ms)) / n
    return d + f + c + fill + (n - 1) * max(d, f, c)


def sync_ms(topo: Topology, *, dispatch_ms: float, ffn_ms: float,
            combine_ms: float = 0.0,
            chunk_overhead_ms: float = DEFAULT_CHUNK_OVERHEAD_MS) -> float:
    """The unpipelined baseline: :func:`overlap_ms` at one chunk."""
    return overlap_ms(topo, 1, dispatch_ms=dispatch_ms, ffn_ms=ffn_ms,
                      combine_ms=combine_ms,
                      chunk_overhead_ms=chunk_overhead_ms)


def optimal_chunks(topo: Topology, *, dispatch_ms: float, ffn_ms: float,
                   combine_ms: float = 0.0, max_chunks: int = 16,
                   chunk_overhead_ms: float = DEFAULT_CHUNK_OVERHEAD_MS
                   ) -> Tuple[int, float]:
    """(argmin chunk count, modelled ms) over ``1..max_chunks``; a tie
    goes to the smaller count."""
    best_n, best_t = 1, None
    for n in range(1, max(1, max_chunks) + 1):
        t = overlap_ms(topo, n, dispatch_ms=dispatch_ms, ffn_ms=ffn_ms,
                       combine_ms=combine_ms,
                       chunk_overhead_ms=chunk_overhead_ms)
        if best_t is None or t < best_t - 1e-12:
            best_n, best_t = n, t
    return best_n, best_t


def decode_combine_ms(tokens: int, d_model: int, topo: Topology, *,
                      bytes_per_el: int = 2) -> float:
    """Modelled decode MoE combine: one [tokens, d_model] ring all-reduce
    over the model axis on the topology's slowest link class, ``2(M-1)``
    steps of ``payload/M`` bytes plus a latency each."""
    M = topo.num_devices
    if M <= 1 or tokens <= 0:
        return 0.0
    payload = float(tokens) * d_model * bytes_per_el
    hier = topo.num_nodes > 1
    bw = topo.inter_bw if hier else topo.intra_bw
    lat = topo.inter_lat if hier else topo.intra_lat
    steps = 2 * (M - 1)
    return (steps / M * payload / bw + steps * lat) * 1e3


def decode_step_ms(*, combine_ms: float, shared_ffn_ms: float,
                   overlap: bool) -> float:
    """One decode MoE sublayer's exposed time: under ``decode_overlap``
    the longer of the combine and the shared-expert FFN, else their
    sum."""
    if overlap:
        return max(combine_ms, shared_ffn_ms)
    return combine_ms + shared_ffn_ms
