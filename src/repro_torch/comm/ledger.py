"""The traffic ledger (counterpart of ``repro/comm/ledger.py``): the
traced inter-node dispatch ledger, for every rank at once
(:func:`dispatch_node_ledger`), and the analytic pricing under uniform
routing that the exchange estimate reads (:func:`expected_dedup_factor`,
:func:`dispatch_bytes`, :func:`a2a_time_s`, :func:`phase_messages`,
:func:`chunk_latency_s`; host floats, the reference's arithmetic).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.topology import Topology


def dispatch_node_ledger(expert_idx, valid, ranks, *, e_local: int,
                         topo: Topology, row_bytes: float):
    """Per-rank inter-node dispatch bytes, flat against node-deduplicated.

    expert_idx, valid: [M, T, k] global expert ids and the rows that take
    a dispatch slot on each rank; ranks: [M] the ranks' global indices
    (node-major). Returns ``(flat [M], dedup [M])`` f32: flat counts
    every valid row bound for another node, dedup the distinct (token,
    remote node) pairs, each times ``row_bytes``."""
    L, N = topo.devices_per_node, topo.num_nodes
    node_of = (expert_idx // e_local) // L                    # [M, T, k]
    my_node = (ranks // L)[:, None, None]
    vf = valid.float()
    remote = (node_of != my_node) & valid
    flat_rows = remote.float().sum(dim=(1, 2))
    oh = F.one_hot(node_of, N).float() * vf[..., None]        # [M,T,k,N]
    present = oh.sum(dim=2) > 0                               # [M, T, N]
    not_mine = torch.arange(N, device=ranks.device)[None, :] \
        != (ranks // L)[:, None]                              # [M, N]
    dedup_rows = (present & not_mine[:, None, :]).float().sum(dim=(1, 2))
    return flat_rows * row_bytes, dedup_rows * row_bytes


def expected_dedup_factor(top_k: int, topo: Topology) -> float:
    """Deduplicated over flat inter-node payloads per token under uniform
    routing of ``top_k`` independent draws: flat pays k (N-1)/N remote
    copies, dedup (N-1)(1 - (1 - 1/N)^k) distinct remote nodes; 1.0 at
    k = 1 or one node."""
    N = topo.num_nodes
    if N <= 1 or top_k <= 1:
        return 1.0
    flat = top_k * (N - 1) / N
    dedup = (N - 1) * (1.0 - (1.0 - 1.0 / N) ** top_k)
    return dedup / flat


def dispatch_bytes(tokens: int, top_k: int, d_model: int, *,
                   topo: Topology, r_cond: float = 0.0,
                   bytes_per_el: int = 4, num_layers: int = 1,
                   dedup: bool = False) -> Tuple[float, float]:
    """(intra_bytes, inter_bytes) of one dispatch pass over all devices,
    uniform routing, ``r_cond`` of the tokens condensed away. With
    ``dedup`` the inter-node part is scaled by
    :func:`expected_dedup_factor` and every copy moves once on the cheap
    links (the fan-out)."""
    M = topo.num_devices
    L = topo.devices_per_node
    payload = tokens * (1.0 - r_cond) * top_k * d_model * bytes_per_el \
        * num_layers
    intra = payload * (L - 1) / M
    inter = payload * (M - L) / M
    if dedup:
        inter *= expected_dedup_factor(top_k, topo)
        intra = payload * (1.0 - 1.0 / M)
    return intra, inter


def a2a_time_s(intra_bytes: float, inter_bytes: float,
               topo: Topology, *, messages_intra: int = 0,
               messages_inter: int = 0) -> float:
    """Bandwidth-latency time of one collective phase pair."""
    return (intra_bytes / topo.intra_bw + inter_bytes / topo.inter_bw
            + messages_intra * topo.intra_lat
            + messages_inter * topo.inter_lat)


def phase_messages(topo: Topology) -> Tuple[int, int]:
    """(intra, inter) messages one device sends per two-phase exchange:
    the latency term every capacity chunk pays again."""
    return max(0, topo.devices_per_node - 1), max(0, topo.num_nodes - 1)


def chunk_latency_s(topo: Topology) -> float:
    """The latency one chunked collective pays on top of its bandwidth
    time: the per-message latencies of both phases."""
    mi, me = phase_messages(topo)
    return mi * topo.intra_lat + me * topo.inter_lat
