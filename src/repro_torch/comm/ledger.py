"""The traced inter-node dispatch ledger (counterpart of
``repro/comm/ledger.py::dispatch_node_ledger``), for every rank at once.
"""
from __future__ import annotations

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
