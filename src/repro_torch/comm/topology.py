"""The network topology the migration planner prices (counterpart of
``repro/comm/topology.py``).

Device order is node-major: global rank ``r = node * devices_per_node +
local``. The link rates below are the reference's planning defaults,
kept only as the planner's pricing inputs: what the planner reads is
their ratio, an inter-node byte costing ``bw_ratio`` = 4 intra-node
bytes, which makes the port's plans equal the reference's; the exchange
estimate (:mod:`repro_torch.plan.estimate`) prices the links with them
and the per-message latencies (0 by default, as the reference's). They
are not the rate of any device this port runs on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the reference's planning defaults (bytes/s per link), ratio 4
DEFAULT_INTRA_BW = 4.9e10
DEFAULT_INTER_BW = 1.225e10


@dataclasses.dataclass(frozen=True)
class Topology:
    """nodes x devices-per-node with a two-level link cost: bytes/s per
    link and seconds per message, within a node and across nodes."""
    num_nodes: int
    devices_per_node: int
    intra_bw: float = DEFAULT_INTRA_BW
    inter_bw: float = DEFAULT_INTER_BW
    intra_lat: float = 0.0
    inter_lat: float = 0.0

    def __post_init__(self):
        if self.num_nodes < 1 or self.devices_per_node < 1:
            raise ValueError(f"topology {self.num_nodes}x"
                             f"{self.devices_per_node}: sizes must be >= 1")
        if self.intra_bw <= 0 or self.inter_bw <= 0:
            raise ValueError("link rates must be positive")

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.devices_per_node

    @property
    def bw_ratio(self) -> float:
        """Cost of an inter-node byte relative to an intra-node byte."""
        return self.intra_bw / self.inter_bw

    @property
    def hierarchical(self) -> bool:
        return self.num_nodes > 1 and self.devices_per_node > 1

    def node_of(self, device):
        return device // self.devices_per_node

    def link_cost(self) -> np.ndarray:
        """[M, M] f64 relative per-byte cost: 0 on the diagonal, 1 within
        a node, ``bw_ratio`` across nodes."""
        dev = np.arange(self.num_devices)
        same = self.node_of(dev)[:, None] == self.node_of(dev)[None, :]
        cost = np.where(same, 1.0, float(self.bw_ratio))
        np.fill_diagonal(cost, 0.0)
        return cost.astype(np.float64)

    @classmethod
    def flat(cls, num_devices: int, bw: float = DEFAULT_INTRA_BW
             ) -> "Topology":
        """One node: every link the same cost."""
        return cls(num_nodes=1, devices_per_node=num_devices, intra_bw=bw,
                   inter_bw=bw)
