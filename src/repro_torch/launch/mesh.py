"""The virtual mesh of the expert-parallel ranks (counterpart of
``repro/launch/mesh.py``: ``make_host_mesh`` and ``topology_for_mesh``).

One process holds every rank, so a mesh here is its layout: ``data`` is
1, ``model`` ranks, split into ``nodes`` nodes of ``model // nodes``
local ranks when ``nodes > 1`` (node-major, as the reference's
``("data", "node", "local")`` host mesh). The topology prices links
with the reference's planning defaults (``repro_torch.comm.topology``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from repro_torch.comm.topology import DEFAULT_INTER_BW, Topology


class VirtualMesh(NamedTuple):
    model: int
    nodes: int = 0

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "node", "local") if self.nodes > 1 \
            else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.nodes > 1:
            return (1, self.nodes, self.model // self.nodes)
        return (1, self.model)


def make_host_mesh(model: int = 4, nodes: int = 0) -> VirtualMesh:
    """``model`` virtual ranks; ``nodes > 1`` splits them (node, local)."""
    if model < 1:
        raise ValueError(f"model axis {model} must be >= 1")
    if nodes > 1 and model % nodes:
        raise ValueError(f"--nodes {nodes} must divide the model axis "
                         f"{model}")
    return VirtualMesh(model, nodes)


def topology_for_mesh(mesh: VirtualMesh, *, inter_bw=None) -> Topology:
    """The mesh's topology; ``inter_bw`` (bytes/s) overrides the cross-node
    link's planning rate, as the reference's ``--inter-bw``."""
    return Topology.from_layout(mesh.model, mesh.nodes,
                                inter_bw=inter_bw or DEFAULT_INTER_BW)
