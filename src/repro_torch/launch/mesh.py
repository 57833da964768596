"""The virtual mesh of the expert-parallel ranks (counterpart of
``repro/launch/mesh.py``: ``make_host_mesh``, ``make_production_mesh``
as a layout, ``topology_for_mesh`` and the roofline's peak).

One process holds every rank, so a mesh here is its layout: ``data`` is
1, ``model`` ranks, split into ``nodes`` nodes of ``model // nodes``
local ranks when ``nodes > 1`` (node-major, as the reference's
``("data", "node", "local")`` host mesh). The topology prices links
with the reference's planning defaults (``repro_torch.comm.topology``).
A mesh object answers what the dry-run ledger reads of a JAX mesh:
``axis_names`` and ``devices.shape`` / ``devices.size``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

from repro_torch.comm.topology import (DEFAULT_INTER_BW, DEFAULT_INTRA_BW,
                                       Topology)

# The roofline's FFN rate: the H100 SXM's dense bf16 tensor-core peak
# (NVIDIA data sheet), the rate the kernel table in PERF.md bounds K1
# with; the port is measured on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s


class DeviceGrid(NamedTuple):
    """The ``devices`` of a layout: its shape and size, no devices."""
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


class MeshLayout(NamedTuple):
    """Named axes and their sizes, with no device behind them."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def devices(self) -> DeviceGrid:
        return DeviceGrid(self.shape)


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

    @property
    def devices(self) -> DeviceGrid:
        return DeviceGrid(self.shape)


def make_host_mesh(model: int = 4, nodes: int = 0) -> VirtualMesh:
    """``model`` virtual ranks; ``nodes > 1`` splits them (node, local)."""
    if model < 1:
        raise ValueError(f"model axis {model} must be >= 1")
    if nodes > 1 and model % nodes:
        raise ValueError(f"--nodes {nodes} must divide the model axis "
                         f"{model}")
    return VirtualMesh(model, nodes)


def production_layout(*, multi_pod: bool = False,
                      nodes: int = 0) -> MeshLayout:
    """The layout of the reference's ``make_production_mesh``: a 16 x 16
    pod (2 x 16 x 16 multi-pod); ``nodes > 1`` splits the model axis
    into a (node, local) hierarchy of that many nodes."""
    if nodes > 1:
        model = 16
        if model % nodes:
            raise ValueError(f"--nodes {nodes} must divide the model axis "
                             f"{model}")
        shape = (2, 16, nodes, model // nodes) if multi_pod \
            else (16, nodes, model // nodes)
        axes = ("pod", "data", "node", "local") if multi_pod \
            else ("data", "node", "local")
        return MeshLayout(axes, shape)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshLayout(axes, shape)


def topology_for_mesh(mesh, *, inter_bw=None) -> Topology:
    """The mesh's topology (the reference's ``Topology.from_mesh``):
    (node, local) when the axes name them, else flat over ``model``;
    ``inter_bw`` (bytes/s) overrides the cross-node link's planning rate,
    as the reference's ``--inter-bw``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if "node" in sizes and "local" in sizes:
        return Topology(sizes["node"], sizes["local"],
                        intra_bw=DEFAULT_INTRA_BW,
                        inter_bw=inter_bw or DEFAULT_INTER_BW)
    return Topology.flat(sizes.get("model", mesh.devices.size))


def model_axes_of(axis_names: Tuple[str, ...]):
    """The expert-parallel axis spelling: ``"model"`` on a flat mesh,
    ``("node", "local")`` on a hierarchical one, None if neither."""
    if "node" in axis_names and "local" in axis_names:
        return ("node", "local")
    if "model" in axis_names:
        return "model"
    return None
