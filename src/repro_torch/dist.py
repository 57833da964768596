"""How the batch maps onto expert-parallel ranks (counterpart of
``repro/dist.py``), for virtual ranks on one device.

The port's :class:`DistContext` carries what the MoE sublayer and the
train step read: the model-axis size ``M``, its (node, local) split and
the :class:`~repro_torch.comm.Topology`. The data axis is 1: the batch
is split over the model axis, rank-major (rank ``r`` holds sequences
``[r * B/M, (r+1) * B/M)``), as the reference's train shapes shard it
over every mesh axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.topology import Topology


@dataclass(frozen=True)
class DistContext:
    model_size: int = 1
    topology: Optional[Topology] = None

    @property
    def enabled(self) -> bool:
        return self.model_size > 1

    @property
    def nodes(self) -> int:
        return 1 if self.topology is None else self.topology.num_nodes

    @property
    def batch_size_divisor(self) -> int:
        return self.model_size

    def comm(self, comm_mode: str) -> Optional[CommContext]:
        """The comm context of the MoE sublayers (None on one rank)."""
        if not self.enabled:
            return None
        return CommContext.build(comm_mode, self.model_size, self.topology)


def single_device() -> DistContext:
    return DistContext()


def make_dist(mesh, global_batch: int) -> DistContext:
    """The train-shape context of a virtual mesh
    (:func:`repro_torch.launch.mesh.make_host_mesh`): the batch over the
    model axis, which must divide it."""
    from repro_torch.launch.mesh import topology_for_mesh
    if global_batch % mesh.model:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"a model axis of {mesh.model}")
    return DistContext(mesh.model, topology_for_mesh(mesh))
