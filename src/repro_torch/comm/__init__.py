"""Where bytes go between expert-parallel ranks and what they cost
(counterpart of ``repro/comm``): the :class:`Topology`, the
:class:`CommContext` over virtual ranks, the wire codec and the traffic
ledger with its analytic pricing."""
from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.ledger import dispatch_node_ledger
from repro_torch.comm.topology import Topology

__all__ = ["CommContext", "Topology", "dispatch_node_ledger"]
