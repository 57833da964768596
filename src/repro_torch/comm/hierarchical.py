"""Expert-parallel collectives over virtual ranks (counterpart of
``repro/comm/hierarchical.py``).

One process holds the data of all ``M`` ranks of the expert-parallel
axis on one device. Every per-rank tensor is rank-major: its leading
axis is the rank, node-major (rank ``n * L + l`` is local rank ``l`` of
node ``n``). A :class:`CommContext` is the only place where ranks meet:
each collective is the exact permutation (or sum) the reference's
``jax.lax`` collective performs between the ranks' slices, so values
move bit for bit. The collectives' cost on one device is a copy in
device memory, not a network transfer.

- ``all_to_all`` / ``combine``: ``x [M, M*c, ...]``, chunk ``j`` of rank
  ``i`` lands as chunk ``i`` of rank ``j``. ``flat`` does it as one
  transpose; ``hier`` as the reference's two phases on the ``(N, L)``
  split (within each node over the local rank, then across nodes), which
  compose to the same permutation, so flat and hier agree bit for bit.
- ``node_all_to_all``: ``x [M, N*c, ...]``, across nodes only;
  ``local_all_to_all``: ``x [M, L*c, ...]``, within each node only.
- ``local_all_gather``: ``x [M, a, ...]`` -> ``[M, L*a, ...]``, the
  node's ranks' slices in local-rank order (``local_all_gather_t``, its
  transpose, for the wire's hand-written backward).
- ``local_psum_scatter``: ``x [M, L*c, ...]`` -> ``[M, c, ...]``, the
  sum over the node's ranks of their chunk ``l``, added in ascending
  local rank (exact in any order for two ranks).
- ``psum`` / ``pmean``: over the rank axis, added in ascending rank.
  (The reference all-gathers the planner's inputs; here they are the
  rank-major tensors themselves, read once on the host.)

Every one of these permutations is its own transpose, which is what the
wire's gradient (``repro_torch.condense.wire``) relies on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm.topology import Topology

MODES = ("local", "flat", "hier")


class CommContext(NamedTuple):
    """How the MoE layer runs its collectives over ``size`` ranks.

    ``mode`` is ``"local"`` (one rank, identity collectives), ``"flat"``
    or ``"hier"`` (two-phase over ``nodes`` x ``size // nodes``);
    ``topology`` prices the links (None: uniform)."""
    mode: str
    ranks: int = 1
    nodes: int = 1
    topology: Optional[Topology] = None

    @classmethod
    def build(cls, mode: str, ranks: int,
              topology: Optional[Topology] = None) -> "CommContext":
        if mode not in ("flat", "hier"):
            raise ValueError(f"unknown comm_mode {mode!r}")
        nodes = 1 if topology is None else topology.num_nodes
        if topology is not None and topology.num_devices != ranks:
            raise ValueError(f"topology of {topology.num_devices} ranks "
                             f"for a model axis of {ranks}")
        if mode == "hier" and not (nodes > 1 and ranks // nodes > 1):
            raise ValueError(
                f"comm_mode='hier' needs a (node, local) split with both "
                f"sizes > 1, got {nodes} nodes of {ranks} ranks; pass "
                f"--nodes")
        return cls(mode, ranks, nodes, topology)

    @classmethod
    def local(cls, topology: Optional[Topology] = None) -> "CommContext":
        return cls("local", 1, 1, topology)

    # -- axis arithmetic ----------------------------------------------------
    def size(self) -> int:
        return self.ranks

    @property
    def local_size(self) -> int:
        return self.ranks // self.nodes

    def index(self, device=None) -> torch.Tensor:
        """[M] every rank's global index."""
        return torch.arange(self.ranks, device=device)

    def link_cost(self):
        """[M, M] f64 link cost for the planner, or None when uniform."""
        if self.topology is None or not self.topology.hierarchical:
            return None
        return self.topology.link_cost()

    # -- collectives --------------------------------------------------------
    def _check(self, x, chunks: int):
        if x.shape[0] != self.ranks or x.shape[1] % chunks:
            raise ValueError(f"{self.mode} collective over {self.ranks} "
                             f"ranks: dims 0-1 of {tuple(x.shape)} must be "
                             f"[{self.ranks}, a multiple of {chunks}]")

    def all_to_all(self, x):
        """Dispatch-layout exchange, dim 1 = one chunk per rank."""
        if self.mode == "local":
            return x
        M, N, L = self.ranks, self.nodes, self.local_size
        self._check(x, M)
        rest = x.shape[2:]
        c = x.shape[1] // M
        if self.mode == "flat":
            y = x.reshape(M, M, c, *rest).transpose(0, 1)
            return y.reshape(x.shape)
        # rank (n, l) holds chunks (n_d, l_d): phase 1 within each node
        # over the local rank, phase 2 across nodes
        b = x.reshape(N, L, N, L, c, *rest)
        b = b.transpose(1, 3)                          # local phase
        b = b.transpose(0, 2)                          # node phase
        return b.reshape(x.shape)

    def combine(self, x):
        """Combine-layout exchange: the same permutation."""
        return self.all_to_all(x)

    def node_all_to_all(self, x):
        """Across nodes only, dim 1 = one chunk per node."""
        self._require_hier()
        N, L = self.nodes, self.local_size
        self._check(x, N)
        c = x.shape[1] // N
        b = x.reshape(N, L, N, c, *x.shape[2:]).transpose(0, 2)
        return b.reshape(x.shape)

    def local_all_to_all(self, x):
        """Within each node only, dim 1 = one chunk per local rank: the
        first phase of the hier :meth:`all_to_all`."""
        self._require_hier()
        N, L = self.nodes, self.local_size
        self._check(x, L)
        c = x.shape[1] // L
        b = x.reshape(N, L, L, c, *x.shape[2:]).transpose(1, 2)
        return b.reshape(x.shape)

    def local_all_gather(self, x):
        """Each rank gets its node's ranks' x, in local-rank order."""
        self._require_hier()
        N, L = self.nodes, self.local_size
        a = x.shape[1]
        b = x.reshape(N, 1, L * a, *x.shape[2:])
        return b.expand(N, L, L * a, *x.shape[2:]).reshape(
            N * L, L * a, *x.shape[2:])

    def local_all_gather_t(self, g):
        """The transpose of :meth:`local_all_gather`: each rank's slice
        is the sum of its copies over the node's ranks, summed as
        autograd's expand backward sums them."""
        self._require_hier()
        N, L = self.nodes, self.local_size
        a = g.shape[1] // L
        return g.reshape(N, L, L * a, *g.shape[2:]).sum(
            dim=1, keepdim=True).reshape(N * L, a, *g.shape[2:])

    def local_psum_scatter(self, x):
        """Sum over the node's ranks, each keeping its own chunk."""
        self._require_hier()
        N, L = self.nodes, self.local_size
        self._check(x, L)
        c = x.shape[1] // L
        b = x.reshape(N, L, L, c, *x.shape[2:])
        acc = b[:, 0]
        for l in range(1, L):
            acc = acc + b[:, l]
        return acc.reshape(N * L, c, *x.shape[2:])

    def psum(self, x):
        """Sum over the rank axis (dim 0), in ascending rank."""
        acc = x[0]
        for r in range(1, x.shape[0]):
            acc = acc + x[r]
        return acc

    def pmean(self, x):
        return self.psum(x) / x.shape[0]

    def _require_hier(self):
        if self.mode != "hier":
            raise ValueError(f"a single-phase collective needs "
                             f"comm_mode='hier', not {self.mode!r}")
