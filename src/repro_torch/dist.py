"""How the batch maps onto expert-parallel ranks (counterpart of
``repro/dist.py``), for virtual ranks on one device.

The port's :class:`DistContext` carries what the MoE sublayer, the
serve engine and the train step read: the model-axis size ``M``, its
(node, local) split and the :class:`~repro_torch.comm.Topology`, and
whether the sequence is split over the model axis (``seq_sharded``, the
reference's ``seq_axis is not None``). The data axis is 1, as in
:mod:`repro_torch.launch.mesh`. Two layouts:

- batch-sharded (``seq_sharded=False``): rank ``r`` holds sequences
  ``[r * B/M, (r+1) * B/M)``, as the reference's train shapes shard the
  batch over every mesh axis;
- sequence-sharded (``seq_sharded=True``): rank ``r`` holds positions
  ``[r * S/M, (r+1) * S/M)`` of every sequence, its tokens row-major
  over (sequence, local position), as the reference's ``P(bax, sax)``
  specs place them (the prefill shape of a MoE arch, and the train shape
  when the batch does not split).

The reference's decode shape has no counterpart on virtual ranks, like
its sequence-parallel attention (``_attn_seqpar``). It puts the KV
cache's sequence dimension over the model axes (``cache_pspecs``), a
GSPMD layout of one value that changes no number beyond the order of a
sum, so the cache stays whole. Its MoE sublayers run by all-reduce
(``moe_decode_allreduce``): every rank gates every token and runs its
E/M experts on the copies routed to them, and the ranks' outputs are
summed. With a data axis of 1 the decode context is sequence-sharded,
so its batch divisor is 1 and a rank's capacity is the one-device
decode's; a rank packs its experts' copies in the order the one-device
decode packs them, and top-2 gives a token at most two nonzero rank
terms, so the sum is the one-device decode's value: bit for bit with
the experts on K1 (the reference's expert FFN there rounds at each
einsum, which moves its bf16 logits; ``tests/test_torch_ep_serve.py``).
The serve engine therefore decodes as on one device at any ``M``. Over
a data group larger than one the all-reduce decode runs its expert FFN
over an FSDP group (``expert_ffn_2d``), which needs a virtual data axis
(ROADMAP Queue 1 item 3d).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.topology import Topology

SHAPE_MODES = ("train", "prefill", "decode")


@dataclass(frozen=True)
class DistContext:
    model_size: int = 1
    topology: Optional[Topology] = None
    seq_sharded: bool = False

    @property
    def enabled(self) -> bool:
        return self.model_size > 1

    @property
    def nodes(self) -> int:
        return 1 if self.topology is None else self.topology.num_nodes

    @property
    def batch_size_divisor(self) -> int:
        """Ranks the batch splits over: M when it is batch-sharded, else
        1 (the reference's batch axes are the data axes, of size 1)."""
        return 1 if self.seq_sharded else self.model_size

    @property
    def token_divisor(self) -> int:
        """Ranks a batch's tokens split over: the batch's, times the
        model axis when the sequence is sharded (the reference's
        ``prefill_capacity`` and ``tokens_per_device``)."""
        return self.batch_size_divisor * (self.model_size if self.seq_sharded
                                          else 1)

    def comm(self, comm_mode: str) -> Optional[CommContext]:
        """The comm context of the MoE sublayers (None on one rank)."""
        if not self.enabled:
            return None
        return CommContext.build(comm_mode, self.model_size, self.topology)


def single_device() -> DistContext:
    return DistContext()


def make_dist(mesh, shape_mode: str, global_batch: int, *,
              moe_arch: bool, topology=None) -> DistContext:
    """The context of a virtual mesh
    (:func:`repro_torch.launch.mesh.make_host_mesh`) for one input
    shape, by the reference's rules:

    - ``train``: the batch over the model axis when it divides, else the
      sequence;
    - ``prefill``: the sequence over the model axis (for a dense arch
      whose batch divides, the batch);
    - ``decode``: the batch over the (size-1) data axis, the KV sequence
      over the model axis (see the module docstring: the serve engine's
      decode reads no context).

    ``topology``: the links to price (default the mesh's, at the planning
    defaults)."""
    from repro_torch.launch.mesh import topology_for_mesh
    if shape_mode not in SHAPE_MODES:
        raise ValueError(f"shape mode {shape_mode!r}: one of {SHAPE_MODES}")
    divides = global_batch % mesh.model == 0
    if shape_mode == "train":
        seq = not divides
    elif shape_mode == "prefill":
        seq = moe_arch or not divides
    else:
        seq = True
    return DistContext(mesh.model, topology or topology_for_mesh(mesh), seq)
