"""Chunk planning over the dispatch-capacity dimension (counterpart of
``repro/sched/plan.py``).

The dispatch buffer holds a static per-(source, expert) capacity ``C``,
a multiple of 8 (``core/moe_layer.py::capacity_for``). A
:class:`ChunkPlan` splits ``C`` into contiguous sub-capacities, each a
multiple of 8. Gating, dispatch positions and drops are decided before
the buffers are sliced, so a row lands in chunk ``j`` exactly when its
position falls in chunk ``j``'s window, and every chunk is non-empty.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

ALIGN = 8


class ChunkPlan(NamedTuple):
    """Contiguous partition of the capacity dimension."""
    capacity: int                 # total per-(source, expert) capacity
    sizes: Tuple[int, ...]        # per-chunk sub-capacities (8-aligned)

    @property
    def n_chunks(self) -> int:
        return len(self.sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)

    def slices(self) -> Tuple[Tuple[int, int], ...]:
        """(offset, size) pairs, in capacity order."""
        return tuple(zip(self.offsets, self.sizes))


def plan_chunks(capacity: int, n_chunks: int, *, align: int = ALIGN
                ) -> ChunkPlan:
    """Split ``capacity`` (a multiple of ``align``) into at most
    ``n_chunks`` aligned sub-capacities: the request is clipped so each
    chunk gets at least one unit of ``align``, the units spread as evenly
    as they go, the remainder on the leading chunks."""
    assert capacity >= align and capacity % align == 0, capacity
    units = capacity // align
    n = max(1, min(int(n_chunks), units))
    base, rem = divmod(units, n)
    sizes = tuple((base + (1 if i < rem else 0)) * align for i in range(n))
    return ChunkPlan(capacity, sizes)


def plan_unique_chunks(unique_capacity: int, n_chunks: int) -> ChunkPlan:
    """:class:`ChunkPlan` over the dedup wire's unique-row axis (``C_u``
    of ``condense/wire.py::dedup_capacity``, or the token axis of the
    migrate-mode combine). An unaligned total takes one chunk."""
    if unique_capacity < ALIGN or unique_capacity % ALIGN != 0:
        return ChunkPlan(unique_capacity, (unique_capacity,))
    return plan_chunks(unique_capacity, n_chunks)
