"""Plan/execute split for the MoE exchange (counterpart of
``repro/plan/exchange.py``).

:func:`build_exchange_plan` decides everything about one exchange from
the router output: the condensation map (§V), dispatch slots and
capacity drops, the wire format, the inter-node ledger and, across
ranks, the migration plan (§IV). :func:`execute_plan` moves the bytes
the plan prescribes: dispatch, the expert FFN, combine and un-condense.

Every tensor is rank-major with a leading axis over the ``M``
expert-parallel ranks of the comm context
(:mod:`repro_torch.comm.hierarchical`); the ranks' per-rank work runs
vectorised, and the collectives of the comm context are the only place
ranks meet. One device is the case ``M = 1`` under a ``"local"``
context: its collectives are the identity, nothing crosses a wire and
migration is the identity, as in the reference. Across ranks the dense
wire runs flat or two-phase (the combine regrouped to the sequences' new
homes under migration, with its ``combine_slack`` drop path), or the
deduplicated hier wire (:mod:`repro_torch.condense.wire`), each at
``wire_dtype``. Modes ``vanilla``, ``decode`` and ``migrate``.

Schedule (``LuffyConfig.exec_mode``, :func:`plan_static_schedule`):
"sync", or across ranks "pipeline", which splits the dispatch capacity
into 8-aligned chunks (``pipeline_chunks``, or the exchange estimate's
search when it is <= 0) and runs :mod:`repro_torch.sched`'s pipeline:
on the dense wire each chunk's dispatch and (vanilla) combine on a side
CUDA stream against the previous chunk's expert FFN on the current one;
on the dedup wire the node hop chunked over the unique rows. The
forward is the sync path's bit for bit.

Plan reuse (``LuffyConfig.plan_reuse``): a :class:`PlanSignature`, the
planner inputs a plan expects at the next exchange, threads through the
layer stack; under "signature" a sublayer whose counts and lengths equal
the carried ones skips the greedy and emits the keep-home plan (what the
greedy would return), under "always" a valid carry is trusted. The
planner's inputs are on the host already, so the signature is numpy and
reuse adds no device sync. Reuse revalidates only under the "traffic"
objective; under "overlap" and "replicate" the emitted signature never
validates (the reference's rule). Wire error feedback carries each
token's quantization residual from one step's payload into the next's
(:func:`execute_plan`).

Replica lanes (the "replicate" objective, migrate mode across ranks on
the dense wire of a hierarchical topology with more than one rank a
node): the builder places each node's hottest expert on an intra-node
peer's spare dispatch lane when the model says it pays
(:func:`~repro_torch.plan.objectives.plan_expert_replicas`, on the
device), and the first overflow copies of a replicated expert (``C <=
pos < 2C``) take the host rank's lane at slot ``pos - C`` instead of
being dropped. Each rank then runs ``E_local + 1`` rows of experts; K1
takes the lanes' weights through its group map, so no stack is
concatenated or cast per step.

Serving templates: :func:`instantiate_plan` / :func:`instantiate_decode_plan`
bind a request's routing onto a cached static template
(:mod:`repro_torch.plan.cache`) without planning.

Tracing (:mod:`repro_torch.obs.trace`): the builder's ``condense`` and
the executor's ``dispatch_pack``, ``dispatch``, ``expert_ffn``,
``combine`` (sync) or ``pipeline_exchange`` (the pipelined dense wire)
phases, with the reference's names, nesting and fenced values.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.comm import dtypes as wdt
from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.ledger import dispatch_node_ledger
from repro_torch.condense import wire as cwire
from repro_torch.condense.plan import (CondenseCarry, CondensePlan,
                                       build_condense_plan,
                                       identity_condense_plan, uncondense)
from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.core import migration as mig
from repro_torch.core.gating import GateOutput, dispatch_positions
from repro_torch.kernels import ops as kops
from repro_torch.plan import objectives
from repro_torch.plan.estimate import PlanEstimate, estimate_exchange
from repro_torch.sched import ChunkPlan, plan_chunks, plan_unique_chunks
from repro_torch.sched.cost import resolve_chunk_overhead_ms
from repro_torch.obs import trace as obs_trace
from repro_torch.sched.pipeline import run_pipeline, share, side_stream

MODES = ("vanilla", "migrate", "decode")
# build_exchange_plan calls (the serving cache's zero-planning guarantee
# is held against this count)
BUILD_CALLS = 0
# the chunk count when pipeline_chunks <= 0 and no topology prices the
# exchange (the reference's)
DEFAULT_PIPELINE_CHUNKS = 4


class MoEAux(NamedTuple):
    """The reference's per-sublayer ledger, field for field ([M], per
    rank, until the layer averages them)."""
    aux_loss: torch.Tensor        # router load-balance loss
    dispatch_drop: torch.Tensor   # fraction of kept rows dropped
    combine_drop: torch.Tensor    # fraction dropped at the combine regroup
    condense_rate: torch.Tensor   # fraction of tokens condensed
    local_frac: torch.Tensor      # fraction of combine rows staying home
    traffic_before: torch.Tensor  # link-cost-weighted combine rows
    traffic_after: torch.Tensor   # without / with migration
    inter_bytes_flat: torch.Tensor   # dispatch bytes a flat a2a ships
    inter_bytes_dedup: torch.Tensor  # ... after per-node dedup
    plans_built: torch.Tensor     # 1 when the migration planner ran
    plans_reused: torch.Tensor    # 1 when a carried plan was reused
    reuse_mismatch: torch.Tensor  # 1 when a valid carry failed to match
    measured_pairs: torch.Tensor  # pairs the similarity measured
    condense_built: torch.Tensor  # 1 when the similarity build ran
    condense_reused: torch.Tensor  # 1 when a carried map was reused
    inter_bytes_shipped: torch.Tensor  # bytes the dedup wire shipped


class PlanSignature(NamedTuple):
    """What a carried plan revalidates against: the migration planner's
    inputs expected at the next exchange, the per-(global slot, rank)
    expert counts and the sequence lengths, rows in the post-migration
    slot order (:func:`next_signature`). The greedy is deterministic in
    them, so observed == expected means a replan would keep every
    sequence home. ``valid`` > 0.5 once a plan was built. Host numpy."""
    counts: np.ndarray            # [n_slots, M] f32
    lens: np.ndarray              # [n_slots] f32
    valid: np.float32             # [] 1 once a plan has been built


def routing_signature_matches(sig: PlanSignature, counts, lens) -> bool:
    """Observed planner inputs == expected, and the carry is valid."""
    if (tuple(sig.counts.shape) != tuple(np.shape(counts))
            or tuple(sig.lens.shape) != tuple(np.shape(lens))):
        return False
    return bool(sig.valid > 0.5 and np.all(sig.counts == counts)
                and np.all(sig.lens == lens))


def next_signature(counts, lens, perm) -> PlanSignature:
    """The planner inputs expected after executing a plan with ``perm``:
    slot ``perm[i]`` next holds the sequence whose counts and length sit
    in row ``i`` today."""
    n = counts.shape[0]
    inv = np.zeros(n, np.int32)
    inv[np.asarray(perm)] = np.arange(n, dtype=np.int32)
    return PlanSignature(counts[inv], lens[inv], np.float32(1.0))


def invalid_signature(n_slots: int, M: int) -> PlanSignature:
    """The 'no carried plan' signature, of the shape a plan's would have."""
    return PlanSignature(np.zeros((n_slots, M), np.float32),
                         np.zeros((n_slots,), np.float32), np.float32(0.0))


class ExchangePlan(NamedTuple):
    """Every decision about one exchange, as data ([M, T, ...])."""
    condense: bool                # condensation active this call
    capacity: int                 # per-(source, expert) dispatch capacity
    group_size: int               # condensation group G
    expert_idx: torch.Tensor      # [M, T, k] global expert ids
    gate_weights: torch.Tensor    # [M, T, k] combine weights
    positions: torch.Tensor       # [M, T, k] dispatch buffer positions
    valid: torch.Tensor           # [M, T, k] row takes a dispatch slot
    aux_loss: torch.Tensor        # [M]
    dispatch_drop: torch.Tensor   # [M]
    condense_plan: CondensePlan
    comm: CommContext
    mode: str
    migrate: bool                 # migrate mode with M > 1
    wire: str                     # "dense" | "dedup"
    wire_dtype: str               # what crosses the wire when M > 1
    combine_slack: float
    perm: Optional[np.ndarray]    # [M*n_seq] new global slot (migrate)
    dest_global: Optional[torch.Tensor]   # [M, n_seq] (migrate)
    traffic_before: torch.Tensor  # [M]
    traffic_after: torch.Tensor
    inter_bytes_flat: torch.Tensor   # [M]
    inter_bytes_dedup: torch.Tensor
    signature: Optional[PlanSignature] = None  # the carry to thread on
    plans_built: float = 0.0      # the greedy ran
    plans_reused: float = 0.0     # a carried plan was reused
    reuse_mismatch: float = 0.0   # a valid carry failed revalidation
    pipelined: bool = False       # the chunked pipeline, not sync
    chunks: Optional[ChunkPlan] = None     # capacity partition
    estimate: Optional[PlanEstimate] = None  # None unless priced (M > 1)
    objective: str = "traffic"    # the planner objective that made it
    # replica lanes ("replicate"): the global expert each rank's lane
    # serves (-1 idle), [M] int32 on the device, and the copies redirected
    # to a lane, [M, T, k]; None without lanes
    replica_src: Optional[torch.Tensor] = None
    replica_valid: Optional[torch.Tensor] = None
    # the reference's kernel flag, carried through the plan format (the
    # port's kernels follow the tensors' device)
    use_kernel: bool = False


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    v = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(v + eps) * scale.float()


def expert_ffn(ew, h, act_name: str, w_idx=None):
    """h: [G, R, d] normed inputs -> [G, R, d], in h's dtype; group g
    reads expert ``w_idx[g]`` of the stack (None: expert g; -1: none, a
    zero output). The reference's kernel path (``use_kernel=True``): the
    f32-math kernel K1 gets the rows and the f32 weights as they are."""
    return kops.expert_ffn(h, ew["w_up"], ew["w_gate"], ew["w_down"],
                           act_name, w_idx)


def _check_whole_stack(params, cfg: ModelConfig):
    e_held = params["experts"]["w_up"].shape[0]
    if e_held != cfg.moe.num_experts:
        raise ValueError(
            f"the MoE layer needs the whole expert stack, got {e_held} of "
            f"{cfg.moe.num_experts} experts; expert parallelism runs it "
            f"over virtual ranks, rank r reading its experts from the "
            f"stack (comm_mode 'flat' or 'hier' with model axis > 1)")


def check_ported(luffy: LuffyConfig):
    """Raise on an option value the port does not know."""
    objectives.get_objective(luffy.plan_objective)
    if luffy.exec_mode not in ("sync", "decode_overlap", "pipeline"):
        raise ValueError(f"unknown exec_mode {luffy.exec_mode!r}")
    if luffy.plan_reuse not in ("off", "signature", "always"):
        raise ValueError(f"unknown plan_reuse {luffy.plan_reuse!r}")


def plan_static_schedule(cfg: ModelConfig, luffy: LuffyConfig, topo, M: int,
                         T: int, d: int, capacity: int, bytes_per_el: int,
                         wire_dtype: str = "f32"
                         ) -> Tuple[bool, ChunkPlan, Optional[PlanEstimate]]:
    """The exchange's token-independent schedule: pipelined or not, the
    :class:`ChunkPlan` and the :class:`PlanEstimate` (None when nothing
    prices it). Pipelined only under ``exec_mode="pipeline"`` at M > 1.
    ``luffy.pipeline_chunks <= 0`` takes the estimate's 1..16 search
    when the topology prices the exchange, else
    :data:`DEFAULT_PIPELINE_CHUNKS`; a positive value is the request,
    clipped by :func:`~repro_torch.sched.plan_chunks`. T is a rank's
    tokens."""
    m = cfg.moe
    pipelined = luffy.exec_mode == "pipeline" and M > 1
    priced = topo is not None and M > 1
    ffn_ms = 0.0
    if priced:
        # the reference's convention: 4·d·d_ff flops a row (the up and
        # down products) over every static row at luffy.gpu_speed
        ffn_rows = m.num_experts * capacity
        ffn_ms = ffn_rows * 4.0 * d * m.d_ff / luffy.gpu_speed * 1e3
    o_ms = resolve_chunk_overhead_ms(luffy.chunk_overhead_ms)
    req = luffy.pipeline_chunks if pipelined else 1
    if pipelined and req <= 0:
        if priced:
            req = estimate_exchange(T, m.top_k, d, topo=topo,
                                    bytes_per_el=bytes_per_el,
                                    ffn_ms=ffn_ms, chunks=None,
                                    chunk_overhead_ms=o_ms,
                                    wire_dtype=wire_dtype).chunks
        else:
            req = DEFAULT_PIPELINE_CHUNKS
    chunks = plan_chunks(capacity, req)
    est = None
    if priced:
        est = estimate_exchange(T, m.top_k, d, topo=topo,
                                bytes_per_el=bytes_per_el, ffn_ms=ffn_ms,
                                chunks=chunks.n_chunks,
                                chunk_overhead_ms=o_ms,
                                wire_dtype=wire_dtype)
    return pipelined, chunks, est


def schedule_of(cfg: ModelConfig, luffy: LuffyConfig,
                comm: Optional[CommContext], tokens: int, capacity: int
                ) -> Tuple[bool, ChunkPlan, Optional[PlanEstimate]]:
    """:func:`plan_static_schedule` of an exchange of a rank's ``tokens``
    over ``comm`` (None: one device) at the compute dtype and wire of
    ``cfg`` and ``luffy``."""
    from repro_torch.models.blocks import _dtype
    comm = CommContext.local() if comm is None else comm
    return plan_static_schedule(
        cfg, luffy, comm.topology, comm.size(), tokens, cfg.d_model,
        capacity, torch.finfo(_dtype(cfg.compute_dtype)).bits // 8,
        wdt.validate_wire_dtype(luffy.wire_dtype))


def _scatter_rows(n_slots: int, slot, valid, *rows):
    """One zero [n_slots, ...] buffer per tensor of ``rows``, with
    ``rows[i]`` at ``slot[i]`` where ``valid[i]``; every valid slot is
    written once, the rest go to a trash row that is dropped."""
    idx = torch.where(valid, slot, torch.full_like(slot, n_slots))
    return [torch.zeros((n_slots + 1, *r.shape[1:]), dtype=r.dtype,
                        device=r.device).index_copy(0, idx, r)[:n_slots]
            for r in rows]


def build_exchange_plan(gate: GateOutput, xn, cfg: ModelConfig,
                        luffy: LuffyConfig, *, mode: str, capacity: int,
                        sideband: Dict[str, torch.Tensor], threshold=None,
                        s_prev: Optional[torch.Tensor] = None,
                        condense_carry: Optional[CondenseCarry] = None,
                        comm: Optional[CommContext] = None,
                        reuse_from: Optional[Union["ExchangePlan",
                                                   PlanSignature]] = None
                        ) -> ExchangePlan:
    """Decide one exchange for every rank of ``comm`` (None: one device,
    a local context).

    gate: router output over ``xn [M, T, d]`` (rank r's tokens, T =
    n_seq * S); sideband ``seq_len [M, n_seq]``. Condensation runs when
    ``luffy.enable_condensation`` and the mode is not ``decode``; it
    needs ``threshold`` (an f32 scalar tensor) and takes the carried
    similarity ``s_prev`` of every rank's groups, rank-major, when given.
    Condensed tokens take no dispatch slot. With ``M > 1`` the migration
    plan is Algorithm 1 under the "traffic" objective over the M * n_seq
    global slots, priced by the topology's link cost; it runs on the host
    (:mod:`repro_torch.core.migration`), so the per-(slot, rank) expert
    counts and the lengths are copied off the device once per sublayer.
    No payload moves here.

    reuse_from: a plan (or its :class:`PlanSignature`) of an earlier
    sublayer of the same forward. Under ``luffy.plan_reuse="signature"``
    a valid carry whose counts and lengths equal the observed ones skips
    the greedy and emits the keep-home plan, which is what the greedy
    would return; a valid carry that does not match is rebuilt and
    counted in ``reuse_mismatch``. "always" trusts a valid carry. Reuse
    engages only under the "traffic" objective, and the emitted
    signature's valid flag is 0 under "off", so such a carry never
    revalidates. The signature needs the host copies the planner already
    makes, so reuse adds no device sync."""
    global BUILD_CALLS
    BUILD_CALLS += 1
    from repro_torch.models.blocks import _dtype
    if mode not in MODES:
        raise ValueError(f"exchange mode {mode!r}: one of {MODES}")
    check_ported(luffy)
    comm = CommContext.local() if comm is None else comm
    if xn.shape[0] != comm.size():
        raise ValueError(f"{comm.mode} exchange over {comm.size()} ranks "
                         f"got tokens {tuple(xn.shape)}")
    m = cfg.moe
    M, T, d = xn.shape
    n_seq = sideband["seq_len"].shape[1]
    S = T // n_seq
    E, k, C = m.num_experts, m.top_k, capacity
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} ranks")
    E_local = E // M
    G = luffy.condense_group
    dev = xn.device
    cdt = _dtype(cfg.compute_dtype)
    expert_idx, gate_w = gate.expert_idx, gate.gate_weights   # [M, T, k]

    keep = _token_keep(sideband["seq_len"], S, k)

    do_condense = luffy.enable_condensation and mode != "decode"
    if do_condense:
        if threshold is None:
            raise ValueError("condensation needs a threshold")
        with obs_trace.phase("condense") as sp:
            cp = build_condense_plan(
                xn.reshape(M * T, d), expert_idx[..., 0].reshape(M * T),
                threshold, group_size=G,
                s_prev=None if s_prev is None else s_prev.reshape(-1, G, G),
                s1=luffy.s1, s2=luffy.s2, backend=luffy.similarity_backend,
                lsh_bits=luffy.lsh_bits, lsh_seed=luffy.lsh_seed,
                reuse_mode=luffy.condense_reuse,
                max_age=luffy.condense_reuse_max_age, carry=condense_carry,
                ranks=M)
            cp = sp.fence(cp)
        keep = keep & cp.is_rep.reshape(M, T)[..., None]
    else:
        cp = identity_condense_plan(M * T, luffy.similarity_backend,
                                    device=dev, ranks=M)

    pos = dispatch_positions(expert_idx, keep, E)
    valid = keep & (pos < C)
    kept = keep.float().sum(dim=(1, 2))
    d_drop = 1.0 - valid.float().sum(dim=(1, 2)) / torch.clamp(kept, min=1.0)

    wire_dtype = wdt.validate_wire_dtype(luffy.wire_dtype)
    wire = ("dedup" if (luffy.hier_dedup == "on" and comm.mode == "hier"
                        and M > 1) else "dense")
    topo = comm.topology
    itemsize = torch.finfo(cdt).bits // 8
    pipelined, chunks, est = schedule_of(cfg, luffy, comm, T, C)

    # replica lanes: each node's hottest expert on an intra-node peer's
    # spare lane when the model says it pays; its first overflow copies
    # (C <= pos < 2C) then take the host's lane instead of dropping
    replica_src = replica_valid = None
    if (luffy.plan_objective == "replicate" and mode == "migrate"
            and luffy.enable_migration and M > 1 and wire == "dense"
            and topo is not None and topo.hierarchical
            and topo.devices_per_node > 1):
        # demand per expert before the capacity drop, summed over every
        # rank (integer counts: exact in any order)
        load_e = torch.zeros((E,), dtype=torch.float32, device=dev) \
            .index_add_(0, expert_idx.reshape(-1),
                        keep.reshape(-1).to(torch.float32))
        replica_src = objectives.plan_expert_replicas(
            load_e, e_local=E_local, topo=topo,
            ffn_ms=0.0 if est is None else est.ffn_ms, d_model=d,
            d_ff=m.d_ff, bytes_per_el=itemsize)
        host_of = _host_of(replica_src, E)
        replica_valid = keep & (pos >= C) & (pos < 2 * C) \
            & (host_of[expert_idx] >= 0)
        d_drop = 1.0 - (valid.float().sum(dim=(1, 2))
                        + replica_valid.float().sum(dim=(1, 2))) \
            / torch.clamp(kept, min=1.0)

    zM = torch.zeros((M,), dtype=torch.float32, device=dev)
    # redirected copies count too: their host shares the owner's node
    ib_flat, ib_dedup = _node_ledger(
        comm, expert_idx, valid if replica_valid is None
        else valid | replica_valid, E_local, (d + 2) * itemsize)

    migrate = mode == "migrate" and luffy.enable_migration and M > 1
    reuse_mode = luffy.plan_reuse
    reuse_on = reuse_mode != "off"
    built = reused = mismatch = 0.0
    sig_out = None
    if migrate:
        oh = F.one_hot(expert_idx // E_local, M).float() \
            * valid[..., None].float()                        # [M,T,k,M]
        counts = oh.reshape(M, n_seq, S, k, M).sum(dim=(2, 3))
        lens = sideband["seq_len"].float()
        counts_h = counts.reshape(M * n_seq, M).cpu().numpy()
        lens_h = lens.reshape(M * n_seq).cpu().numpy()
        sig_in = (reuse_from.signature
                  if isinstance(reuse_from, ExchangePlan) else reuse_from)
        match = False
        if sig_in is not None:
            have = bool(sig_in.valid > 0.5)
            if reuse_mode == "always":
                match = have
            else:                               # "off" | "signature"
                match = routing_signature_matches(sig_in, counts_h, lens_h)
                mismatch = float(have and not match)
        if match:
            # the greedy would keep every sequence home: skip it
            mplan = mig.home_plan(counts_h, n_seq,
                                  link_cost=objectives.traffic_link_cost(
                                      topo))
        else:
            mplan = objectives.plan_migration_with_objective(
                counts_h, lens_h, n_seq, objective=luffy.plan_objective,
                ctx=objective_context(topo, est, chunks, luffy,
                                      d * itemsize),
                q=luffy.q, d_model=d, speed=luffy.gpu_speed)
        built, reused = float(not match), float(match)
        perm = mplan.perm
        if reuse_on or sig_in is not None:
            sig_out = next_signature(counts_h, lens_h, perm)
            if not (reuse_on and luffy.plan_objective == "traffic"):
                sig_out = sig_out._replace(valid=np.float32(0.0))
        dest_global = torch.as_tensor(perm, device=dev).long() \
            .reshape(M, n_seq)
        t_before = torch.full((M,), float(mplan.traffic_before),
                              dtype=torch.float32, device=dev)
        t_after = torch.full((M,), float(mplan.traffic_after),
                             dtype=torch.float32, device=dev)
    else:
        perm = None
        dest_global = (torch.arange(M * n_seq, device=dev)
                       .reshape(M, n_seq))
        t_before = t_after = zM
    if sig_out is None and (reuse_on or reuse_from is not None):
        sig_out = invalid_signature(M * n_seq, M)
    return ExchangePlan(
        condense=do_condense, capacity=C, group_size=G,
        expert_idx=expert_idx, gate_weights=gate_w, positions=pos,
        valid=valid, aux_loss=gate.aux_loss, dispatch_drop=d_drop,
        condense_plan=cp, comm=comm, mode=mode, migrate=migrate, wire=wire,
        wire_dtype=wire_dtype, combine_slack=luffy.combine_slack,
        perm=perm, dest_global=dest_global, traffic_before=t_before,
        traffic_after=t_after, inter_bytes_flat=ib_flat,
        inter_bytes_dedup=ib_dedup, signature=sig_out, plans_built=built,
        plans_reused=reused, reuse_mismatch=mismatch, pipelined=pipelined,
        chunks=chunks, estimate=est, objective=luffy.plan_objective,
        replica_src=replica_src, replica_valid=replica_valid)


def objective_context(topo, est: Optional[PlanEstimate], chunks: ChunkPlan,
                      luffy: LuffyConfig, row_bytes: float
                      ) -> objectives.ObjectiveContext:
    """What the planner objective prices against: the exchange estimate's
    FFN stage and dispatch phases, the chunk count and the combine row's
    bytes (the reference's, host floats)."""
    o_ms = resolve_chunk_overhead_ms(luffy.chunk_overhead_ms)
    if est is None:
        return objectives.ObjectiveContext(topo=topo, chunk_overhead_ms=o_ms)
    return objectives.ObjectiveContext(
        topo=topo, ffn_ms=est.ffn_ms,
        dispatch_intra_ms=est.intra_dispatch_bytes / topo.intra_bw * 1e3,
        dispatch_inter_ms=est.inter_dispatch_bytes / topo.inter_bw * 1e3,
        chunks=chunks.n_chunks, row_bytes=float(row_bytes),
        chunk_overhead_ms=o_ms)


def _token_keep(seq_len, S: int, k: int):
    """[M, T, k]: the copies of each rank's tokens inside their sequence's
    length (seq_len [M, n_seq], T = n_seq * S)."""
    M, n_seq = seq_len.shape
    valid = (torch.arange(S, device=seq_len.device)[None, None, :]
             < seq_len[..., None]).reshape(M, n_seq * S)
    return valid[..., None].expand(M, n_seq * S, k)


def _node_ledger(comm: CommContext, expert_idx, valid, e_local: int,
                 row_bytes: int):
    """The inter-node dispatch ledger (flat and per-node deduplicated
    bytes, [M] each) on a hierarchical topology across ranks, else
    zeros; the flat wire ships every copy."""
    M = comm.size()
    topo = comm.topology
    if topo is None or not topo.hierarchical or M <= 1:
        z = torch.zeros((M,), dtype=torch.float32, device=valid.device)
        return z, z
    ib_flat, ib_dedup = dispatch_node_ledger(
        expert_idx, valid, comm.index(valid.device), e_local=e_local,
        topo=topo, row_bytes=float(row_bytes))
    return ib_flat, ib_flat if comm.mode != "hier" else ib_dedup


def _host_of(replica_src, E: int):
    """[E] int32: the rank whose lane serves each expert, -1 for none."""
    M = replica_src.shape[0]
    ranks = torch.arange(M, dtype=torch.int32, device=replica_src.device)
    live = replica_src >= 0
    return torch.full((E,), -1, dtype=torch.int32,
                      device=replica_src.device).scatter_reduce(
        0, torch.where(live, replica_src, 0).long(),
        torch.where(live, ranks, -1), reduce="amax")


def instantiate_plan(template: ExchangePlan, gate: GateOutput, xn,
                     cfg: ModelConfig, *, capacity: int,
                     sideband: Dict[str, torch.Tensor],
                     comm: Optional[CommContext] = None) -> ExchangePlan:
    """Bind fresh routing onto a cached static template (the serving
    path's zero-planning exchange): every static decision (schedule,
    estimate, wire) is the template's, and the routing fields are what
    :func:`build_exchange_plan` computes in vanilla or decode mode, in the
    same arithmetic, so the executed forward is the built plan's bit for
    bit. No planning runs and ``BUILD_CALLS`` does not move. Templates
    are vanilla or decode, never condensed or migrating. gate, xn,
    sideband: as :func:`build_exchange_plan`'s, over ``comm``'s ranks
    (None: one device)."""
    from repro_torch.models.blocks import _dtype
    comm = CommContext.local() if comm is None else comm
    if template.mode not in ("vanilla", "decode") or template.migrate \
            or template.condense:
        raise ValueError(f"a template is vanilla or decode, got mode "
                         f"{template.mode!r} migrate={template.migrate} "
                         f"condense={template.condense}")
    if template.capacity != capacity or template.chunks.capacity != capacity:
        raise ValueError(f"template of capacity {template.capacity} for an "
                         f"exchange of capacity {capacity}")
    m = cfg.moe
    M, T, d = xn.shape
    n_seq = sideband["seq_len"].shape[1]
    S = T // n_seq
    E, k, C = m.num_experts, m.top_k, capacity
    E_local = E // M
    dev = xn.device
    cdt = _dtype(cfg.compute_dtype)
    expert_idx, gate_w = gate.expert_idx, gate.gate_weights
    keep = _token_keep(sideband["seq_len"], S, k)
    pos = dispatch_positions(expert_idx, keep, E)
    valid = keep & (pos < C)
    kept = keep.float().sum(dim=(1, 2))
    d_drop = 1.0 - valid.float().sum(dim=(1, 2)) / torch.clamp(kept, min=1.0)
    zM = torch.zeros((M,), dtype=torch.float32, device=dev)
    ib_flat, ib_dedup = _node_ledger(
        comm, expert_idx, valid, E_local,
        (d + 2) * (torch.finfo(cdt).bits // 8))
    return ExchangePlan(
        condense=False, capacity=C, group_size=template.group_size,
        expert_idx=expert_idx, gate_weights=gate_w, positions=pos,
        valid=valid, aux_loss=gate.aux_loss, dispatch_drop=d_drop,
        condense_plan=identity_condense_plan(
            M * T, template.condense_plan.backend, device=dev, ranks=M),
        comm=comm, mode=template.mode, migrate=False, wire=template.wire,
        wire_dtype=template.wire_dtype, combine_slack=template.combine_slack,
        perm=None,
        dest_global=torch.arange(M * n_seq, device=dev).reshape(M, n_seq),
        traffic_before=zM, traffic_after=zM, inter_bytes_flat=ib_flat,
        inter_bytes_dedup=ib_dedup, signature=None, plans_built=0.0,
        plans_reused=1.0, reuse_mismatch=0.0, pipelined=template.pipelined,
        chunks=template.chunks, estimate=template.estimate,
        objective=template.objective)


def instantiate_decode_plan(template: ExchangePlan, gate: GateOutput, xn,
                            cfg: ModelConfig, *, capacity: int,
                            sideband: Dict[str, torch.Tensor],
                            comm: Optional[CommContext] = None
                            ) -> ExchangePlan:
    """:func:`instantiate_plan` on a decode template (one template serves
    every decode step of a batch shape); a prefill template bound to a
    decode step is an error."""
    if template.mode != "decode":
        raise ValueError(f"not a decode template: mode {template.mode!r}")
    return instantiate_plan(template, gate, xn, cfg, capacity=capacity,
                            sideband=sideband, comm=comm)


def _exchange_sideband(sb: Dict[str, torch.Tensor], dest_global
                       ) -> Dict[str, torch.Tensor]:
    """Move per-sequence state [M, n_seq, ...] to the sequences' new
    homes: slot ``i`` goes to global slot ``dest_global[i]``. The
    reference ships it through the combine all-to-all with one writer per
    slot; across virtual ranks that is exactly this permutation."""
    n = dest_global.numel()
    inv = torch.empty_like(dest_global.reshape(-1))
    inv[dest_global.reshape(-1)] = torch.arange(n, device=inv.device)
    return {key: v.reshape(n, *v.shape[2:]).index_select(0, inv)
            .reshape(v.shape) for key, v in sb.items()}


def execute_plan(params, x, plan: ExchangePlan, cfg: ModelConfig,
                 sideband: Dict[str, torch.Tensor], *,
                 wire_ef: Optional[torch.Tensor] = None):
    """Run one exchange for every rank: pack the dispatch rows, run the
    expert FFN, combine, and un-condense.

    params: the MoE sublayer's parameters with the whole expert stack
    [E, ...] (rank r owns experts [r*E_local, (r+1)*E_local)); x:
    [M, n_seq, S, d] pre-norm hidden; sideband: seq_len [M, n_seq] and
    any per-sequence state (labels [M, n_seq, S]). The expert FFN runs
    once over every rank's rows, [E, M*C, d], or on the pipelined dense
    wire (``plan.pipelined``) once per capacity chunk, [E, M*Ck, d], with
    each chunk's all-to-all (and in vanilla mode its combine) on the
    pipeline's side stream; the chunks reassemble in the sync layout, so
    the forward is the sync path's bit for bit.

    wire_ef: [M, n_seq, S, d] f32, the error-feedback residual of the
    previous step (None: off). It is added to the shipped payload only;
    the residual connection keeps the exact hidden (under migration the
    primary copy's row carries the residual, so there it is the
    payload's, as in the reference). The new residual ``payload -
    dequant(quant(payload))`` at the compute dtype, through the wire's
    codec, is returned at the same (slot, position), detached: zero on
    the f32 wire or one rank.

    Returns ``(y, aux, cond_carry, sideband, s_next, wire_ef)``: in
    vanilla and decode mode ``y = x + moe_delta`` and the sideband is
    unchanged; in migrate mode (M > 1) ``y`` is the post-block hidden at
    the sequences' new slots, and the sideband, the rep map and the
    similarity history have moved with them. A shared expert adds its
    FFN of ``rms(x)``, in migrate mode of ``rms(y)`` (the reference's
    rule). aux fields are per rank, [M]; ``cond_carry`` is the
    condense-reuse carry for the next sublayer (None without
    condensation). Rounding follows the reference: rows are packed in
    the compute dtype, RMS-normed from those rounded rows, scaled by the
    compute-dtype gate weight and summed over k in the compute dtype.
    Un-condense replaces each condensed token's whole output row
    (residual included) by its representative's."""
    from repro_torch.models.blocks import _dtype, ffn_apply
    _check_whole_stack(params, cfg)
    m = cfg.moe
    cdt = _dtype(cfg.compute_dtype)
    comm = plan.comm
    M, n_seq, S, d = x.shape
    T, E, k, C = n_seq * S, m.num_experts, m.top_k, plan.capacity
    E_local = E // M
    migrate = plan.migrate
    dev = x.device
    ranks = comm.index(dev)
    expert_idx, gate_w = plan.expert_idx, plan.gate_weights
    pos, valid = plan.positions, plan.valid
    dest_global = plan.dest_global
    xf = x.reshape(M, T, d)
    scale = params["norm"]["scale"]
    x_pay, ef_next = xf, None
    if wire_ef is not None:
        x_pay = xf + wire_ef.reshape(M, T, d).to(xf.dtype)
        if plan.wire_dtype != "f32" and M > 1:
            pc = x_pay.detach().to(cdt)
            deq = wdt.dequantize_rows(*wdt.quantize_rows(pc, plan.wire_dtype),
                                      cdt, d)
            ef_next = (pc - deq).float().reshape(M, n_seq, S, d)
        else:       # an exact wire, or nothing crosses it
            ef_next = torch.zeros((M, n_seq, S, d), dtype=torch.float32,
                                  device=dev)

    # replica lanes: lane E_local of rank r runs expert replica_src[r] (or
    # nothing), read from the one stack through K1's group map
    has_lane = plan.replica_src is not None
    n_lanes = E_local + int(has_lane)
    w_idx = None
    if has_lane:
        own = (ranks[:, None] * E_local
               + torch.arange(E_local, device=dev)[None, :])
        w_idx = torch.cat([own.to(torch.int32), plan.replica_src[:, None]],
                          dim=1).reshape(-1).contiguous()

    def ffn(x_rows):
        """x_rows [M, n_lanes, M, c, d] -> expert outputs, one launch (c:
        the capacity, or a chunk of it)."""
        g, c = x_rows.shape[1], x_rows.shape[3]
        h = _rms(x_rows, scale).to(cdt)
        return expert_ffn(params["experts"], h.reshape(M * g, M * c, d),
                          cfg.act, w_idx).reshape(M, g, M, c, d)

    def shared(y_out):
        """The always-on shared expert (llama4's), where the reference
        applies it: on ``rms(x)`` in vanilla and decode mode, and in
        migrate mode on ``rms(y_out)``, the post-combine hidden at the
        sequences' new homes."""
        if "shared" not in params:
            return y_out
        sh = ffn_apply(params["shared"], cfg,
                       _rms(y_out if migrate else x, scale).to(cdt))
        return y_out + sh.to(y_out.dtype)

    def ship(fn, buf):
        # one device ships nothing: its rows keep the compute dtype
        return cwire.ship_rows(fn, buf, d, plan.wire_dtype) if M > 1 \
            else fn(buf)

    if plan.wire == "dedup":
        dchunks = mchunks = None
        if plan.pipelined:
            n = plan.chunks.n_chunks
            dchunks = plan_unique_chunks(cwire.dedup_capacity(
                T, E_local, comm.local_size, C), n)
            mchunks = plan_unique_chunks(T, n) if migrate else None
        dest_gpos = prim_tk = None
        if migrate:
            tok = torch.arange(T, device=dev)
            dslot = dest_global[:, tok // S]                      # [M, T]
            dest_gpos = (dslot // n_seq) * T + (dslot % n_seq) * S + tok % S
            prim_tk = (torch.arange(k, device=dev) == 0).expand(M, T, k)
        with obs_trace.phase("dispatch") as sp:
            x_rows, gw_rows, rvalid, wst = cwire.dedup_dispatch(
                x_pay.to(cdt), expert_idx, gate_w, valid, pos, comm=comm,
                e_local=E_local, capacity=C, wire_dtype=plan.wire_dtype,
                dest_gpos=dest_gpos, prim=prim_tk, chunks=dchunks)
            x_rows = sp.fence(x_rows)
        with obs_trace.phase("expert_ffn") as sp:
            y_rows = sp.fence(ffn(x_rows))
        n_rv = torch.clamp(rvalid.float().sum(dim=(1, 2, 3)), min=1.0)
        with obs_trace.phase("combine") as sp:
            if not migrate:
                delta = cwire.dedup_combine(y_rows * gw_rows[..., None],
                                            wst, comm=comm,
                                            wire_dtype=plan.wire_dtype,
                                            chunks=dchunks)
                y_tok = xf + delta.to(xf.dtype)
                local_frac = torch.full((M,), 1.0 / M, device=dev)
                new_sb = dict(sideband)
            else:
                out_rows = (y_rows * gw_rows[..., None]
                            + x_rows * wst["prim"][..., None])
                y_tok = cwire.dedup_combine_migrate(
                    out_rows, wst, comm=comm, wire_dtype=plan.wire_dtype,
                    chunks=mchunks).to(xf.dtype)
                dd = torch.where(wst["dgpos"] >= 0, wst["dgpos"] // T,
                                 torch.full_like(wst["dgpos"], -1))
                local_frac = (dd == ranks[:, None, None, None]).float() \
                    .sum(dim=(1, 2, 3)) / n_rv
                new_sb = _exchange_sideband(sideband, dest_global)
            y_tok = sp.fence(y_tok)
        row_bytes = wdt.wire_row_bytes(d, plan.wire_dtype,
                                       torch.finfo(cdt).bits // 8)
        shipped = wst["shipped_rows"] * row_bytes
        return _finish(plan, y_tok, new_sb, None, local_frac, shipped,
                       n_seq, S, shared) + (ef_next,)

    # ---- dense wire: each copy's row, and beside it its gate weight (and
    # under migration its primary flag and its row metadata: destination
    # global slot + 1, 0 = empty, and position). The side columns move in
    # their own buffers through the same collective, so the rows stay d
    # wide.
    side = gate_w[..., None].to(cdt)
    if migrate:          # the primary copy carries the token's residual
        side = torch.cat([side, (torch.arange(k, device=dev) == 0).to(cdt)
                          .expand(M, T, k)[..., None]], dim=-1)
    # a copy's row: rank r's lane j is row r * n_lanes + j; a redirected
    # copy takes its host's replica lane (row host * n_lanes + E_local) at
    # slot pos - C
    row = (expert_idx // E_local) * n_lanes + expert_idx % E_local
    p_slot, v_slot = pos, valid
    if has_lane:
        rv = plan.replica_valid
        row = torch.where(rv, _host_of(plan.replica_src, E)[expert_idx]
                          .long() * n_lanes + E_local, row)
        p_slot = torch.where(rv, pos - C, pos)
        v_slot = valid | rv
    R_rows = M * n_lanes
    slot = (ranks[:, None, None] * R_rows + row) * C + p_slot  # [M, T, k]
    w = side.shape[-1]
    rows = [x_pay.to(cdt)[:, :, None, :].expand(M, T, k, d).reshape(-1, d),
            side.reshape(-1, w)]
    if migrate:
        tok = torch.arange(T, device=dev)
        dest_of_tok = dest_global[:, tok // S][..., None].expand(M, T, k)
        rows.append(torch.stack([dest_of_tok + 1,
                                 (tok % S)[None, :, None].expand(M, T, k)],
                                -1).reshape(-1, 2))
    with obs_trace.phase("dispatch_pack") as sp:
        bufs = sp.fence([b.reshape(M, R_rows, C, b.shape[-1])
                         for b in _scatter_rows(M * R_rows * C,
                                                slot.reshape(-1),
                                                v_slot.reshape(-1), *rows)])

    def arrive(t):
        """[M, M * n_lanes, c, .] after the all-to-all -> [M, n_lanes, M,
        c, .]."""
        return t.reshape(M, M, n_lanes, *t.shape[2:]).transpose(1, 2)

    def dispatch(bs):
        """(rows, side[, meta]) through the all-to-all; the rows at the
        wire dtype."""
        return (ship(comm.all_to_all, bs[0]),
                *(comm.all_to_all(b) for b in bs[1:]))

    def compute(moved):
        """The expert FFN on one exchange's rows: the gate-weighted output
        (plus the primary copy's residual under migration), and under
        migration the primary flags and the row metadata."""
        xr, sr = arrive(moved[0]), arrive(moved[1])
        out = ffn(xr) * sr[..., :1]                          # [M,El,M,c,d]
        if not migrate:
            return out
        prim = sr[..., 1:]
        return out + xr * prim, prim, arrive(moved[2])

    def combine_back(out):
        return ship(comm.combine, out.transpose(1, 2).reshape(
            M, R_rows, out.shape[3], d))

    if not plan.pipelined:
        with obs_trace.phase("dispatch") as sp:
            moved = sp.fence(dispatch(bufs))
        with obs_trace.phase("expert_ffn") as sp:
            res = sp.fence(compute(moved))
        back = None
        if not migrate:
            with obs_trace.phase("combine") as sp:
                back = sp.fence(combine_back(res))
    else:
        # capacity chunks through the pipeline: chunk k+1's dispatch on
        # the side stream while chunk k's FFN runs; each chunk's rows
        # are the sync path's rows, reassembled in the sync layout before
        # anything that depends on row order (the migrate-mode regroup
        # sorts across all rows, so it stays after the pipeline)
        ch = plan.chunks
        stream = side_stream(dev)
        share(stream, bufs)

        def chunk(j):
            o, n = ch.offsets[j], ch.sizes[j]
            return dispatch([b[:, :, o:o + n] for b in bufs])

        with obs_trace.phase("pipeline_exchange") as sp:
            outs, backs = run_pipeline(
                ch.n_chunks, dispatch=chunk,
                compute=lambda j, moved: compute(moved),
                combine=None if migrate else (
                    lambda j, out: combine_back(out)),
                stream=stream)
            if migrate:
                res = sp.fence(tuple(torch.cat(parts, dim=3)
                                     for parts in zip(*outs)))
                back = None
            else:
                back = sp.fence(torch.cat(backs, dim=2))     # [M, E, C, d]

    if not migrate:
        # index_select, not back[slot]: its backward is an index_add_,
        # where advanced indexing's sorts the indices (15 ms per layer at
        # B=8, S=1024 on an H100). Each kept slot is read by one copy, so
        # the index_add_ adds one value into zero per row, and the dropped
        # copies read slot 0 times 0, adding exact zeros: the gradient
        # repeats bit for bit.
        e_safe = torch.where(valid, slot, torch.zeros_like(slot))
        vals = back.reshape(M * R_rows * C, d).index_select(
            0, e_safe.reshape(-1)).reshape(M, T, k, d)
        vals = vals * valid[..., None].to(cdt)
        y_tok = xf + vals.sum(dim=2).to(xf.dtype)
        c_drop = None
        local_frac = torch.full((M,), 1.0 / M, device=dev)
        new_sb = dict(sideband)
    else:
        out, prim, rmeta = res
        # regroup rows by destination rank, residual rows first
        R = n_lanes * M * C
        o_f = out.reshape(M, R, d)
        dslot = rmeta[..., 0].reshape(M, R) - 1
        rpos = rmeta[..., 1].reshape(M, R)
        rprim = prim.reshape(M, R) > 0.5
        rvalid = dslot >= 0
        ddev = torch.where(rvalid, dslot // n_seq,
                           torch.full_like(dslot, M))
        prio = (~rvalid).long() * 2 + (~rprim).long()
        order = torch.sort(prio, dim=1, stable=True).indices
        o_f = torch.gather(o_f, 1, order[..., None].expand(M, R, d))
        dslot, rpos, ddev, rvalid = (torch.gather(a, 1, order) for a in
                                     (dslot, rpos, ddev, rvalid))
        C_comb = max(8, int(math.ceil(plan.combine_slack * n_lanes * C
                                      / 8)) * 8)
        oh = F.one_hot(ddev, M + 1)[..., :M]
        rank = torch.gather(torch.cumsum(oh, dim=1) - oh, 2,
                            torch.where(rvalid, ddev, torch.zeros_like(ddev))
                            [..., None])[..., 0]
        keep_c = rvalid & (rank < C_comb)
        n_rv = torch.clamp(rvalid.float().sum(dim=1), min=1.0)
        c_drop = 1.0 - keep_c.float().sum(dim=1) / n_rv
        local_frac = (keep_c & (ddev == ranks[:, None])).float() \
            .sum(dim=1) / n_rv
        cslot = ((ranks[:, None] * M + ddev.clamp(max=M - 1)) * C_comb
                 + rank.clamp(max=C_comb - 1))
        cbuf, cmeta = _scatter_rows(
            M * M * C_comb, cslot.reshape(-1), keep_c.reshape(-1),
            o_f.reshape(-1, d),
            torch.stack([dslot % n_seq + 1, rpos], -1).reshape(-1, 2)
            .to(torch.int64))
        cbuf = ship(comm.combine, cbuf.reshape(M, M, C_comb, d))
        cmeta = comm.combine(cmeta.reshape(M, M, C_comb, 2))
        rslot = cmeta[..., 0].reshape(M, M * C_comb) - 1
        rp = cmeta[..., 1].reshape(M, M * C_comb)
        ok = rslot >= 0
        at = (ranks[:, None] * n_seq + rslot) * S + rp
        at = torch.where(ok, at, torch.full_like(at, M * T))
        y_grid = torch.zeros((M * T + 1, d), dtype=cdt, device=dev)
        y_grid = y_grid.index_add(0, at.reshape(-1),
                                  cbuf.reshape(M * M * C_comb, d))
        y_tok = y_grid[:M * T].reshape(M, T, d).to(xf.dtype)
        new_sb = _exchange_sideband(sideband, dest_global)
    return _finish(plan, y_tok, new_sb, c_drop, local_frac, None, n_seq,
                   S, shared) + (ef_next,)


def _finish(plan: ExchangePlan, y_tok, new_sb, c_drop, local_frac,
            shipped, n_seq: int, S: int, shared):
    """The executor's tail: un-condense through kernel K3 (with the rep
    map moved to the sequences' new homes under migration), migrate the
    similarity history and the condense carry, add the shared expert
    (``shared``, on the un-condensed output) and the per-rank ledger
    (``c_drop`` / ``shipped`` None: zero)."""
    M, T, d = y_tok.shape
    G = plan.group_size
    dev = y_tok.device
    cp = plan.condense_plan
    s_next = cp.s_next
    cond_carry = None
    if plan.condense:
        local = cp.rep_idx.reshape(M, T) \
            - (torch.arange(M, device=dev) * T)[:, None]
        sig = cp.signature
        carry = {}
        if sig is not None:
            carry = {"cexp": sig.expert.reshape(M, n_seq, S),
                     "age": sig.age.reshape(M, n_seq),
                     "valid": sig.valid.reshape(M, n_seq)}
        if not plan.migrate:
            y_tok = uncondense(y_tok.reshape(M * T, d), cp.rep_idx, G)
            rep = (local % G).reshape(M, n_seq, S)
        else:
            moved = _exchange_sideband(
                {"rep": (local % S).reshape(M, n_seq, S), **carry},
                plan.dest_global)
            rep_sb = moved.pop("rep")
            carry = moved
            seq = torch.arange(M * n_seq, device=dev)[:, None] * S
            y_tok = uncondense(y_tok.reshape(M * T, d),
                               (seq + rep_sb.reshape(M * n_seq, S))
                               .reshape(-1), G)
            rep = rep_sb % G
            ng = S // G
            s_mig = s_next.reshape(M, n_seq, ng, G, G).to(torch.bfloat16)
            s_next = _exchange_sideband({"s": s_mig}, plan.dest_global)[
                "s"].float().reshape(-1, G, G)
        if sig is not None:
            cond_carry = {"rep": rep.reshape(M * n_seq, S),
                          "cexp": carry["cexp"].reshape(M * n_seq, S),
                          "age": carry["age"].reshape(-1),
                          "valid": carry["valid"].reshape(-1)}
    zM = torch.zeros((M,), dtype=torch.float32, device=dev)

    def per_rank(v):     # a scalar flag -> [M]; None -> 0
        return zM if v is None else v.expand(M)

    aux = MoEAux(
        plan.aux_loss, plan.dispatch_drop, per_rank(c_drop), cp.rate,
        local_frac, plan.traffic_before, plan.traffic_after,
        plan.inter_bytes_flat, plan.inter_bytes_dedup,
        zM + plan.plans_built, zM + plan.plans_reused,
        zM + plan.reuse_mismatch, cp.measured_pairs,
        per_rank(cp.built), per_rank(cp.reused), per_rank(shipped))
    return (shared(y_tok.reshape(M, n_seq, S, d)), aux, cond_carry, new_sb,
            s_next)
