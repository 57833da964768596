"""Keyed :class:`PlanCache` with disk spill, and ahead-of-time serving
templates (counterpart of ``repro/plan/cache.py``).

For a known batch shape every static decision of a vanilla exchange
(capacity partition, chunk schedule, pipelined flag, estimate) is a pure
function of the shape key, so it is decided once
(:func:`build_plan_template`, from the same ``plan_static_schedule`` the
live builder calls), stored (:mod:`repro_torch.plan.serial`, the
reference's byte format) and looked up on the request path:
``serve/engine.py``'s prefill and decode step bind each request's routing
onto the template (``plan/exchange.py::instantiate_plan``) without a
``build_exchange_plan`` call. Keys are the reference's slugs, letter for
letter, over the batch shape, objective, topology fingerprint and every
knob that selects the schedule; a stale, corrupt or foreign file is a
miss and is rebuilt, never misread.

The port's decode is the one-device decode at any number of ranks
(``repro_torch.dist``), so its decode template is always a one-rank one.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.comm import dtypes as wire_dtypes
from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.topology import Topology
from repro_torch.condense.plan import CondensePlan
from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.plan import serial
from repro_torch.plan.exchange import ExchangePlan, plan_static_schedule


def topology_fingerprint(topo: Optional[Topology], M: int) -> str:
    """Short stable id of the fabric a plan was priced on, link speeds
    and latencies included."""
    if topo is None:
        return f"flat{M}"
    return (f"{topo.num_nodes}x{topo.devices_per_node}"
            f"i{topo.intra_bw:.4g}e{topo.inter_bw:.4g}"
            f"l{topo.intra_lat:.3g}-{topo.inter_lat:.3g}")


def plan_key(*, n_seq: int, seq_len: int, d_model: int, capacity: int,
             top_k: int, num_experts: int, mode: str, objective: str,
             exec_mode: str, pipeline_chunks: int, comm_mode: str,
             topo: Optional[Topology], M: int,
             compute_dtype: str = "bfloat16", gpu_speed: float = 1.0e13,
             d_ff: int = 0, hier_dedup: str = "off",
             params_version: str = "0", chunk_overhead_ms: float = -1.0,
             wire_dtype: str = "f32") -> str:
    """The cache key (the reference's slug): a rank's sequence slots and
    tokens, the widths, capacity, mode, objective, schedule knobs,
    topology fingerprint, dtypes, wire and router fingerprint. Unset
    defaults add nothing, so older keys stay valid."""
    o_part = f"_o{chunk_overhead_ms:.3g}" if chunk_overhead_ms > 0 else ""
    wd_part = f"_wd{wire_dtype}" if wire_dtype != "f32" else ""
    rep_part = ("_rep1" if (objective == "replicate" and mode == "migrate")
                else "")
    return (f"b{n_seq}_s{seq_len}_d{d_model}_f{d_ff}_c{capacity}"
            f"_k{top_k}_e{num_experts}_{mode}_{objective}"
            f"_{exec_mode}{pipeline_chunks}_p{gpu_speed:.4g}"
            f"_{comm_mode}_{topology_fingerprint(topo, M)}"
            f"_{compute_dtype}_w{hier_dedup}_pv{params_version}"
            f"{o_part}{wd_part}{rep_part}")


class PlanCache:
    """In-memory LRU of plans keyed by :func:`plan_key`, with an optional
    disk spill (``<key>.plan`` files in the serialised format). ``get``
    falls back to disk on a memory miss; an unreadable, stale or foreign
    file is a miss."""

    def __init__(self, path: Optional[Union[str, Path]] = None,
                 mem_capacity: int = 64, params_version: str = "0"):
        self.path = None if path is None else Path(path)
        if self.path is not None:
            self.path.mkdir(parents=True, exist_ok=True)
        self.mem_capacity = int(mem_capacity)
        self.params_version = str(params_version)
        self._mem: "OrderedDict[str, ExchangePlan]" = OrderedDict()
        self.hits = self.misses = self.disk_loads = self.puts = 0

    def __len__(self) -> int:
        return len(self._mem)

    def _file(self, key: str) -> Optional[Path]:
        return None if self.path is None else self.path / f"{key}.plan"

    def get(self, key: str) -> Optional[ExchangePlan]:
        plan = self._mem.get(key)
        if plan is not None:
            self._mem.move_to_end(key)
            self.hits += 1
            return plan
        f = self._file(key)
        if f is not None and f.exists():
            try:
                plan = serial.from_bytes(
                    f.read_bytes(), expect_params_version=self.params_version)
            except Exception:        # stale, corrupt or foreign: a miss
                plan = None
            if plan is not None:
                self._insert(key, plan)
                self.hits += 1
                self.disk_loads += 1
                return plan
        self.misses += 1
        return None

    def put(self, key: str, plan: ExchangePlan):
        self._insert(key, plan)
        self.puts += 1
        f = self._file(key)
        if f is not None:
            f.write_bytes(serial.to_bytes(
                plan, params_version=self.params_version))

    def _insert(self, key: str, plan: ExchangePlan):
        self._mem[key] = plan
        self._mem.move_to_end(key)
        while len(self._mem) > self.mem_capacity:
            self._mem.popitem(last=False)   # the disk copy stays

    def stats(self) -> dict:
        return {"entries": len(self._mem), "hits": self.hits,
                "misses": self.misses, "disk_loads": self.disk_loads,
                "puts": self.puts}


# ---------------------------------------------------------------------------
# ahead-of-time templates
# ---------------------------------------------------------------------------

def build_plan_template(cfg: ModelConfig, luffy: LuffyConfig, *,
                        n_seq: int, seq_len: int, capacity: int,
                        comm: Optional[CommContext] = None,
                        mode: str = "vanilla") -> ExchangePlan:
    """Every static part of a vanilla (or decode) exchange of one shape
    key over ``comm``'s ranks (None: one device), host-side, without
    routing: the schedule of :func:`plan_static_schedule`, the wire, and
    one rank's zero placeholders (on the host) for the routing fields,
    which ``instantiate_plan`` replaces per request."""
    from repro_torch.models.blocks import _dtype
    comm = CommContext.local() if comm is None else comm
    M = comm.size()
    d = cfg.d_model
    wire_dtype = wire_dtypes.validate_wire_dtype(luffy.wire_dtype)
    pipelined, chunks, est = plan_static_schedule(
        cfg, luffy, comm.topology if M > 1 else None, M, n_seq * seq_len, d,
        capacity, torch.finfo(_dtype(cfg.compute_dtype)).bits // 8,
        wire_dtype)
    wire = ("dedup" if (luffy.hier_dedup == "on" and comm.mode == "hier"
                        and M > 1) else "dense")

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    i32 = torch.int32
    return ExchangePlan(
        condense=False, capacity=capacity, group_size=luffy.condense_group,
        expert_idx=z(1, 0, 1, dtype=i32), gate_weights=z(1, 0, 1),
        positions=z(1, 0, 1, dtype=i32), valid=z(1, 0, 1, dtype=torch.bool),
        aux_loss=z(1), dispatch_drop=z(1),
        condense_plan=CondensePlan(
            backend=luffy.similarity_backend, rep_idx=z(0, dtype=i32),
            is_rep=z(0, dtype=torch.bool), s_next=None, rate=z(1),
            measured_pairs=z(1)),
        comm=comm, mode=mode, migrate=False, wire=wire,
        wire_dtype=wire_dtype, combine_slack=luffy.combine_slack, perm=None,
        dest_global=z(1, 0, dtype=i32), traffic_before=z(1),
        traffic_after=z(1), inter_bytes_flat=z(1), inter_bytes_dedup=z(1),
        pipelined=pipelined, chunks=chunks, estimate=est,
        objective=luffy.plan_objective)


def _prefill_locals(dist, batch: int, seq_len: int):
    """A rank's (n_seq, seq_len, M, topo) of one prefill shape."""
    if dist is None or not dist.enabled:
        return max(1, batch), seq_len, 1, None
    M = dist.model_size
    n_seq = max(1, batch // max(1, dist.batch_size_divisor))
    s_l = seq_len // M if dist.seq_sharded else seq_len
    return n_seq, s_l, M, dist.topology


def _key(cfg, luffy, *, n_seq, seq_len, capacity, mode, M, topo) -> str:
    return plan_key(
        n_seq=n_seq, seq_len=seq_len, d_model=cfg.d_model,
        capacity=capacity, top_k=cfg.moe.top_k,
        num_experts=cfg.moe.num_experts, mode=mode,
        objective=luffy.plan_objective, exec_mode=luffy.exec_mode,
        pipeline_chunks=luffy.pipeline_chunks,
        comm_mode=luffy.comm_mode if M > 1 else "local",
        topo=topo if M > 1 else None, M=M, compute_dtype=cfg.compute_dtype,
        gpu_speed=luffy.gpu_speed, d_ff=cfg.moe.d_ff,
        hier_dedup=luffy.hier_dedup,
        chunk_overhead_ms=luffy.chunk_overhead_ms,
        wire_dtype=luffy.wire_dtype)


def _serving(luffy: LuffyConfig) -> LuffyConfig:
    """Serving's exchange: never condensed, never re-homed."""
    return dataclasses.replace(luffy, enable_condensation=False,
                               enable_migration=False)


def prefill_plan_key(cfg: ModelConfig, luffy: LuffyConfig, dist, batch: int,
                     seq_len: int, capacity: Optional[int] = None) -> str:
    """The key the prefill and :func:`precompute_prefill_plans` agree on;
    ``capacity`` defaults to ``serve/engine.py::prefill_capacity``."""
    if capacity is None:
        from repro_torch.serve.engine import prefill_capacity
        capacity = prefill_capacity(cfg, batch, seq_len, dist)
    n_seq, s_l, M, topo = _prefill_locals(dist, batch, seq_len)
    return _key(cfg, luffy, n_seq=n_seq, seq_len=s_l, capacity=capacity,
                mode="vanilla", M=M, topo=topo)


def precompute_prefill_plans(cfg: ModelConfig, luffy: LuffyConfig, dist,
                             batch: int, seq_len: int, cache: PlanCache,
                             capacity: Optional[int] = None) -> str:
    """Warm ``cache`` with the template of one (batch, seq_len) prefill;
    returns its key."""
    if capacity is None:
        from repro_torch.serve.engine import prefill_capacity
        capacity = prefill_capacity(cfg, batch, seq_len, dist)
    luffy = _serving(luffy)
    n_seq, s_l, M, _ = _prefill_locals(dist, batch, seq_len)
    comm = dist.comm(luffy.comm_mode) if M > 1 else None
    key = prefill_plan_key(cfg, luffy, dist, batch, seq_len, capacity)
    cache.put(key, build_plan_template(cfg, luffy, n_seq=n_seq,
                                       seq_len=s_l, capacity=capacity,
                                       comm=comm))
    return key


def decode_plan_key(cfg: ModelConfig, luffy: LuffyConfig, batch: int,
                    capacity: Optional[int] = None) -> str:
    """The key of the decode step of ``batch`` slots (one rank: the port
    decodes as one device at any number of ranks); constant over a
    serving run."""
    if capacity is None:
        from repro_torch.serve.engine import decode_capacity
        capacity = decode_capacity(cfg, batch)
    return _key(cfg, luffy, n_seq=max(1, batch), seq_len=1,
                capacity=capacity, mode="decode", M=1, topo=None)


def build_decode_template(cfg: ModelConfig, luffy: LuffyConfig, *,
                          n_seq: int, capacity: int) -> ExchangePlan:
    """The decode twin of :func:`build_plan_template`: seq_len 1, one
    rank, stamped ``mode="decode"`` (decode never pipelines)."""
    tmpl = build_plan_template(cfg, luffy, n_seq=n_seq, seq_len=1,
                               capacity=capacity, mode="decode")
    assert not tmpl.pipelined
    return tmpl


def precompute_decode_plans(cfg: ModelConfig, luffy: LuffyConfig,
                            batch: int, cache: PlanCache,
                            capacity: Optional[int] = None) -> str:
    """Warm ``cache`` with the decode template of ``batch`` slots;
    returns its key."""
    if capacity is None:
        from repro_torch.serve.engine import decode_capacity
        capacity = decode_capacity(cfg, batch)
    key = decode_plan_key(cfg, luffy, batch, capacity)
    cache.put(key, build_decode_template(cfg, _serving(luffy),
                                         n_seq=max(1, batch),
                                         capacity=capacity))
    return key
