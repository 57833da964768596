"""Versioned byte format of an :class:`~repro_torch.plan.exchange.ExchangePlan`
(counterpart of ``repro/plan/serial.py``; the same format, byte for
byte).

``MAGIC | u16 version | u32 header length | JSON header | payload``: the
header holds every static field and a manifest of the array fields
(dtype name, shape, byte offset), the payload their raw little-endian
bytes. Nothing executable is read back (no pickle); a foreign magic, any
other format version, another f8 scale block or, when asked for, another
``params_version`` raises :class:`PlanFormatError`. bf16 arrays travel as
their raw 16-bit words under the dtype name ``"bfloat16"`` (numpy has no
bf16).

The reference's plan is one device's; the port's is rank-major, its
per-rank fields carrying a leading axis over the ``M`` ranks. The mapping
is defined once, here: a blob's per-rank array field is the port's with
that axis of size 1 taken off, so a serving template (whose fields are
placeholders of one rank) and a one-rank plan carry the same fields both
ways, and a plan of more ranks raises. A scalar is stored with shape
``[1]`` (the reference's ``np.ascontiguousarray`` makes every array at
least 1-d), which is the port's per-rank scalar at M = 1 as it is.
Fields that are global already (the replica placement, the signature,
the condensation map, which is flat over the ranks' tokens) travel as
they are; the plan counters, Python floats in the port, as f32 scalars.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.comm import dtypes as wire_dtypes
from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.topology import Topology
from repro_torch.condense.plan import CondensePlan, CondenseSignature
from repro_torch.plan.estimate import PlanEstimate
from repro_torch.plan.exchange import ExchangePlan, PlanSignature
from repro_torch.sched import ChunkPlan

MAGIC = b"LFPL"
FORMAT_VERSION = 4      # the reference's

# ExchangePlan array fields in the reference's serialisation order
_ARRAY_FIELDS = (
    "expert_idx", "gate_weights", "positions", "valid", "aux_loss",
    "dispatch_drop", "dest_global",
    "traffic_before", "traffic_after", "inter_bytes_flat",
    "inter_bytes_dedup", "plans_built", "plans_reused", "reuse_mismatch",
    "replica_src", "replica_valid",
)
# ... of them, the arrays that are per rank in the port (leading axis M)
_PER_RANK = frozenset({
    "expert_idx", "gate_weights", "positions", "valid", "dest_global",
    "replica_valid"})
# ... and the per-rank scalars ([M] in the port, [1] in a blob)
_RANK_SCALARS = frozenset({
    "aux_loss", "dispatch_drop", "traffic_before", "traffic_after",
    "inter_bytes_flat", "inter_bytes_dedup", "condense.rate",
    "condense.measured_pairs"})
# ... and the counters the port holds as Python floats
_COUNTERS = frozenset({"plans_built", "plans_reused", "reuse_mismatch"})
_SIG_FIELDS = ("counts", "lens", "valid")
_COND_FIELDS = ("rep_idx", "is_rep", "s_next", "rate", "measured_pairs",
                "built", "reused")
_CSIG_FIELDS = ("expert", "age", "valid")
# the reference's mesh axes of each comm mode (its host meshes' names)
_AXES = {"local": (), "flat": ("model",), "hier": ("node", "local")}


class PlanFormatError(ValueError):
    """Bytes that are not a compatible serialised ExchangePlan."""


def _np(a) -> np.ndarray:
    """A field as a contiguous numpy array of at least one dimension (bf16
    as its raw words)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    return np.ascontiguousarray(np.asarray(a))


def _one_rank(name: str, a, drop: bool):
    if a.shape[0] != 1:
        raise TypeError(f"{name} holds {a.shape[0]} ranks: a serialised "
                        f"plan is one rank's (a template, or M = 1)")
    return a[0] if drop else a


def _estimate_to_dict(est: Optional[PlanEstimate]) -> Optional[Dict]:
    if est is None:
        return None
    return {k: (int(v) if k == "chunks" else float(v))
            for k, v in est._asdict().items()}


def _comm_to_dict(comm: CommContext) -> Dict[str, Any]:
    topo = comm.topology
    return {
        "mode": comm.mode,
        "axes": list(_AXES[comm.mode]),
        "topology": None if topo is None else {
            "num_nodes": topo.num_nodes,
            "devices_per_node": topo.devices_per_node,
            "intra_bw": topo.intra_bw, "inter_bw": topo.inter_bw,
            "intra_lat": topo.intra_lat, "inter_lat": topo.inter_lat,
        },
    }


def _comm_from_dict(d: Dict[str, Any]) -> CommContext:
    t = d.get("topology")
    topo = None if t is None else Topology(**t)
    if d["mode"] == "local":
        return CommContext.local(topo)
    if topo is None:
        raise PlanFormatError(f"a {d['mode']!r} plan without a topology")
    return CommContext.build(d["mode"], topo.num_devices, topo)


def to_bytes(plan: ExchangePlan, *, params_version: str = "0") -> bytes:
    """Serialise a plan of one rank (a template, or M = 1): MAGIC, u16
    version, u32 header length, JSON header, raw array payload.
    ``params_version`` is the router fingerprint the plan was built
    against ("0" for a routing-free template)."""
    payloads: list = []
    manifest = []
    none_fields = []
    offset = 0

    def add(name: str, a) -> None:
        nonlocal offset
        bf16 = isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
        na = _np(a)
        raw = na.tobytes()
        manifest.append({"field": name,
                         "dtype": "bfloat16" if bf16 else na.dtype.name,
                         "shape": list(na.shape), "offset": offset,
                         "nbytes": len(raw)})
        payloads.append(raw)
        offset += len(raw)

    for f in _ARRAY_FIELDS:
        v = getattr(plan, f)
        if v is None:
            none_fields.append(f)
        elif f in _COUNTERS:
            add(f, np.float32(v))
        elif f in _PER_RANK or f in _RANK_SCALARS:
            add(f, _one_rank(f, v, f in _PER_RANK))
        else:
            add(f, v)
    sig = plan.signature
    if sig is None:
        none_fields.append("signature")
    else:
        for f in _SIG_FIELDS:
            add(f"signature.{f}", getattr(sig, f))
    cp = plan.condense_plan
    for f in _COND_FIELDS:
        v = getattr(cp, f)
        if v is None:
            none_fields.append(f"condense.{f}")
        elif f"condense.{f}" in _RANK_SCALARS:
            add(f"condense.{f}", _one_rank(f, v, False))
        else:
            add(f"condense.{f}", v)
    if cp.signature is None:
        none_fields.append("condense.signature")
    else:
        for f in _CSIG_FIELDS:
            add(f"condense.signature.{f}", getattr(cp.signature, f))

    header = {
        "mode": plan.mode, "migrate": bool(plan.migrate),
        "condense": bool(plan.condense), "pipelined": bool(plan.pipelined),
        "capacity": int(plan.capacity),
        "chunks": {"capacity": int(plan.chunks.capacity),
                   "sizes": [int(s) for s in plan.chunks.sizes]},
        "comm": _comm_to_dict(plan.comm),
        "objective": plan.objective,
        "group_size": int(plan.group_size),
        "combine_slack": float(plan.combine_slack),
        "use_kernel": bool(plan.use_kernel),
        "wire": plan.wire,
        "wire_dtype": plan.wire_dtype,
        "wire_scale_block": wire_dtypes.SCALE_BLOCK,
        "condense_backend": cp.backend,
        "params_version": str(params_version),
        "estimate": _estimate_to_dict(plan.estimate),
        "arrays": manifest,
        "none_fields": none_fields,
    }
    hj = json.dumps(header, sort_keys=True).encode("utf-8")
    return b"".join([MAGIC, struct.pack("<HI", FORMAT_VERSION, len(hj)),
                     hj] + payloads)


def _tensor(na: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(na.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(na.copy()).to(device)


def from_bytes(data: bytes, *, expect_params_version: Optional[str] = None,
               device="cpu") -> ExchangePlan:
    """Parse :func:`to_bytes` output (the reference's too) into a
    one-rank ExchangePlan with its arrays on ``device``. Rejects a foreign
    magic, any other format version or f8 scale block, and with
    ``expect_params_version`` a plan of another router fingerprint."""
    if len(data) < 10 or data[:4] != MAGIC:
        raise PlanFormatError("not a serialised ExchangePlan (bad magic)")
    version, hlen = struct.unpack("<HI", data[4:10])
    if version != FORMAT_VERSION:
        raise PlanFormatError(f"plan format version {version} != supported "
                              f"{FORMAT_VERSION}; rebuild the cache")
    try:
        header = json.loads(data[10:10 + hlen].decode("utf-8"))
    except Exception as e:
        raise PlanFormatError(f"corrupt plan header: {e}") from None
    if expect_params_version is not None \
            and header.get("params_version") != str(expect_params_version):
        raise PlanFormatError(
            f"plan params_version {header.get('params_version')!r} != "
            f"expected {expect_params_version!r}; rebuild the cache")
    if header["wire_scale_block"] != wire_dtypes.SCALE_BLOCK:
        raise PlanFormatError(
            f"plan f8 scale block {header['wire_scale_block']} != supported "
            f"{wire_dtypes.SCALE_BLOCK}; rebuild the cache")
    if header["migrate"]:
        raise PlanFormatError("a migrating plan is one rank's share of M: "
                              "the port's plans hold every rank")
    payload = data[10 + hlen:]
    vals: Dict[str, Any] = {}
    for rec in header["arrays"]:
        dt = np.dtype(np.int16 if rec["dtype"] == "bfloat16" else
                      rec["dtype"])
        raw = payload[rec["offset"]:rec["offset"] + rec["nbytes"]]
        if len(raw) != rec["nbytes"]:
            raise PlanFormatError("truncated plan payload")
        na = np.frombuffer(raw, dtype=dt).reshape(rec["shape"])
        vals[rec["field"]] = (na, rec["dtype"])

    none = set(header["none_fields"])

    def field(name):
        if name in none:
            return None
        na, dtn = vals[name]
        if name in _COUNTERS:
            return float(na.reshape(-1)[0])
        t = _tensor(na, dtn, device)
        return t[None] if name in _PER_RANK else t

    arr = {f: field(f) for f in _ARRAY_FIELDS}
    sig = None
    if "signature" not in none:
        sig = PlanSignature(*(vals[f"signature.{f}"][0].copy()
                              for f in _SIG_FIELDS))
    csig = None
    if "condense.signature" not in none:
        csig = CondenseSignature(*(field(f"condense.signature.{f}")
                                   for f in _CSIG_FIELDS))
    cond = CondensePlan(
        backend=header["condense_backend"], signature=csig,
        **{f: field(f"condense.{f}") for f in _COND_FIELDS})
    est = None
    if header["estimate"] is not None:
        est = PlanEstimate(**header["estimate"])
    return ExchangePlan(
        mode=header["mode"], migrate=header["migrate"],
        condense=header["condense"], pipelined=header["pipelined"],
        capacity=header["capacity"],
        chunks=ChunkPlan(header["chunks"]["capacity"],
                         tuple(header["chunks"]["sizes"])),
        comm=_comm_from_dict(header["comm"]),
        objective=header["objective"], group_size=header["group_size"],
        combine_slack=header["combine_slack"],
        use_kernel=header["use_kernel"], wire=header["wire"],
        wire_dtype=header["wire_dtype"], estimate=est, condense_plan=cond,
        signature=sig, perm=None, **arr)
