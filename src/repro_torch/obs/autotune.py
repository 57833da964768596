"""Calibration-driven configuration search (counterpart of
``repro/obs/autotune.py``).

The execution knobs (``exec_mode`` / ``pipeline_chunks``,
``plan_objective``, ``comm_mode`` / ``hier_dedup``,
``similarity_backend`` / ``lsh_bits``, ``wire_dtype``) are priced with
the estimators everything else uses (``estimate_exchange`` and
:mod:`repro_torch.sched.cost` for the exchange, ``estimate_planning_ms``
for the migration greedy, ``estimate_similarity_ms`` x the backend's
``expected_measured_pairs`` for condensation), over a small candidate
grid, under a measured :class:`~repro_torch.obs.calibrate.Calibration`
when one is given; the argmin is a versioned :class:`TunedConfig`
artifact in the reference's format. It is host arithmetic, so every
choice equals the reference's bit for bit on the same inputs.

Artifacts follow :mod:`repro_torch.obs.calibrate`: keyed by topology
fingerprint and backend (:func:`tuned_key` == ``calibration_key``),
``magic`` + ``schema_version`` + key checked on load, any mismatch a
miss. ``--autotune DIR`` on the train and serve launchers and the dry
run resolve the artifact into ``LuffyConfig`` through one function,
:func:`resolve_knobs`: an explicit flag beats the tuned artifact, which
beats the default.

Pricing conventions (shared with the dry run's ``comm_ledger``): the
dedup wire (``comm_mode="hier"`` + ``hier_dedup="on"``) ships the
per-node-deduplicated bytes, every other wire the flat payload, and a
pipelined dedup candidate prices the chunked hop's phase overlap
(``dedup_overlap_ms``); ``exec_mode="sync"`` prices ``sync_ms``, a
positive chunk count ``overlap_ms`` at that count, ``pipeline_chunks <=
0`` (the "overlap" objective's search) ``optimal_chunks``; the
similarity term is the only knob-dependent planning cost, so the search
models time, not condensation quality.

The grid lists the defaults first and a candidate wins only by strict
improvement, so the search is reproducible and never leaves the
defaults for a tie; the tuned modeled step is at most the default's by
construction. Without a calibration the FFN is priced at the card's
peak (:data:`DEFAULT_FFN_SPEED`). :func:`rerank` is the online
refinement: scale the kept candidates' phase components by measured
residual ratios and re-pick (the train launcher's
``--autotune-refine``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import (AbstractSet, Any, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.comm.topology import Topology
from repro_torch.launch.mesh import PEAK_FLOPS_BF16
from repro_torch.obs.calibrate import Calibration, calibration_key
from repro_torch.sched import cost as sched_cost

TUNED_MAGIC = "repro-tuned-config"
# v2: the knob set gained "wire_dtype"; a v1 artifact misses (schema
# drift) and the search reruns
TUNED_SCHEMA_VERSION = 2

# The LuffyConfig fields the tuner may set (and the launchers guard
# with explicit-flag precedence).
TUNABLE_KNOBS = ("comm_mode", "hier_dedup", "exec_mode",
                 "pipeline_chunks", "plan_objective",
                 "similarity_backend", "lsh_bits", "wire_dtype")

# The repo defaults, in one place: always the FIRST grid candidate, so
# ties resolve to them and `default_step_ms` is always priced.
DEFAULT_KNOBS: Dict[str, Any] = {
    "comm_mode": "flat", "hier_dedup": "off", "exec_mode": "sync",
    "pipeline_chunks": 4, "plan_objective": "traffic",
    "similarity_backend": "exact", "lsh_bits": 8, "wire_dtype": "f32",
}

# the default FFN roofline when no calibration supplies a measured speed:
# the card's bf16 tensor-core peak (launch.mesh.PEAK_FLOPS_BF16)
DEFAULT_FFN_SPEED = PEAK_FLOPS_BF16


def tuned_key(topo: Optional[Topology], M: int,
              backend: Optional[str] = None) -> str:
    """Same key form as the calibration artifact: topology fingerprint
    + the backend the model constants describe."""
    return calibration_key(topo, M, backend=backend)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One search result, bound to (topology fingerprint, backend).

    ``knobs`` is the chosen knob dict (exactly :data:`TUNABLE_KNOBS`);
    ``top`` keeps the best few candidates WITH their modeled phase
    components so :func:`rerank` can refine the choice online;
    ``workload`` records the shape the search priced (an artifact tuned
    for one workload is keyed only by fabric+backend — the launcher
    prints the workload so a cross-shape reuse is visible, and a fresh
    search is one ``--autotune-force`` away).
    """
    key: str
    knobs: Dict[str, Any]
    modeled_step_ms: float
    default_step_ms: float
    candidates: int
    calibrated: bool
    workload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    top: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    refined: bool = False
    schema_version: int = TUNED_SCHEMA_VERSION

    @property
    def modeled_savings_ms(self) -> float:
        return self.default_step_ms - self.modeled_step_ms

    def apply(self, luffy, explicit: Sequence[str] = ()) -> Any:
        """``luffy`` with every tuned knob the user did NOT set
        explicitly (``explicit``: LuffyConfig field names pinned by CLI
        flags — those always win)."""
        skip = set(explicit)
        updates = {k: v for k, v in self.knobs.items()
                   if k in TUNABLE_KNOBS and k not in skip}
        return dataclasses.replace(luffy, **updates)

    # -- serialization (the Calibration miss discipline) --------------------
    def to_json(self) -> str:
        payload = {"magic": TUNED_MAGIC, **dataclasses.asdict(self)}
        return json.dumps(payload, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str, expect_key: Optional[str] = None
                  ) -> Optional["TunedConfig"]:
        """Parse an artifact; None (a miss) on wrong magic, schema
        drift, or — with ``expect_key`` — a stale fingerprint/backend."""
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return None
        if not isinstance(payload, dict):
            return None
        if payload.pop("magic", None) != TUNED_MAGIC:
            return None
        if payload.get("schema_version") != TUNED_SCHEMA_VERSION:
            return None
        if expect_key is not None and payload.get("key") != expect_key:
            return None
        fields = {f.name for f in dataclasses.fields(cls)}
        if not fields.issubset(payload):
            return None
        try:
            return cls(**{k: payload[k] for k in fields})
        except (TypeError, ValueError):
            return None


def _artifact_path(out_dir, key: str) -> Path:
    return Path(out_dir) / f"{key}.tuned.json"


def save_tuned(out_dir, tuned: TunedConfig) -> Path:
    path = _artifact_path(out_dir, tuned.key)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(tuned.to_json())
    return path


def load_tuned(out_dir, key: str) -> Optional[TunedConfig]:
    path = _artifact_path(out_dir, key)
    if not path.exists():
        return None
    try:
        text = path.read_text()
    except OSError:
        return None
    return TunedConfig.from_json(text, expect_key=key)


# ---------------------------------------------------------------------------
# candidate grid
# ---------------------------------------------------------------------------

def candidate_grid(topo: Topology, *,
                   fixed_chunks: Sequence[int] = (2, 4, 8),
                   lsh_bits_options: Sequence[int] = (4, 8, 16)
                   ) -> List[Dict[str, Any]]:
    """Every knob combination the fabric supports, defaults first.

    Structural constraints mirror the executors: ``comm_mode="hier"``
    needs a hierarchical topology; ``hier_dedup="on"`` needs hier and
    pairs with every TRAIN exec_mode (the dedup wire is universal
    across sync/migrate/pipelined execution since DESIGN.md §15) but
    never with ``decode_overlap`` — serving forces the wire off
    (single-token decode has nothing to dedup and runs flat comm, see
    ``launch/serve.py``); ``pipeline_chunks <= 0``
    (the planned search) is tied to ``plan_objective="overlap"``
    exactly as ``resolve_pipeline_chunks`` ties them for the launchers.
    """
    wire = [("flat", "off")]
    if topo.hierarchical:
        wire += [("hier", "off"), ("hier", "on")]
    execs: List[Tuple[str, str, int]] = [("sync", "traffic", 4)]
    execs += [("pipeline", "traffic", int(n)) for n in fixed_chunks
              if int(n) > 0]
    execs += [("pipeline", "overlap", 0)]          # planned chunk search
    # decode combine/shared-FFN overlap (DESIGN.md §13): prices like
    # sync on the build/execute path, wins only through the decode_ms
    # term — so it is only ever picked for decode workloads
    # (decode_tokens > 0 with shared experts)
    execs += [("decode_overlap", "traffic", 4)]
    sims = [("exact", 8)] + [("lsh", int(b)) for b in lsh_bits_options]
    # wire precision: f32 first so ties resolve to the identity wire;
    # torch always has float8_e4m3fn, so f8 is always offered
    wds = ["f32", "bf16", "f8e4m3"]
    out: List[Dict[str, Any]] = []
    for cm, hd in wire:
        for em, obj, nc in execs:
            if hd == "on" and em == "decode_overlap":
                continue        # serving runs flat comm — no dedup wire
            for wd in wds:
                for sb, bits in sims:
                    out.append({"comm_mode": cm, "hier_dedup": hd,
                                "exec_mode": em, "plan_objective": obj,
                                "pipeline_chunks": nc,
                                "similarity_backend": sb, "lsh_bits": bits,
                                "wire_dtype": wd})
    assert out[0] == DEFAULT_KNOBS
    return out


# ---------------------------------------------------------------------------
# the modeled step
# ---------------------------------------------------------------------------

def modeled_step_components(knobs: Mapping[str, Any], *,
                            topo: Topology, tokens: int, top_k: int,
                            d_model: int, d_ff: int, num_layers: int,
                            n_moe: int, n_slots: int,
                            num_experts: Optional[int] = None,
                            mesh_devices: Optional[int] = None,
                            group_size: int = 128, r_cond: float = 0.0,
                            plan_reuse: str = "off",
                            condense_reuse: str = "off",
                            calib: Optional[Calibration] = None,
                            ffn_speed: float = DEFAULT_FFN_SPEED,
                            decode_tokens: int = 0,
                            d_ff_shared: int = 0) -> Dict[str, float]:
    """Price one candidate: the per-phase components and their total.

    Returns ``{"dispatch_ms", "combine_ms", "ffn_ms", "exchange_ms",
    "chunks", "planning_ms", "similarity_ms", "decode_ms",
    "total_ms"}`` — all host-side floats under the calibrated constants
    when ``calib`` is given. ``mesh_devices`` is the full mesh size
    (data × model) the per-device similarity work divides over;
    defaults to the expert devices ``topo.num_devices``.

    ``decode_tokens`` > 0 adds the decode-step term (DESIGN.md §13):
    per MoE sublayer, one [decode_tokens, d_model] combine all-reduce
    plus the shared-expert FFN (``d_ff_shared`` = total shared hidden
    width), overlapped into ``max`` of the two when the candidate's
    ``exec_mode`` is ``"decode_overlap"`` and summed otherwise. Train
    workloads leave it 0, so the term vanishes and the grid behaves
    exactly as before (ties still resolve to the defaults).
    """
    from repro_torch.condense.backends import expected_measured_pairs
    from repro_torch.plan.estimate import (PLAN_STEP_US,
                                           estimate_exchange,
                                           estimate_planning_ms,
                                           estimate_similarity_ms)
    M = topo.num_devices
    devices = mesh_devices or M
    speed = calib.ffn_speed if calib is not None else ffn_speed
    est_kw = calib.estimate_kwargs() if calib is not None else {}
    overhead = sched_cost.resolve_chunk_overhead_ms(
        est_kw.pop("chunk_overhead_ms", None))
    ffn_ms = (tokens * (1.0 - r_cond) * top_k * 4.0 * d_model * d_ff
              * num_layers / (speed * M) * 1e3)
    est = estimate_exchange(tokens, top_k, d_model, topo=topo,
                            r_cond=r_cond, num_layers=num_layers,
                            ffn_ms=ffn_ms, chunks=1,
                            chunk_overhead_ms=overhead,
                            wire_dtype=knobs.get("wire_dtype", "f32"),
                            **est_kw)
    dedup_wire = (knobs["comm_mode"] == "hier"
                  and knobs["hier_dedup"] == "on")
    d_ms = est.dispatch_ms if dedup_wire else est.flat_dispatch_ms
    c_ms = d_ms                        # locality 0: combine == dispatch
    kw = dict(dispatch_ms=d_ms, ffn_ms=ffn_ms, combine_ms=c_ms,
              chunk_overhead_ms=overhead)
    if knobs["exec_mode"] in ("sync", "decode_overlap"):
        # decode_overlap chunks/prices the build/execute exchange like
        # sync — it only reschedules the decode combine (decode_ms)
        chunks, exchange_ms = 1, sched_cost.sync_ms(topo, **kw)
    elif dedup_wire:
        # pipelined dedup wire (DESIGN.md §15): chunking the unique-row
        # capacity lets the hop's intra-node fan-out / pre-reduce hide
        # behind the next chunk's inter-node leg — price it with the
        # same estimator the plan builder freezes (dedup_overlap_ms)
        nc = int(knobs["pipeline_chunks"])
        est_p = estimate_exchange(tokens, top_k, d_model, topo=topo,
                                  r_cond=r_cond, num_layers=num_layers,
                                  ffn_ms=ffn_ms,
                                  chunks=nc if nc > 0 else None,
                                  chunk_overhead_ms=overhead,
                                  wire_dtype=knobs.get("wire_dtype",
                                                       "f32"),
                                  **est_kw)
        chunks, exchange_ms = est_p.chunks, est_p.dedup_overlap_ms
    elif int(knobs["pipeline_chunks"]) > 0:
        chunks = int(knobs["pipeline_chunks"])
        exchange_ms = sched_cost.overlap_ms(topo, chunks, **kw)
    else:                              # planned search (overlap objective)
        chunks, exchange_ms = sched_cost.optimal_chunks(topo, **kw)

    step_us = calib.plan_step_us if calib is not None else PLAN_STEP_US
    built = n_moe if plan_reuse == "off" else min(1, n_moe)
    planning_ms = built * estimate_planning_ms(n_slots, M,
                                               step_us=step_us)
    sim_kw = ({"speed": calib.sim_speed} if calib is not None else {})
    G = max(1, min(group_size, tokens))
    E = num_experts if num_experts else M   # one-expert-per-device default
    pairs_local = expected_measured_pairs(
        max(1, tokens // devices), G, num_experts=max(1, E),
        backend=knobs["similarity_backend"],
        lsh_bits=int(knobs["lsh_bits"]))
    c_built = n_moe if condense_reuse == "off" else min(1, n_moe)
    similarity_ms = c_built * estimate_similarity_ms(
        pairs_local, d_model, **sim_kw)
    decode_ms = 0.0
    if decode_tokens > 0:
        dec_combine = sched_cost.decode_combine_ms(decode_tokens, d_model,
                                                   topo)
        shared_ffn = (decode_tokens * 4.0 * d_model * d_ff_shared
                      / speed * 1e3)
        decode_ms = sched_cost.decode_step_ms(
            combine_ms=dec_combine, shared_ffn_ms=shared_ffn,
            overlap=knobs["exec_mode"] == "decode_overlap") * n_moe
    total = exchange_ms + planning_ms + similarity_ms + decode_ms
    return {"dispatch_ms": d_ms, "combine_ms": c_ms, "ffn_ms": ffn_ms,
            "exchange_ms": exchange_ms, "chunks": float(chunks),
            "planning_ms": planning_ms, "similarity_ms": similarity_ms,
            "decode_ms": decode_ms, "total_ms": total}


def _exchange_ms_for(knobs: Mapping[str, Any], topo: Topology, *,
                     dispatch_ms: float, ffn_ms: float,
                     combine_ms: float, chunk_overhead_ms: float
                     ) -> float:
    """Re-price one candidate's exchange from (possibly rescaled) phase
    components — the :func:`rerank` kernel."""
    kw = dict(dispatch_ms=dispatch_ms, ffn_ms=ffn_ms,
              combine_ms=combine_ms,
              chunk_overhead_ms=chunk_overhead_ms)
    if knobs["exec_mode"] in ("sync", "decode_overlap"):
        return sched_cost.sync_ms(topo, **kw)
    if int(knobs["pipeline_chunks"]) > 0:
        return sched_cost.overlap_ms(topo, int(knobs["pipeline_chunks"]),
                                     **kw)
    return sched_cost.optimal_chunks(topo, **kw)[1]


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def autotune_config(*, topo: Topology, tokens: int, top_k: int,
                    d_model: int, d_ff: int, num_layers: int,
                    n_moe: Optional[int] = None,
                    n_slots: Optional[int] = None,
                    num_experts: Optional[int] = None,
                    mesh_devices: Optional[int] = None,
                    group_size: int = 128, r_cond: float = 0.0,
                    plan_reuse: str = "off",
                    condense_reuse: str = "off",
                    calib: Optional[Calibration] = None,
                    ffn_speed: float = DEFAULT_FFN_SPEED,
                    decode_tokens: int = 0, d_ff_shared: int = 0,
                    key: Optional[str] = None,
                    backend: Optional[str] = None,
                    grid: Optional[List[Dict[str, Any]]] = None,
                    top_n: int = 5) -> TunedConfig:
    """Brute-force argmin of the modeled step over the candidate grid.

    Strict-improvement selection in grid order (defaults first) makes
    the result deterministic and tie-stable."""
    n_moe = num_layers if n_moe is None else n_moe
    n_slots = topo.num_devices if n_slots is None else n_slots
    if key is None:
        key = tuned_key(topo, topo.num_devices, backend=backend)
    if grid is None:
        grid = candidate_grid(topo)
    model_kw = dict(topo=topo, tokens=tokens, top_k=top_k,
                    d_model=d_model, d_ff=d_ff, num_layers=num_layers,
                    n_moe=n_moe, n_slots=n_slots,
                    num_experts=num_experts,
                    mesh_devices=mesh_devices, group_size=group_size,
                    r_cond=r_cond, plan_reuse=plan_reuse,
                    condense_reuse=condense_reuse, calib=calib,
                    ffn_speed=ffn_speed, decode_tokens=decode_tokens,
                    d_ff_shared=d_ff_shared)
    scored: List[Dict[str, Any]] = []
    for knobs in grid:
        comp = modeled_step_components(knobs, **model_kw)
        scored.append({"knobs": dict(knobs), "components": comp,
                       "modeled_ms": comp["total_ms"]})
    default_ms = scored[0]["modeled_ms"]    # defaults lead the grid
    best = scored[0]
    for cand in scored[1:]:
        if cand["modeled_ms"] < best["modeled_ms"] - 1e-12:
            best = cand
    top = sorted(scored, key=lambda c: c["modeled_ms"])[:max(1, top_n)]
    workload = {"tokens": tokens, "top_k": top_k, "d_model": d_model,
                "d_ff": d_ff, "num_layers": num_layers, "n_moe": n_moe,
                "n_slots": n_slots, "num_experts": num_experts,
                "group_size": group_size, "r_cond": r_cond,
                "decode_tokens": decode_tokens,
                "d_ff_shared": d_ff_shared}
    return TunedConfig(
        key=key, knobs=dict(best["knobs"]),
        modeled_step_ms=best["modeled_ms"],
        default_step_ms=default_ms, candidates=len(scored),
        calibrated=calib is not None,
        # canonicalize so the in-memory result equals its round trip
        workload=json.loads(json.dumps(workload)),
        top=json.loads(json.dumps(top)))


def run_autotune(*, topo: Topology, out_dir=None, force: bool = False,
                 backend: Optional[str] = None,
                 **search_kw) -> TunedConfig:
    """Load-before-search: return the persisted artifact for this
    fabric+backend when one validates, else search and persist (the
    PlanCache / run_calibration discipline). ``force`` re-searches and
    overwrites."""
    key = tuned_key(topo, topo.num_devices, backend=backend)
    if out_dir is not None and not force:
        cached = load_tuned(out_dir, key)
        if cached is not None:
            return cached
    tuned = autotune_config(topo=topo, key=key, **search_kw)
    if out_dir is not None:
        save_tuned(out_dir, tuned)
    return tuned


# ---------------------------------------------------------------------------
# online refinement
# ---------------------------------------------------------------------------

def rerank(tuned: TunedConfig, ratios: Mapping[str, float], *,
           topo: Topology,
           chunk_overhead_ms: float = -1.0) -> TunedConfig:
    """Re-rank the stored top candidates under measured residuals.

    ``ratios`` maps residual phases (``repro_torch.obs.monitor``) to measured
    / predicted factors: ``dispatch`` / ``combine`` / ``expert_ffn``
    scale that component; a ``step`` ratio scales all three (the
    per-step signal the train warmup loop has). Planning and similarity
    terms are host-side and keep their modeled values. Returns a new
    ``TunedConfig`` (``refined=True``) whose knobs are the re-ranked
    winner — possibly unchanged."""
    if not tuned.top:
        return tuned
    overhead = sched_cost.resolve_chunk_overhead_ms(chunk_overhead_ms)
    common = float(ratios.get("step", 1.0))
    r_d = float(ratios.get("dispatch", 1.0)) * common
    r_f = float(ratios.get("expert_ffn", 1.0)) * common
    r_c = float(ratios.get("combine", 1.0)) * common
    best = None
    best_ms = None
    for cand in tuned.top:
        comp = cand["components"]
        ex = _exchange_ms_for(cand["knobs"], topo,
                              dispatch_ms=comp["dispatch_ms"] * r_d,
                              ffn_ms=comp["ffn_ms"] * r_f,
                              combine_ms=comp["combine_ms"] * r_c,
                              chunk_overhead_ms=overhead)
        # decode_ms keeps its modeled value (host-side; absent on
        # artifacts persisted before the decode term existed)
        total = (ex + comp["planning_ms"] + comp["similarity_ms"]
                 + comp.get("decode_ms", 0.0))
        if best_ms is None or total < best_ms - 1e-12:
            best, best_ms = cand, total
    return dataclasses.replace(
        tuned, knobs=dict(best["knobs"]), modeled_step_ms=best_ms,
        refined=True)


# ---------------------------------------------------------------------------
# knob resolution
# ---------------------------------------------------------------------------

def resolve_knobs(cli: Mapping[str, Any],
                  tuned: Optional[TunedConfig] = None, *,
                  tunable: AbstractSet[str] = frozenset(TUNABLE_KNOBS),
                  comm_mode: Optional[str] = None) -> Dict[str, Any]:
    """Every knob of :data:`TUNABLE_KNOBS`: an explicit flag (``cli``: knob
    -> value, None where the flag was not given) beats the ``tuned``
    artifact's choice (only for knobs in ``tunable``), which beats
    :data:`DEFAULT_KNOBS`. ``comm_mode`` given pins the wire structurally
    (the dry run's mesh decides it). The dedup wire needs hier comm, so a
    ``hier_dedup="on"`` that no flag set falls back to "off" on a flat
    wire; an unset ``pipeline_chunks`` follows the objective
    (``resolve_pipeline_chunks``). The launchers' precedence, in one
    place."""
    from repro_torch.config import resolve_pipeline_chunks
    explicit = {k for k, v in cli.items() if v is not None}
    knobs: Dict[str, Any] = dict(DEFAULT_KNOBS)
    knobs["pipeline_chunks"] = None    # sentinel: resolve by objective
    if tuned is not None:
        knobs.update({k: v for k, v in tuned.knobs.items()
                      if k in tunable and k not in explicit})
    knobs.update({k: cli[k] for k in explicit})
    if comm_mode is not None:
        knobs["comm_mode"] = comm_mode
    if "hier_dedup" not in explicit and knobs["hier_dedup"] == "on" \
            and knobs["comm_mode"] != "hier":
        knobs["hier_dedup"] = "off"
    if knobs["pipeline_chunks"] is None:
        knobs["pipeline_chunks"] = resolve_pipeline_chunks(
            None, knobs["plan_objective"])
    return knobs
