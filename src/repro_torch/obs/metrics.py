"""Unified metrics registry (counterpart of ``repro/obs/metrics.py``,
the same names, kinds and records).

The same quantities live under three naming schemes: the
``MoEAux``-derived dict ``forward_train`` returns (``plans_built``,
``inter_bytes_shipped``, …), the optimizer metrics (``grad_norm``,
``lr``), and the dryrun ``comm_ledger`` sections. The
registry maps every known legacy key onto one canonical
``group/name`` scheme, distinguishes **gauges** (per-step values) from
**counters** (per-step increments that also accumulate into a
cumulative view), and emits one JSONL record per step that benchmarks
and CI consume directly.

Applicability masking: some legacy keys are only *populated* under a
specific config — ``inter_bytes_shipped`` is computed only when
``hier_dedup="on"``; in every other mode the aux slot is numerically
``0.0``, which a dashboard would read as "zero bytes shipped" rather
than "dense wire, nothing measured". :func:`mask_inapplicable` (and
:meth:`MetricsRegistry.observe`, which applies it) reports such keys as
``None`` (JSON ``null``) when their requirement is not met.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

# Version of the per-step metrics JSONL record (bump on renames or
# structural changes).
METRICS_SCHEMA_VERSION = 1

# Version of the reference's dryrun comm-traffic ledger JSON (the
# port's modeled dryrun is still to come). v2 added the field itself,
# v3 the ``autotune`` section, v4 ``decode``, v5 ``wire`` (wire_dtype
# precision; bucket bytes priced at the run's wire dtype), v6 the
# shipped inter-node bytes of each execution mode in ``wire``.
COMM_LEDGER_SCHEMA_VERSION = 6


class MetricSpec(NamedTuple):
    """One canonical metric: its unified name, kind, the legacy keys it
    absorbs, and an optional config requirement gating applicability."""
    name: str                      # canonical "group/name"
    kind: str                      # "gauge" | "counter"
    legacy: Tuple[str, ...]        # raw dict keys mapped onto this
    unit: str = ""
    requires: Optional[str] = None  # key into _REQUIREMENTS, or None


# Config predicates for MetricSpec.requires. A metric whose predicate
# fails is *inapplicable*: reported as None, never accumulated.
_REQUIREMENTS = {
    "hier": lambda luffy: luffy is not None and luffy.comm_mode == "hier",
    "hier_dedup": lambda luffy: (luffy is not None
                                 and luffy.hier_dedup == "on"),
}


_SPECS = (
    MetricSpec("train/loss", "gauge", ("loss",)),
    MetricSpec("train/total_loss", "gauge", ("total_loss",)),
    MetricSpec("train/aux_loss", "gauge", ("aux_loss",)),
    MetricSpec("train/grad_norm", "gauge", ("grad_norm",)),
    MetricSpec("train/lr", "gauge", ("lr",)),
    MetricSpec("moe/dispatch_drop", "gauge", ("dispatch_drop",), "frac"),
    MetricSpec("moe/combine_drop", "gauge", ("combine_drop",), "frac"),
    MetricSpec("condense/rate", "gauge", ("condense_rate",), "frac"),
    MetricSpec("migrate/local_frac", "gauge", ("local_frac",), "frac"),
    MetricSpec("migrate/traffic_before", "gauge", ("traffic_before",),
               "rows"),
    MetricSpec("migrate/traffic_after", "gauge", ("traffic_after",),
               "rows"),
    MetricSpec("comm/inter_bytes_flat", "counter", ("inter_bytes_flat",),
               "bytes", "hier"),
    MetricSpec("comm/inter_bytes_dedup", "counter", ("inter_bytes_dedup",),
               "bytes", "hier"),
    MetricSpec("comm/inter_bytes_shipped", "counter",
               ("inter_bytes_shipped",), "bytes", "hier_dedup"),
    MetricSpec("plan/built", "counter", ("plans_built",)),
    MetricSpec("plan/reused", "counter", ("plans_reused",)),
    MetricSpec("plan/reuse_mismatch", "counter", ("plan_reuse_mismatch",
                                                  "reuse_mismatch")),
    MetricSpec("condense/measured_pairs", "counter", ("measured_pairs",),
               "pairs"),
    MetricSpec("condense/built", "counter", ("condense_built",)),
    MetricSpec("condense/reused", "counter", ("condense_reused",)),
    MetricSpec("step/time_s", "gauge", ("time_s", "step_time_s"), "s"),
    MetricSpec("step/bucket", "gauge", ("bucket",)),
) + tuple(
    # Residual-stream gauges (obs/monitor.py): one
    # predicted/measured/ratio triple per instrumented phase.
    MetricSpec(f"residual/{phase}/{field}", "gauge",
               (f"residual_{phase}_{field}",), unit)
    for phase in ("plan_build", "dispatch", "expert_ffn", "combine",
                  "step")
    for field, unit in (("predicted_ms", "ms"), ("measured_ms", "ms"),
                        ("ratio", "x"))
) + (
    MetricSpec("residual/drift", "gauge", ("residual_drift",)),
    MetricSpec("residual/device_dispersion", "gauge",
               ("residual_device_dispersion",), "x"),
) + (
    # Serving SLOs + scheduler occupancy (serve/scheduler.py):
    # per-step rows from launch/serve.py --continuous. The SLO gauges
    # are means over the requests that FINISHED that step (absent keys
    # stay inapplicable-None under the masking rule).
    MetricSpec("serve/queue_ms", "gauge", ("queue_ms",), "ms"),
    MetricSpec("serve/ttft_ms", "gauge", ("ttft_ms",), "ms"),
    MetricSpec("serve/tpot_ms", "gauge", ("tpot_ms",), "ms"),
    MetricSpec("serve/active_slots", "gauge", ("active_slots",)),
    MetricSpec("serve/queued", "gauge", ("queued_requests",)),
    MetricSpec("serve/admitted", "counter", ("admitted",)),
    MetricSpec("serve/finished", "counter", ("finished",)),
    MetricSpec("serve/generated_tokens", "counter", ("generated_tokens",),
               "tokens"),
    MetricSpec("serve/slot_churn", "counter", ("slot_churn",)),
)

SCHEMA: Dict[str, MetricSpec] = {s.name: s for s in _SPECS}
_LEGACY: Dict[str, MetricSpec] = {
    legacy: s for s in _SPECS for legacy in s.legacy}


def canonical_name(legacy_key: str) -> str:
    """The unified name for a legacy metrics-dict key (unknown keys map
    to themselves — they pass through records verbatim)."""
    spec = _LEGACY.get(legacy_key)
    return spec.name if spec is not None else legacy_key


def applicable(spec: MetricSpec, luffy) -> bool:
    if spec.requires is None:
        return True
    return _REQUIREMENTS[spec.requires](luffy)


def mask_inapplicable(raw: Dict[str, Any], luffy) -> Dict[str, Any]:
    """Replace values of config-gated legacy keys with ``None`` when the
    gating config is off (the ``inter_bytes_shipped`` fix: a dense-wire
    run reports null, not 0 bytes). Operates on *legacy* names so the
    launchers can apply it before or instead of full canonicalization."""
    out = dict(raw)
    for key, value in raw.items():
        spec = _LEGACY.get(key)
        if spec is not None and not applicable(spec, luffy):
            out[key] = None
    return out


def _to_float(v):
    if v is None or isinstance(v, (bool, str)):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricsRegistry:
    """Per-step metric canonicalizer + counter accumulator.

    ``observe(step, raw)`` maps a raw legacy metrics dict to one JSONL
    record: values under canonical names (inapplicable ones ``None``),
    plus a ``cumulative`` view of every counter observed so far.
    """

    def __init__(self, *, luffy=None, run_info: Optional[Dict[str, Any]]
                 = None):
        self.luffy = luffy
        self.run_info = dict(run_info or {})
        self.cumulative: Dict[str, float] = {}
        self.steps_observed = 0

    def observe(self, step: int, raw: Dict[str, Any],
                **extra) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {}
        for key, value in {**raw, **extra}.items():
            spec = _LEGACY.get(key)
            if spec is None:
                metrics[key] = _to_float(value)
                continue
            if not applicable(spec, self.luffy):
                metrics[spec.name] = None
                continue
            value = _to_float(value)
            metrics[spec.name] = value
            if spec.kind == "counter" and isinstance(value, float):
                self.cumulative[spec.name] = (
                    self.cumulative.get(spec.name, 0.0) + value)
        self.steps_observed += 1
        record = {"schema_version": METRICS_SCHEMA_VERSION,
                  "step": int(step), "metrics": metrics,
                  "cumulative": dict(self.cumulative)}
        if self.run_info and self.steps_observed == 1:
            record["run"] = dict(self.run_info)
        return record


def write_jsonl(path, record: Dict[str, Any]) -> None:
    """Append one record as a JSON line (creating parent dirs).

    The whole line goes out in a single ``os.write`` on an
    ``O_APPEND`` descriptor: a run killed mid-stream leaves a valid
    JSONL *prefix* plus at most one torn final line, which
    :func:`read_jsonl` skips — no record is ever half-applied across
    two lines."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    line = (json.dumps(record) + "\n").encode("utf-8")
    fd = os.open(str(p), os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, line)
    finally:
        os.close(fd)


def read_jsonl(path) -> list:
    """Every complete record of a (possibly truncated) JSONL file.

    Parses record-by-record and stops at the first undecodable line —
    the torn tail a killed writer leaves — so crash artifacts are
    readable up to the last whole record."""
    out = []
    try:
        data = Path(path).read_bytes()
    except OSError:
        return out
    for raw in data.split(b"\n"):
        if not raw.strip():
            continue
        try:
            out.append(json.loads(raw.decode("utf-8")))
        except (ValueError, UnicodeDecodeError):
            break
    return out


def flatten(prefix: str, nested: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a nested dict (e.g. the dryrun ledger) into
    ``prefix/key/subkey`` scalars for a metrics record."""
    out: Dict[str, Any] = {}
    for key, value in nested.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(name, value))
        else:
            out[name] = value
    return out
