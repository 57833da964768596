"""Predicted-vs-measured residual monitoring and drift detection
(counterpart of ``repro/obs/monitor.py``).

Every executed plan carries a :class:`repro_torch.plan.estimate.PlanEstimate`
(what the cost model *predicted*), the tracer records fenced phase spans
(what *happened*), and the metrics registry publishes both. This module
joins them:

* :func:`predicted_phase_ms` maps a ``PlanEstimate`` onto the traced
  phase names (``dispatch`` / ``expert_ffn`` / ``combine`` and the
  whole-sublayer ``step``), so predictions and measurements share one
  key space;
* :func:`measured_phase_ms` aggregates a tracer's completed spans into
  mean per-phase milliseconds under the same names;
* :class:`ResidualMonitor` joins the two streams per step, publishes
  the canonical ``residual/<phase>/{predicted_ms,measured_ms,ratio}``
  gauges (plus ``residual/device_dispersion`` — max/median of
  per-device probe times, the straggler signal) through the metrics
  registry's legacy-key mapping, and runs one EWMA
  :class:`DriftDetector` per phase.

Drift semantics: each step updates an EWMA of ``log(measured /
predicted)``; a step is *out of tolerance* when ``|ewma| >
log(tolerance)``, and the detector **fires** after ``k`` consecutive
out-of-tolerance steps — a single straggler step never flags a stale
calibration, a sustained 2× bandwidth degradation does within a few
steps of the EWMA crossing. The train launcher feeds the step
detector its measured step time against the mean of a short warm-up.

Everything here is host-side float arithmetic: the monitor never
touches device values and adds nothing to the step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Optional

# The phase names shared between PlanEstimate fields and the tracer's
# instrumented spans ("step" is the whole exchange: sync or pipelined).
RESIDUAL_PHASES = ("plan_build", "dispatch", "expert_ffn", "combine",
                   "step")

_EPS_MS = 1e-9


def predicted_phase_ms(est, *, pipelined: bool = False
                       ) -> Dict[str, float]:
    """A :class:`~repro_torch.plan.estimate.PlanEstimate` keyed by the traced
    phase names — the join key of the residual stream. ``step`` is the
    modeled whole-sublayer time under the executed schedule
    (``overlap_ms`` when pipelined, ``sync_ms`` otherwise)."""
    return {
        "dispatch": float(est.dispatch_ms),
        "expert_ffn": float(est.ffn_ms),
        "combine": float(est.combine_ms),
        "step": float(est.overlap_ms if pipelined else est.sync_ms),
    }


def measured_phase_ms(tracer, phases: Iterable[str] = RESIDUAL_PHASES
                      ) -> Dict[str, float]:
    """Mean inclusive milliseconds per phase name from a tracer's
    completed spans (fenced spans: real device time). Phases that never
    fired are absent, not zero."""
    summary = tracer.summary()
    out: Dict[str, float] = {}
    for name in phases:
        s = summary.get(name)
        if s and s["count"] > 0:
            out[name] = s["total_us"] / s["count"] / 1e3
    return out


class DriftDetector:
    """EWMA drift detector on the log residual ratio of ONE phase.

    ``update(ratio)`` folds ``log(ratio)`` into an exponentially
    weighted mean (initialized at the first sample, so the EWMA is
    always a convex combination of observed log-ratios: samples that
    all stay within tolerance can NEVER push it out — the
    no-false-positive property). Returns True — *fired* — once
    ``consecutive`` out-of-tolerance steps reach ``k``; ``fired``
    latches until :meth:`reset`.
    """

    def __init__(self, *, tolerance: float = 1.5,
                 ewma_alpha: float = 0.5, k: int = 5):
        assert tolerance > 1.0 and 0.0 < ewma_alpha <= 1.0 and k >= 1
        self.tolerance = float(tolerance)
        self.log_tol = math.log(tolerance)
        self.alpha = float(ewma_alpha)
        self.k = int(k)
        self.reset()

    def reset(self) -> None:
        self.ewma = 0.0
        self.samples = 0
        self.consecutive = 0
        self.fired = False

    @property
    def ewma_ratio(self) -> float:
        return math.exp(self.ewma)

    @property
    def out_of_tolerance(self) -> bool:
        return self.samples > 0 and abs(self.ewma) > self.log_tol

    def update(self, ratio: float) -> bool:
        x = math.log(max(float(ratio), 1e-9))
        self.samples += 1
        self.ewma = x if self.samples == 1 else (
            (1.0 - self.alpha) * self.ewma + self.alpha * x)
        if self.out_of_tolerance:
            self.consecutive += 1
        else:
            self.consecutive = 0
        if self.consecutive >= self.k:
            self.fired = True
        return self.fired


class ResidualMonitor:
    """Per-step join of predicted vs measured phase times.

    ``observe(step, predicted_ms, measured_ms)`` emits one flat dict of
    *legacy* residual keys (``residual_<phase>_predicted_ms`` /
    ``_measured_ms`` / ``_ratio`` plus ``residual_drift`` /
    ``residual_device_dispersion``) — exactly what
    ``MetricsRegistry.observe(step, raw, **extra)`` canonicalizes into
    the ``residual/...`` schema — and feeds each phase's ratio into its
    drift detector. Only phases present in BOTH streams produce
    residuals; prediction without measurement (or vice versa) is
    silence, not zero.
    """

    def __init__(self, *, tolerance: float = 1.5,
                 ewma_alpha: float = 0.5, k: int = 5,
                 phases: Iterable[str] = RESIDUAL_PHASES):
        self.phases = tuple(phases)
        self.detectors: Dict[str, DriftDetector] = {
            p: DriftDetector(tolerance=tolerance, ewma_alpha=ewma_alpha,
                             k=k) for p in self.phases}

    def reset(self) -> None:
        for d in self.detectors.values():
            d.reset()

    @property
    def drifted(self) -> bool:
        return any(d.fired for d in self.detectors.values())

    def drifted_phases(self) -> tuple:
        return tuple(p for p, d in self.detectors.items() if d.fired)

    def observe(self, step: int, predicted_ms: Mapping[str, float],
                measured_ms: Mapping[str, float],
                per_device_ms: Optional[Mapping[Any, float]] = None
                ) -> Dict[str, Any]:
        del step                       # kept for call-site symmetry
        out: Dict[str, Any] = {}
        for phase in self.phases:
            pred = predicted_ms.get(phase)
            meas = measured_ms.get(phase)
            if pred is None or meas is None:
                continue
            ratio = float(meas) / max(float(pred), _EPS_MS)
            out[f"residual_{phase}_predicted_ms"] = float(pred)
            out[f"residual_{phase}_measured_ms"] = float(meas)
            out[f"residual_{phase}_ratio"] = ratio
            self.detectors[phase].update(ratio)
        if per_device_ms:
            out["residual_device_dispersion"] = device_dispersion(
                per_device_ms)
        out["residual_drift"] = 1.0 if self.drifted else 0.0
        return out


def device_dispersion(per_device_ms: Mapping[Any, float]) -> float:
    """Straggler signal: max over median of per-device phase times. 1.0
    means perfectly balanced devices; 2.0 means the slowest device took
    twice the median — the Perfetto per-device rows (`Tracer.to_chrome`)
    show *which* one."""
    vals = sorted(float(v) for v in per_device_ms.values())
    if not vals:
        return 1.0
    mid = vals[len(vals) // 2] if len(vals) % 2 else (
        0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]))
    return vals[-1] / max(mid, _EPS_MS)
