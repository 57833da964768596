"""Observability (counterpart of ``repro/obs``), five layers:

* :mod:`repro_torch.obs.trace`: host-timed spans, fenced by a device
  synchronize under ``--trace``, with Chrome-trace / Perfetto export
  (``--trace`` / ``--trace-out`` on both launchers);
* :mod:`repro_torch.obs.metrics`: one registry of canonical metric
  names, counters and gauges, applicability masking and crash-safe
  JSONL (``--metrics-json``);
* :mod:`repro_torch.obs.calibrate`: measured cost-model constants (the
  virtual ranks' collectives, chunk overhead, the planner's step, K2's
  and K1's speeds) kept as a versioned artifact keyed by topology
  fingerprint and backend (``--calibrate``);
* :mod:`repro_torch.obs.monitor`: the predicted-vs-measured residual
  stream and its EWMA drift detector (``--drift-tolerance``,
  ``--drift-k``, ``--recalibrate-on-drift`` on the train launcher);
* :mod:`repro_torch.obs.autotune`: the calibration-driven knob search,
  a versioned ``TunedConfig`` artifact that ``--autotune`` resolves
  into ``LuffyConfig`` (an explicit flag always wins).
"""
from repro_torch.obs.autotune import (DEFAULT_KNOBS, TUNABLE_KNOBS,
                                      TUNED_SCHEMA_VERSION, TunedConfig,
                                      autotune_config, candidate_grid,
                                      load_tuned, modeled_step_components,
                                      rerank, resolve_knobs, run_autotune,
                                      save_tuned, tuned_key)
from repro_torch.obs.calibrate import (CALIBRATION_SCHEMA_VERSION,
                                       Calibration, calibration_key,
                                       load_calibration, probe_exchange,
                                       probe_exchange_per_device,
                                       run_calibration, save_calibration)
from repro_torch.obs.metrics import (COMM_LEDGER_SCHEMA_VERSION,
                                     METRICS_SCHEMA_VERSION, MetricsRegistry,
                                     MetricSpec, SCHEMA, canonical_name,
                                     flatten, mask_inapplicable, read_jsonl,
                                     write_jsonl)
from repro_torch.obs.monitor import (RESIDUAL_PHASES, DriftDetector,
                                     ResidualMonitor, device_dispersion,
                                     measured_phase_ms, predicted_phase_ms)
from repro_torch.obs.trace import (DEVICE_TID_BASE, NULL_SPAN, Tracer,
                                   activate, active, deactivate, phase)

__all__ = [
    "CALIBRATION_SCHEMA_VERSION", "Calibration", "calibration_key",
    "load_calibration", "probe_exchange", "probe_exchange_per_device",
    "run_calibration", "save_calibration", "COMM_LEDGER_SCHEMA_VERSION", "METRICS_SCHEMA_VERSION",
    "MetricsRegistry", "MetricSpec", "SCHEMA", "canonical_name", "flatten",
    "mask_inapplicable", "read_jsonl", "write_jsonl", "DEVICE_TID_BASE",
    "NULL_SPAN", "Tracer", "activate", "active", "deactivate", "phase",
    "RESIDUAL_PHASES", "DriftDetector", "ResidualMonitor",
    "device_dispersion", "measured_phase_ms", "predicted_phase_ms",
    "DEFAULT_KNOBS", "TUNABLE_KNOBS", "TUNED_SCHEMA_VERSION", "TunedConfig",
    "autotune_config", "candidate_grid", "load_tuned",
    "modeled_step_components", "rerank", "resolve_knobs", "run_autotune",
    "save_tuned", "tuned_key",
]
