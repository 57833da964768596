"""Observability (counterpart of ``repro/obs``), three of its five
layers:

* :mod:`repro_torch.obs.trace`: host-timed spans, fenced by a device
  synchronize under ``--trace``, with Chrome-trace / Perfetto export
  (``--trace`` / ``--trace-out`` on both launchers);
* :mod:`repro_torch.obs.metrics`: one registry of canonical metric
  names, counters and gauges, applicability masking and crash-safe
  JSONL (``--metrics-json``);
* :mod:`repro_torch.obs.monitor`: the predicted-vs-measured residual
  stream and its EWMA drift detector (``--drift-tolerance``,
  ``--drift-k`` on the train launcher).

Calibration and autotuning are not ported yet (ROADMAP Queue 1 item
10).
"""
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
    "COMM_LEDGER_SCHEMA_VERSION", "METRICS_SCHEMA_VERSION",
    "MetricsRegistry", "MetricSpec", "SCHEMA", "canonical_name", "flatten",
    "mask_inapplicable", "read_jsonl", "write_jsonl", "DEVICE_TID_BASE",
    "NULL_SPAN", "Tracer", "activate", "active", "deactivate", "phase",
    "RESIDUAL_PHASES", "DriftDetector", "ResidualMonitor",
    "device_dispersion", "measured_phase_ms", "predicted_phase_ms",
]
