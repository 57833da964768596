"""Step tracing: host-timed spans and Chrome-trace export (counterpart
of ``repro/obs/trace.py``).

A :class:`Tracer` records **host-timed spans**, begin/end pairs on the
host clock with their nesting, and exports them in the Chrome trace-event
JSON format (``chrome://tracing`` / Perfetto: ``{"traceEvents": [{"ph":
"X", "ts", "dur", "name", ...}]}``).

Two ways to open a span:

* ``tracer.span("step", step=i)``: explicit, for a caller that holds the
  tracer;
* ``phase("dispatch")``: the module-level hook the hot path calls
  (``core/moe_layer.py``, ``plan/exchange.py``). It returns the inert
  :data:`NULL_SPAN` unless a tracer is :func:`activate`\\ d, and also
  while a CUDA graph is being captured (a host timestamp there times the
  capture, not the work) and inside :func:`quiet` regions, which the
  train forward opens around the remat recompute of a layer in the
  backward: every phase records once per MoE sublayer forward, as the
  reference's (it records at run time, never while tracing a program).

Fencing: CUDA launches are asynchronous, so a host timestamp right after
an op returns measures the launch, not the work. With
``Tracer(fence=True)`` (the launchers' ``--trace``) ``span.fence(value)``
synchronizes every CUDA device that holds a tensor of ``value`` (a
pytree), so the span's end covers the device work of the phase, the
side stream's collectives of the pipelined executor included; CPU
tensors need nothing. Fencing never changes a value. Untraced runs pay
one module-global ``None`` check per ``phase()`` call and no sync.

Exclusive time: every completed span records ``self_us`` (its duration
minus its direct children's), so a parent's inclusive time is at least
the sum of its children's exclusive times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

# Synthetic Chrome-trace thread ids for device-tagged spans: host tids
# are masked to 16 bits, so rows at 0x10000+ can never collide.
DEVICE_TID_BASE = 0x10000


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices holding a tensor anywhere in ``value``."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    return out


def _block(value):
    """Wait for the device work behind ``value``: one device-wide
    synchronize per CUDA device it lives on (which covers every stream
    of that device). Returns ``value`` unchanged."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


class _Span:
    """One open span. Context manager; records an ``"X"`` (complete)
    event on exit."""
    __slots__ = ("tracer", "name", "cat", "args", "t0", "child_us",
                 "parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.child_us = 0.0
        self.parent: Optional["_Span"] = None

    def set(self, **kw) -> "_Span":
        self.args.update(kw)
        return self

    def fence(self, value):
        """Wait for ``value``'s device work (when fencing is on) so the
        span's end covers it. Returns the value unchanged either way."""
        if self.tracer.fence:
            value = _block(value)
        return value

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        dur = _now_us() - self.t0
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.parent is not None:
            self.parent.child_us += dur
        self.tracer._record({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self.t0, "dur": dur, "pid": self.tracer.pid,
            "tid": threading.get_ident() & 0xFFFF,
            "args": {**self.args,
                     "self_us": max(0.0, dur - self.child_us)},
        })
        return False


class _NullSpan:
    """Inert span returned when no tracer is active (or the caller is in
    a graph capture or a quiet region). One shared instance; every
    method is a no-op."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **_kw) -> "_NullSpan":
        return self

    def fence(self, value):
        return value


NULL_SPAN = _NullSpan()


class Tracer:
    """Host-side span recorder with Chrome-trace export.

    ``fence=True`` makes ``span.fence(x)`` wait for the device work
    behind ``x`` at phase boundaries (the launchers' ``--trace``); with
    ``fence=False`` spans are pure host intervals (launch times)."""

    def __init__(self, *, fence: bool = False):
        self.fence = fence
        self.pid = os.getpid()
        self.events: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------
    def _stack(self) -> List[_Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(event)

    def span(self, name: str, cat: str = "phase", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "mark", **args) -> None:
        self._record({"name": name, "cat": cat, "ph": "i",
                      "ts": _now_us(), "pid": self.pid,
                      "tid": threading.get_ident() & 0xFFFF, "s": "t",
                      "args": args})

    def counter(self, name: str, **series: float) -> None:
        self._record({"name": name, "cat": "metric", "ph": "C",
                      "ts": _now_us(), "pid": self.pid, "tid": 0,
                      "args": dict(series)})

    # -- views ---------------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Completed ``"X"`` events (optionally filtered by name), in
        completion order."""
        return [e for e in self.events
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregate: count, inclusive total, exclusive total
        (µs). Exclusive = duration minus direct children, so the
        exclusive totals sum to wall time without double counting."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self.spans():
            s = out.setdefault(e["name"],
                               {"count": 0, "total_us": 0.0,
                                "self_us": 0.0})
            s["count"] += 1
            s["total_us"] += e["dur"]
            s["self_us"] += e["args"].get("self_us", e["dur"])
        return out

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (a ``traceEvents`` array of
        events, each with ``ph``/``ts``/``name``, and ``dur`` for
        complete events). Spans tagged with an integer ``device`` arg go
        onto synthetic per-device ``tid`` rows with ``thread_name``
        metadata, so Perfetto shows the devices side by side."""
        events: List[Dict[str, Any]] = []
        device_rows: Dict[int, int] = {}   # device index -> pid
        for e in self.events:
            dev = e.get("args", {}).get("device")
            if e["ph"] == "X" and isinstance(dev, int):
                e = dict(e)
                e["tid"] = DEVICE_TID_BASE + dev
                device_rows[dev] = e["pid"]
            events.append(e)
        for dev in sorted(device_rows):
            events.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                           "pid": device_rows[dev],
                           "tid": DEVICE_TID_BASE + dev,
                           "args": {"name": f"device {dev}"}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        from pathlib import Path
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_chrome(), indent=1))


# ---------------------------------------------------------------------------
# module-level hook (the instrumented hot path calls this)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None
_QUIET = 0          # depth of open quiet() regions


def activate(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-wide :func:`phase` sink."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Tracer]:
    return _ACTIVE


@contextlib.contextmanager
def quiet():
    """A region whose :func:`phase` calls record nothing (a replay of
    work that was already recorded, such as the remat recompute)."""
    global _QUIET
    _QUIET += 1
    try:
        yield
    finally:
        _QUIET -= 1


def first_call_traced(fn):
    """``fn``, whose calls after the first run inside :func:`quiet`.
    ``torch.utils.checkpoint`` calls a layer once in the forward and
    once more, to recompute it, in the backward: wrapped so, the layer's
    phases record once per forward."""
    called = []

    def run(*args, **kwargs):
        if called:
            with quiet():
                return fn(*args, **kwargs)
        called.append(True)
        return fn(*args, **kwargs)

    return run


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def phase(name: str, cat: str = "phase", **args):
    """Span hook for the hot path (``plan_build``, ``exchange``,
    ``condense``, ``dispatch_pack``, ``dispatch``, ``expert_ffn``,
    ``combine``, ``pipeline_exchange``). Returns :data:`NULL_SPAN` unless
    a tracer is active, outside a quiet region and a graph capture: an
    untraced step pays one module-global comparison."""
    tracer = _ACTIVE
    if tracer is None:
        return NULL_SPAN
    if _QUIET or _capturing():
        return NULL_SPAN
    return tracer.span(name, cat, **args)
