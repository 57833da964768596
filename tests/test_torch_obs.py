"""The port's observability layer (repro_torch.obs: trace, metrics,
monitor) against the reference's (repro.obs).

The reference's tracer and registry cases run against the port (span
nesting and exclusive time, the span-tree property, Chrome export with
device rows, the no-op hook, the summary, canonical names, counters
against gauges, masking, JSONL append and truncation, flatten); metrics
records from the same raw dicts are JSON-equal between the packages, and
so are the drift detector's and the residual monitor's outputs on one
ratio sequence and ``finalize_metrics``. Then one eager train step of
reduced moe-gpt2 with remat and a tracer active records each exchange
phase once per MoE sublayer (none from the recompute in the backward),
nested as the reference nests them, with the loss and metrics of an
untraced step bit for bit.
"""
import json
import time

import numpy as np
import pytest
import torch

from _hyp import given, settings, st   # optional dep; skips when absent

from repro import train_lib as jtrain_lib
from repro.config import LuffyConfig as JLuffy
from repro.obs import metrics as jmetrics
from repro.obs import monitor as jmonitor

from repro_torch import obs as tobs
from repro_torch import train_lib
from repro_torch.config import LuffyConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import monitor as obs_monitor
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import (COMM_LEDGER_SCHEMA_VERSION,
                                     METRICS_SCHEMA_VERSION, MetricsRegistry,
                                     canonical_name, flatten,
                                     mask_inapplicable)
from repro_torch.obs.trace import NULL_SPAN, Tracer


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_span_nesting_and_exclusive_time():
    tr = Tracer()
    with tr.span("outer"):
        with tr.span("a"):
            time.sleep(0.002)
        with tr.span("b"):
            time.sleep(0.002)
    ev = {e["name"]: e for e in tr.spans()}
    assert set(ev) == {"outer", "a", "b"}
    names = [e["name"] for e in tr.spans()]
    assert names.index("outer") > names.index("a")
    assert names.index("outer") > names.index("b")
    child_dur = ev["a"]["dur"] + ev["b"]["dur"]
    assert ev["outer"]["dur"] >= child_dur
    assert ev["outer"]["args"]["self_us"] == pytest.approx(
        ev["outer"]["dur"] - child_dur, abs=1e-3)
    for e in tr.spans():
        assert 0.0 <= e["args"]["self_us"] <= e["dur"] + 1e-9


def _tree_strategy():
    return st.recursive(st.just([]),
                        lambda kids: st.lists(kids, max_size=3),
                        max_leaves=12)


@settings(max_examples=25, deadline=None)
@given(tree=_tree_strategy())
def test_span_tree_property(tree):
    """For any nesting: one event per span, post-order completion, child
    intervals inside the parent's, parent inclusive time >= the sum of
    its direct children's."""
    tr = Tracer()
    parent_of = {}
    counter = [0]

    def walk(kids, parent_name):
        name = f"n{counter[0]}"
        counter[0] += 1
        parent_of[name] = parent_name
        with tr.span(name):
            for k in kids:
                walk(k, name)

    walk(tree, None)
    events = {e["name"]: e for e in tr.spans()}
    assert len(events) == len(parent_of)
    order = [e["name"] for e in tr.spans()]
    for name, parent in parent_of.items():
        if parent is None:
            continue
        c, p = events[name], events[parent]
        assert order.index(name) < order.index(parent)
        assert c["ts"] >= p["ts"] - 1e-6
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-6
    for parent in set(parent_of.values()) - {None}:
        kids = [events[n] for n, p in parent_of.items() if p == parent]
        assert events[parent]["dur"] >= sum(k["dur"] for k in kids) - 1e-6
        assert events[parent]["args"]["self_us"] == pytest.approx(
            events[parent]["dur"] - sum(k["dur"] for k in kids), abs=1e-3)


def test_chrome_trace_export(tmp_path):
    tr = Tracer()
    with tr.span("step", cat="step", step=0):
        pass
    tr.instant("mark")
    tr.counter("tokens", condensed=3.0)
    path = tmp_path / "sub" / "trace.json"
    tr.write(path)
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    for e in doc["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert "dur" in e and e["dur"] >= 0.0
    steps = [e for e in doc["traceEvents"] if e["name"] == "step"]
    assert steps[0]["args"]["step"] == 0


def test_chrome_trace_per_device_rows():
    tr = Tracer()
    for dev in range(3):
        with tr.span("probe_exchange", cat="probe", device=dev):
            pass
    with tr.span("step", cat="step"):
        pass
    doc = tr.to_chrome()
    base = obs_trace.DEVICE_TID_BASE
    probes = [e for e in doc["traceEvents"]
              if e["ph"] == "X" and e["name"] == "probe_exchange"]
    assert sorted(e["tid"] for e in probes) == [base, base + 1, base + 2]
    (step,) = [e for e in doc["traceEvents"]
               if e["ph"] == "X" and e["name"] == "step"]
    assert step["tid"] < base
    names = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {e["args"]["name"] for e in names} == \
        {"device 0", "device 1", "device 2"}
    for e in names:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
    assert tr.summary()["probe_exchange"]["count"] == 3


def test_phase_hook_noop_without_tracer_and_when_quiet():
    obs_trace.deactivate()
    assert obs_trace.phase("dispatch") is NULL_SPAN
    sentinel = object()
    with obs_trace.phase("dispatch") as sp:
        assert sp.fence(sentinel) is sentinel
    tr = obs_trace.activate(Tracer(fence=True))
    try:
        with obs_trace.phase("dispatch", cat="phase", layer=3) as sp:
            x = torch.ones(3)
            assert sp.fence(x) is x     # a CPU tensor: nothing to wait on
        with obs_trace.quiet():
            assert obs_trace.phase("combine") is NULL_SPAN
        calls = []

        def layer():
            with obs_trace.phase("expert_ffn"):
                calls.append(1)

        once = obs_trace.first_call_traced(layer)
        once()
        once()                         # the recompute: runs, not recorded
    finally:
        obs_trace.deactivate()
    (e,) = tr.spans("dispatch")
    assert e["args"]["layer"] == 3
    assert tr.spans("combine") == []
    assert len(calls) == 2 and len(tr.spans("expert_ffn")) == 1


def test_tracer_summary():
    tr = Tracer()
    for _ in range(3):
        with tr.span("step"):
            with tr.span("io"):
                pass
    s = tr.summary()
    assert s["step"]["count"] == 3 and s["io"]["count"] == 3
    assert s["step"]["self_us"] <= s["step"]["total_us"]
    assert obs_monitor.measured_phase_ms(tr, ("step", "absent")).keys() \
        == {"step"}


def test_exports():
    for name in ("Tracer", "NULL_SPAN", "phase", "activate", "deactivate",
                 "active", "MetricsRegistry", "write_jsonl", "read_jsonl",
                 "DriftDetector", "ResidualMonitor", "RESIDUAL_PHASES"):
        assert name in tobs.__all__ and hasattr(tobs, name)
    assert METRICS_SCHEMA_VERSION == jmetrics.METRICS_SCHEMA_VERSION
    assert COMM_LEDGER_SCHEMA_VERSION == jmetrics.COMM_LEDGER_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_schema_and_canonical_names_match_reference():
    assert canonical_name("loss") == "train/loss"
    assert canonical_name("plans_built") == "plan/built"
    assert canonical_name("inter_bytes_shipped") == \
        "comm/inter_bytes_shipped"
    assert canonical_name("reuse_mismatch") == "plan/reuse_mismatch"
    assert canonical_name("not_a_known_key") == "not_a_known_key"
    assert {k: tuple(v) for k, v in obs_metrics.SCHEMA.items()} == \
        {k: tuple(v) for k, v in jmetrics.SCHEMA.items()}
    for key in ("loss", "queue_ms", "slot_churn", "residual_step_ratio",
                "time_s", "step_time_s", "unknown"):
        assert canonical_name(key) == jmetrics.canonical_name(key)


def test_registry_counters_accumulate_gauges_dont():
    luffy = LuffyConfig(comm_mode="hier", hier_dedup="on")
    reg = MetricsRegistry(luffy=luffy, run_info={"arch": "x"})
    r0 = reg.observe(0, {"loss": 2.0, "plans_built": 2,
                         "inter_bytes_shipped": 100.0})
    r1 = reg.observe(1, {"loss": 1.0, "plans_built": 1,
                         "inter_bytes_shipped": 50.0})
    assert r0["schema_version"] == METRICS_SCHEMA_VERSION
    assert "run" in r0 and "run" not in r1
    assert r1["metrics"]["train/loss"] == 1.0
    assert r1["cumulative"]["plan/built"] == 3.0
    assert r1["cumulative"]["comm/inter_bytes_shipped"] == 150.0
    assert "train/loss" not in r1["cumulative"]


def test_applicability_masking():
    raw = {"inter_bytes_flat": 10.0, "inter_bytes_dedup": 8.0,
           "inter_bytes_shipped": 0.0, "loss": 1.0}
    flat = mask_inapplicable(raw, LuffyConfig(comm_mode="flat"))
    assert flat["inter_bytes_flat"] is None
    assert flat["inter_bytes_shipped"] is None
    assert flat["loss"] == 1.0
    hier = mask_inapplicable(raw, LuffyConfig(comm_mode="hier"))
    assert hier["inter_bytes_flat"] == 10.0
    assert hier["inter_bytes_shipped"] is None
    dedup = mask_inapplicable(
        raw, LuffyConfig(comm_mode="hier", hier_dedup="on"))
    assert dedup["inter_bytes_shipped"] == 0.0
    reg = MetricsRegistry(luffy=LuffyConfig(comm_mode="flat"))
    rec = reg.observe(0, raw)
    assert rec["metrics"]["comm/inter_bytes_flat"] is None
    assert "comm/inter_bytes_flat" not in rec["cumulative"]


RAW = [{"loss": 2.5, "plans_built": 12, "inter_bytes_flat": 1e6,
        "inter_bytes_dedup": 6e5, "inter_bytes_shipped": 3e5,
        "condense_rate": 0.93, "bucket": 1, "custom": "tag", "flag": True},
       {"queue_ms": 3.5, "admitted": 2, "finished": 1, "slot_churn": 1,
        "active_slots": 3.0, "queued_requests": 0.0, "generated_tokens": 4},
       {"residual_step_predicted_ms": 100.0, "residual_step_measured_ms":
        140.0, "residual_step_ratio": 1.4, "residual_drift": 0.0,
        "time_s": 0.25, "none_value": None}]


@pytest.mark.parametrize("mode", [("flat", "off"), ("hier", "off"),
                                  ("hier", "on"), (None, None)])
def test_records_json_equal_to_reference(mode):
    """The same raw dicts through both registries: the same JSON."""
    if mode[0] is None:
        ours, ref = MetricsRegistry(), jmetrics.MetricsRegistry()
    else:
        kw = dict(comm_mode=mode[0], hier_dedup=mode[1])
        info = {"arch": "moe-gpt2", "steps": 3}
        ours = MetricsRegistry(luffy=LuffyConfig(**kw), run_info=info)
        ref = jmetrics.MetricsRegistry(luffy=JLuffy(**kw), run_info=info)
    for i, raw in enumerate(RAW + RAW):
        got = ours.observe(i, raw, extra_key=1.5, bucket=i)
        want = ref.observe(i, raw, extra_key=1.5, bucket=i)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
        assert mask_inapplicable(raw, ours.luffy) == \
            jmetrics.mask_inapplicable(raw, ref.luffy)


def test_write_jsonl_appends(tmp_path):
    path = tmp_path / "deep" / "m.jsonl"
    obs_metrics.write_jsonl(path, {"step": 0})
    obs_metrics.write_jsonl(path, {"step": 1})
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert jmetrics.read_jsonl(path) == obs_metrics.read_jsonl(path)


def test_read_jsonl_tolerates_truncation(tmp_path):
    path = tmp_path / "m.jsonl"
    for i in range(5):
        obs_metrics.write_jsonl(path, {"step": i, "metrics": {"x": i}})
    data = path.read_bytes()
    assert len(obs_metrics.read_jsonl(path)) == 5
    path.write_bytes(data[:-7])
    assert [r["step"] for r in obs_metrics.read_jsonl(path)] == [0, 1, 2, 3]
    for cut in range(len(data)):
        path.write_bytes(data[:cut])
        recs = obs_metrics.read_jsonl(path)
        assert [r["step"] for r in recs] == list(range(len(recs)))
        assert len(recs) >= data[:cut].count(b"\n") - 1
    assert obs_metrics.read_jsonl(tmp_path / "absent.jsonl") == []


def test_flatten_nested():
    nested = {"buckets": {"0.0": {"flat": 1}}, "dedup_factor": 2.0}
    assert flatten("comm_ledger", nested) == {
        "comm_ledger/buckets/0.0/flat": 1, "comm_ledger/dedup_factor": 2.0}
    assert flatten("", nested) == jmetrics.flatten("", nested)


def test_finalize_metrics_masks_like_reference():
    raw = {"loss": np.float32(1.5), "inter_bytes_shipped": np.float32(0.0),
           "inter_bytes_flat": np.float32(7.0), "bucket": 1}
    for kw in (dict(comm_mode="hier"), dict(comm_mode="flat"),
               dict(comm_mode="hier", hier_dedup="on")):
        got = train_lib.finalize_metrics(
            {k: torch.as_tensor(v) for k, v in raw.items()},
            LuffyConfig(**kw))
        assert got == jtrain_lib.finalize_metrics(raw, JLuffy(**kw))
    got = train_lib.finalize_metrics({"loss": torch.tensor(1.5),
                                      "inter_bytes_shipped": torch.tensor(
                                          0.0)}, LuffyConfig())
    assert got == {"loss": 1.5, "inter_bytes_shipped": None}


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------

RATIOS = [1.0, 1.1, 0.9, 2.5, 2.6, 2.4, 2.7, 2.5, 2.9, 1.0, 0.3, 0.35,
          0.31, 0.3, 0.29, 0.33, 1.2]


def test_drift_detector_matches_reference():
    ours = obs_monitor.DriftDetector(tolerance=1.5, ewma_alpha=0.5, k=3)
    ref = jmonitor.DriftDetector(tolerance=1.5, ewma_alpha=0.5, k=3)
    for r in RATIOS:
        assert ours.update(r) == ref.update(r)
        assert (ours.ewma, ours.consecutive, ours.fired,
                ours.out_of_tolerance, ours.ewma_ratio) == \
            (ref.ewma, ref.consecutive, ref.fired, ref.out_of_tolerance,
             ref.ewma_ratio)
    assert ours.fired


def test_residual_monitor_matches_reference():
    ours = obs_monitor.ResidualMonitor(tolerance=1.5, k=2)
    ref = jmonitor.ResidualMonitor(tolerance=1.5, k=2)
    assert ours.phases == ref.phases == obs_monitor.RESIDUAL_PHASES
    for i, r in enumerate(RATIOS):
        pred = {"step": 10.0, "dispatch": 2.0, "combine": 1.0}
        meas = {"step": 10.0 * r, "dispatch": 2.0 / r, "expert_ffn": 3.0}
        dev = {0: 1.0, 1: r, 2: 1.5} if i % 3 == 0 else None
        assert ours.observe(i, pred, meas, per_device_ms=dev) == \
            ref.observe(i, pred, meas, per_device_ms=dev)
        assert ours.drifted_phases() == ref.drifted_phases()
    ours.reset()
    ref.reset()
    assert not ours.drifted and not ref.drifted
    for vals in ({}, {0: 3.0}, {0: 1.0, 1: 3.0}, {0: 1.0, 1: 2.0, 2: 5.0}):
        assert obs_monitor.device_dispersion(vals) == \
            jmonitor.device_dispersion(vals)


def test_predicted_phase_ms_from_port_estimate():
    from repro_torch.comm.topology import Topology
    from repro_torch.plan.estimate import estimate_exchange
    est = estimate_exchange(4096, 2, 768, topo=Topology.flat(4), ffn_ms=1.5,
                            chunks=4)
    for piped in (False, True):
        assert obs_monitor.predicted_phase_ms(est, pipelined=piped) == \
            jmonitor.predicted_phase_ms(est, pipelined=piped)
    got = obs_monitor.predicted_phase_ms(est, pipelined=True)
    assert got["step"] == est.overlap_ms and got["expert_ffn"] == 1.5


# ---------------------------------------------------------------------------
# one traced train step
# ---------------------------------------------------------------------------

PHASES = {"plan_build", "condense", "exchange", "dispatch_pack", "dispatch",
          "expert_ffn", "combine"}
PARENT = {"condense": "plan_build", "dispatch_pack": "exchange",
          "dispatch": "exchange", "expert_ffn": "exchange",
          "combine": "exchange"}


def _train_step(traced: bool, remat: bool):
    import dataclasses
    from repro_torch import optim
    from repro_torch.config import OptimConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2")), remat=remat,
                              compute_dtype="float32")
    shape = ShapeConfig("train", 128, 2, "train")
    luffy = LuffyConfig(condense_group=128)
    ocfg = OptimConfig(total_steps=2, warmup_steps=2)
    params = build_model(cfg, device="cpu", seed=0).params
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0)
    step = train_lib.make_train_step(cfg, luffy, ocfg, cap)
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(cfg, shape).batch(0).items()}
    tracer = obs_trace.activate(Tracer(fence=True)) if traced else None
    try:
        out = step(params, optim.init_opt_state(params, ocfg),
                   train_lib.init_luffy_state("cpu"), batch)
    finally:
        obs_trace.deactivate()
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    return tracer, train_lib.finalize_metrics(out[3], luffy), n_moe, \
        [p.detach().clone() for _, p in optim.leaves_with_path(out[0])]


@pytest.mark.parametrize("remat", [True, False])
def test_traced_train_step_records_each_phase_once(remat):
    """Under remat the backward recomputes each layer; its phases record
    nothing, so the counts are those without remat."""
    tracer, m, n_moe, params = _train_step(True, remat)
    _, m_plain, _, params_plain = _train_step(False, remat)
    assert m == m_plain               # fencing changes nothing
    # the updated parameters too, but for the CPU's embedding backward,
    # whose threads sum a token's rows in any order, traced or not
    for a, b in zip(params, params_plain):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0.0)
    counts = {k: v["count"] for k, v in tracer.summary().items()}
    assert counts == {k: n_moe for k in PHASES}, counts
    spans = tracer.spans()
    for e in spans:
        parent = PARENT.get(e["name"])
        if parent is None:
            continue
        assert any(p["name"] == parent and p["ts"] <= e["ts"] and
                   e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
                   for p in spans), e["name"]
    summary = tracer.summary()
    assert summary["exchange"]["total_us"] >= sum(
        summary[k]["total_us"] for k in ("dispatch", "expert_ffn",
                                         "combine"))
