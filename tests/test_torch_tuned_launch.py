"""The launchers' calibration and tuning flags on the CPU (``--device cpu
--reduced``): train's ``--calibrate`` / ``--autotune`` over 4 virtual
ranks with the tuned knobs applied and an explicit flag winning,
``--recalibrate-on-drift`` firing once, ``--trace``'s end-of-run probe,
``--mesh``; serve's ``--autotune`` with an explicit flag giving the same
tokens as the run given those knobs explicitly.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.obs import autotune as tat
from repro_torch.obs import calibrate as tcal
from repro_torch.obs import monitor as obs_monitor

TRAIN = ["--reduced", "--layers", "1", "--d-model", "64", "--seq-len", "32",
         "--global-batch", "4", "--device", "cpu", "--seed", "0"]
EP = ["--model-axis", "4", "--nodes", "2"]


def _luffy_knobs(luffy):
    return {k: getattr(luffy, k) for k in tat.TUNABLE_KNOBS}


def test_train_calibrate_autotune(tmp_path):
    """The first run measures and keeps the fit, searches and keeps the
    knobs and applies them; the second, with the tuned artifact rewritten
    to pipeline at bf16 on the lsh backend, loads both and applies the
    artifact's knobs except an explicit ``--exec-mode sync``."""
    d = str(tmp_path / "d")
    res = ttrain.main(TRAIN + EP + ["--steps", "1", "--calibrate", d,
                                    "--autotune", d])
    calib, tuned = res["calibration"], res["tuned"]
    assert calib is not None and tuned is not None and tuned.calibrated
    assert res["luffy"].gpu_speed == calib.ffn_speed
    assert res["luffy"].chunk_overhead_ms == calib.chunk_overhead_ms
    assert _luffy_knobs(res["luffy"]) == tat.resolve_knobs(
        {k: None for k in tat.TUNABLE_KNOBS}, tuned)
    assert res["log"][0]["run"]["calibrated"] is True
    assert res["log"][0]["run"]["autotuned"] is True
    assert np.isfinite([s["loss"] for s in res["steps"]]).all()
    # the dist context prices the measured links
    assert res["dist"].topology.intra_bw == calib.intra_bw

    knobs = dict(tuned.knobs, comm_mode="hier", hier_dedup="on",
                 exec_mode="pipeline", pipeline_chunks=2,
                 similarity_backend="lsh", lsh_bits=4, wire_dtype="bf16")
    art = tmp_path / "d" / f"{tuned.key}.tuned.json"
    payload = json.loads(art.read_text())
    payload["knobs"] = knobs
    art.write_text(json.dumps(payload))
    res2 = ttrain.main(TRAIN + EP + ["--steps", "1", "--calibrate", d,
                                     "--autotune", d, "--exec-mode",
                                     "sync"])
    assert res2["calibration"] == calib          # loaded, not measured
    assert res2["tuned"].knobs == knobs
    assert _luffy_knobs(res2["luffy"]) == dict(knobs, exec_mode="sync")
    assert res2["steps"][0]["chunks"] == 1       # sync: one chunk
    assert res2["steps"][0]["inter_bytes_shipped"] is not None


def test_train_recalibrates_once(tmp_path, monkeypatch):
    """A drift detector forced to fire measures the fit again exactly
    once (force=True), under the key the run started from (one device:
    no mesh, so the compute and planning fits). The warm-up takes steps
    1-3, so the detector first reads step 4."""
    forced = []
    orig = tcal.run_calibration

    def run(*a, **kw):
        forced.append(kw.get("force", False))
        return orig(*a, **kw)
    monkeypatch.setattr(tcal, "run_calibration", run)
    monkeypatch.setattr(obs_monitor.ResidualMonitor, "drifted",
                        property(lambda self: True))
    d = str(tmp_path / "c")
    res = ttrain.main(TRAIN + ["--steps", "5", "--calibrate", d,
                               "--recalibrate-on-drift"])
    assert forced == [False, True]
    assert res["recalibrated"]
    assert res["calibration"].key == tcal.calibration_key(None, 1,
                                                          backend="cpu")
    assert len(list((tmp_path / "c").glob("*.calib.json"))) == 1


def test_train_trace_probe(tmp_path):
    """``--trace`` ends with one ``probe_exchange`` span on device 0 and a
    residual record of the probe's expert FFN."""
    m = tmp_path / "m.jsonl"
    res = ttrain.main(TRAIN + ["--steps", "1", "--trace-out",
                               str(tmp_path / "t.json"), "--metrics-json",
                               str(m)])
    spans = res["tracer"].spans("probe_exchange")
    assert len(spans) == 1 and spans[0]["args"]["device"] == 0
    last = json.loads(m.read_text().splitlines()[-1])
    assert last["step"] == 1
    met = last["metrics"]
    assert met["residual/expert_ffn/ratio"] > 0
    assert met["residual/device_dispersion"] == 1.0
    assert res["probe"]["per_device_ms"].keys() == {0}
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(e["name"] == "probe_exchange" for e in trace["traceEvents"])


def test_train_mesh_flag():
    with pytest.raises(NotImplementedError, match="item 3d"):
        ttrain.main(TRAIN + ["--steps", "1", "--mesh", "production"])
    res = ttrain.main(TRAIN + EP + ["--steps", "1", "--mesh", "none"])
    assert not res["dist"].enabled


SERVE = ["--reduced", "--batch", "2", "--prompt-len", "4", "--gen", "2",
         "--model-axis", "4", "--prefill", "batch", "--device", "cpu"]


def test_serve_autotune_explicit_flag(tmp_path):
    """``--autotune`` with an explicit ``--exec-mode pipeline``: the
    artifact's wire dtype and similarity pair applied, the flag kept, and
    tokens and prefill logits bit for bit the run given every one of
    those knobs explicitly."""
    res = tserve.main(SERVE + ["--autotune", str(tmp_path),
                               "--exec-mode", "pipeline"])
    tuned, knobs = res["tuned"], res["knobs"]
    assert tuned is not None
    assert knobs["exec_mode"] == "pipeline"
    for k in ("wire_dtype", "similarity_backend", "lsh_bits",
              "plan_objective"):
        assert knobs[k] == tuned.knobs[k], k
    assert knobs["comm_mode"] == "flat" and knobs["hier_dedup"] == "off"
    flags = []
    for k in ("exec_mode", "pipeline_chunks", "plan_objective",
              "hier_dedup", "similarity_backend", "lsh_bits", "wire_dtype"):
        flags += ["--" + k.replace("_", "-"), str(knobs[k])]
    explicit = tserve.main(SERVE + flags)
    assert explicit["knobs"] == knobs and explicit["tuned"] is None
    assert torch.equal(res["tokens"], explicit["tokens"])
    assert torch.equal(res["prefill_logits"], explicit["prefill_logits"])
