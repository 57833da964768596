"""The port's modeled dry run (``repro_torch.launch.dryrun``) against the
reference's ``comm_traffic_ledger`` on the CPU: moe-gpt2 at ``train_4k``
over the 16 x 16 layout split into 4 nodes, the ledger's JSON equal with
sorted keys across knob sets and a calibration. The port's roofline
defaults to the card's peak, so it gets the reference's
``PEAK_FLOPS_BF16`` here. Then the dry run's CLI: knob precedence, the
``"modeled"`` record, a calibration artifact read from either package.
"""
import json
import os
import types

import numpy as np
import pytest

from repro.comm.topology import Topology as JTopology
from repro.config import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch.mesh import PEAK_FLOPS_BF16 as JPEAK
from repro.obs import calibrate as jcal

# importing the reference's dry run sets XLA_FLAGS for its own
# 512-device use; restore the suite's environment
_SAVED_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch.dryrun import comm_traffic_ledger as jledger  # noqa: E402
if _SAVED_XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _SAVED_XLA_FLAGS

from repro_torch.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, make_host_mesh,
                                     production_layout)
from repro_torch.obs import calibrate as tcal
from repro_torch.obs.autotune import TunedConfig


def _jmesh(shape_by_axis):
    return types.SimpleNamespace(
        axis_names=tuple(shape_by_axis),
        devices=np.zeros(tuple(shape_by_axis.values())))


def _calibs():
    f = dict(key=jcal.calibration_key(JTopology(4, 4), 16, backend="cpu"),
             intra_bw=1e9, inter_bw=1e8, intra_lat=1e-5, inter_lat=1e-4,
             chunk_overhead_ms=0.5, plan_step_us=50.0, sim_speed=1e10,
             ffn_speed=1e12)
    return jcal.Calibration(**f), tcal.Calibration(**f)


KNOBS = {
    "defaults": {},
    "dedup_f8": dict(hier_dedup="on", wire_dtype="f8e4m3"),
    "reuse_lsh": dict(plan_reuse="signature", condense_reuse="always",
                      similarity_backend="lsh"),
    "chunks4": dict(exec_chunks=4),
    "calibrated": "calib",
}


def _both(name, jmesh, tmesh, **extra):
    kw = KNOBS[name]
    jkw = tkw = kw
    if kw == "calib":
        jc, tc = _calibs()
        jkw, tkw = {"calibration": jc}, {"calibration": tc}
    want = jledger(jget_config("moe-gpt2"), JSHAPES["train_4k"], jmesh,
                   **extra, **jkw)
    got = tdry.comm_traffic_ledger(get_config("moe-gpt2"), SHAPES["train_4k"],
                                   tmesh, peak_flops=JPEAK, **extra, **tkw)
    return want, got


@pytest.mark.parametrize("name", list(KNOBS))
def test_ledger_matches_reference(name):
    want, got = _both(name, _jmesh({"data": 16, "model": 16}),
                      production_layout(), nodes=4)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if name == "calibrated":
        assert got["calibration"] == _calibs()[1].key


def test_ledger_on_a_node_layout():
    """A layout with (node, local) axes takes its topology from them."""
    want, got = _both("defaults", _jmesh({"data": 16, "node": 4,
                                          "local": 4}),
                      production_layout(nodes=4))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_ledger_returns_none_where_the_reference_does():
    """A split that does not divide the model axis; a flat 1-node split;
    an arch with no MoE sublayer."""
    cases = [("moe-gpt2", {"data": 16, "model": 3}, dict(nodes=2)),
             ("moe-gpt2", {"data": 16, "model": 16}, dict(nodes=1)),
             ("hymba-1.5b", {"data": 16, "model": 16}, dict(nodes=4))]
    for arch, axes, kw in cases:
        want = jledger(jget_config(arch), JSHAPES["train_4k"], _jmesh(axes),
                       **kw)
        layout = types.SimpleNamespace(
            axis_names=tuple(axes),
            devices=types.SimpleNamespace(shape=tuple(axes.values()),
                                          size=int(np.prod(list(
                                              axes.values())))))
        got = tdry.comm_traffic_ledger(get_config(arch), SHAPES["train_4k"],
                                       layout, peak_flops=JPEAK, **kw)
        assert want is None and got is None, (arch, axes)


def test_layouts_and_peak():
    assert production_layout().axis_names == ("data", "model")
    assert production_layout(multi_pod=True, nodes=4).shape == \
        (2, 16, 4, 4)
    assert production_layout(nodes=2).devices.size == 256
    m = make_host_mesh(4, 2)
    assert m.devices.shape == (1, 2, 2) and m.devices.size == 4
    assert PEAK_FLOPS_BF16 == 989e12 != JPEAK


def test_dryrun_cli(tmp_path):
    """The CLI resolves knobs with the launchers' precedence (an explicit
    ``--exec-mode sync`` beats the tuned artifact), writes a
    ``"modeled"`` record whose ledger has the reference's key sets and is
    priced on a calibration artifact the reference wrote, and appends
    the flattened ledger to ``--metrics-json``."""
    jc, _ = _calibs()
    cal = tmp_path / "fit.calib.json"
    jcal.save_calibration(tmp_path, jc)
    os.replace(tmp_path / f"{jc.key}.calib.json", cal)
    out = tmp_path / "rec.json"
    common = ["--arch", "moe-gpt2", "--shape", "train_4k", "--nodes", "4",
              "--calibration", str(cal), "--autotune", str(tmp_path / "at")]
    rec = tdry.main(common + ["--out", str(out), "--metrics-json",
                              str(tmp_path / "m.jsonl")])
    assert rec["status"] == "modeled" and rec["autotuned"]
    assert json.loads(out.read_text()) == rec
    led = rec["comm_ledger"]
    assert led["calibration"] == jc.key
    want = jledger(jget_config("moe-gpt2"), JSHAPES["train_4k"],
                   _jmesh({"data": 16, "node": 4, "local": 4}),
                   calibration=jc)
    assert set(led) == set(want)
    for sec in ("buckets", "wire", "plan_reuse", "condensation", "decode",
                "autotune"):
        if isinstance(want[sec], dict):
            assert set(led[sec]) == set(want[sec]), sec
    assert led["autotune"]["applied"] is True
    flat = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert flat["metrics"]["comm_ledger/schema_version"] == 6
    # the record's knobs are the kept artifact's, the wire pinned to hier
    (art,) = (tmp_path / "at").glob("*.tuned.json")
    tuned = TunedConfig.from_json(art.read_text())
    want_knobs = dict(tuned.knobs, comm_mode="hier")
    assert rec["knobs"] == want_knobs
    pinned = tdry.main(common + ["--out", str(out), "--exec-mode", "sync"])
    assert pinned["knobs"] == dict(want_knobs, exec_mode="sync")
    # a non-train shape has no ledger
    dec = tdry.main(["--arch", "moe-gpt2", "--shape", "decode_32k",
                     "--out", str(tmp_path / "dec.json")])
    assert dec["status"] == "modeled" and dec["comm_ledger"] is None
    with pytest.raises(ValueError, match="unreadable"):
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        tdry.main(common[:6] + ["--calibration", str(bad), "--out",
                                str(out)])


def test_long_500k_skip_follows_the_reference_rule(tmp_path):
    """At ``long_500k`` every registered arch gets the reference's status
    (``src/repro/launch/dryrun.py``: "skipped", with its reason, where
    ``supports_long_decode`` is false), decided here without the
    reference's compile; rwkv6-3b, with recurrent state only, is priced."""
    from repro_torch.configs import ALIASES
    seen = set()
    for arch in ALIASES:
        out = tmp_path / f"{arch}.json"
        rec = tdry.main(["--arch", arch, "--shape", "long_500k", "--out",
                         str(out)])
        want = ("modeled" if jget_config(arch).supports_long_decode
                else "skipped")
        assert rec["status"] == want, arch
        assert json.loads(out.read_text()) == rec
        if want == "skipped":
            assert rec["reason"] == ("full-attention arch; long_500k "
                                     "skipped (DESIGN.md)")
        seen.add(want)
    assert seen == {"modeled", "skipped"}
    assert tdry.main(["--arch", "rwkv6-3b", "--shape", "long_500k", "--out",
                      str(tmp_path / "r.json")])["status"] == "modeled"
