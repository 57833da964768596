"""The port's knob search (``repro_torch.obs.autotune``) against the
reference's ``repro.obs.autotune`` on the CPU, bit for bit: it is host
arithmetic over the ported estimators, so the grid, every candidate's
modeled components, the chosen config and the re-ranked one are the
reference's exactly. Both get ``backend="cpu"``, and, where no
calibration prices the FFN, the reference's ``DEFAULT_FFN_SPEED`` (the
port's default is the card's peak). Also ``resolve_knobs``, the one
precedence rule of the launchers and the dry run.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.comm import dtypes as jdtypes
from repro.comm.topology import Topology as JTopology
from repro.obs import autotune as jat
from repro.obs import calibrate as jcal

from repro_torch.comm.topology import Topology
from repro_torch.launch.mesh import PEAK_FLOPS_BF16
from repro_torch.obs import autotune as tat
from repro_torch.obs import calibrate as tcal

FFN = jat.DEFAULT_FFN_SPEED            # the reference's default
# a train workload (moe-gpt2 over 4 ranks, B=8, S=1024) and a decode one
# with shared experts (the decode term)
TRAIN = dict(tokens=8 * 1024, top_k=2, d_model=768, d_ff=3072,
             num_layers=12, n_moe=12, n_slots=8, num_experts=16,
             mesh_devices=4, group_size=128, r_cond=0.25)
DECODE = dict(tokens=8 * 128, top_k=2, d_model=768, d_ff=3072,
              num_layers=12, n_moe=12, n_slots=8, num_experts=16,
              group_size=128, decode_tokens=8, d_ff_shared=2 * 3072)


def _calibs(seed=0, M=4):
    rng = np.random.default_rng(seed)
    f = dict(key=jcal.calibration_key(JTopology(2, 2), M, backend="cpu"),
             intra_bw=float(rng.uniform(1e9, 1e11)),
             inter_bw=float(rng.uniform(1e8, 1e10)),
             intra_lat=float(rng.uniform(0, 1e-5)),
             inter_lat=float(rng.uniform(0, 1e-4)),
             chunk_overhead_ms=float(rng.uniform(1e-3, 0.2)),
             plan_step_us=float(rng.uniform(0.5, 50.0)),
             sim_speed=float(rng.uniform(1e10, 1e14)),
             ffn_speed=float(rng.uniform(1e12, 5e14)))
    return jcal.Calibration(**f), tcal.Calibration(**f)


def test_reference_offers_f8_here():
    """The reference gates f8e4m3 on ``have_f8()``; the port always offers
    it, so the grids agree only where the reference's stack has it."""
    assert jdtypes.have_f8()


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 4), (1, 1)])
def test_candidate_grid(shape):
    n, l = shape
    got = tat.candidate_grid(Topology(n, l))
    assert got == jat.candidate_grid(JTopology(n, l))
    assert got[0] == tat.DEFAULT_KNOBS
    assert any(c["wire_dtype"] == "f8e4m3" for c in got)
    assert tat.TUNABLE_KNOBS == jat.TUNABLE_KNOBS
    assert tat.DEFAULT_KNOBS == jat.DEFAULT_KNOBS
    assert tat.TUNED_SCHEMA_VERSION == jat.TUNED_SCHEMA_VERSION == 2


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("work", ["train", "decode"])
def test_modeled_step_components_every_candidate(work, calibrated):
    kw = dict(TRAIN if work == "train" else DECODE)
    jc, tc = _calibs(1) if calibrated else (None, None)
    jt, tt = JTopology(2, 2), Topology(2, 2)
    if calibrated:
        jt, tt = jc.topology(jt), tc.topology(tt)
    grid = tat.candidate_grid(tt)
    for reuse in (("off", "off"), ("always", "signature")):
        extra = dict(plan_reuse=reuse[0], condense_reuse=reuse[1])
        for knobs in grid:
            got = tat.modeled_step_components(
                knobs, topo=tt, calib=tc, ffn_speed=FFN, **kw, **extra)
            want = jat.modeled_step_components(
                knobs, topo=jt, calib=jc, ffn_speed=FFN, **kw, **extra)
            assert got == want, knobs
    assert got["decode_ms"] > 0 if work == "decode" \
        else got["decode_ms"] == 0.0


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("work", ["train", "decode"])
def test_autotune_config_and_rerank_bytes(work, calibrated):
    kw = dict(TRAIN if work == "train" else DECODE)
    jc, tc = _calibs(2) if calibrated else (None, None)
    for n, l in ((2, 2), (1, 4)):
        jt, tt = JTopology(n, l), Topology(n, l)
        got = tat.autotune_config(topo=tt, calib=tc, ffn_speed=FFN,
                                  backend="cpu", **kw)
        want = jat.autotune_config(topo=jt, calib=jc, ffn_speed=FFN,
                                   backend="cpu", **kw)
        assert got.to_json() == want.to_json()
        assert got.modeled_step_ms <= got.default_step_ms
        for ratios in ({"step": 3.0}, {"step": 0.2}, {"dispatch": 5.0},
                       {"expert_ffn": 0.1, "combine": 2.0}):
            for ovh in (-1.0, 0.3):
                assert tat.rerank(got, ratios, topo=tt,
                                  chunk_overhead_ms=ovh).to_json() == \
                    jat.rerank(want, ratios, topo=jt,
                               chunk_overhead_ms=ovh).to_json()


def test_default_ffn_speed_is_the_cards():
    """Without a calibration the port prices the FFN at the H100's bf16
    peak, not the reference's TPU constant."""
    assert tat.DEFAULT_FFN_SPEED == PEAK_FLOPS_BF16 == 989e12
    assert jat.DEFAULT_FFN_SPEED == 197e12


def test_run_autotune_loads_before_search(tmp_path, monkeypatch):
    """The first call searches and keeps the artifact; the second loads
    it (no search); ``force`` searches again; each package loads the
    other's artifact with equal fields."""
    calls = [0]
    orig = tat.autotune_config

    def count(**kw):
        calls[0] += 1
        return orig(**kw)
    monkeypatch.setattr(tat, "autotune_config", count)
    topo = Topology(2, 2)
    a = tat.run_autotune(topo=topo, out_dir=tmp_path, backend="cpu",
                         ffn_speed=FFN, **TRAIN)
    assert calls[0] == 1
    b = tat.run_autotune(topo=topo, out_dir=tmp_path, backend="cpu",
                         ffn_speed=FFN, **TRAIN)
    assert calls[0] == 1 and b == a
    tat.run_autotune(topo=topo, out_dir=tmp_path, backend="cpu",
                     force=True, ffn_speed=FFN, **TRAIN)
    assert calls[0] == 2
    key = tat.tuned_key(topo, 4, backend="cpu")
    assert key == jat.tuned_key(JTopology(2, 2), 4, backend="cpu")
    j = jat.load_tuned(tmp_path, key)
    assert dataclasses.asdict(j) == dataclasses.asdict(a)
    jdir = tmp_path / "j"
    jat.save_tuned(jdir, j)
    assert dataclasses.asdict(tat.load_tuned(jdir, key)) == \
        dataclasses.asdict(a)
    # a miss: another backend's key, a corrupt file
    assert tat.load_tuned(tmp_path, key.replace("__cpu", "__gpu")) is None
    (jdir / f"{key}.tuned.json").write_text("{")
    assert tat.load_tuned(jdir, key) is None


def test_tuned_apply_honours_explicit():
    tuned = tat.TunedConfig(
        key="k", knobs=dict(tat.DEFAULT_KNOBS, exec_mode="pipeline",
                            wire_dtype="bf16"),
        modeled_step_ms=1.0, default_step_ms=2.0, candidates=3,
        calibrated=False)
    from repro_torch.config import LuffyConfig
    got = tuned.apply(LuffyConfig(), explicit=("exec_mode",))
    assert got.exec_mode == "sync" and got.wire_dtype == "bf16"
    assert tuned.modeled_savings_ms == 1.0
    assert json.loads(tuned.to_json())["magic"] == tat.TUNED_MAGIC


def _tuned(**knobs):
    return tat.TunedConfig(key="k", knobs=dict(tat.DEFAULT_KNOBS, **knobs),
                           modeled_step_ms=1.0, default_step_ms=1.0,
                           candidates=1, calibrated=False)


NONE = {k: None for k in tat.TUNABLE_KNOBS}


@pytest.mark.parametrize("case", [
    # (cli, tuned knobs, kwargs, expected subset)
    ({}, None, {}, dict(tat.DEFAULT_KNOBS)),
    ({}, dict(exec_mode="pipeline", pipeline_chunks=8, wire_dtype="bf16"),
     {}, dict(exec_mode="pipeline", pipeline_chunks=8, wire_dtype="bf16")),
    ({"exec_mode": "sync"}, dict(exec_mode="pipeline", pipeline_chunks=8),
     {}, dict(exec_mode="sync", pipeline_chunks=8)),
    ({"plan_objective": "overlap"}, None, {},
     dict(plan_objective="overlap", pipeline_chunks=0)),
    ({"plan_objective": "overlap", "pipeline_chunks": 3}, None, {},
     dict(pipeline_chunks=3)),
    # a tuned dedup wire on a flat wire falls back; an explicit one stays
    ({}, dict(comm_mode="hier", hier_dedup="on"), {"comm_mode": "flat"},
     dict(comm_mode="flat", hier_dedup="off")),
    ({"hier_dedup": "on"}, None, {}, dict(hier_dedup="on")),
    ({}, dict(comm_mode="hier", hier_dedup="on"), {},
     dict(comm_mode="hier", hier_dedup="on")),
    # a knob outside ``tunable`` keeps its default
    ({}, dict(comm_mode="hier", similarity_backend="lsh", lsh_bits=4),
     {"tunable": {"similarity_backend"}},
     dict(comm_mode="flat", similarity_backend="lsh", lsh_bits=8)),
])
def test_resolve_knobs(case):
    cli, knobs, kw, want = case
    got = tat.resolve_knobs({**NONE, **cli},
                            None if knobs is None else _tuned(**knobs), **kw)
    assert set(got) == set(tat.TUNABLE_KNOBS)
    for k, v in want.items():
        assert got[k] == v, (k, got)
