"""The port's measured calibration (``repro_torch.obs.calibrate``)
against the reference's ``repro.obs.calibrate`` on the CPU.

What is exact is held bit for bit: the fit ``_fit_bw_lat`` on given
samples (numpy seeds), ``calibration_key``, the artifact's JSON bytes,
each package loading the other's artifact, the miss cases, and
``apply`` / ``estimate_kwargs`` / ``topology`` field by field. The
within-node exchange ``CommContext.local_all_to_all`` is held to
``jax.lax.all_to_all`` over ``"local"`` on a 4-device ``(node=2,
local=2)`` mesh (one JAX subprocess). Measured numbers are not
comparable; ``run_calibration`` over 4 virtual ranks is held to the
rails, its artifact, and load-before-measure (probe calls counted).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.comm.topology import Topology as JTopology
from repro.config import LuffyConfig as JLuffy
from repro.obs import calibrate as jcal

from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.topology import Topology
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, topology_for_mesh
from repro_torch.obs import calibrate as tcal
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]

TOPOS = [None, (1, 4, {}), (2, 2, {}), (4, 4, {}),
         (2, 2, dict(intra_bw=3.3e9, inter_bw=1.7e8, intra_lat=2.5e-5,
                     inter_lat=1.25e-4))]


def _topos(spec):
    if spec is None:
        return None, None
    n, l, kw = spec
    return JTopology(n, l, **kw), Topology(n, l, **kw)


def _fields(rng):
    return dict(key="k", intra_bw=float(rng.uniform(1e8, 1e11)),
                inter_bw=float(rng.uniform(1e7, 1e10)),
                intra_lat=float(rng.uniform(0, 1e-4)),
                inter_lat=float(rng.uniform(0, 1e-3)),
                chunk_overhead_ms=float(rng.uniform(1e-3, 1.0)),
                plan_step_us=float(rng.uniform(0.1, 100.0)),
                sim_speed=float(rng.uniform(1e9, 1e14)),
                ffn_speed=float(rng.uniform(1e11, 1e15)),
                samples={"rows_list": [64, 256, 1024],
                         "a2a_intra": [[float(a), float(b)] for a, b in
                                       rng.uniform(0, 1, (3, 2))],
                         "ffn_s": float(rng.uniform(0, 1))})


def _pair(seed, key):
    rng = np.random.default_rng(seed)
    f = _fields(rng)
    f["key"] = key
    return jcal.Calibration(**f), tcal.Calibration(**f)


@pytest.mark.parametrize("seed", range(4))
def test_fit_bw_lat_bitwise(seed):
    """The least-squares link fit on the same samples: a noisy line, a
    negative slope (clamped), one sample, equal payloads."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(1e4, 1e7, 5)
    lines = [list(zip(xs, 2e-5 + xs / rng.uniform(1e8, 1e11)
                      + rng.normal(0, 1e-6, 5))),
             list(zip(xs, 1e-3 - xs * 1e-12)),
             [(float(xs[0]), 1e-4)],
             [(1e5, 1e-4), (1e5, 2e-4)],
             []]
    for s in lines:
        assert tcal._fit_bw_lat(s) == jcal._fit_bw_lat(s)


@pytest.mark.parametrize("spec", TOPOS)
def test_calibration_key_bitwise(spec):
    jt, tt = _topos(spec)
    M = tt.num_devices if tt is not None else 1
    for backend in ("cpu", "gpu"):
        assert tcal.calibration_key(tt, M, backend=backend) == \
            jcal.calibration_key(jt, M, backend=backend)
    # no backend: the entry points' default device, "cpu" without a card,
    # the reference's jax default backend here
    want = jcal.calibration_key(jt, M)
    if torch.cuda.is_available():
        want = jcal.calibration_key(jt, M, backend="gpu")
    assert tcal.calibration_key(tt, M) == want
    assert tcal.backend_of("cpu") == "cpu"
    assert tcal.backend_of(torch.device("cuda", 0)) == "gpu"


@pytest.mark.parametrize("seed", range(3))
def test_to_json_bytes_and_cross_load(seed, tmp_path):
    """The artifact's bytes are the reference's, and each package loads
    the other's saved artifact with equal fields."""
    key = tcal.calibration_key(Topology(2, 2), 4, backend="gpu")
    j, t = _pair(seed, key)
    assert t.to_json() == j.to_json()
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jcal.save_calibration(jdir, j)
    tcal.save_calibration(tdir, t)
    assert (jdir / f"{key}.calib.json").read_bytes() == \
        (tdir / f"{key}.calib.json").read_bytes()
    got_t = tcal.load_calibration(jdir, key)
    got_j = jcal.load_calibration(tdir, key)
    assert dataclasses.asdict(got_t) == dataclasses.asdict(j)
    assert dataclasses.asdict(got_j) == dataclasses.asdict(t)
    assert tcal.Calibration.from_json(j.to_json()) == t


def test_artifact_misses(tmp_path):
    """Wrong magic, schema drift, another key, a corrupt file, a payload
    that is not an object, missing fields, an absent file: None in both
    packages."""
    key = "2x2i4.9e+10e1.225e+10l0-0__cpu"
    j, t = _pair(7, key)
    good = json.loads(t.to_json())
    texts = {
        "magic": json.dumps({**good, "magic": "other"}),
        "schema": json.dumps({**good, "schema_version": 2}),
        "key": json.dumps({**good, "key": "4x4__cpu"}),
        "corrupt": t.to_json()[:40],
        "list": "[1, 2]",
        "fields": json.dumps({k: v for k, v in good.items()
                              if k != "ffn_speed"}),
    }
    for name, text in texts.items():
        assert tcal.Calibration.from_json(text, expect_key=key) is None, name
        assert jcal.Calibration.from_json(text, expect_key=key) is None, name
        d = tmp_path / name
        d.mkdir()
        (d / f"{key}.calib.json").write_text(text)
        assert tcal.load_calibration(d, key) is None, name
        assert jcal.load_calibration(d, key) is None, name
    assert tcal.load_calibration(tmp_path / "absent", key) is None
    # the good text loads, the same in both
    assert tcal.Calibration.from_json(t.to_json(), expect_key=key) == t
    assert jcal.Calibration.from_json(t.to_json(), expect_key=key) == j


@pytest.mark.parametrize("seed", range(3))
def test_apply_estimate_kwargs_topology(seed):
    j, t = _pair(seed, "k")
    assert t.estimate_kwargs() == j.estimate_kwargs()
    jl, tl = j.apply(JLuffy()), t.apply(LuffyConfig())
    for f in dataclasses.fields(tl):
        assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    for spec in TOPOS[1:]:
        jt, tt = _topos(spec)
        assert dataclasses.asdict(t.topology(tt)) == \
            dataclasses.asdict(j.topology(jt))


ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.comm import make_mesh, shard_map
    mesh = make_mesh((2, 2), ("node", "local"))
    x = np.random.default_rng(5).standard_normal((4 * 6, 3)).astype(
        np.float32)
    out = {"x": x}
    for axis in ("local", "node"):
        f = jax.jit(shard_map(
            lambda a, ax=axis: jax.lax.all_to_all(a, ax, 0, 0, tiled=True),
            mesh=mesh, in_specs=P(("node", "local")),
            out_specs=P(("node", "local"))))
        out[axis] = np.asarray(f(x))
    np.savez(sys.argv[1], **out)
""")


def test_local_all_to_all_matches_jax(tmp_path):
    """``local_all_to_all`` (and ``node_all_to_all``) over 2 nodes of 2
    ranks, 6 rows a rank: the reference's ``lax.all_to_all`` over
    ``"local"`` (``"node"``) bit for bit."""
    path = tmp_path / "a2a.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = np.load(path)
    comm = CommContext.build("hier", 4, Topology(2, 2))
    x = torch.as_tensor(ref["x"]).reshape(4, 6, 3)
    np.testing.assert_array_equal(
        comm.local_all_to_all(x).numpy(), ref["local"].reshape(4, 6, 3))
    np.testing.assert_array_equal(
        comm.node_all_to_all(x).numpy(), ref["node"].reshape(4, 6, 3))
    with pytest.raises(ValueError, match="hier"):
        CommContext.build("flat", 4, Topology.flat(4)).local_all_to_all(x)


def _count_probes(monkeypatch):
    names = ("measure_all_to_all", "measure_psum",
             "measure_chunk_overhead_ms", "measure_plan_step_us",
             "measure_sim_speed", "measure_ffn_speed")
    calls = {n: 0 for n in names}
    for n in names:
        orig = getattr(tcal, n)

        def wrap(*a, _n=n, _orig=orig, **kw):
            calls[_n] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tcal, n, wrap)
    return calls


@pytest.mark.parametrize("nodes", [2, 0])
def test_run_calibration_cpu(nodes, tmp_path, monkeypatch):
    """Over 4 virtual ranks (2 x 2 hier, or flat): every field within the
    rails, the artifact written under the key; a second call loads it and
    measures nothing; ``force=True`` measures again."""
    calls = _count_probes(monkeypatch)
    mesh = make_host_mesh(model=4, nodes=nodes)
    topo = topology_for_mesh(mesh)
    calib = tcal.run_calibration(mesh, topo, device="cpu", out_dir=tmp_path)
    assert calib.key == tcal.calibration_key(topo, 4, backend="cpu")
    assert calib.key.endswith("__cpu")
    assert tcal._MIN_BW <= calib.intra_bw <= tcal._MAX_BW
    assert tcal._MIN_BW <= calib.inter_bw <= tcal._MAX_BW
    assert tcal._MIN_LAT <= calib.intra_lat <= tcal._MAX_LAT
    assert tcal._MIN_LAT <= calib.inter_lat <= tcal._MAX_LAT
    assert 1e-4 <= calib.chunk_overhead_ms <= 1e3
    assert calib.plan_step_us >= 0.01
    for v in (calib.sim_speed, calib.ffn_speed):
        assert tcal._MIN_SPEED <= v <= tcal._MAX_SPEED
    assert len(calib.samples["a2a_intra"]) == 3
    assert ("a2a_inter" in calib.samples) == (nodes > 1)
    assert calib.samples["ffn_shape"] == [1, 512, 256, 1024]
    path = tmp_path / f"{calib.key}.calib.json"
    assert path.read_text() == calib.to_json()
    # the reference reads the port's artifact
    assert dataclasses.asdict(jcal.load_calibration(tmp_path, calib.key)) \
        == dataclasses.asdict(calib)
    first = dict(calls)
    assert first["measure_all_to_all"] == (2 if nodes > 1 else 1)
    assert first["measure_ffn_speed"] == first["measure_sim_speed"] == 1
    again = tcal.run_calibration(mesh, topo, device="cpu", out_dir=tmp_path)
    assert again == calib
    assert calls == first                     # loaded: nothing measured
    forced = tcal.run_calibration(mesh, topo, device="cpu",
                                  out_dir=tmp_path, force=True)
    assert all(calls[n] == 2 * first[n] for n in calls)
    assert forced.key == calib.key
    assert tcal.load_calibration(tmp_path, calib.key) == forced


def test_run_calibration_without_mesh():
    """No mesh: the topology's links are kept, the compute and planning
    fits run, the chunk overhead is the default."""
    from repro_torch.sched.cost import DEFAULT_CHUNK_OVERHEAD_MS
    calib = tcal.run_calibration(None, None, device="cpu")
    assert calib.key == "flat1__cpu"
    assert calib.intra_bw == calib.inter_bw == tcal._MAX_BW
    assert calib.chunk_overhead_ms == DEFAULT_CHUNK_OVERHEAD_MS
    assert "a2a_intra" not in calib.samples


def test_probe_exchange_span_cpu():
    """The probe runs one exchange under a ``probe_exchange`` span tagged
    with its device, fenced phase spans inside."""
    cfg = reduced(get_config("moe-gpt2"))
    tracer = obs_trace.activate(obs_trace.Tracer(fence=True))
    try:
        per_dev = tcal.probe_exchange_per_device(cfg, LuffyConfig(),
                                                 device="cpu", seq_len=32)
    finally:
        obs_trace.deactivate()
    assert list(per_dev) == [0] and per_dev[0] > 0
    spans = tracer.spans("probe_exchange")
    assert len(spans) == 1 and spans[0]["args"]["device"] == 0
    assert len(tracer.spans("expert_ffn")) == 1
    y, aux = tcal.probe_exchange(cfg, LuffyConfig(), device="cpu",
                                 seq_len=32)
    assert y.shape == (2, 32, cfg.d_model)
    assert torch.isfinite(y).all()
