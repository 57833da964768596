"""Measured cost-model calibration (counterpart of
``repro/obs/calibrate.py``).

Every planning decision prices against analytic models with hand-set
constants: link bandwidths and latencies
(:class:`repro_torch.comm.topology.Topology`), the per-chunk pipeline
overhead (``repro_torch.sched.cost.DEFAULT_CHUNK_OVERHEAD_MS``), the
planning-cost slope (``repro_torch.plan.estimate.PLAN_STEP_US``), the
similarity and FFN compute speeds (``estimate_similarity_ms``,
``LuffyConfig.gpu_speed``). This module measures each of them where the
program runs:

* **collectives**: the flat or hier all-to-all and the psum of
  :class:`repro_torch.comm.hierarchical.CommContext` timed at several
  payload sizes, and a linear fit ``t = lat + bytes / bw`` per link tier.
  The ranks are virtual (one process, one device), so these collectives
  are copies in device memory: the fit prices the virtual ranks this
  program runs, not a network;
* **per-chunk overhead**: ``k`` dependent collectives against one, the
  residual beyond the fitted message latency;
* **compute**: K1 (the expert FFN) and K2 (the fused similarity) timed
  through :mod:`repro_torch.kernels.ops` and converted to effective
  FLOP/s under the estimators' conventions, ``rows * 4 * d * d_ff`` and
  ``pairs * 4 * d``, so the fitted speeds replace ``gpu_speed`` and
  ``speed`` directly. On the card each probe launches the hand-written
  kernel (or raises); on the CPU it runs the kernel's plain version;
* **planning**: the host migration greedy
  (``plan_migration_with_objective``) timed over several slot counts,
  its slope a per-slot ``step_us``.

The fit is kept as a versioned artifact in the reference's format, keyed
by topology fingerprint and backend (:func:`calibration_key`), so a stale
fingerprint, another backend or a schema bump is a miss (measure again),
never a misread; each package reads the other's artifact.
:meth:`Calibration.topology`, :meth:`Calibration.apply` and
:meth:`Calibration.estimate_kwargs` hand the fit to ``Topology``,
``LuffyConfig`` and ``estimate_exchange``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.topology import Topology

CALIBRATION_MAGIC = "repro-calibration"
CALIBRATION_SCHEMA_VERSION = 1

# Clamp rails for degenerate fits (two near-equal timing points on a
# noisy host can produce a negative slope): bandwidths in bytes/s,
# latencies in seconds, speeds in FLOP/s.
_MIN_BW, _MAX_BW = 1e6, 1e13
_MIN_LAT, _MAX_LAT = 0.0, 1.0
_MIN_SPEED, _MAX_SPEED = 1e6, 1e16

# the K1 and K2 probes at the main path's compute dtype
PROBE_DTYPE = torch.bfloat16


def backend_of(device=None) -> str:
    """The device a fit describes, in JAX's backend names, so that both
    packages key an artifact alike: ``"gpu"`` for a CUDA device,
    ``"cpu"`` for the CPU. None: the default device of the entry points,
    the card when there is one."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def calibration_key(topo: Optional[Topology], M: int,
                    backend: Optional[str] = None) -> str:
    """Artifact key: the plan cache's topology fingerprint and the backend
    the numbers were measured on (a CPU fit must never price a card
    run); ``backend`` None is :func:`backend_of`'s default."""
    from repro_torch.plan.cache import topology_fingerprint
    if backend is None:
        backend = backend_of()
    return f"{topology_fingerprint(topo, M)}__{backend}"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One measured fit, bound to (topology fingerprint, backend).

    Bandwidths bytes/s, latencies seconds, speeds FLOP/s under the
    estimator conventions (``4·d·d_ff`` per FFN row, ``4·d`` per
    measured similarity pair). ``samples`` keeps the raw (bytes,
    seconds) measurements and the probes' shapes; it is persisted but
    never read back into pricing.
    """
    key: str
    intra_bw: float
    inter_bw: float
    intra_lat: float
    inter_lat: float
    chunk_overhead_ms: float
    plan_step_us: float
    sim_speed: float
    ffn_speed: float
    samples: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = CALIBRATION_SCHEMA_VERSION

    # -- pricing hand-off ----------------------------------------------------
    def topology(self, base: Topology) -> Topology:
        """``base`` with the measured link speeds and latencies: what the
        launchers hand to ``make_dist``, so the migration link costs, the
        ledger and the overlap model price measured links."""
        return dataclasses.replace(
            base, intra_bw=self.intra_bw, inter_bw=self.inter_bw,
            intra_lat=self.intra_lat, inter_lat=self.inter_lat)

    def apply(self, luffy):
        """``luffy`` with the measured compute speed and chunk overhead
        (``LuffyConfig.chunk_overhead_ms``; <= 0 means the built-in
        default, see ``repro_torch.sched.cost``)."""
        return dataclasses.replace(
            luffy, gpu_speed=self.ffn_speed,
            chunk_overhead_ms=self.chunk_overhead_ms)

    def estimate_kwargs(self) -> Dict[str, float]:
        """Overrides for :func:`repro_torch.plan.estimate.estimate_exchange`."""
        return {"intra_bw": self.intra_bw, "inter_bw": self.inter_bw,
                "chunk_overhead_ms": self.chunk_overhead_ms}

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        payload = {"magic": CALIBRATION_MAGIC, **dataclasses.asdict(self)}
        return json.dumps(payload, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str,
                  expect_key: Optional[str] = None
                  ) -> Optional["Calibration"]:
        """Parse an artifact; None (a miss) on any mismatch: wrong
        magic, schema drift, or, when ``expect_key`` is given, a stale
        topology fingerprint or backend."""
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return None
        if not isinstance(payload, dict):
            return None
        if payload.pop("magic", None) != CALIBRATION_MAGIC:
            return None
        if payload.get("schema_version") != CALIBRATION_SCHEMA_VERSION:
            return None
        if expect_key is not None and payload.get("key") != expect_key:
            return None
        fields = {f.name for f in dataclasses.fields(cls)}
        if not fields.issubset(payload):
            return None
        try:
            return cls(**{k: payload[k] for k in fields})
        except (TypeError, ValueError):
            return None


def _artifact_path(out_dir, key: str) -> Path:
    return Path(out_dir) / f"{key}.calib.json"


def save_calibration(out_dir, calib: Calibration) -> Path:
    path = _artifact_path(out_dir, calib.key)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(calib.to_json())
    return path


def load_calibration(out_dir, key: str) -> Optional[Calibration]:
    """Artifact for ``key``, or None (miss: absent, corrupt, version
    drift, or written for another fingerprint or backend)."""
    path = _artifact_path(out_dir, key)
    if not path.exists():
        return None
    try:
        text = path.read_text()
    except OSError:
        return None
    return Calibration.from_json(text, expect_key=key)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, *args, device, repeats: int = 3) -> float:
    """Best-of-``repeats`` wall seconds of ``fn(*args)``, the device
    synchronized before and after each call (one untimed warm-up builds
    the kernels and fills the weight cache)."""
    device = torch.device(device)
    fn(*args)
    best = float("inf")
    for _ in range(max(1, repeats)):
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _fit_bw_lat(samples: Sequence[Tuple[float, float]]
                ) -> Tuple[float, float]:
    """Least-squares ``t = lat + bytes/bw`` over (bytes, seconds)
    samples, clamped to physical rails."""
    xs = np.array([s[0] for s in samples], np.float64)
    ys = np.array([s[1] for s in samples], np.float64)
    if len(xs) < 2 or float(np.ptp(xs)) == 0.0:
        bw = float(xs.mean() / max(ys.mean(), 1e-12)) if len(xs) else _MIN_BW
        return float(np.clip(bw, _MIN_BW, _MAX_BW)), 0.0
    slope, intercept = np.polyfit(xs, ys, 1)
    bw = 1.0 / max(float(slope), 1e-14)
    lat = max(float(intercept), 0.0)
    return (float(np.clip(bw, _MIN_BW, _MAX_BW)),
            float(np.clip(lat, _MIN_LAT, _MAX_LAT)))


def _comm_of(mesh):
    """The mesh's ranks as a :class:`CommContext`: hier over (node, local)
    when the mesh names them, else flat over ``model``."""
    from repro_torch.comm.hierarchical import CommContext
    from repro_torch.launch.mesh import topology_for_mesh
    topo = topology_for_mesh(mesh)
    mode = "hier" if topo.hierarchical else "flat"
    return CommContext.build(mode, topo.num_devices, topo)


def _axis_size(mesh, axis: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[axis]


def _a2a_fn(mesh, axis: str, chain: int = 1):
    """A chain of ``chain`` dependent all-to-alls over ``axis`` of the
    mesh's ranks."""
    comm = _comm_of(mesh)
    one = {"model": comm.all_to_all, "node": comm.node_all_to_all,
           "local": comm.local_all_to_all}[axis]

    def f(x):
        for _ in range(chain):
            x = one(x)
        return x
    return f


def _psum_fn(mesh, axis: str):
    """The sum over ``axis``: every rank's (``model``) or the node's
    ranks' (``local``), added in ascending rank."""
    comm = _comm_of(mesh)
    if axis != "local":
        return comm.psum
    N, L = comm.nodes, comm.local_size

    def f(x):
        b = x.reshape(N, L, *x.shape[1:])
        acc = b[:, 0]
        for l in range(1, L):
            acc = acc + b[:, l]
        return acc
    return f


def _payload(mesh, rows: int, d: int, device) -> torch.Tensor:
    """[M, rows, d] f32: each rank holds ``rows`` rows (split into one
    exchange chunk per rank of the axis)."""
    return torch.ones((mesh.devices.size, rows, d), dtype=torch.float32,
                      device=device)


def measure_all_to_all(mesh, axis: str, rows_list: Sequence[int],
                       d: int = 256, *, device
                       ) -> List[Tuple[float, float]]:
    """(off-rank bytes per rank, seconds) of one all-to-all over
    ``axis`` at each payload size."""
    size = _axis_size(mesh, axis)
    fn = _a2a_fn(mesh, axis)
    out = []
    for rows in rows_list:
        x = _payload(mesh, rows, d, device)
        t = _timeit(fn, x, device=device)
        off_bytes = (size - 1) / size * rows * d * 4.0
        out.append((off_bytes, t))
    return out


def measure_psum(mesh, axis: str, rows_list: Sequence[int],
                 d: int = 256, *, device) -> List[Tuple[float, float]]:
    """(payload bytes per rank, seconds) of one psum over ``axis``."""
    fn = _psum_fn(mesh, axis)
    out = []
    for rows in rows_list:
        x = _payload(mesh, rows, d, device)
        t = _timeit(fn, x, device=device)
        out.append((rows * d * 4.0, t))
    return out


def measure_chunk_overhead_ms(mesh, axis: str, topo: Topology, *,
                              device, rows: int = 512, d: int = 256,
                              chain: int = 4,
                              intra_lat: float = 0.0,
                              inter_lat: float = 0.0) -> float:
    """Per-chunk issue cost beyond message latency: ``chain`` dependent
    all-to-alls against one, the residual per extra collective less the
    fitted per-message latencies (what ``sched.cost.overlap_ms`` adds on
    top of ``chunk_latency_s``)."""
    from repro_torch.comm.ledger import phase_messages
    x = _payload(mesh, rows, d, device)
    t1 = _timeit(_a2a_fn(mesh, axis, 1), x, device=device)
    tk = _timeit(_a2a_fn(mesh, axis, chain), x, device=device)
    per_extra_s = max(0.0, (tk - t1) / max(1, chain - 1) - t1)
    mi, me = phase_messages(topo)
    lat_s = mi * intra_lat + me * inter_lat
    return float(np.clip((per_extra_s - lat_s) * 1e3, 1e-4, 1e3))


def measure_plan_step_us(M: int, *, q: int = 3,
                         slot_counts: Sequence[int] = (16, 32, 64)
                         ) -> Tuple[float, List[Tuple[float, float]]]:
    """Fitted per-slot cost (µs) of one migration replan, from timing
    the host greedy at several slot counts."""
    from repro_torch.plan.estimate import PLAN_DEVICE_US
    from repro_torch.plan.objectives import plan_migration_with_objective
    rng = np.random.default_rng(0)
    samples = []
    for n_slots in slot_counts:
        counts = np.floor(rng.random((n_slots, M)) ** 3 * 16.0)
        lens = rng.permutation(np.arange(8, 8 + n_slots)).astype(np.float64)
        n_per_dev = max(1, n_slots // M)

        def run():
            return plan_migration_with_objective(counts, lens, n_per_dev,
                                                 q=q)
        run()                                    # warm-up
        t0 = time.perf_counter()
        run()
        samples.append((float(n_slots), time.perf_counter() - t0))
    xs = np.array([s[0] for s in samples])
    ys = np.array([s[1] for s in samples])
    slope_us = float(np.polyfit(xs, ys, 1)[0]) * 1e6 if len(xs) > 1 \
        else float(ys[0] / xs[0]) * 1e6
    step_us = max(slope_us - PLAN_DEVICE_US * M * max(1, q), 0.01)
    return step_us, samples


def measure_sim_speed(*, device, group: int = 64, d: int = 256,
                      dtype=PROBE_DTYPE) -> Tuple[float, float]:
    """(effective FLOP/s, seconds) of one condensation similarity build,
    under the ``pairs · 4 · d`` convention of ``estimate_similarity_ms``:
    K2's fused entry (the one the main path launches) on one group of
    [group, d] rows of one expert with no carried similarity, so that it
    measures every pair."""
    from repro_torch.config import LuffyConfig
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, group, d), generator=gen).to(dtype).to(device)
    expert = torch.zeros((1, group), dtype=torch.int32, device=device)
    t = _timeit(ops.masked_similarity_fused, x, expert, None,
                LuffyConfig.s1, LuffyConfig.s2, device=device)
    pairs = group * (group - 1) / 2.0
    speed = pairs * 4.0 * d / max(t, 1e-9)
    return float(np.clip(speed, _MIN_SPEED, _MAX_SPEED)), t


def measure_ffn_speed(*, device, rows: int = 512, d: int = 256,
                      d_ff: int = 1024, dtype=PROBE_DTYPE
                      ) -> Tuple[float, float]:
    """(effective FLOP/s, seconds) of one gated expert FFN under the
    ``rows · 4 · d · d_ff`` convention the exchange planner prices
    ``ffn_ms`` with (an effective speed: the FFN has three products, the
    convention two): K1 on one expert's [rows, d] rows at ``dtype`` with
    f32 weights, as the main path calls it."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(2)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)

    h = torch.randn((1, rows, d), generator=gen).to(dtype).to(device)
    wu = normal((1, d, d_ff), 1.0 / np.sqrt(d))
    wg = normal((1, d, d_ff), 1.0 / np.sqrt(d))
    wd = normal((1, d_ff, d), 1.0 / np.sqrt(d_ff))
    with torch.no_grad():
        t = _timeit(ops.expert_ffn, h, wu, wg, wd, "silu", device=device)
    speed = rows * 4.0 * d * d_ff / max(t, 1e-9)
    return float(np.clip(speed, _MIN_SPEED, _MAX_SPEED)), t


# ---------------------------------------------------------------------------
# the full run
# ---------------------------------------------------------------------------

def run_calibration(mesh, topo: Optional[Topology], *, device="cuda",
                    out_dir=None, quick: bool = True,
                    force: bool = False) -> Calibration:
    """Measure everything on ``device`` over ``mesh``'s virtual ranks and
    return the fit, loading a kept artifact for the same key from
    ``out_dir`` instead of measuring, and keeping a fresh fit there.

    ``mesh=None`` (or a mesh with no expert axis) skips the collective
    fits and keeps the topology's link constants; the compute and
    planning fits always run. ``force=True`` skips the load and
    overwrites the artifact with a fresh fit: the drift detector's
    recalibration (``--recalibrate-on-drift``)."""
    from repro_torch.launch.mesh import model_axes_of
    device = torch.device(device)
    M = topo.num_devices if topo is not None else 1
    axes = model_axes_of(tuple(mesh.axis_names)) if mesh is not None \
        else None
    key = calibration_key(topo, M, backend=backend_of(device))
    if out_dir is not None and not force:
        cached = load_calibration(out_dir, key)
        if cached is not None:
            return cached

    rows_list = (64, 256, 1024) if quick else (64, 256, 1024, 4096)
    samples: Dict[str, Any] = {"rows_list": list(rows_list)}
    intra_bw = topo.intra_bw if topo is not None else _MAX_BW
    inter_bw = topo.inter_bw if topo is not None else _MAX_BW
    intra_lat = topo.intra_lat if topo is not None else 0.0
    inter_lat = topo.inter_lat if topo is not None else 0.0
    chunk_overhead_ms = -1.0

    if mesh is not None and axes is not None and topo is not None:
        if isinstance(axes, tuple):               # ("node", "local")
            node_ax, local_ax = axes
            intra_samples = measure_all_to_all(mesh, local_ax, rows_list,
                                               device=device)
            inter_samples = measure_all_to_all(mesh, node_ax, rows_list,
                                               device=device)
            intra_bw, intra_lat = _fit_bw_lat(intra_samples)
            inter_bw, inter_lat = _fit_bw_lat(inter_samples)
            samples["a2a_intra"] = intra_samples
            samples["a2a_inter"] = inter_samples
            samples["psum"] = measure_psum(mesh, local_ax, rows_list[:2],
                                           device=device)
            overhead_ax = local_ax
        else:                                     # flat "model"
            flat_samples = measure_all_to_all(mesh, axes, rows_list,
                                              device=device)
            intra_bw, intra_lat = _fit_bw_lat(flat_samples)
            inter_bw, inter_lat = intra_bw, intra_lat
            samples["a2a_intra"] = flat_samples
            samples["psum"] = measure_psum(mesh, axes, rows_list[:2],
                                           device=device)
            overhead_ax = axes
        chunk_overhead_ms = measure_chunk_overhead_ms(
            mesh, overhead_ax, topo, device=device, intra_lat=intra_lat,
            inter_lat=inter_lat)
    if chunk_overhead_ms <= 0.0:
        from repro_torch.sched.cost import DEFAULT_CHUNK_OVERHEAD_MS
        chunk_overhead_ms = DEFAULT_CHUNK_OVERHEAD_MS

    plan_step_us, plan_samples = measure_plan_step_us(max(M, 2))
    samples["planning"] = plan_samples
    sim_speed, sim_t = measure_sim_speed(device=device)
    samples["similarity_s"] = sim_t
    samples["similarity_shape"] = [1, 64, 256]
    ffn_speed, ffn_t = measure_ffn_speed(device=device)
    samples["ffn_s"] = ffn_t
    samples["ffn_shape"] = [1, 512, 256, 1024]
    samples["probe_dtype"] = str(PROBE_DTYPE).replace("torch.", "")
    samples["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")

    calib = Calibration(
        key=key, intra_bw=intra_bw, inter_bw=inter_bw,
        intra_lat=intra_lat, inter_lat=inter_lat,
        chunk_overhead_ms=chunk_overhead_ms, plan_step_us=plan_step_us,
        sim_speed=sim_speed, ffn_speed=ffn_speed,
        # canonicalize (tuples -> lists) so the in-memory fit equals its
        # serialized round trip
        samples=json.loads(json.dumps(samples)))
    if out_dir is not None:
        save_calibration(out_dir, calib)
    return calib


# ---------------------------------------------------------------------------
# trace-mode phase probe
# ---------------------------------------------------------------------------

def probe_exchange(cfg, luffy, *, device="cuda", n_seq: int = 2,
                   seq_len: Optional[int] = None, seed: int = 0):
    """Drive ONE gate -> plan-build -> execute exchange on ``device``, so
    an active tracer records fenced ``plan_build`` / ``condense`` /
    ``dispatch`` / ``expert_ffn`` / ``combine`` phase spans of one MoE
    sublayer at a representative shape, one rank. Returns (y, aux)."""
    from repro_torch.core import moe_layer
    device = torch.device(device)
    S = seq_len if seq_len is not None else 64
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe_layer.moe_init(gen, cfg, device=device)
    x = torch.randn((n_seq, S, cfg.d_model), generator=gen, device=device)
    sideband = {"seq_len": torch.full((n_seq,), S, dtype=torch.int32,
                                      device=device)}
    capacity = moe_layer.capacity_for(cfg.moe, n_seq * S,
                                      cfg.moe.num_experts)
    luffy = dataclasses.replace(
        luffy, condense_group=min(luffy.condense_group, S))
    with torch.no_grad():
        y, _sb, _sn, aux = moe_layer.moe_core(
            params, x, sideband, cfg, luffy, mode="vanilla",
            capacity=capacity,
            threshold=torch.tensor(0.95, dtype=torch.float32,
                                   device=device))
    _sync(device)
    return y, aux


def probe_exchange_per_device(cfg, luffy, *, device="cuda", n_seq: int = 1,
                              seq_len: Optional[int] = None,
                              seed: int = 0,
                              max_devices: int = 8) -> Dict[int, float]:
    """Run :func:`probe_exchange` once on each visible CUDA device (the
    CPU alone when ``device`` is the CPU) and return ``{device_index:
    wall_ms}``, the straggler probe. Each run is under a
    ``probe_exchange`` span tagged ``device=i``; the dict feeds
    :func:`repro_torch.obs.monitor.device_dispersion`. On one card it is
    one entry (dispersion 1.0)."""
    from repro_torch.obs import trace as obs_trace
    device = torch.device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())][:max_devices]
               if device.type == "cuda" else [device])
    out: Dict[int, float] = {}
    for i, dev in enumerate(devices):
        with obs_trace.phase("probe_exchange", cat="probe", device=i):
            t0 = time.perf_counter()
            probe_exchange(cfg, luffy, device=dev, n_seq=n_seq,
                           seq_len=seq_len, seed=seed)
            out[i] = (time.perf_counter() - t0) * 1e3
    return out
