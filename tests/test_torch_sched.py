"""The port's pipelined executor (``repro_torch.sched``,
``exec_mode="pipeline"``) against the JAX reference, on the CPU.

- The chunk plans, the schedule, ``run_pipeline``'s issue order, the
  cost model, the ledger's pricing, ``estimate_exchange`` and
  ``plan_static_schedule`` equal the reference's (host floats, exactly).
- In the port, pipeline equals sync bit for bit at f32: the loss and
  every forward metric, over {migration, condensation} x {flat, hier} x
  chunks {3, 8} on the dense wire, the dedup wire (vanilla and migrate
  mode) at f32 and f8, wire error feedback (its residual too), and the
  sequence-sharded vanilla exchange; at one device pipeline is sync.
  Gradients (weight gradients add up per chunk) within 1e-5.
- Against the reference's own pipeline on a 4-device host mesh (one JAX
  subprocess, ``shard_map(check_vma=False)`` as in
  ``tests/test_torch_ep.py``, whose 8-device pipeline grids fail this
  JAX's vma check): reduced moe-gpt2 (d 256, 4 experts, 2 layers), B=8,
  S=128, 4 ranks flat and as 2 nodes of 2, condensation and migration on,
  the dense and dedup wires. The reference's Pallas K1 takes rows in
  blocks of 128, so its pipeline runs at chunks 4 and 8 (a chunk of
  4 x 64 or 4 x 32 rows). Loss and metrics bitwise, and the reference's
  pipeline bitwise its sync path; gradients within 1e-5 of ``jax.grad``
  of its ``use_kernels=False`` pipeline with condensation off (its
  gradient with condensation on has no multi-device oracle).
- The launchers take ``--exec-mode pipeline --pipeline-chunks {0, 3}``.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.comm import ledger as jledger
from repro.comm.topology import Topology as JTopology
from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.plan import estimate as jestimate
from repro.plan import exchange as jexchange
from repro.sched import cost as jcost
from repro.sched import pipeline as jpipe
from repro.sched import plan as jplan

import repro_torch.condense.wire as twire
import repro_torch.plan.exchange as tex
from repro_torch import convert, optim, sched
from repro_torch.comm import ledger as tledger
from repro_torch.comm.topology import Topology
from repro_torch.config import (LuffyConfig, ShapeConfig, reduced,
                                resolve_pipeline_chunks)
from repro_torch.configs import get_config
from repro_torch.core import moe_layer as tmoe
from repro_torch.data import SyntheticLM
from repro_torch.dist import make_dist
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.plan import estimate as testimate
from repro_torch.sched import cost as tcost
from repro_torch.sched import pipeline as tpipe

ROOT = os.path.join(os.path.dirname(__file__), "..")
WIRES = ("f32", "bf16", "f8e4m3")


# ---------------------------------------------------------------------------
# host-side: chunk plans, schedule, cost model, estimate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [8, 16, 40, 64, 136, 512, 2048])
def test_chunk_plans_equal_reference(capacity):
    for n in (0, 1, 2, 3, 4, 5, 8, 16, 100):
        got, want = sched.plan_chunks(capacity, n), jplan.plan_chunks(
            capacity, n)
        assert tuple(got) == tuple(want), (capacity, n)
        assert (got.n_chunks, got.offsets, got.slices()) == \
            (want.n_chunks, want.offsets, want.slices())
        for cap_u in (capacity, capacity + 4, 4, 12):
            assert tuple(sched.plan_unique_chunks(cap_u, n)) == \
                tuple(jplan.plan_unique_chunks(cap_u, n)), (cap_u, n)
    with pytest.raises(AssertionError):
        sched.plan_chunks(capacity + 4, 2)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_schedule_and_run_pipeline_equal_reference(n):
    for wc in (True, False):
        assert tuple(tpipe.pipeline_schedule(n, with_combine=wc)) == \
            tuple(jpipe.pipeline_schedule(n, with_combine=wc))
        assert tpipe.format_schedule(n, with_combine=wc) == \
            jpipe.format_schedule(n, with_combine=wc)

    def traced(run, **kw):
        calls = []

        def disp(k):
            calls.append(("dispatch", k))
            return 10 * k

        def comp(k, p):
            calls.append(("compute", k))
            return p + 1

        def comb(k, o):
            calls.append(("combine", k))
            return -o

        out = run(n, dispatch=disp, compute=comp, combine=comb, **kw)
        out2 = run(n, dispatch=disp, compute=comp, **kw)
        return calls, out, out2

    assert traced(sched.run_pipeline) == traced(jpipe.run_pipeline,
                                                barrier=False)
    # tensors through the port's executor on the CPU (no stream)
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(n))
    outs, backs = sched.run_pipeline(
        n, dispatch=lambda k: x[k] * 2.0, compute=lambda k, p: p + k,
        combine=lambda k, o: o.sum())
    assert all(torch.equal(outs[k], x[k] * 2.0 + k) for k in range(n))
    assert all(torch.equal(backs[k], outs[k].sum()) for k in range(n))
    assert tpipe.side_stream("cpu") is None


TOPOS = [(1, 4, 0.0, 0.0), (2, 2, 0.0, 0.0), (2, 4, 0.0, 0.0),
         (2, 2, 2e-6, 1e-5), (4, 2, 1e-6, 3e-5)]


def _topos(spec):
    N, L, li, le = spec
    return (Topology(N, L, intra_lat=li, inter_lat=le),
            JTopology(N, L, intra_lat=li, inter_lat=le))


@pytest.mark.parametrize("spec", TOPOS)
def test_cost_and_ledger_equal_reference(spec):
    t, j = _topos(spec)
    for top_k in (1, 2, 4):
        assert tledger.expected_dedup_factor(top_k, t) == \
            jledger.expected_dedup_factor(top_k, j)
        for dedup, rc in itertools.product((False, True), (0.0, 0.3)):
            kw = dict(r_cond=rc, bytes_per_el=2, num_layers=3, dedup=dedup)
            assert tledger.dispatch_bytes(4096, top_k, 768, topo=t, **kw) \
                == jledger.dispatch_bytes(4096, top_k, 768, topo=j, **kw)
    assert tledger.phase_messages(t) == jledger.phase_messages(j)
    assert tledger.chunk_latency_s(t) == jledger.chunk_latency_s(j)
    assert tledger.a2a_time_s(1e6, 3e6, t, messages_intra=2,
                              messages_inter=1) == \
        jledger.a2a_time_s(1e6, 3e6, j, messages_intra=2, messages_inter=1)
    for d_ms, f_ms, c_ms, o in ((1.0, 0.6, 0.8, 0.05), (0.01, 3.0, 0.0, 0.1),
                                (5.0, 0.2, 2.5, 0.0)):
        kw = dict(dispatch_ms=d_ms, ffn_ms=f_ms, combine_ms=c_ms,
                  chunk_overhead_ms=o)
        for n in range(1, 17):
            assert tcost.overlap_ms(t, n, **kw) == jcost.overlap_ms(j, n,
                                                                    **kw)
            dkw = dict(dispatch_inter_ms=d_ms, dispatch_intra_ms=d_ms / 3,
                       ffn_ms=f_ms, combine_inter_ms=c_ms,
                       combine_intra_ms=c_ms / 5, chunk_overhead_ms=o)
            assert tcost.dedup_overlap_ms(t, n, **dkw) == \
                jcost.dedup_overlap_ms(j, n, **dkw)
        assert tcost.sync_ms(t, **kw) == jcost.sync_ms(j, **kw)
        for mc in (1, 4, 16):
            assert tcost.optimal_chunks(t, max_chunks=mc, **kw) == \
                jcost.optimal_chunks(j, max_chunks=mc, **kw)
    for v in (None, -1.0, 0.0, 0.3):
        assert tcost.resolve_chunk_overhead_ms(v) == \
            jcost.resolve_chunk_overhead_ms(v)
    for tokens, bpe in ((0, 2), (8, 2), (64, 4)):
        assert tcost.decode_combine_ms(tokens, 768, t, bytes_per_el=bpe) \
            == jcost.decode_combine_ms(tokens, 768, j, bytes_per_el=bpe)
    for ov in (False, True):
        assert tcost.decode_step_ms(combine_ms=0.3, shared_ffn_ms=0.5,
                                    overlap=ov) == \
            jcost.decode_step_ms(combine_ms=0.3, shared_ffn_ms=0.5,
                                 overlap=ov)


@pytest.mark.parametrize("spec", TOPOS)
@pytest.mark.parametrize("wd", WIRES)
def test_estimate_equals_reference(spec, wd):
    t, j = _topos(spec)
    for chunks, bpe, ffn_ms in itertools.product(
            (None,) + tuple(range(1, 17)), (2, 4), (0.0, 0.7)):
        kw = dict(r_cond=0.25, locality=0.4, bytes_per_el=bpe,
                  num_layers=2, ffn_ms=ffn_ms, chunks=chunks,
                  chunk_overhead_ms=0.05, wire_dtype=wd)
        got = testimate.estimate_exchange(2048, 2, 768, topo=t, **kw)
        want = jestimate.estimate_exchange(2048, 2, 768, topo=j, **kw)
        assert tuple(got) == tuple(want), (chunks, bpe)
        assert got.speedup == want.speedup
    got = testimate.estimate_exchange(512, 2, 256, topo=t, intra_bw=1e9,
                                      inter_bw=2e8, wire_dtype=wd)
    assert tuple(got) == tuple(jestimate.estimate_exchange(
        512, 2, 256, topo=j, intra_bw=1e9, inter_bw=2e8, wire_dtype=wd))
    assert testimate.estimate_planning_ms(64, 4, q=3) == \
        jestimate.estimate_planning_ms(64, 4, q=3)
    assert testimate.estimate_revalidate_ms(64, 4) == \
        jestimate.estimate_revalidate_ms(64, 4)
    assert testimate.replica_consistency_ms(2, 768, 3072, topo=t) == \
        jestimate.replica_consistency_ms(2, 768, 3072, topo=j)
    assert testimate.estimate_similarity_ms(1e6, 768) == \
        jestimate.estimate_similarity_ms(1e6, 768)


@pytest.mark.parametrize("arch,T,cap", [("moe-gpt2", 2048, 512),
                                        ("moe-gpt2", 256, 64),
                                        ("moe-transformerxl", 1024, 256)])
def test_plan_static_schedule_equals_reference(arch, T, cap):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    d = tcfg.d_model
    for spec, M in ((None, 1), (TOPOS[0], 4), (TOPOS[1], 4), (TOPOS[2], 8),
                    (TOPOS[3], 4)):
        t, j = (None, None) if spec is None else _topos(spec)
        for ex, pc, wd, bpe in itertools.product(
                ("sync", "pipeline"), (0, 1, 3, 4, 8), WIRES, (2, 4)):
            kw = dict(exec_mode=ex, pipeline_chunks=pc, wire_dtype=wd)
            got = tex.plan_static_schedule(tcfg, LuffyConfig(**kw), t, M, T,
                                           d, cap, bpe, wd)
            want = jexchange.plan_static_schedule(jcfg, JLuffy(**kw), j, M,
                                                  T, d, cap, bpe, wd)
            assert got[0] == want[0] and tuple(got[1]) == tuple(want[1]), \
                (spec, ex, pc, wd)
            assert (got[2] is None) == (want[2] is None)
            if got[2] is not None:
                assert tuple(got[2]) == tuple(want[2]), (spec, ex, pc, wd)
            if ex == "pipeline" and M > 1 and pc > 0:
                assert got[1].n_chunks == min(pc, cap // 8)
    for pc in (None, 0, 3):
        for obj in ("traffic", "overlap"):
            from repro.config import resolve_pipeline_chunks as jres
            assert resolve_pipeline_chunks(pc, obj) == jres(pc, obj)


# ---------------------------------------------------------------------------
# pipeline == sync in the port, bit for bit at f32
# ---------------------------------------------------------------------------

PB, PS = 8, 64


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2"), num_layers=2,
                                      d_model=128), compute_dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    shape = ShapeConfig("t", PS, PB, "train")
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(cfg, shape).batch(0).items()}
    cap = tmoe.capacity_for(cfg.moe, PS, cfg.moe.num_experts, slack=8.0)
    return cfg, model, batch, cap


def _counting(monkeypatch):
    """Count run_pipeline's calls from the executor and the wire."""
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return tpipe.run_pipeline(*a, **kw)

    monkeypatch.setattr(tex, "run_pipeline", counted)
    monkeypatch.setattr(twire, "run_pipeline", counted)
    return calls


def _equal_runs(small, base, chunk_counts, monkeypatch, nodes, wire_ef=None):
    cfg, model, batch, cap = small
    dist = make_dist(make_host_mesh(model=4, nodes=nodes), "train", PB,
                     moe_arch=True)
    thr = torch.tensor(0.4)
    ls, ms = ttf.forward_train(model.params, cfg, base, batch, thr, cap,
                               dist=dist, wire_ef=wire_ef)
    calls = _counting(monkeypatch)
    for nc in chunk_counts:
        pipe = dataclasses.replace(base, exec_mode="pipeline",
                                   pipeline_chunks=nc)
        n0 = calls[0]
        lp, mp = ttf.forward_train(model.params, cfg, pipe, batch, thr, cap,
                                   dist=dist, wire_ef=wire_ef)
        assert calls[0] > n0, "the pipeline did not run"
        assert lp.item() == ls.item(), (nc, lp.item(), ls.item())
        for key in ms:
            assert torch.equal(torch.as_tensor(ms[key]),
                               torch.as_tensor(mp[key])), (nc, key)
    return ls, ms


@pytest.mark.parametrize("cm,nodes", [("flat", 0), ("hier", 2)])
@pytest.mark.parametrize("mig,cond", list(itertools.product((True, False),
                                                            repeat=2)))
def test_pipeline_equals_sync_dense(small, monkeypatch, cm, nodes, mig,
                                    cond):
    base = LuffyConfig(enable_condensation=cond, enable_migration=mig,
                       combine_slack=4.0, condense_group=32, comm_mode=cm)
    _equal_runs(small, base, (3, 8), monkeypatch, nodes)


@pytest.mark.parametrize("mig", [True, False])
@pytest.mark.parametrize("wd", ["f32", "f8e4m3"])
def test_pipeline_equals_sync_dedup(small, monkeypatch, mig, wd):
    base = LuffyConfig(enable_migration=mig, combine_slack=4.0,
                       condense_group=32, comm_mode="hier", hier_dedup="on",
                       wire_dtype=wd)
    _equal_runs(small, base, (3, 8), monkeypatch, 2)


@pytest.mark.parametrize("dd", ["off", "on"])
def test_pipeline_equals_sync_error_feedback(small, monkeypatch, dd):
    """f8 wire with a carried residual: the loss, the metrics and the
    refreshed residual (``_wire_ef``) bit for bit."""
    cfg = small[0]
    ef = torch.randn(ttf.wire_ef_shape(cfg, PB, PS),
                     generator=torch.Generator().manual_seed(3)) * 1e-2
    base = LuffyConfig(combine_slack=4.0, condense_group=32,
                       comm_mode="hier", hier_dedup=dd, wire_dtype="f8e4m3",
                       wire_error_feedback=True)
    _, ms = _equal_runs(small, base, (3,), monkeypatch, 2, wire_ef=ef)
    assert ms["_wire_ef"].abs().max() > 0


def test_pipeline_sequence_sharded_equals_sync(small, monkeypatch):
    """The vanilla exchange in the sequence-sharded layout (the EP
    prefill's and the seq-sharded train shape's)."""
    cfg, model, _, _ = small
    B = 6                   # does not split over 4 ranks: the sequence does
    shape = ShapeConfig("t", PS, B, "train")
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(cfg, shape).batch(0).items()}
    dist = make_dist(make_host_mesh(model=4), "train", B, moe_arch=True)
    assert dist.seq_sharded
    base = LuffyConfig(enable_condensation=False, enable_migration=False)
    cap = tmoe.capacity_for(cfg.moe, B * PS // 4, cfg.moe.num_experts)
    thr = torch.tensor(0.4)
    ls, ms = ttf.forward_train(model.params, cfg, base, batch, thr, cap,
                               dist=dist)
    calls = _counting(monkeypatch)
    pipe = dataclasses.replace(base, exec_mode="pipeline", pipeline_chunks=3)
    lp, mp = ttf.forward_train(model.params, cfg, pipe, batch, thr, cap,
                               dist=dist)
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    assert calls[0] == n_moe > 0 and lp.item() == ls.item()
    assert all(torch.equal(torch.as_tensor(ms[k]), torch.as_tensor(mp[k]))
               for k in ms)


def test_pipeline_gradients_within_tolerance_of_sync(small):
    """Weight gradients add up per chunk, so pipeline's may differ from
    sync's in the last ulp: every leaf within 1e-5 relative."""
    cfg, model, batch, cap = small
    dist = make_dist(make_host_mesh(model=4, nodes=2), "train", PB,
                     moe_arch=True)
    grads = []
    for ex in ("sync", "pipeline"):
        params = optim.tree_map(
            lambda p: p.detach().clone().requires_grad_(), model.params)
        lf = LuffyConfig(combine_slack=4.0, condense_group=32,
                         comm_mode="hier", exec_mode=ex, pipeline_chunks=3)
        loss, _ = ttf.forward_train(params, cfg, lf, batch,
                                    torch.tensor(0.4), cap, dist=dist)
        loss.backward()
        grads.append({n: p.grad for n, p in optim.leaves_with_path(params)})
    for n, g in grads[0].items():
        err = (grads[1][n] - g).norm() / max(g.norm(), 1e-12)
        assert err <= 1e-5, (n, float(err))


def test_pipeline_single_device_is_sync():
    """One rank: pipeline is the sync path (the reference's
    ``test_pipeline_single_device_falls_back_to_sync``)."""
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                              compute_dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(g, cfg, device="cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    sb = {"seq_len": torch.full((2,), 16, dtype=torch.int32)}
    base = LuffyConfig(enable_condensation=False, enable_migration=False)
    pipe = dataclasses.replace(base, exec_mode="pipeline", pipeline_chunks=4)
    ys = tmoe.moe_core(p, x, sb, cfg, base, mode="vanilla", capacity=256)[0]
    yp = tmoe.moe_core(p, x, sb, cfg, pipe, mode="vanilla", capacity=256)[0]
    assert torch.equal(ys, yp)
    piped, chunks, est = tex.schedule_of(cfg, pipe, None, 32, 256)
    assert not piped and chunks.n_chunks == 1 and est is None


# ---------------------------------------------------------------------------
# the reference's pipeline on a 4-device host mesh
# ---------------------------------------------------------------------------

B, S, M, NODES, THR, SLACK = 8, 128, 4, 2, 0.6, 4.0
# (comm mode, nodes, hier_dedup, chunk counts of the pipeline)
GRID = [("flat", 0, "off", (4, 8)), ("hier", NODES, "off", (8,)),
        ("hier", NODES, "on", (4,))]
GRAD_CHUNKS = 3
BITWISE = ("condense_rate", "local_frac", "traffic_before", "traffic_after",
           "inter_bytes_flat", "inter_bytes_dedup", "inter_bytes_shipped",
           "dispatch_drop", "combine_drop")

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.comm as rcomm
    import repro.comm.compat as compat
    from repro import train_lib
    from repro.config import LuffyConfig, ShapeConfig, reduced
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.dist import make_dist
    from repro.launch.mesh import make_host_mesh, topology_for_mesh
    from repro.models.model import build_model
    B, S, M, NODES, THR, SLACK, GRID, GRAD_CHUNKS, BITWISE = %s
    out = {}
    shape = ShapeConfig("train", S, B, "train")
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                              compute_dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLM(cfg, shape).batch(0).items()}

    def dist_of(nodes):
        mesh = make_host_mesh(model=M, nodes=nodes)
        return make_dist(mesh, "train", B, moe_arch=True,
                         topology=topology_for_mesh(mesh))

    # gradients: the jnp path, condensation off, unpatched
    dist = dist_of(NODES)
    for ex in ("sync", "pipeline"):
        lf = LuffyConfig(comm_mode="hier", hier_dedup="on",
                         combine_slack=SLACK, enable_condensation=False,
                         exec_mode=ex, pipeline_chunks=GRAD_CHUNKS)
        cap = train_lib.capacity_for_bucket(cfg, shape, dist, lf, 0)
        f = lambda p: build_model(cfg).train_loss(
            p, batch, jnp.float32(THR), luffy=lf, dist=dist, capacity=cap)
        (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        out[f"grad/{ex}/loss"] = np.float32(loss)
        for path, leaf in jax.tree_util.tree_leaves_with_path(g):
            out[f"grad/{ex}/" + jax.tree_util.keystr(path)] = \\
                np.asarray(leaf)

    # forwards: the kernel path, shard_map's vma check off
    def _sm(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = _sm
    rcomm.shard_map = _sm
    for cm, nodes, dd, counts in GRID:
        dist = dist_of(nodes)
        for ex, nc in [("sync", 0)] + [("pipeline", n) for n in counts]:
            lf = LuffyConfig(comm_mode=cm, hier_dedup=dd,
                             combine_slack=SLACK, use_kernels=True,
                             exec_mode=ex, pipeline_chunks=max(nc, 1))
            cap = train_lib.capacity_for_bucket(cfg, shape, dist, lf, 0)
            loss, m = jax.jit(lambda p, b: build_model(cfg).train_loss(
                p, b, jnp.float32(THR), luffy=lf, dist=dist,
                capacity=cap))(params, batch)
            key = f"fwd/{cm}/{dd}/{nc}/"
            out[key + "loss"] = np.float32(loss)
            for k in BITWISE:
                out[key + k] = np.float32(m[k])
    np.savez(sys.argv[1], **out)
    print("OK")
""") % repr((B, S, M, NODES, THR, SLACK, GRID, GRAD_CHUNKS, BITWISE))


def _ref_cfg():
    return dataclasses.replace(jreduced(jget_config("moe-gpt2")),
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    from repro.models.model import build_model as jbuild_model
    path = tmp_path_factory.mktemp("sched") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    params = jbuild_model(_ref_cfg()).init(jax.random.PRNGKey(0))
    return {"npz": dict(np.load(path)),
            "params": jax.tree.map(np.asarray, params)}


def _port_setup(oracle, nodes, grad=False):
    tcfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                               compute_dtype="float32")
    params = convert.from_reference(oracle["params"], tcfg)
    if grad:
        for _, p in optim.leaves_with_path(params):
            p.requires_grad_()
    shape = ShapeConfig("t", S, B, "train")
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(tcfg, shape).batch(0).items()}
    dist = make_dist(make_host_mesh(model=M, nodes=nodes), "train", B,
                     moe_arch=True)
    return tcfg, params, shape, batch, dist


@pytest.mark.parametrize("cm,nodes,dd,counts", GRID)
def test_pipeline_matches_reference_pipeline(oracle, cm, nodes, dd, counts):
    tcfg, params, shape, batch, dist = _port_setup(oracle, nodes)
    ref = oracle["npz"]
    sync = f"fwd/{cm}/{dd}/0/"
    for nc in counts:
        key = f"fwd/{cm}/{dd}/{nc}/"
        # the reference's own contract: its pipeline is its sync path
        for k in ("loss",) + BITWISE:
            assert ref[key + k] == ref[sync + k], (nc, k)
        lf = LuffyConfig(comm_mode=cm, hier_dedup=dd, combine_slack=SLACK,
                         exec_mode="pipeline", pipeline_chunks=nc)
        cap = tmoe.capacity_for(tcfg.moe, B // M * S, tcfg.moe.num_experts)
        piped, chunks, _ = tex.schedule_of(tcfg, lf, dist.comm(cm),
                                           B // M * S, cap)
        assert piped and chunks.n_chunks == nc
        loss, m = ttf.forward_train(params, tcfg, lf, batch,
                                    torch.tensor(THR), cap, dist=dist)
        assert loss.item() == float(ref[key + "loss"]), nc
        for k in BITWISE:
            assert np.float32(m[k].item()) == ref[key + k], (nc, k)
        assert m["traffic_after"] < m["traffic_before"]
        assert 0.5 < m["condense_rate"] < 1.0


def test_pipeline_gradients_match_jax_grad(oracle):
    tcfg, params, shape, batch, dist = _port_setup(oracle, NODES, grad=True)
    lf = LuffyConfig(comm_mode="hier", hier_dedup="on", combine_slack=SLACK,
                     enable_condensation=False, exec_mode="pipeline",
                     pipeline_chunks=GRAD_CHUNKS)
    cap = tmoe.capacity_for(tcfg.moe, B // M * S, tcfg.moe.num_experts)
    loss, _ = ttf.forward_train(params, tcfg, lf, batch, torch.tensor(THR),
                                cap, dist=dist)
    loss.backward()
    ref = oracle["npz"]
    np.testing.assert_allclose(loss.item(), ref["grad/pipeline/loss"],
                               rtol=1e-5)
    assert ref["grad/pipeline/loss"] == ref["grad/sync/loss"]
    grads = convert.to_reference(optim.tree_map(lambda p: p.grad, params),
                                 tcfg)
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        g = np.asarray(g, np.float64)
        w = ref["grad/pipeline/" + jax.tree_util.keystr(path)].astype(
            np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)
        n += 1
    assert n > 10


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [0, 3])
def test_launchers_pipeline_cpu(capsys, chunks):
    res = ttrain.main(["--reduced", "--steps", "2", "--model-axis", "4",
                       "--comm-mode", "hier", "--nodes", "2",
                       "--hier-dedup", "on", "--wire-dtype", "f8e4m3",
                       "--exec-mode", "pipeline", "--pipeline-chunks",
                       str(chunks), "--device", "cpu"])
    out = capsys.readouterr().out
    luffy = res["luffy"]
    assert luffy.exec_mode == "pipeline" and luffy.pipeline_chunks == chunks
    cap = res["steps"][0]["capacity"]
    want = tex.schedule_of(res["cfg"], luffy, res["dist"].comm("hier"),
                           res["global_batch"] * res["seq_len"] // 4, cap)
    n = want[1].n_chunks
    assert f"exec_mode=pipeline pipeline_chunks={chunks} chunks={n}" in out
    if chunks:
        assert n == chunks
    for st in res["steps"]:
        assert np.isfinite(st["loss"]) and st["chunks"] == n
        assert 0.0 < st["inter_bytes_shipped"] < st["inter_bytes_dedup"]
    sres = tserve.main(["--reduced", "--model-axis", "4", "--batch", "4",
                        "--prompt-len", "32", "--gen", "2", "--prefill",
                        "batch", "--exec-mode", "pipeline",
                        "--pipeline-chunks", str(chunks), "--device",
                        "cpu"])
    out = capsys.readouterr().out
    assert f"exec_mode=pipeline pipeline_chunks={chunks} chunks=" \
        f"{sres['chunks']} in the prefill" in out
    if chunks:
        assert sres["chunks"] == chunks
    sync = tserve.main(["--reduced", "--model-axis", "4", "--batch", "4",
                        "--prompt-len", "32", "--gen", "2", "--prefill",
                        "batch", "--device", "cpu"])
    capsys.readouterr()
    assert torch.equal(sres["prefill_logits"], sync["prefill_logits"])
    assert torch.equal(sres["tokens"], sync["tokens"])
    assert tserve.parse_args(["--exec-mode", "decode_overlap"]).exec_mode \
        == "decode_overlap"
    assert resolve_pipeline_chunks(None, "traffic") == 4
