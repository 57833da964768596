"""The "replicate" and "overlap" objectives on the port's expert-parallel
train path against the JAX reference, on the CPU.

One JAX subprocess runs the reference on a 4-device ``(node=2,
local=2)`` host mesh: reduced moe-gpt2 with 8 experts at f32, B=8,
S=128, capacity 64 (K1's rows, 4 x 64 and 4 x 32 a chunk, are multiples
of the 128 its Pallas kernel takes), ``gpu_speed=1e11`` and every MoE
router's column 0 pushed by 4 times the unit vector of the batch's mean
token embedding: at 4 experts top-2 caps any expert at twice the mean
demand, and at the default speed the modelled relief never beats the
replica-consistency cost, so no replica could fire. Its plans reach the
host through ``jax.debug.callback`` (per device, in layer order).

- Kernel path (``use_kernels=True``, ``shard_map(check_vma=False)`` in
  that process only, as ``tests/test_torch_ep.py``): "replicate" sync and
  pipelined (2 chunks), condensation off and on, "traffic" sync and
  "overlap" pipelined at the estimate's chunk count. Every plan's
  ``replica_src``, ``replica_valid``, positions and destinations, and the
  metrics (drops, locality, traffic, inter-node bytes, condensation
  rate) bitwise; the loss within 2 f32 ulps (:data:`LOSS_ULPS`).
- Gradients: ``jax.grad`` of the reference's ``use_kernels=False`` path
  (unpatched), condensation off, sync and pipelined: every leaf within
  1e-5.
- Sanity: without condensation a lane goes live in every MoE sublayer
  and "replicate" drops fewer copies than "traffic" on the same inputs
  (condensed, the hot expert's demand falls under the skew bound and
  the lanes stay idle, in the reference too); the pipelined port equals
  its sync path bit for bit in the forward.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config

import repro_torch.plan.exchange as tex
from repro_torch import convert, optim
from repro_torch.config import LuffyConfig, ShapeConfig, reduced
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.dist import make_dist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as ttf

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S, M, NODES, THR, SLACK, CAP, SPEED, BIAS = \
    8, 128, 4, 2, 0.6, 4.0, 64, 1e11, 4.0
# (objective, exec_mode, pipeline_chunks, condensation) of the kernel path
FWD = [("replicate", "sync", 1, False), ("replicate", "pipeline", 2, False),
       ("replicate", "sync", 1, True), ("replicate", "pipeline", 2, True),
       ("traffic", "sync", 1, False), ("overlap", "pipeline", 0, False)]
GRAD = [("replicate", "sync", 1), ("replicate", "pipeline", 2)]
BITWISE = ("dispatch_drop", "combine_drop", "condense_rate", "local_frac",
           "traffic_before", "traffic_after", "inter_bytes_flat",
           "inter_bytes_dedup")
PLAN = ("replica_src", "replica_valid", "positions", "dest_global")
# The MoE sublayers' outputs differ from the reference's in their last
# bits on every path here, "traffic" too (torch's f32 products against
# XLA's: up to 3.1e-6 at layer 2, in 60-77% of the entries), while every
# plan and metric is bitwise; the loss lands within 2 f32 ulps (the
# replicate runs) or equal ("traffic").
LOSS_ULPS = 2


def bias_router(params, tokens, bias):
    """Push every MoE router's column 0 by ``bias`` times the unit vector
    of the batch's mean token embedding (numpy, in place)."""
    emb = params["embed"]["table"][np.asarray(tokens)].astype(
        np.float64).mean(axis=(0, 1))
    u = (emb / np.linalg.norm(emb)).astype(np.float32)
    for lay in params["layers"]:
        if "moe" in lay:
            w = np.array(lay["moe"]["router"]["w_gate"])
            w[..., :, 0] += np.float32(bias) * u
            lay["moe"]["router"]["w_gate"] = w
    return params


ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.comm as rcomm
    import repro.comm.compat as compat
    import repro.core.moe_layer as rml
    from repro.config import LuffyConfig, ShapeConfig, reduced
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.dist import make_dist
    from repro.launch.mesh import make_host_mesh, topology_for_mesh
    from repro.models.model import build_model
    (B, S, M, NODES, THR, SLACK, CAP, SPEED, BIAS, FWD, GRAD,
     BITWISE) = %s
    %s
    out = {}
    shape = ShapeConfig("train", S, B, "train")
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2"),
                                      max_experts=8),
                              compute_dtype="float32")
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(0)))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLM(cfg, shape).batch(0).items()}
    params = bias_router(params, batch["tokens"], BIAS)
    mesh = make_host_mesh(model=M, nodes=NODES)
    dist = make_dist(mesh, "train", B, moe_arch=True,
                     topology=topology_for_mesh(mesh))
    rec = []
    orig = rml.build_exchange_plan

    def build(*a, **kw):
        plan = orig(*a, **kw)
        none_i = jnp.zeros((0,), jnp.int32)

        def cb(my, *vals):
            rec.append((int(my), [np.asarray(v) for v in vals]))
        jax.debug.callback(
            cb, plan.comm.index(),
            none_i if plan.replica_src is None else plan.replica_src,
            none_i if plan.replica_valid is None else plan.replica_valid,
            plan.positions, plan.dest_global)
        return plan
    rml.build_exchange_plan = build

    def luffy(obj, ex, nc, cond, kernels):
        return LuffyConfig(comm_mode="hier", combine_slack=SLACK,
                           enable_condensation=cond, plan_objective=obj,
                           gpu_speed=SPEED, use_kernels=kernels,
                           exec_mode=ex, pipeline_chunks=nc)

    for obj, ex, nc in GRAD:
        lf = luffy(obj, ex, nc, False, False)
        f = lambda p: build_model(cfg).train_loss(
            p, batch, jnp.float32(THR), luffy=lf, dist=dist, capacity=CAP)
        (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        key = f"grad/{obj}/{ex}/"
        out[key + "loss"] = np.float32(loss)
        for path, leaf in jax.tree_util.tree_leaves_with_path(g):
            out[key + jax.tree_util.keystr(path)] = np.asarray(leaf)

    def _sm(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = _sm
    rcomm.shard_map = _sm
    for obj, ex, nc, cond in FWD:
        lf = luffy(obj, ex, nc, cond, True)
        rec.clear()
        loss, m = jax.jit(lambda p, b: build_model(cfg).train_loss(
            p, b, jnp.float32(THR), luffy=lf, dist=dist,
            capacity=CAP))(params, batch)
        jax.block_until_ready(loss)
        key = f"fwd/{obj}/{ex}/{nc}/{int(cond)}/"
        out[key + "loss"] = np.float32(loss)
        for k in BITWISE:
            out[key + k] = np.float32(m[k])
        seen = {}
        for my, vals in rec:
            layer = seen.get(my, 0)
            seen[my] = layer + 1
            for name, v in zip(("replica_src", "replica_valid",
                                "positions", "dest_global"), vals):
                out[f"{key}plan/{layer}/{my}/{name}"] = v
    np.savez(sys.argv[1], **out)
    print("OK")
""") % (repr((B, S, M, NODES, THR, SLACK, CAP, SPEED, BIAS, FWD, GRAD,
             BITWISE)),
        textwrap.indent(inspect.getsource(bias_router), "    ").strip())


def _ref_cfg():
    return dataclasses.replace(
        jreduced(jget_config("moe-gpt2"), max_experts=8),
        compute_dtype="float32")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    from repro.models.model import build_model as jbuild_model
    path = tmp_path_factory.mktemp("replicate") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    params = jax.tree.map(
        np.asarray, jbuild_model(_ref_cfg()).init(jax.random.PRNGKey(0)))
    return {"npz": dict(np.load(path)), "params": params}


def _setup(oracle, grad=False):
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2"), max_experts=8),
                              compute_dtype="float32")
    shape = ShapeConfig("t", S, B, "train")
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(cfg, shape).batch(0).items()}
    ref = jax.tree.map(np.array, oracle["params"])
    params = convert.from_reference(
        bias_router(ref, batch["tokens"].numpy(), BIAS), cfg)
    if grad:
        for _, p in optim.leaves_with_path(params):
            p.requires_grad_()
    dist = make_dist(make_host_mesh(model=M, nodes=NODES), "train", B,
                     moe_arch=True)
    return cfg, params, batch, dist


def _luffy(obj, ex, nc, cond):
    return LuffyConfig(comm_mode="hier", combine_slack=SLACK,
                       enable_condensation=cond, plan_objective=obj,
                       gpu_speed=SPEED, exec_mode=ex, pipeline_chunks=nc)


def _run(oracle, monkeypatch, obj, ex, nc, cond):
    cfg, params, batch, dist = _setup(oracle)
    plans = []
    orig = tex.build_exchange_plan

    def rec(*a, **kw):
        plans.append(orig(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(tex, "build_exchange_plan", rec)
    with torch.no_grad():
        loss, m = ttf.forward_train(params, cfg, _luffy(obj, ex, nc, cond),
                                    batch, torch.tensor(THR), CAP, dist=dist)
    monkeypatch.setattr(tex, "build_exchange_plan", orig)
    return loss, m, plans


def _plan_field(plan, name, my):
    if name == "replica_src":
        return (np.zeros((0,), np.int32) if plan.replica_src is None
                else plan.replica_src.numpy())
    if name == "replica_valid":
        return (np.zeros((0,), bool) if plan.replica_valid is None
                else plan.replica_valid[my].numpy())
    return getattr(plan, name)[my].numpy()


@pytest.mark.parametrize("obj,ex,nc,cond", FWD)
def test_forward_matches_reference(oracle, monkeypatch, obj, ex, nc, cond):
    ref = oracle["npz"]
    key = f"fwd/{obj}/{ex}/{nc}/{int(cond)}/"
    loss, m, plans = _run(oracle, monkeypatch, obj, ex, nc, cond)
    want = np.float32(ref[key + "loss"])
    assert abs(np.float32(loss.item()) - want) <= LOSS_ULPS \
        * np.spacing(want), (loss.item(), want)
    for k in BITWISE:
        assert np.float32(m[k].item()) == ref[key + k], k
    n_moe = len(plans)
    assert n_moe == 2
    for layer, plan in enumerate(plans):
        for my in range(M):
            for name in PLAN:
                np.testing.assert_array_equal(
                    _plan_field(plan, name, my),
                    ref[f"{key}plan/{layer}/{my}/{name}"],
                    err_msg=f"layer {layer} rank {my} {name}")
    if obj == "replicate":
        # a live lane takes copies; without condensation one is live in
        # every MoE sublayer and the run drops fewer than traffic's
        # (condensed, the hot expert's demand falls under the skew bound
        # here: the lanes stay idle in the reference too)
        live = [bool((p.replica_src >= 0).any()) for p in plans]
        assert cond or all(live), live
        assert all(p.replica_valid.any() == lv for p, lv in zip(plans, live))
        if not cond:
            t = ref["fwd/traffic/sync/1/0/dispatch_drop"]
            assert m["dispatch_drop"].item() < t
    if ex == "pipeline" and obj == "replicate":
        sync = _run(oracle, monkeypatch, obj, "sync", 1, cond)
        assert sync[0].item() == loss.item()
        assert all(torch.equal(torch.as_tensor(sync[1][k]),
                               torch.as_tensor(m[k])) for k in m)


def test_overlap_plans_and_chunk_count(oracle, monkeypatch):
    """"overlap" at the estimate's chunk count: its plans equal the
    reference's (held above); whether they moved sequences other than
    traffic's does is recorded, and the chunk count is the estimate's."""
    ref = oracle["npz"]
    cfg, _, _, dist = _setup(oracle)
    lf = _luffy("overlap", "pipeline", 0, False)
    piped, chunks, est = tex.schedule_of(cfg, lf, dist.comm("hier"),
                                         B // M * S, CAP)
    assert piped and chunks.n_chunks == est.chunks >= 1
    _, _, plans = _run(oracle, monkeypatch, "overlap", "pipeline", 0, False)
    differ = [any(not np.array_equal(
        plan.dest_global[my].numpy(),
        ref[f"fwd/traffic/sync/1/0/plan/{layer}/{my}/dest_global"])
        for my in range(M)) for layer, plan in enumerate(plans)]
    print(f"overlap at {chunks.n_chunks} chunks: plans differ from "
          f"traffic's per sublayer: {differ}")
    assert all(p.objective == "overlap" and p.replica_src is None
               for p in plans)


@pytest.mark.parametrize("obj,ex,nc", GRAD)
def test_gradients_match_jax_grad(oracle, obj, ex, nc):
    cfg, params, batch, dist = _setup(oracle, grad=True)
    loss, _ = ttf.forward_train(params, cfg, _luffy(obj, ex, nc, False),
                                batch, torch.tensor(THR), CAP, dist=dist)
    loss.backward()
    ref = oracle["npz"]
    key = f"grad/{obj}/{ex}/"
    np.testing.assert_allclose(loss.item(), ref[key + "loss"], rtol=1e-5)
    grads = convert.to_reference(optim.tree_map(lambda p: p.grad, params),
                                 cfg)
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        g = np.asarray(g, np.float64)
        w = ref[key + jax.tree_util.keystr(path)].astype(np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)
        n += 1
    assert n > 10


def test_train_launcher_objectives_cpu(capsys):
    """The train launcher's ``--plan-objective`` and ``--inter-bw``: the
    objective reaches the plans, the override the topology and the
    estimate; "overlap" defaults to the estimate's chunk count."""
    from repro_torch.launch import train as ttrain
    base = ["--reduced", "--experts", "8", "--steps", "1", "--model-axis",
            "4", "--comm-mode", "hier", "--nodes", "2", "--device", "cpu"]
    res = ttrain.main(base + ["--plan-objective", "replicate", "--inter-bw",
                              "6e9"])
    out = capsys.readouterr().out
    assert "plan_objective=replicate" in out
    assert res["luffy"].plan_objective == "replicate"
    assert res["dist"].topology.inter_bw == 6e9
    assert res["dist"].topology.intra_bw == 4.9e10
    assert np.isfinite(res["steps"][0]["loss"])
    res = ttrain.main(base + ["--plan-objective", "overlap", "--exec-mode",
                              "pipeline"])
    capsys.readouterr()
    assert res["luffy"].pipeline_chunks == 0 and res["steps"][0]["chunks"] \
        >= 1
    with pytest.raises(SystemExit):
        ttrain.parse_args(["--plan-objective", "nope"])
