"""The port's expert-parallel train slice (virtual ranks) against the
JAX reference on a 4-device ``(node=2, local=2)`` mesh, on the CPU.

Reduced moe-gpt2 (2 layers, d 256, 4 experts, one per rank), B=8,
S=128, M=4 ranks as 2 nodes of 2, condensation (threshold 0.6) and
migration on, ``combine_slack`` 4. The reference runs once per module in
a subprocess (``--xla_force_host_platform_device_count=4``) that writes
an .npz; the port gets the same parameters through
``repro_torch.convert`` and the same synthetic batch.

Oracles:
- forward: ``model.train_loss`` under jit with ``use_kernels=True`` (the
  Pallas kernels interpreted) and, in the subprocess only, ``shard_map``
  with ``check_vma=False``: with condensation on, this JAX's vma check
  rejects the reference's own ``lax.cond`` and its Pallas K4 inside
  ``shard_map`` (the reference's 8-device tests fail on this tree for
  that reason); with condensation off the flag changes no value.
  Matrix: {flat, hier} x {dense, dedup} on the f32 wire, and the dedup
  wire at bf16 and f8e4m3, at f32 and bf16 compute. Loss within 1e-5
  relative (bit-equal on the f32 wire at f32 compute); the condense
  rate, ``local_frac``, traffic before/after, inter-node bytes flat,
  dedup and shipped, and every layer's migration perm and rep map
  bitwise.
- gradients: ``jax.grad`` of the ``use_kernels=False`` path (the
  reference cannot differentiate its Pallas kernels), unpatched, with
  condensation off (its multi-device gradient with condensation on fails
  the vma check even patched), migration on, hier x dedup, each wire.
  Every leaf within 1e-5 relative on the f32 wire, 3e-3 on the lossy
  wires (their cotangent casts round at the margin differently after
  float sums in another order); the global norm within 1e-5 / 1e-4. The
  f8 wire shows the reference's zeroed expert-path gradient.
- a 3-step AdamW trajectory (hier, dedup, f32 wire, condensation off):
  losses within 1e-5, gradient norms within 1e-4.
"""
import dataclasses
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
from repro.models.model import build_model as jbuild_model

import repro_torch.plan.exchange as tex
from repro_torch import convert, optim, train_lib
from repro_torch.comm.topology import Topology
from repro_torch.config import (LuffyConfig, OptimConfig, ShapeConfig,
                                reduced)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.dist import DistContext, make_dist
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as ttf

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S, M, NODES, THR, SLACK = 8, 128, 4, 2, 0.6, 4.0
FWD = [("hier", "off", "f32"), ("flat", "off", "f32"), ("hier", "on", "f32"),
       ("flat", "on", "f32"), ("hier", "on", "bf16"),
       ("hier", "on", "f8e4m3")]
WIRES = ("f32", "bf16", "f8e4m3")
BITWISE = ("condense_rate", "local_frac", "traffic_before", "traffic_after",
           "inter_bytes_flat", "inter_bytes_dedup", "inter_bytes_shipped",
           "dispatch_drop", "combine_drop")

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.comm as rcomm
    import repro.comm.compat as compat
    import repro.core.moe_layer as jml
    import repro.plan.exchange as jex
    from repro import optim as joptim, train_lib
    from repro.config import LuffyConfig, OptimConfig, ShapeConfig, reduced
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.dist import make_dist
    from repro.launch.mesh import make_host_mesh, topology_for_mesh
    from repro.models.model import build_model
    B, S, M, NODES, THR, SLACK, FWD, WIRES, BITWISE = %s
    out = {}
    mesh = make_host_mesh(model=M, nodes=NODES)
    dist = make_dist(mesh, "train", B, moe_arch=True,
                     topology=topology_for_mesh(mesh))
    shape = ShapeConfig("train", S, B, "train")

    def cfg_of(cdt):
        return dataclasses.replace(reduced(get_config("moe-gpt2")),
                                   compute_dtype=cdt)

    params = build_model(cfg_of("float32")).init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLM(cfg_of("float32"), shape).batch(0).items()}
    # which experts each rank's shard of the stacked [E, ...] weights holds
    E = cfg_of("float32").moe.num_experts
    arr = jax.device_put(jnp.arange(E), NamedSharding(
        mesh, P(dist.model_axis)))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    out["expert_shards"] = np.stack([by_dev[d] for d in mesh.devices.flat])

    def luffy(cm, dd, wd, **kw):
        return LuffyConfig(comm_mode=cm, hier_dedup=dd, wire_dtype=wd,
                           combine_slack=SLACK, **kw)

    # gradients and the AdamW trajectory: the jnp path, unpatched
    cfg = cfg_of("float32")
    for wd in WIRES:
        lf = luffy("hier", "on", wd, enable_condensation=False)
        cap = train_lib.capacity_for_bucket(cfg, shape, dist, lf, 0)
        f = lambda p: build_model(cfg).train_loss(
            p, batch, jnp.float32(THR), luffy=lf, dist=dist, capacity=cap)
        (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        out[f"grad/{wd}/loss"] = np.float32(loss)
        for path, leaf in jax.tree_util.tree_leaves_with_path(g):
            out[f"grad/{wd}/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
    lf = luffy("hier", "on", "f32", enable_condensation=False)
    cap = train_lib.capacity_for_bucket(cfg, shape, dist, lf, 0)
    ocfg = OptimConfig(lr=1e-3, total_steps=3, warmup_steps=2)
    step = jax.jit(train_lib.make_train_step(cfg, lf, ocfg, dist, cap))
    p, os_, ls = params, joptim.init_opt_state(params, ocfg), \\
        train_lib.init_luffy_state()
    data = SyntheticLM(cfg, shape)
    losses, gns = [], []
    for i in range(3):
        b = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        p, os_, ls, m = step(p, os_, ls, b)
        losses.append(float(m["loss"]))
        gns.append(float(m["grad_norm"]))
    out["adamw/loss"] = np.array(losses)
    out["adamw/grad_norm"] = np.array(gns)

    # forwards: the kernel path, shard_map's vma check off
    def _sm(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = _sm
    rcomm.shard_map = _sm
    rec = []
    orig = jex.build_exchange_plan

    def wrap(*a, **kw):
        pl = orig(*a, **kw)
        jax.debug.callback(
            lambda i, dg, rep: rec.append((int(i), np.asarray(dg),
                                           np.asarray(rep))),
            pl.comm.index(), pl.dest_global, pl.rep_idx)
        return pl

    jml.build_exchange_plan = wrap
    for cdt in ("float32", "bfloat16"):
        cfg = cfg_of(cdt)
        for cm, dd, wd in FWD:
            lf = luffy(cm, dd, wd, use_kernels=True)
            cap = train_lib.capacity_for_bucket(cfg, shape, dist, lf, 0)
            rec.clear()
            loss, m = jax.jit(lambda p, b: build_model(cfg).train_loss(
                p, b, jnp.float32(THR), luffy=lf, dist=dist,
                capacity=cap))(params, batch)
            jax.effects_barrier()
            key = f"fwd/{cdt}/{cm}/{dd}/{wd}/"
            out[key + "loss"] = np.float32(loss)
            for k in BITWISE:
                out[key + k] = np.float32(m[k])
            seen = {}
            for i, dg, rep in rec:
                layer = seen.get(i, 0)
                seen[i] = layer + 1
                out[key + f"perm{layer}/{i}"] = dg
                out[key + f"rep{layer}/{i}"] = rep
    np.savez(sys.argv[1], **out)
    print("OK")
""") % repr((B, S, M, NODES, THR, SLACK, FWD, WIRES, BITWISE))


def _cfgs(cdt):
    jcfg = dataclasses.replace(jreduced(jget_config("moe-gpt2")),
                               compute_dtype=cdt)
    tcfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                               compute_dtype=cdt)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    jcfg, _ = _cfgs("float32")
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return {"npz": dict(np.load(path)),
            "params": jax.tree.map(np.asarray, params),
            "batch": SyntheticLM(_cfgs("float32")[1],
                                 ShapeConfig("t", S, B, "train")).batch(0)}


def _dist():
    return make_dist(make_host_mesh(model=M, nodes=NODES), "train", B,
                     moe_arch=True)


def _luffy(cm, dd, wd, **kw):
    return LuffyConfig(comm_mode=cm, hier_dedup=dd, wire_dtype=wd,
                       combine_slack=SLACK, **kw)


def _params(oracle, tcfg, grad=False):
    params = convert.from_reference(oracle["params"], tcfg)
    if grad:
        for _, p in optim.leaves_with_path(params):
            p.requires_grad_()
    return params


def _batch(oracle):
    return {k: torch.as_tensor(v) for k, v in oracle["batch"].items()}


def test_virtual_ranks_hold_the_reference_shards(oracle):
    """Rank r of the node-major model axis holds experts [r*E_l, (r+1)*E_l)
    in the reference's sharding, which is what the port's whole stack
    gives rank r (so ``convert`` needs no change)."""
    shards = oracle["npz"]["expert_shards"]
    E = shards.size
    np.testing.assert_array_equal(shards, np.arange(E).reshape(M, -1))
    dist = _dist()
    assert dist.model_size == M and dist.topology == Topology(2, 2)
    assert dist.comm("hier").local_size == 2


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cm,dd,wd", FWD)
def test_forward_matches_reference(oracle, monkeypatch, cdt, cm, dd, wd):
    _, tcfg = _cfgs(cdt)
    plans = []
    orig = tex.build_exchange_plan

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        plans.append(pl)
        return pl

    monkeypatch.setattr(tex, "build_exchange_plan", rec)
    cap = train_lib.capacity_for_bucket(
        tcfg, ShapeConfig("t", S, B, "train"), _luffy(cm, dd, wd), 0,
        _dist())
    loss, m = ttf.forward_train(_params(oracle, tcfg), tcfg,
                                _luffy(cm, dd, wd), _batch(oracle),
                                torch.tensor(THR), cap, dist=_dist())
    key = f"fwd/{cdt}/{cm}/{dd}/{wd}/"
    ref = oracle["npz"]
    np.testing.assert_allclose(loss.item(), ref[key + "loss"], rtol=1e-5)
    if cdt == "float32" and wd == "f32":
        assert loss.item() == float(ref[key + "loss"])
    for k in BITWISE:
        assert np.float32(m[k].item()) == ref[key + k], k
    assert len(plans) == 2
    T = B // M * S
    for layer, pl in enumerate(plans):
        for r in range(M):
            np.testing.assert_array_equal(
                pl.dest_global[r].numpy(), ref[key + f"perm{layer}/{r}"])
            rep = pl.condense_plan.rep_idx.reshape(M, T)[r] - r * T
            np.testing.assert_array_equal(rep.numpy(),
                                          ref[key + f"rep{layer}/{r}"])
    # migration moved sequences and condensation removed most rows
    assert m["traffic_after"] < m["traffic_before"]
    assert 0.5 < m["condense_rate"] < 1.0
    # the executed-bytes law: shipped == flat / (dedup x precision)
    from repro_torch.comm import dtypes as wdt
    if dd == "on" and cm == "hier":
        prec = wdt.wire_precision(tcfg.d_model, wd, 4 if cdt == "float32"
                                  else 2)
        np.testing.assert_allclose(m["inter_bytes_shipped"].item() * prec,
                                   m["inter_bytes_dedup"].item(), rtol=1e-6)
        assert m["inter_bytes_dedup"] < m["inter_bytes_flat"]
    else:
        assert m["inter_bytes_shipped"] == 0.0


@pytest.mark.parametrize("wd", WIRES)
def test_gradients_match_jax_grad(oracle, wd):
    _, tcfg = _cfgs("float32")
    params = _params(oracle, tcfg, grad=True)
    lf = _luffy("hier", "on", wd, enable_condensation=False)
    cap = train_lib.capacity_for_bucket(
        tcfg, ShapeConfig("t", S, B, "train"), lf, 0, _dist())
    loss, _ = ttf.forward_train(params, tcfg, lf, _batch(oracle),
                                torch.tensor(THR), cap, dist=_dist())
    loss.backward()
    ref = oracle["npz"]
    np.testing.assert_allclose(loss.item(), ref[f"grad/{wd}/loss"],
                               rtol=1e-5)
    grads = convert.to_reference(optim.tree_map(lambda p: p.grad, params),
                                 tcfg)
    got = {jax.tree_util.keystr(p): np.asarray(g, np.float64)
           for p, g in jax.tree_util.tree_leaves_with_path(grads)}
    leaf_tol, norm_tol = (1e-5, 1e-5) if wd == "f32" else (3e-3, 1e-4)
    sq_got = sq_want = 0.0
    for path, g in got.items():
        w = ref[f"grad/{wd}/" + path].astype(np.float64)
        sq_got += np.sum(g * g)
        sq_want += np.sum(w * w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= leaf_tol, (path, err)
    np.testing.assert_allclose(np.sqrt(sq_got), np.sqrt(sq_want),
                               rtol=norm_tol)
    if wd == "f8e4m3":
        # the reference's f8 backward casts small cotangents to zero
        f32 = sum(np.sum(ref["grad/f32/" + p].astype(np.float64) ** 2)
                  for p in got)
        assert sq_want < 0.5 * f32 and sq_got < 0.5 * f32


def test_adamw_trajectory_matches_reference(oracle):
    _, tcfg = _cfgs("float32")
    params = _params(oracle, tcfg, grad=True)
    lf = _luffy("hier", "on", "f32", enable_condensation=False)
    shape = ShapeConfig("t", S, B, "train")
    dist = _dist()
    cap = train_lib.capacity_for_bucket(tcfg, shape, lf, 0, dist)
    ocfg = OptimConfig(lr=1e-3, total_steps=3, warmup_steps=2)
    step = train_lib.make_train_step(tcfg, lf, ocfg, cap, dist)
    os_, ls = optim.init_opt_state(params, ocfg), \
        train_lib.init_luffy_state("cpu")
    data = SyntheticLM(tcfg, shape)
    ref = oracle["npz"]
    for i in range(3):
        b = {k: torch.as_tensor(v) for k, v in data.batch(i).items()}
        params, os_, ls, m = step(params, os_, ls, b)
        np.testing.assert_allclose(float(m["loss"]), ref["adamw/loss"][i],
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   ref["adamw/grad_norm"][i], rtol=1e-4)


def test_ep_launcher_cpu_end_to_end(capsys):
    res = ttrain.main(["--reduced", "--steps", "2", "--model-axis", "4",
                       "--comm-mode", "hier", "--nodes", "2",
                       "--hier-dedup", "on", "--wire-dtype", "f8e4m3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert [s["step"] for s in res["steps"]] == [0, 1]
    assert res["dist"].model_size == 4
    for s in res["steps"]:
        assert np.isfinite(s["loss"])
        assert 0.0 < s["local_frac"] < 1.0
        assert 0.0 < s["inter_bytes_shipped"] < s["inter_bytes_dedup"] \
            < s["inter_bytes_flat"]
    assert "inter=" in out and "shipped=" in out and "local=" in out
    # the train launcher's schedules are the reference's: sync, pipeline
    with pytest.raises(SystemExit):
        ttrain.parse_args(["--model-axis", "4", "--exec-mode",
                           "decode_overlap"])
    # 8 sequences do not split over 3 ranks, so the sequence would, and
    # 128 positions do not
    with pytest.raises(ValueError, match="128 positions does not split"):
        ttrain.main(["--reduced", "--steps", "1", "--model-axis", "3",
                     "--device", "cpu"])
