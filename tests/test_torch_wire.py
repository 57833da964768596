"""The port's expert-parallel pieces (repro_torch.comm, core.migration,
the K4 plain version and condense.wire) against the JAX reference, on
the CPU.

- Migration: the port's planners against ``plan_migration_np`` and the
  jitted ``plan_migration_jax`` (its f32 arithmetic as the train step
  compiles it) on random counts and lengths, M in {4, 8}, 1-4 sequences
  per rank, uniform and two-node link costs, and forced near-ties:
  assignments, perms and both traffic numbers bitwise.
- Codec and K4's plain version: bitwise (uint8 views of payload and
  scales) against ``repro.comm.dtypes`` and ``repro.kernels.ref``; the
  codec's gradient against ``jax.grad`` within 1e-6 of its largest
  entry (f32 sums of 32 elements in another order, which cancel on the
  block maxima), with the same exactly-zero entries.
- The collectives and the dedup wire against the reference under a
  4-device ``(node=2, local=2)`` mesh, run once in a subprocess
  (``--xla_force_host_platform_device_count=4``) that writes an .npz:
  collectives, rebuilt expert rows, gate rows, slot maps and the
  shipped-rows ledger bitwise; the combines within 1e-6 (sums of at most
  two addends per slot, exact here, but held to a tolerance because the
  reference's scatter adds +-0 rows where the port skips them).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import dtypes as jdt
from repro.comm.topology import Topology as JTopology
from repro.core import migration as jmig
from repro.kernels import ref as jref

from repro_torch.comm import dtypes as wdt
from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.ledger import dispatch_node_ledger
from repro_torch.comm.topology import Topology
from repro_torch.condense import wire as twire
from repro_torch.core import migration as tmig
from repro_torch.core.gating import dispatch_positions
from repro_torch.kernels import ref as tref
from repro_torch.plan import objectives

ROOT = os.path.join(os.path.dirname(__file__), "..")

# ---------------------------------------------------------------------------
# migration


def _plan_inputs(seed, M, n_seq, tie):
    r = np.random.default_rng(seed)
    n = M * n_seq
    if tie:
        counts = np.full((n, M), 4.0, np.float32)
        lens = np.full(n, 64.0, np.float32)
        lens[::3] = 128.0
    else:
        counts = r.integers(0, 40, (n, M)).astype(np.float32)
        lens = r.integers(8, 257, n).astype(np.float32)
    return counts, lens


_JIT = jax.jit(lambda c, l, lc, n_seq: jmig.plan_migration_jax(
    c, l, n_seq, q=3, d_model=256, speed=1e13, link_cost=lc),
    static_argnums=3)


def _jit_plan_jax(counts, lens, n_seq, link_cost):
    """The reference's traced planner as its train step compiles it."""
    lc = None if link_cost is None else jnp.asarray(link_cost, jnp.float32)
    return [np.asarray(a) for a in _JIT(jnp.asarray(counts),
                                        jnp.asarray(lens), lc, n_seq)]


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("n_seq", [1, 2, 4])
@pytest.mark.parametrize("topo", ["uniform", "two_nodes"])
@pytest.mark.parametrize("tie", [False, True])
def test_migration_planners_match(M, n_seq, topo, tie):
    lc = None if topo == "uniform" else JTopology(2, M // 2).link_cost()
    assert lc is None or np.array_equal(lc, Topology(2, M // 2).link_cost())
    for seed in range(4):
        counts, lens = _plan_inputs(seed + 10 * M + n_seq, M, n_seq, tie)
        want = _jit_plan_jax(counts, lens, n_seq, lc)
        got = tmig.plan_migration_jax(counts, lens, n_seq, q=3, d_model=256,
                                      speed=1e13, link_cost=lc)
        for name, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        want = jmig.plan_migration_np(counts.astype(np.float64), lens, n_seq,
                                      q=3, d_model=256, link_cost=lc)
        got = tmig.plan_migration_np(counts.astype(np.float64), lens, n_seq,
                                     q=3, d_model=256, link_cost=lc)
        for name, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"np {name}")


def test_home_plan_and_cost_model():
    counts, _ = _plan_inputs(3, 4, 2, False)
    lc = Topology(2, 2).link_cost()
    want = jmig.home_plan(jnp.asarray(counts), 2,
                          link_cost=jnp.asarray(lc, jnp.float32))
    got = tmig.home_plan(counts, 2, link_cost=lc)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    want = jmig.home_plan(counts.astype(np.float64), 2)
    got = tmig.home_plan(counts.astype(np.float64), 2, traced=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for B, L in ((1, 128), (3, 1024), (7, 2048)):
        assert tmig.t_att(B, L, 768, 1e13) == jmig.t_att(B, L, 768, 1e13)
    ident = tmig.identity_plan(8, 2)
    np.testing.assert_array_equal(ident.perm, np.arange(8))
    # the "traffic" objective is the traced planner over the link cost
    _, lens = _plan_inputs(3, 4, 2, False)
    got = objectives.plan_migration_with_objective(
        counts, lens, 2, ctx=objectives.ObjectiveContext(topo=Topology(2, 2)),
        d_model=256)
    want = tmig.plan_migration_jax(counts, lens, 2, d_model=256,
                                   link_cost=lc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown plan_objective"):
        objectives.get_objective("nope")


# ---------------------------------------------------------------------------
# codec and the K4 plain version


def _u8(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("T,d,R", [(128, 64, 128), (256, 96, 192),
                                   (64, 33, 96)])
def test_pack_quantize_plain_bitwise(T, d, R):
    rng = np.random.default_rng(T + d)
    x = (rng.standard_normal((T, d)) * 3).astype(np.float32)
    x[3] = 0.0
    tok = rng.integers(-1, T, R).astype(np.int32)
    tok[::7] = -1                                  # forced empties
    for wd in ("f32", "bf16", "f8e4m3"):
        want_q, want_sc = jref.pack_quantize_ref(jnp.asarray(x),
                                                 jnp.asarray(tok), wd)
        got_q, got_sc = tref.pack_quantize_ref(torch.as_tensor(x),
                                               torch.as_tensor(tok), wd)
        assert tuple(got_q.shape) == want_q.shape
        if wd == "f32":
            np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        else:
            np.testing.assert_array_equal(_u8(got_q), _u8(want_q),
                                          err_msg=f"payload {wd}")
        assert (got_sc is None) == (want_sc is None)
        if got_sc is not None:
            np.testing.assert_array_equal(got_sc.numpy().view(np.uint8),
                                          np.asarray(want_sc).view(np.uint8))
        # the codec alone, and its inverse
        jq, jsc = jdt.quantize_rows(jnp.asarray(x), wd)
        tq, tsc = wdt.quantize_rows(torch.as_tensor(x), wd)
        jy = np.asarray(jdt.dequantize_rows(jq, jsc, jnp.float32, d))
        ty = wdt.dequantize_rows(tq, tsc, torch.float32, d).numpy()
        np.testing.assert_array_equal(ty, jy, err_msg=f"round trip {wd}")


def test_wire_byte_model_matches():
    for d in (33, 128, 768):
        for wd in ("f32", "bf16", "f8e4m3"):
            for item in (2, 4):
                assert wdt.wire_row_bytes(d, wd, item) == \
                    jdt.wire_row_bytes(d, wd, item)
                assert wdt.wire_precision(d, wd, item) == \
                    jdt.wire_precision(d, wd, item)
        assert wdt.pad_to_block(d) == jdt.pad_to_block(d)
    with pytest.raises(ValueError):
        wdt.validate_wire_dtype("f16")


@pytest.mark.parametrize("scale", [1.0, 1e-2, 1e-4])
def test_codec_gradient_matches_jax_grad(scale):
    """The reference's f8 backward casts the scaled cotangent to e4m3, so
    small cotangents come back as exact zeros: the port gives the same
    zeros and the same values (within 1e-6 of the largest: 32-element
    f32 sums in another order)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 40)).astype(np.float32)
    x[2, :32] = 0.0                              # an all-zero block
    x[3, 0] = x[3, 1] = 5.0                      # a tie at the block max
    ct = (rng.standard_normal((64, 40)) * scale).astype(np.float32)

    def f(a):
        q, sc = jdt.quantize_rows(a, "f8e4m3")
        return jnp.sum(jdt.dequantize_rows(q, sc, jnp.float32, 40)
                       * jnp.asarray(ct))

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    tx = torch.as_tensor(x)
    q, sc = wdt.quantize_rows(tx, "f8e4m3")
    ct_q, ct_sc = wdt.dequantize_t(torch.as_tensor(ct), q, sc)
    got = wdt.quantize_t(tx, ct_q, ct_sc).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if scale <= 1e-2:
        assert (want == 0).mean() > 0.5          # the reference's zeros


# ---------------------------------------------------------------------------
# the collectives and the dedup wire under a 4-device mesh

N, L = 2, 2
M = N * L
T, K, D, E_LOCAL, C = 48, 2, 40, 2, 24
N_SEQ, S = 2, 24

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.comm import CommContext, Topology, make_mesh, shard_map
    from repro.comm import ledger as comm_ledger
    from repro.condense.wire import (dedup_combine, dedup_combine_migrate,
                                     dedup_dispatch)
    from repro.core.gating import dispatch_positions
    N, L, T, K, D, E_LOCAL, C, N_SEQ, S = %s
    M = N * L
    E = E_LOCAL * M
    mesh = make_mesh((N, L), ("node", "local"))
    topo = Topology(N, L)
    hier = CommContext.build("hier", ("node", "local"), topo)
    flat = CommContext.build("flat", ("node", "local"), topo)
    r = np.random.default_rng(0)
    out = {}
    xf = r.standard_normal((M, T, D)).astype(np.float32)
    expert_idx = r.integers(0, E, (M, T, K)).astype(np.int32)
    expert_idx[..., 1] = (expert_idx[..., 0] + 1 + r.integers(0, E - 1, (M, T))) %% E
    gate_w = r.random((M, T, K)).astype(np.float32)
    keep = r.random((M, T, K)) < 0.9
    perm = r.permutation(M * N_SEQ).astype(np.int32)
    coll_in = r.standard_normal((M, M * 3, 5)).astype(np.float32)
    out.update(xf=xf, expert_idx=expert_idx, gate_w=gate_w, keep=keep,
               perm=perm, coll_in=coll_in)
    spec = P(("node", "local"))

    def colls(x):
        x = x[0]
        return tuple(a[None] for a in (
            flat.all_to_all(x), hier.all_to_all(x), hier.combine(x),
            hier.node_all_to_all(x[:4]), hier.local_all_gather(x),
            hier.local_psum_scatter(x[:6])))

    res = jax.jit(shard_map(colls, mesh=mesh, in_specs=(spec,),
                            out_specs=(spec,) * 6))(jnp.asarray(coll_in))
    for name, a in zip(("a2a_flat", "a2a_hier", "combine_hier", "node_a2a",
                        "local_gather", "local_psum_scatter"), res):
        out[name] = np.asarray(a)

    for wd in ("f32", "bf16", "f8e4m3"):
        def inner(xf_l, e_l, g_l, k_l, perm_r):
            xf_l, e_l, g_l, k_l = xf_l[0], e_l[0], g_l[0], k_l[0]
            pos = dispatch_positions(e_l, k_l, E)
            valid = k_l & (pos < C)
            my = hier.index()
            x_rows, gw, rvalid, st = dedup_dispatch(
                xf_l, e_l, g_l, valid, pos, comm=hier, e_local=E_LOCAL,
                capacity=C, wire_dtype=wd)
            delta = dedup_combine(3.0 * x_rows * gw[..., None], st,
                                  comm=hier, wire_dtype=wd)
            tok = jnp.arange(T, dtype=jnp.int32)
            dslot = perm_r[my * N_SEQ + tok // S]
            dgp = (dslot // N_SEQ) * T + (dslot %% N_SEQ) * S + tok %% S
            prim = jnp.broadcast_to((jnp.arange(K) == 0)[None], (T, K))
            xm, gm, rvm, sm = dedup_dispatch(
                xf_l, e_l, g_l, valid, pos, comm=hier, e_local=E_LOCAL,
                capacity=C, wire_dtype=wd, dest_gpos=dgp, prim=prim)
            ym = dedup_combine_migrate(
                3.0 * xm * gm[..., None] + xm * sm["prim"][..., None], sm,
                comm=hier, wire_dtype=wd)
            fl, dd = comm_ledger.dispatch_node_ledger(
                e_l, valid, my, e_local=E_LOCAL, topo=topo, row_bytes=1.0)
            return tuple(jnp.asarray(a)[None] for a in (
                pos, valid, x_rows, gw, rvalid, delta, st["shipped_rows"],
                fl, dd, sm["dgpos"], ym, xm))

        fn = jax.jit(shard_map(inner, mesh=mesh,
                               in_specs=(spec,) * 4 + (P(),),
                               out_specs=(spec,) * 12))
        res = fn(jnp.asarray(xf), jnp.asarray(expert_idx),
                 jnp.asarray(gate_w), jnp.asarray(keep), jnp.asarray(perm))
        for name, a in zip(("pos", "valid", "x_rows", "gw", "rvalid",
                            "delta", "shipped", "ledger_flat",
                            "ledger_dedup", "dgpos", "y_mig", "x_rows_mig"),
                           res):
            out[f"{wd}/{name}"] = np.asarray(a)
    np.savez(sys.argv[1], **out)
    print("OK")
""") % repr((N, L, T, K, D, E_LOCAL, C, N_SEQ, S))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("wire") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def _hier():
    return CommContext.build("hier", M, Topology(N, L))


def test_collectives_match_jax(oracle):
    x = torch.as_tensor(oracle["coll_in"])
    flat = CommContext.build("flat", M, Topology(N, L))
    hier = _hier()
    got = {"a2a_flat": flat.all_to_all(x), "a2a_hier": hier.all_to_all(x),
           "combine_hier": hier.combine(x),
           "node_a2a": hier.node_all_to_all(x[:, :4]),
           "local_gather": hier.local_all_gather(x),
           "local_psum_scatter": hier.local_psum_scatter(x[:, :6])}
    for name, a in got.items():
        np.testing.assert_array_equal(a.numpy(), oracle[name], err_msg=name)
    assert torch.equal(got["a2a_flat"], got["a2a_hier"])
    np.testing.assert_array_equal(hier.psum(x).numpy(),
                                  oracle["coll_in"].sum(0))
    # the planner's link cost: the reference's, or None when uniform
    np.testing.assert_array_equal(hier.link_cost(),
                                  JTopology(N, L).link_cost())
    assert CommContext.build("flat", M, Topology.flat(M)).link_cost() is None
    with pytest.raises(ValueError, match="node, local"):
        CommContext.build("hier", M, Topology.flat(M))


@pytest.mark.parametrize("wd", ["f32", "bf16", "f8e4m3"])
def test_dedup_wire_matches_reference(oracle, wd):
    hier = _hier()
    xf = torch.as_tensor(oracle["xf"])
    e = torch.as_tensor(oracle["expert_idx"]).long()
    gw = torch.as_tensor(oracle["gate_w"])
    keep = torch.as_tensor(oracle["keep"])
    pos = dispatch_positions(e, keep, E_LOCAL * M)
    np.testing.assert_array_equal(pos.numpy(), oracle[f"{wd}/pos"])
    valid = keep & (pos < C)
    x_rows, gw_rows, rvalid, st = twire.dedup_dispatch(
        xf, e, gw, valid, pos, comm=hier, e_local=E_LOCAL, capacity=C,
        wire_dtype=wd)
    np.testing.assert_array_equal(x_rows.numpy(), oracle[f"{wd}/x_rows"])
    np.testing.assert_array_equal(gw_rows.numpy(), oracle[f"{wd}/gw"])
    np.testing.assert_array_equal(rvalid.numpy(), oracle[f"{wd}/rvalid"])
    delta = twire.dedup_combine(3.0 * x_rows * gw_rows[..., None], st,
                                comm=hier, wire_dtype=wd)
    np.testing.assert_allclose(delta.numpy(), oracle[f"{wd}/delta"],
                               rtol=1e-6, atol=1e-6)
    # the shipped rows are the ledger's distinct (token, remote node) pairs
    ranks = torch.arange(M)
    fl, dd = dispatch_node_ledger(e, valid, ranks, e_local=E_LOCAL,
                                  topo=Topology(N, L), row_bytes=1.0)
    np.testing.assert_array_equal(fl.numpy(), oracle[f"{wd}/ledger_flat"])
    np.testing.assert_array_equal(dd.numpy(), oracle[f"{wd}/ledger_dedup"])
    np.testing.assert_array_equal(st["shipped_rows"].numpy(),
                                  oracle[f"{wd}/shipped"])
    np.testing.assert_array_equal(st["shipped_rows"].numpy(), dd.numpy())
    assert float(dd.sum()) < float(fl.sum())
    # migrate mode: the destination plane and the dest-keyed combine
    perm = torch.as_tensor(oracle["perm"]).long()
    dest = perm.reshape(M, N_SEQ)
    tok = torch.arange(T)
    dslot = dest[:, tok // S]
    dgp = (dslot // N_SEQ) * T + (dslot % N_SEQ) * S + tok % S
    prim = (torch.arange(K) == 0).expand(M, T, K)
    xm, gm, rvm, sm = twire.dedup_dispatch(
        xf, e, gw, valid, pos, comm=hier, e_local=E_LOCAL, capacity=C,
        wire_dtype=wd, dest_gpos=dgp, prim=prim)
    np.testing.assert_array_equal(xm.numpy(), oracle[f"{wd}/x_rows_mig"])
    np.testing.assert_array_equal(sm["dgpos"].numpy(), oracle[f"{wd}/dgpos"])
    ym = twire.dedup_combine_migrate(
        3.0 * xm * gm[..., None] + xm * sm["prim"][..., None], sm,
        comm=hier, wire_dtype=wd)
    np.testing.assert_allclose(ym.numpy(), oracle[f"{wd}/y_mig"], rtol=1e-6,
                               atol=1e-6)


def test_wire_gradient_repeats_and_moves_back():
    """The dedup wire's backward: the f32 wire passes cotangents back
    unchanged to each token (summed over its destination nodes); two
    backward passes agree bit for bit; the chunked node hop (the
    pipelined executor's ``chunks=``) gives the same rows and gradients
    bit for bit on the f32 and f8 wires."""
    hier = _hier()
    r = np.random.default_rng(2)
    xf = torch.as_tensor(r.standard_normal((M, T, D)).astype(np.float32))
    e = torch.as_tensor(r.integers(0, E_LOCAL * M, (M, T, K)))
    gw = torch.as_tensor(r.random((M, T, K)).astype(np.float32))
    keep = torch.ones((M, T, K), dtype=torch.bool)
    pos = dispatch_positions(e, keep, E_LOCAL * M)
    valid = keep & (pos < C)
    grads, rows = [], []
    for wd in ("f32", "f32", "f8e4m3"):
        x = xf.clone().requires_grad_()
        x_rows, gwr, rv, st = twire.dedup_dispatch(
            x, e, gw, valid, pos, comm=hier, e_local=E_LOCAL, capacity=C,
            wire_dtype=wd)
        x_rows.sum().backward()
        grads.append(x.grad)
        rows.append(x_rows.detach())
    assert torch.equal(grads[0], grads[1])
    # each valid copy reads its token's row once: the gradient counts them
    np.testing.assert_array_equal(grads[0].numpy()[..., 0],
                                  valid.sum(-1).float().numpy())
    assert torch.isfinite(grads[2]).all()
    from repro_torch.sched import plan_unique_chunks
    ch = plan_unique_chunks(
        twire.dedup_capacity(T, E_LOCAL, hier.local_size, C), 3)
    assert ch.n_chunks == 3
    for i, wd in ((0, "f32"), (2, "f8e4m3")):
        x = xf.clone().requires_grad_()
        x_rows = twire.dedup_dispatch(
            x, e, gw, valid, pos, comm=hier, e_local=E_LOCAL, capacity=C,
            wire_dtype=wd, chunks=ch)[0]
        x_rows.sum().backward()
        assert torch.equal(x_rows.detach(), rows[i]), wd
        assert torch.equal(x.grad, grads[i]), wd
