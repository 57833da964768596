"""The port's planner objectives (``repro_torch.plan.objectives``) against
the JAX reference's (``repro.plan.objectives``), on the CPU, in process.

- ``exposed_link_cost`` equals the reference's numpy path exactly (f64
  host floats), and ``plan_exposed_ms``, the f32 exposed time the
  overlap objective decides with, equals the reference's under jit bit
  for bit.
- The "overlap" plan (assign, perm and the traffic ledger) equals the
  reference's traced planner under jit, whose plans its train step takes,
  on ``tests/test_plan.py``'s inter-bound instances (2 x 4, 2 x 2 and
  4 x 2 topologies, 2-8 chunks) at integer row counts, as the train
  path's are; on some of them it is strictly better than traffic's in
  modelled exposed time, and never worse.
- On a flat fabric or a sync exchange "overlap" is traffic's plan;
  "replicate"'s migration plan is traffic's.
- ``plan_expert_replicas`` on the device equals the reference's under jit
  (f32) on skewed, uniform and near-tie loads, with the first-maximum
  tie-break.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.topology import Topology as JTopology
from repro.plan import objectives as jobj

from repro_torch.comm.topology import Topology
from repro_torch.plan import objectives as tobj


def _instance(seed, n_slots, M):
    """``tests/test_plan.py``'s planner instance."""
    r = np.random.default_rng(seed)
    counts = (r.random((n_slots, M)) ** 3)
    counts = (counts / counts.sum(1, keepdims=True) * 100)
    counts = counts + r.random(counts.shape) * 1e-3   # break ties
    lens = r.integers(10, 100, n_slots).astype(np.float64)
    return counts.astype(np.float64), lens


def _ctx_pair(N, L, chunks=4, **kw):
    """``tests/test_plan.py``'s inter-bound context, in both packages."""
    args = dict(ffn_ms=5.0, dispatch_intra_ms=1.0, dispatch_inter_ms=8.0,
                chunks=chunks, row_bytes=4096.0)
    args.update(kw)
    return (tobj.ObjectiveContext(topo=Topology(N, L), **args),
            jobj.ObjectiveContext(topo=JTopology(N, L), **args))


CTXS = [(2, 4, 4, {}), (2, 4, 8, {}), (2, 2, 2, {}), (2, 2, 3, {}),
        (2, 4, 3, dict(ffn_ms=12.0)), (4, 2, 4, dict(row_bytes=1536.0)),
        (2, 2, 4, dict(dispatch_inter_ms=0.5, dispatch_intra_ms=3.0))]


@pytest.mark.parametrize("N,L,chunks,kw", CTXS)
def test_pricing_equals_reference(N, L, chunks, kw):
    t, j = _ctx_pair(N, L, chunks, **kw)
    np.testing.assert_array_equal(tobj.exposed_link_cost(t),
                                  jobj.exposed_link_cost(j))
    M = N * L
    jpe = jax.jit(lambda c, a: jobj.plan_exposed_ms(c, a, j))
    for seed in range(6):
        counts, _ = _instance(seed, 2 * M, M)
        assign = np.random.default_rng(seed).integers(0, M, 2 * M)
        c32 = np.round(counts * 10.0).astype(np.float32)
        got = tobj.plan_exposed_ms(c32, assign, t)
        want = jpe(jnp.asarray(c32), jnp.asarray(assign, jnp.int32))
        assert got.dtype == np.float32 and got == np.asarray(want), seed
    # one chunk: the exposed cost is the link cost
    t1, _ = _ctx_pair(N, L, 1, **kw)
    np.testing.assert_array_equal(tobj.exposed_link_cost(t1),
                                  t1.topo.link_cost())


def _jit_plan(objective, j):
    @jax.jit
    def go(c, lens):
        p = jobj.plan_migration_with_objective(c, lens, 2,
                                               objective=objective, ctx=j)
        return p.assign, p.perm, p.traffic_before, p.traffic_after
    return go


@pytest.mark.parametrize("N,L,chunks,kw", CTXS)
def test_overlap_plans_equal_reference_jit(N, L, chunks, kw):
    t, j = _ctx_pair(N, L, chunks, **kw)
    M = N * L
    go = _jit_plan("overlap", j)
    better = 0
    for seed in range(24):
        # integer row counts, as the train path's planner inputs are (the
        # ledger's f32 sum is then exact in any order)
        counts, lens = _instance(seed, 2 * M, M)
        counts = np.round(counts * 10.0)
        c32, l32 = counts.astype(np.float32), lens.astype(np.float32)
        got = tobj.plan_migration_with_objective(c32, l32, 2,
                                                 objective="overlap", ctx=t)
        want = go(jnp.asarray(c32), jnp.asarray(l32))
        for name, a, b in zip(("assign", "perm", "traffic_before",
                               "traffic_after"),
                              (got.assign, got.perm, got.traffic_before,
                               got.traffic_after), want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"seed {seed} {name}")
        base = tobj.plan_migration_with_objective(c32, l32, 2, ctx=t)
        t_o = tobj.plan_exposed_ms(c32, got.assign, t)
        t_b = tobj.plan_exposed_ms(c32, base.assign, t)
        assert t_o <= t_b, (seed, t_o, t_b)
        better += t_o < t_b
    if (N, L, chunks, kw) == (2, 4, 4, {}):
        # the instances of tests/test_plan.py's never-worse test
        assert better >= 1


def test_overlap_and_replicate_degenerate():
    """Flat fabric or one chunk: "overlap" is traffic's plan;
    "replicate" migrates as traffic does."""
    counts, lens = _instance(1, 8, 4)
    c32, l32 = counts.astype(np.float32), lens.astype(np.float32)
    cases = [tobj.ObjectiveContext(topo=Topology.flat(4), chunks=8),
             _ctx_pair(2, 2, 1)[0], tobj.ObjectiveContext(topo=None),
             _ctx_pair(2, 2, 4)[0]]
    for ctx in cases:
        p_t = tobj.plan_migration_with_objective(c32, l32, 2, ctx=ctx)
        p_r = tobj.plan_migration_with_objective(c32, l32, 2, ctx=ctx,
                                                 objective="replicate")
        for a, b in zip(p_t, p_r):
            np.testing.assert_array_equal(a, b)
        if not ctx.hierarchical or ctx.chunks <= 1:
            p_o = tobj.plan_migration_with_objective(c32, l32, 2, ctx=ctx,
                                                     objective="overlap")
            for a, b in zip(p_t, p_o):
                np.testing.assert_array_equal(a, b)
    assert tobj.available_objectives() == jobj.available_objectives()
    with pytest.raises(ValueError, match="unknown plan_objective"):
        tobj.get_objective("nope")


def _loads():
    r = np.random.default_rng(5)
    out = []
    for E in (8, 16):
        base = r.integers(0, 40, E).astype(np.float32)
        hot = base.copy()
        hot[3] += 400.0
        tie = np.full(E, 10.0, np.float32)
        tie[[1, 2]] = 90.0                     # equal maxima in node 0
        tie[[E - 3, E - 1]] = 90.0             # and in the last node
        edge = np.full(E, 10.0, np.float32)
        edge[0] = 20.0 * (E - 1) / (E - 2)      # at the skew bound
        out += [(E, base), (E, hot), (E, tie), (E, edge),
                (E, np.zeros(E, np.float32))]
    return out


@pytest.mark.parametrize("i", range(10))
@pytest.mark.parametrize("N,L", [(2, 2), (2, 4)])
def test_plan_expert_replicas_equals_reference(i, N, L):
    E, load = _loads()[i]
    M = N * L
    for ffn_ms, bpe in ((2.68, 4), (0.01, 2), (40.0, 2)):
        kw = dict(e_local=E // M, ffn_ms=ffn_ms, d_model=256, d_ff=512,
                  bytes_per_el=bpe)
        want = jax.jit(lambda x: jobj.plan_expert_replicas(
            x, topo=JTopology(N, L), **kw))(jnp.asarray(load))
        got = tobj.plan_expert_replicas(torch.as_tensor(load),
                                        topo=Topology(N, L), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{ffn_ms} {bpe}")


def test_replicas_fire_only_with_skew():
    """A uniform load never replicates; a hot expert over twice the mean
    goes to its owner's next intra-node peer."""
    E, N, L = 8, 2, 2
    topo = Topology(N, L)
    kw = dict(e_local=2, topo=topo, ffn_ms=40.0, d_model=256, d_ff=512)
    flat = tobj.plan_expert_replicas(torch.full((E,), 5.0), **kw)
    assert flat.tolist() == [-1] * 4
    hot = torch.full((E,), 5.0)
    hot[5] = 60.0                              # owner rank 2, node 1
    got = tobj.plan_expert_replicas(hot, **kw)
    assert got.tolist() == [-1, -1, -1, 5]
