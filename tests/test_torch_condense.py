"""The port's condensation (kernels K2, K3, the plan) and K1's backward
against the JAX reference, on the CPU, where the port takes each kernel's
plain version and the reference runs its Pallas kernels in interpret
mode. Inputs come from numpy seeds.

Tolerances: K2 1e-5 at f32 rows and 2e-2 at bf16 rows (sum order), tiles
with nothing to measure exactly 0; rep maps, representatives and rates
bitwise (inputs keep every measured pair away from the threshold); K3
bitwise, its gradient 1e-6; K1's gradients 1e-4 (f32 sum order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.condense import plan as jplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.condense import plan as tplan
from repro_torch.kernels import ops, ref

G = 128


def _clustered(seed, n, d, n_clusters=12, noise=0.15):
    """Rows near a few random centres: condensable, like the clustered
    embeddings of the synthetic stream."""
    r = np.random.default_rng(seed)
    centres = r.standard_normal((n_clusters, d))
    x = centres[r.integers(0, n_clusters, n)] + noise * r.standard_normal(
        (n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("x_dtype,tol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_masked_similarity_plain_matches_pallas(x_dtype, tol):
    r = np.random.default_rng(0)
    x = _clustered(1, 256, 96)
    mask = r.random((256, 256)) < 0.5
    mask[:128, 128:] = False                  # a tile the kernel skips
    jx = jnp.asarray(x).astype(x_dtype)
    want = np.asarray(jops.masked_similarity(jx, jnp.asarray(mask),
                                             interpret=True))
    tx = torch.as_tensor(x).to(getattr(torch, x_dtype))
    got = ops.masked_similarity(tx, torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.all(got[:128, 128:] == 0) and np.all(got[~mask] == 0)
    # every group at once equals one group at a time
    batched = ops.masked_similarity(torch.stack([tx, tx.flip(0)]),
                                    torch.as_tensor(np.stack([mask, mask])))
    np.testing.assert_array_equal(batched[0].numpy(), got)


def _fast_similarity_ops(x, expert, s_prev, s1, s2):
    """``condense/backends.py::fast_similarity`` as it was written before
    K2's fused entry: the skip rules op by op around K2's contract entry."""
    same_expert = expert[:, :, None] == expert[:, None, :]
    if s_prev is not None:
        known_hi = s_prev > s1
        uncertain = same_expert & ~known_hi & ~(s_prev < s2)
    else:
        known_hi = torch.zeros_like(same_expert)
        uncertain = same_expert
    measured = uncertain
    cos = ops.masked_similarity(x, measured)
    zero = torch.zeros((), dtype=torch.float32, device=cos.device)
    sim = torch.where(measured, cos, zero)
    sim = torch.where(known_hi & same_expert, torch.ones_like(zero), sim)
    sim = torch.where(same_expert, sim, zero)
    return sim, measured.float().mean(dim=(1, 2))


def _skip_rule_inputs(seed, n_groups, G, d, E, with_history):
    """Clustered rows, top-2 expert ids read as the path reads them (a
    strided int64 view of the first column), and a carried similarity
    with pairs above s1, below s2, exactly at both and NaN."""
    r = np.random.default_rng(seed)
    x = _clustered(seed + 1, n_groups * G, d).reshape(n_groups, G, d)
    top2 = torch.as_tensor(r.integers(0, E, (n_groups * G, 2)))
    expert = top2[:, 0].reshape(n_groups, G)
    s_prev = None
    if with_history:
        sp = r.random((n_groups, G, G)).astype(np.float32)
        sp[0, :4, :4] = np.float32(0.8)
        sp[0, 4:8, 4:8] = np.float32(0.2)
        sp[0, 8, :] = np.nan
        s_prev = torch.as_tensor(sp)
    return x, expert, s_prev


@pytest.mark.parametrize("with_history", [False, True])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_masked_similarity_fused_ref_is_the_op_sequence(with_history,
                                                        x_dtype):
    """The fused entry's plain version, CPU dispatch through ops and
    fast_similarity itself: bit for bit the op sequence it replaced."""
    from repro_torch.condense import backends
    x, expert, s_prev = _skip_rule_inputs(9, 3, 96, 40, 4, with_history)
    tx = torch.as_tensor(x).to(getattr(torch, x_dtype))
    want = _fast_similarity_ops(tx, expert, s_prev, 0.8, 0.2)
    for got in (ref.masked_similarity_fused_ref(tx, expert, s_prev, 0.8,
                                                0.2),
                ops.masked_similarity_fused(tx, expert, s_prev, 0.8, 0.2),
                backends.fast_similarity(tx, expert, s_prev, 0.8, 0.2)):
        assert got[0].dtype == torch.float32 and got[1].shape == (3,)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_history", [False, True])
@pytest.mark.parametrize("x_dtype,tol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_masked_similarity_fused_matches_pallas(with_history, x_dtype, tol):
    """The fused entry's plain version against the reference's
    fast_similarity with the Pallas K2 (interpret mode), vmapped over the
    groups: measured pairs within K2's tolerance, every other entry (0
    cross-expert, 1 known high, 0 known low) and measured_frac exact."""
    from repro.condense import backends as jbackends
    x, expert, s_prev = _skip_rule_inputs(12, 2, G, 64, 4, with_history)
    jx = jnp.asarray(x).astype(x_dtype)
    je = jnp.asarray(expert.numpy())

    def one(xg, eg, sg):
        return jbackends.fast_similarity(xg, eg, sg, 0.8, 0.2,
                                         use_kernel=True)

    if s_prev is None:
        jsim, jfrac = jax.vmap(lambda xg, eg: one(xg, eg, None))(jx, je)
    else:
        jsim, jfrac = jax.vmap(one)(jx, je, jnp.asarray(s_prev.numpy()))
    jsim, jfrac = np.asarray(jsim), np.asarray(jfrac)
    tx = torch.as_tensor(x).to(getattr(torch, x_dtype))
    sim, frac = ops.masked_similarity_fused(tx, expert, s_prev, 0.8, 0.2)
    sim = sim.numpy()
    same = (expert[:, :, None] == expert[:, None, :]).numpy()
    measured = same.copy()
    if s_prev is not None:
        sp = s_prev.numpy()
        measured &= ~(sp > 0.8) & ~(sp < 0.2)
        assert np.all(sim[same & (sp > 0.8)] == 1.0)
    assert 0 < measured.sum() < same.sum() or s_prev is None
    np.testing.assert_array_equal(sim[~measured], jsim[~measured])
    np.testing.assert_allclose(sim[measured], jsim[measured], atol=tol,
                               rtol=0)
    np.testing.assert_array_equal(frac.numpy(), jfrac)


def test_masked_similarity_fused_dispatches_by_device(monkeypatch):
    """CPU tensors take the plain version and never reach the card's
    wrapper, whose launch count stays put."""
    from repro_torch.kernels import similarity as ksim

    def card(*a, **kw):
        raise AssertionError("a CPU tensor reached the card's wrapper")

    fused = ksim.masked_similarity_fused
    before = (ksim.masked_similarity.launches, fused.launches)
    monkeypatch.setattr(ksim, "masked_similarity_fused", card)
    x, expert, s_prev = _skip_rule_inputs(3, 2, 64, 32, 3, True)
    tx = torch.as_tensor(x)
    got = ops.masked_similarity_fused(tx, expert, s_prev, 0.8, 0.2)
    want = ref.masked_similarity_fused_ref(tx, expert, s_prev, 0.8, 0.2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (ksim.masked_similarity.launches, fused.launches) == before


def _chain(G, perm):
    adj = np.zeros((G, G), bool)
    adj[perm[:-1], perm[1:]] = True
    return adj | adj.T


def test_components_and_reps_bitwise():
    """Random graphs of several densities and chains longer than the
    ceil(log2 G) + 1 rounds reach: the port's rounds equal the
    reference's, representatives and all."""
    r = np.random.default_rng(2)
    adjs = []
    for p in (0.002, 0.01, 0.05, 0.3):
        a = r.random((G, G)) < p
        adjs.append(a | a.T)
    adjs.append(_chain(G, np.arange(G)))
    adjs.append(_chain(G, r.permutation(G)))
    adjs.append(_chain(G, np.arange(G)[::-1].copy()))
    adj = np.stack([a & ~np.eye(G, dtype=bool) for a in adjs])
    got = tplan._components_and_reps(torch.as_tensor(adj)).numpy()
    for i, a in enumerate(adj):
        want = np.asarray(jplan._components_and_reps(jnp.asarray(a)))
        np.testing.assert_array_equal(got[i], want, err_msg=f"graph {i}")
    assert len(np.unique(got[5])) > 1     # the round bound splits a chain


@pytest.mark.parametrize("with_history", [False, True])
def test_condense_plan_matches_reference(with_history):
    """build_condense_plan against the reference's kernel path
    (use_kernel=True): rep_idx, is_rep and rate bitwise, sim 1e-5."""
    T, d, E = 4 * G, 64, 4
    x = _clustered(3, T, d)
    r = np.random.default_rng(4)
    expert = r.integers(0, E, T).astype(np.int32)
    thr = np.float32(0.93)
    s_prev = None
    if with_history:
        s_prev = r.random((T // G, G, G)).astype(np.float32)
        s_prev = (s_prev + s_prev.transpose(0, 2, 1)) / 2
    cp_ref = jplan.build_condense_plan(
        jnp.asarray(x), jnp.asarray(expert), jnp.float32(thr), group_size=G,
        s_prev=None if s_prev is None else jnp.asarray(s_prev),
        use_kernel=True)
    cp = tplan.build_condense_plan(
        torch.as_tensor(x), torch.as_tensor(expert), torch.tensor(thr),
        group_size=G,
        s_prev=None if s_prev is None else torch.as_tensor(s_prev))
    sim = cp.s_next.numpy()
    # the input is at fault if a measured pair sits at the margin
    measured = (sim > 0) & (sim < 1)
    assert np.min(np.abs(sim[measured] - thr)) > 1e-5
    np.testing.assert_allclose(sim, np.asarray(cp_ref.s_next), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(cp.rep_idx.numpy(),
                                  np.asarray(cp_ref.rep_idx))
    np.testing.assert_array_equal(cp.is_rep.numpy(),
                                  np.asarray(cp_ref.is_rep))
    assert float(cp.rate) == float(cp_ref.rate) > 0.1
    assert float(cp.measured_pairs) == float(cp_ref.measured_pairs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_matches_pallas_and_grad(dtype):
    T, d = 512, 48
    r = np.random.default_rng(5)
    y = r.standard_normal((T, d)).astype(np.float32)
    idx = r.integers(0, T, T).astype(np.int32)
    want = np.asarray(jops.gather_rows(jnp.asarray(y).astype(dtype),
                                       jnp.asarray(idx), interpret=True),
                      np.float32)
    ty = torch.as_tensor(y).to(getattr(torch, dtype)).requires_grad_()
    got = ops.gather_rows(ty, torch.as_tensor(idx))
    np.testing.assert_array_equal(got.float().detach().numpy(), want)
    dy = r.standard_normal((T, d)).astype(np.float32)
    got.backward(torch.as_tensor(dy).to(ty.dtype))
    if dtype == "float32":
        g_ref = jax.grad(lambda v: jnp.sum(jref.gather_rows_ref(
            v, jnp.asarray(idx)) * dy))(jnp.asarray(y))
        np.testing.assert_allclose(ty.grad.numpy(), np.asarray(g_ref),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_bwd_plain_matches_jax_grad(dtype):
    """The plain version of K3's backward, which the card's segmented-sum
    kernel is held to: f32 sums in ascending source order (bitwise those
    of np.add.at), cast once to dy's dtype; against jax.grad of the
    reference's gather."""
    T, n_src, d = 512, 300, 48
    r = np.random.default_rng(8)
    idx = r.integers(0, n_src, T).astype(np.int32)
    dy = r.standard_normal((T, d)).astype(np.float32)
    dt = getattr(torch, dtype)
    got = ref.gather_rows_bwd_ref(torch.as_tensor(dy).to(dt),
                                  torch.as_tensor(idx), n_src)
    assert got.dtype == dt and got.shape == (n_src, d)
    dy_t = torch.as_tensor(dy).to(dt).float().numpy()
    seq = np.zeros((n_src, d), np.float32)
    np.add.at(seq, idx, dy_t)
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.as_tensor(seq).to(dt).float().numpy())
    g_ref = jax.grad(lambda v: jnp.sum(jref.gather_rows_ref(
        v, jnp.asarray(idx)) * dy_t))(jnp.zeros((n_src, d), jnp.float32))
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(g_ref),
                               atol=1e-6, rtol=tol)


@pytest.mark.parametrize("R", [8, 20])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_backward_plain_matches_jax_grad(R, act):
    """The plain version of K1's backward (autograd through the plain
    forward) against jax.grad of the reference's oracle, f32."""
    E, d, F = 3, 32, 64
    r = np.random.default_rng(6)
    h = r.standard_normal((E, R, d)).astype(np.float32)
    ws = [(r.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, d, F), (E, d, F), (E, F, d))]
    dy = r.standard_normal((E, R, d)).astype(np.float32)

    def jloss(h, wu, wg, wd):
        return jnp.sum(jref.expert_ffn_ref(h, wu, wg, wd, act) * dy)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(h), *map(jnp.asarray, ws))
    th = torch.as_tensor(h).requires_grad_()
    tw = [torch.as_tensor(w).requires_grad_() for w in ws]
    ref.expert_ffn_ref(th, *tw, act).backward(torch.as_tensor(dy))
    for name, g, w in zip(("dh", "dw_up", "dw_gate", "dw_down"),
                          [th.grad] + [t.grad for t in tw], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
