"""The port's cross-sublayer plan reuse, condense reuse and LSH similarity
backend against the JAX reference, on the CPU.

Inputs come from numpy seeds; the reference's weights reach the port
through ``repro_torch.convert``.

- LSH: the projection matrix bit for bit; the bucket codes bit for bit,
  except that a token with a projection within 1e-6 of 0, relative to
  ``|x| |w_i|``, is left out of the comparison (the two frameworks sum
  the f32 product in another order, so such a sign may differ; none of
  the seeded tokens comes that close, which the test asserts). The lsh
  backend's ``fast_similarity``: measured pairs within 1e-6, every other
  entry and the measured fractions bit for bit, against the reference's
  ``use_kernel=False`` path with ``pairwise_cosine`` patched to K2's
  formula (the test process only). ``expected_measured_pairs``,
  ``pick_rate_bucket`` and ``similarity_quantiles`` bit for bit.
- ``build_condense_plan`` under "signature" (a stable frame, an expert
  drift, the age bound) and "always": rep maps, the passed-through
  history, rates, pair counts, counters and signatures bit for bit.
- One device: a reduced moe-gpt2 forward and gradient under each new
  mode against ``jax.grad`` of the reference's ``use_kernels=False``
  path (``pairwise_cosine`` patched): every layer's rep map and the
  counters bit for bit, the condense rate (a mean over sublayers, summed
  in another order by the compiled reference) within 1e-6, the loss
  within 1e-5, every gradient leaf within 1e-5 relative.
- Expert-parallel: one JAX subprocess on a 4-device ``(node=2,
  local=2)`` mesh, ``shard_map``'s vma check off (this JAX rejects the
  reference's reuse ``lax.cond`` inside ``shard_map`` otherwise; the
  reference's own 8-device reuse grid fails on that), runs the cases of
  ``test_plan_cache.py::test_plan_reuse_golden_grid_8dev``: drifting
  routing and zeroed routers under "signature", "always", and
  condensation on (plan "signature"; condense "always" with the lsh
  backend). The port's EP path over 4 virtual ranks: the cross-entropy
  (one ulp in one case, see ``ELOSS_ULP``), the counters, every layer's
  migration perm and rep map bit for bit;
  the metrics that are means over the 3 sublayers, and the total loss
  (which adds the router loss's mean), within one f32 ulp (1.2e-7), as
  the compiled reference multiplies by the f32 reciprocal of 3 where the
  port divides; and "signature" bit for bit the port's "off".
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.condense.backends as jbackends
import repro.condense.plan as jplan
import repro.core.moe_layer as jml
from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.dist import single_device
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild_model

import repro_torch.plan.exchange as tex
from repro_torch import convert, optim
from repro_torch.condense import backends as tbackends
from repro_torch.condense import plan as tplan
from repro_torch.config import LuffyConfig, ShapeConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core.moe_layer import capacity_for
from repro_torch.data import SyntheticLM
from repro_torch.dist import make_dist
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as ttf

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _k2_cosine(x, eps: float = 1e-8):
    """Kernel K2's formula in jnp (``repro/kernels/similarity.py``)."""
    xf = x.astype(jnp.float32)
    sq = jnp.sum(xf * xf, -1)
    inv = jax.lax.rsqrt(sq[:, None] * sq[None, :] + eps)
    return (xf @ xf.T * inv + 1.0) * 0.5


def _clustered(seed, n, d, n_clusters=6, noise=0.3):
    r = np.random.default_rng(seed)
    c = r.standard_normal((n_clusters, d))
    return (c[r.integers(0, n_clusters, n)]
            + noise * r.standard_normal((n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# the lsh backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,bits,seed", [(96, 8, 0), (128, 1, 3),
                                         (64, 30, 1), (64, 0, 0),
                                         (64, 40, 2)])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_lsh_codes_match_reference(d, bits, seed, x_dtype):
    np.testing.assert_array_equal(
        tbackends._lsh_projections(d, max(1, min(bits, 30)), seed),
        jbackends._lsh_projections(d, max(1, min(bits, 30)), seed))
    x = np.random.default_rng(7).standard_normal((512, d)) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.as_tensor(x).to(getattr(torch, x_dtype))
    want = np.asarray(jbackends.lsh_codes(jx, bits=bits, seed=seed))
    got = tbackends.lsh_codes(tx, bits=bits, seed=seed)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    # the f64 projection of the rows as both frameworks read them
    xr = np.asarray(jx.astype(jnp.float32), np.float64)
    w = tbackends._lsh_projections(d, max(1, min(bits, 30)), seed) \
        .astype(np.float64)
    scale = np.linalg.norm(xr, axis=1)[:, None] * np.linalg.norm(w, axis=0)
    near = np.any(np.abs(xr @ w) <= 1e-6 * scale, axis=1)
    assert not near.any()
    np.testing.assert_array_equal(got.numpy()[~near], want[~near])
    if bits <= 0:
        assert got.max() <= 1     # clamped to one bit
    # a leading group axis is a batch of rows
    np.testing.assert_array_equal(
        tbackends.lsh_codes(tx.reshape(4, 128, d), bits=bits, seed=seed)
        .reshape(-1).numpy(), got.numpy())


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("bits", [1, 8])
def test_lsh_fast_similarity_matches_reference(monkeypatch, history, bits):
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    NG, G, d = 3, 64, 48
    x = _clustered(2, NG * G, d).reshape(NG, G, d)
    r = np.random.default_rng(5)
    e = r.integers(0, 4, (NG, G)).astype(np.int32)
    sp = None
    if history:
        sp = r.random((NG, G, G)).astype(np.float32)
    got, gfrac = tbackends.fast_similarity(
        torch.as_tensor(x), torch.as_tensor(e).long(),
        None if sp is None else torch.as_tensor(sp), 0.8, 0.2,
        backend="lsh", lsh_bits=bits, lsh_seed=0)
    for g in range(NG):
        want, wfrac = jbackends.fast_similarity(
            jnp.asarray(x[g]), jnp.asarray(e[g]),
            None if sp is None else jnp.asarray(sp[g]), 0.8, 0.2,
            backend="lsh", lsh_bits=bits, lsh_seed=0)
        want = np.asarray(want)
        code = np.asarray(jbackends.lsh_codes(jnp.asarray(x[g]), bits=bits))
        unc = e[g][:, None] == e[g][None, :]
        if sp is not None:
            unc &= ~(sp[g] > 0.8) & ~(sp[g] < 0.2)
        measured = unc & (code[:, None] == code[None, :])
        assert (unc & ~measured).any() and measured.any()
        sim = got[g].numpy()
        np.testing.assert_array_equal(sim[~measured], want[~measured])
        np.testing.assert_allclose(sim[measured], want[measured], atol=1e-6,
                                   rtol=0)
        assert np.float32(gfrac[g].item()) == np.float32(wfrac)
    # the exact backend measures every uncertain pair: at least as many
    _, efrac = tbackends.fast_similarity(
        torch.as_tensor(x), torch.as_tensor(e).long(),
        None if sp is None else torch.as_tensor(sp), 0.8, 0.2)
    assert torch.all(efrac >= gfrac) and torch.any(efrac > gfrac)


def test_backend_registry_and_expected_measured_pairs():
    assert tbackends.available_similarity_backends() == \
        jbackends.available_similarity_backends() == ["exact", "lsh"]
    with pytest.raises(ValueError, match="unknown similarity_backend"):
        tbackends.get_similarity_backend("nope")
    for args in [(8192, 128, 16, "exact", 8), (8192, 128, 16, "lsh", 8),
                 (4096, 64, 4, "lsh", 1), (100, 128, 0, "lsh", 40),
                 (1000, 32, 8, "lsh", 0)]:
        tokens, G, E, be, bits = args
        got = tbackends.expected_measured_pairs(tokens, G, E, backend=be,
                                                lsh_bits=bits)
        want = jbackends.expected_measured_pairs(tokens, G, E, backend=be,
                                                 lsh_bits=bits)
        assert got == want, args
    # a first block's group at full width: 1144 -> about 132 pairs
    assert tbackends.expected_measured_pairs(128, 128, 16) == 1144.0
    assert tbackends.expected_measured_pairs(128, 128, 16,
                                             backend="lsh") == 131.96875
    with pytest.raises(ValueError):
        tbackends.expected_measured_pairs(128, 128, 16, backend="nope")


def test_pick_rate_bucket_and_similarity_quantiles_match_reference():
    r = np.random.default_rng(3)
    sim = r.random((4, 32, 32)).astype(np.float32)
    e = r.integers(0, 4, (4, 32))
    for kw in ({"expert_idx": e}, {"same_expert_only": False}):
        want = jplan.similarity_quantiles(jnp.asarray(sim), **{
            k: (jnp.asarray(v) if k == "expert_idx" else v)
            for k, v in kw.items()})
        got = tplan.similarity_quantiles(torch.as_tensor(sim), **{
            k: (torch.as_tensor(v) if k == "expert_idx" else v)
            for k, v in kw.items()})
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="expert_idx"):
        tplan.similarity_quantiles(sim)
    q = tplan.similarity_quantiles(sim, e)
    for thr in (0.0, 0.3, 0.5, 0.77, 0.95, 1.01):
        for buckets in ((0.0, 0.25, 0.5), (0.0, 0.1, 0.9)):
            assert tplan.pick_rate_bucket(thr, q, buckets) == \
                jplan.pick_rate_bucket(thr, q, buckets)


# ---------------------------------------------------------------------------
# build_condense_plan's reuse
# ---------------------------------------------------------------------------

CG, CT, CD, CNSEQ = 16, 64, 24, 2       # G, T (2 sequences of 32), d


def _condense_inputs():
    x = _clustered(11, CT, CD, n_clusters=3, noise=0.2)
    e = np.random.default_rng(12).integers(0, 2, CT).astype(np.int32)
    s_prev = np.full((CT // CG, CG, CG), 0.5, np.float32)
    return x, e, s_prev


def _both_plans(x, e, s_prev, carry, mode, max_age=4, backend="exact"):
    """The reference's and the port's build_condense_plan on the same
    inputs and carry (rep, expert, age, valid as numpy)."""
    kw = dict(group_size=CG, s1=0.8, s2=0.2, backend=backend,
              reuse_mode=mode, max_age=max_age)
    jc = None if carry is None else jplan.CondenseCarry(
        *(jnp.asarray(v) for v in carry))
    want = jplan.build_condense_plan(
        jnp.asarray(x), jnp.asarray(e), jnp.float32(0.6),
        s_prev=jnp.asarray(s_prev), carry=jc, **kw)
    tc = None if carry is None else tplan.CondenseCarry(
        torch.as_tensor(carry[0]).long(), torch.as_tensor(carry[1]).long(),
        torch.as_tensor(carry[2]), torch.as_tensor(carry[3]))
    got = tplan.build_condense_plan(
        torch.as_tensor(x), torch.as_tensor(e).long(), torch.tensor(0.6),
        s_prev=torch.as_tensor(s_prev), carry=tc, **kw)
    np.testing.assert_array_equal(got.rep_idx.numpy(), want.rep_idx)
    np.testing.assert_array_equal(got.is_rep.numpy(), want.is_rep)
    assert np.float32(got.rate.item()) == np.float32(want.rate)
    assert np.float32(got.measured_pairs.item()) == \
        np.float32(want.measured_pairs)
    assert float(got.built) == float(want.built)
    assert float(got.reused) == float(want.reused)
    np.testing.assert_allclose(got.s_next.numpy(), want.s_next, atol=1e-6,
                               rtol=0)
    if carry is not None:
        for a, b in zip(got.signature, want.signature):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return got


def _carry_of(plan):
    sig = plan.signature
    return ((plan.rep_idx % CG).numpy().astype(np.int32),
            sig.expert.numpy().astype(np.int32), sig.age.numpy(),
            sig.valid.numpy())


def _zero_carry():
    return (np.zeros(CT, np.int32), np.zeros(CT, np.int32),
            np.zeros(CNSEQ, np.float32), np.zeros(CNSEQ, np.float32))


@pytest.mark.parametrize("backend", ["exact", "lsh"])
def test_condense_reuse_signature_on_a_stable_frame(monkeypatch, backend):
    """Revalidating against the frame the plan was built on: the rep map
    of a rebuild, the history passed through, nothing measured."""
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    x, e, sp = _condense_inputs()
    p1 = _both_plans(x, e, sp, _zero_carry(), "signature", backend=backend)
    assert float(p1.built) == 1.0 and 0.0 < p1.rate.item() < 1.0
    assert p1.signature.valid.tolist() == [1.0, 1.0]
    s1 = p1.s_next.numpy()
    p2 = _both_plans(x, e, s1, _carry_of(p1), "signature", backend=backend)
    assert float(p2.reused) == 1.0 and p2.measured_pairs.item() == 0.0
    np.testing.assert_array_equal(p2.s_next.numpy(), s1)
    assert p2.signature.age.tolist() == [1.0, 1.0]
    rebuilt = _both_plans(x, e, s1, None, "off", backend=backend)
    np.testing.assert_array_equal(p2.rep_idx.numpy(),
                                  rebuilt.rep_idx.numpy())


def test_condense_reuse_age_bound_drift_and_always(monkeypatch):
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    x, e, sp = _condense_inputs()
    p1 = _both_plans(x, e, sp, _zero_carry(), "signature", max_age=1)
    rep, exp_, age, valid = _carry_of(p1)
    s1 = p1.s_next.numpy()
    # at the age bound the carried map is stale: rebuilt
    old = (rep, exp_, np.full(CNSEQ, 1.0, np.float32), valid)
    p2 = _both_plans(x, e, s1, old, "signature", max_age=1)
    assert float(p2.built) == 1.0 and p2.signature.age.tolist() == [0, 0]
    # merged tokens no longer share an expert: rebuilt
    drift = (rep, exp_ + 1, age, valid)
    p3 = _both_plans(x, e, s1, drift, "signature", max_age=1)
    assert float(p3.built) == 1.0
    # "always" skips the expert compare, not the age bound
    p5 = _both_plans(x, e, s1, drift, "always", max_age=1)
    assert float(p5.reused) == 1.0
    p6 = _both_plans(x, e, s1, old, "always", max_age=1)
    assert float(p6.built) == 1.0
    # "off" emits flags of 0, so its carries never revalidate
    p4 = _both_plans(x, e, sp, _zero_carry(), "off")
    assert p4.signature.valid.tolist() == [0.0, 0.0]
    p4b = _both_plans(x, e, p4.s_next.numpy(), _carry_of(p4), "off")
    assert float(p4b.built) == 1.0
    # no history: a build and a signature that never validates
    got = tplan.build_condense_plan(
        torch.as_tensor(x), torch.as_tensor(e).long(), torch.tensor(0.6),
        group_size=CG, carry=tplan.CondenseCarry(
            *(torch.as_tensor(v) for v in _carry_of(p1))),
        reuse_mode="always")
    assert float(got.built) == 1.0 and got.signature.valid.tolist() == [0, 0]
    with pytest.raises(ValueError, match="condense_reuse"):
        tplan.build_condense_plan(
            torch.as_tensor(x), torch.as_tensor(e).long(), torch.tensor(0.6),
            group_size=CG, reuse_mode="sometimes")


# ---------------------------------------------------------------------------
# one device: forward and gradient under each mode
# ---------------------------------------------------------------------------

B1, S1, D1, L1, G1, THR1 = 2, 128, 128, 6, 64, 0.45
MODES1 = {
    "condense_signature": dict(condense_reuse="signature"),
    "condense_always": dict(condense_reuse="always"),
    "lsh": dict(similarity_backend="lsh"),
    "lsh_always_plan_signature": dict(similarity_backend="lsh",
                                      condense_reuse="always",
                                      plan_reuse="signature"),
}


def _cfgs1():
    jcfg = dataclasses.replace(
        jreduced(jget_config("moe-gpt2"), d_model=D1, num_layers=L1),
        compute_dtype="float32")
    tcfg = dataclasses.replace(
        reduced(get_config("moe-gpt2"), d_model=D1, num_layers=L1),
        compute_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def one_device():
    jcfg, tcfg = _cfgs1()
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    batch = SyntheticLM(tcfg, ShapeConfig("t", S1, B1, "train")).batch(0)
    cap = capacity_for(tcfg.moe, B1 * S1, tcfg.moe.num_experts)
    return {"jparams": params, "np_params": jax.tree.map(np.asarray, params),
            "batch": batch, "cap": cap}


def _record_plans_jax(monkeypatch, store):
    orig = jml.build_exchange_plan

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        jax.debug.callback(lambda r: store.append(np.asarray(r)),
                           pl.rep_idx, ordered=True)
        return pl

    monkeypatch.setattr(jml, "build_exchange_plan", rec)


def _record_plans_torch(monkeypatch, store):
    orig = tex.build_exchange_plan

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        store.append(pl)
        return pl

    monkeypatch.setattr(tex, "build_exchange_plan", rec)


@pytest.mark.parametrize("mode", sorted(MODES1))
def test_one_device_forward_and_gradient_match_jax_grad(one_device, mode,
                                                        monkeypatch):
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    jcfg, tcfg = _cfgs1()
    kw = dict(condense_group=G1, **MODES1[mode])
    jl = JLuffy(use_kernels=False, **kw)
    jreps = []
    _record_plans_jax(monkeypatch, jreps)
    jb = {k: jnp.asarray(v) for k, v in one_device["batch"].items()}

    def f(p):
        return jtf.forward_train(p, jcfg, jl, single_device(), jb,
                                 jnp.float32(THR1), one_device["cap"])

    (jloss, jm), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        one_device["jparams"])
    jax.effects_barrier()
    jm = {k: float(v) for k, v in jm.items()}

    params = convert.from_reference(one_device["np_params"], tcfg)
    for _, p in optim.leaves_with_path(params):
        p.requires_grad_()
    plans = []
    _record_plans_torch(monkeypatch, plans)
    tb = {k: torch.as_tensor(v) for k, v in one_device["batch"].items()}
    loss, m = ttf.forward_train(params, tcfg, LuffyConfig(**kw), tb,
                                torch.tensor(THR1), one_device["cap"])
    assert len(plans) == len(jreps) == L1
    for i, (pl, want) in enumerate(zip(plans, jreps)):
        np.testing.assert_array_equal(pl.condense_plan.rep_idx.numpy(), want,
                                      err_msg=f"layer {i} rep map")
    for k in ("condense_built", "condense_reused", "measured_pairs",
              "plans_built", "plans_reused", "plan_reuse_mismatch",
              "dispatch_drop"):
        assert float(m[k]) == jm[k], (k, float(m[k]), jm[k])
    # a mean over the sublayers' rates, which the rep maps fix bit for
    # bit; the compiled reference sums them in another order
    np.testing.assert_allclose(float(m["condense_rate"]),
                               jm["condense_rate"], rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    if "always" in mode:
        # max age 4: built at sublayer 0 and 5 of 6
        assert (jm["condense_built"], jm["condense_reused"]) == (2.0, 4.0)
    elif mode == "condense_signature":
        assert jm["condense_built"] + jm["condense_reused"] == L1
    if mode.startswith("lsh"):
        exact = LuffyConfig(condense_group=G1)
        _, me = ttf.forward_train(params, tcfg, exact, tb,
                                  torch.tensor(THR1), one_device["cap"])
        assert 0 < m["measured_pairs"] < me["measured_pairs"]
    loss.backward()
    grads = convert.to_reference(optim.tree_map(lambda p: p.grad, params),
                                 tcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)


def test_remat_replays_the_reuse_decisions(one_device, monkeypatch):
    """Under ``cfg.remat`` the recompute of each layer takes the forward's
    carries, so it repeats the forward's reuse decisions and rep maps and
    gives the gradients of the plain forward: every leaf bit for bit but
    the tied embedding table, whose residual gradient the autograd engine
    sums in another order once layer 0 is checkpointed (as
    ``test_torch_train.py::test_remat_matches_plain_forward`` has it)."""
    _, tcfg = _cfgs1()
    luffy = LuffyConfig(condense_group=G1, condense_reuse="always",
                        similarity_backend="lsh")
    tb = {k: torch.as_tensor(v) for k, v in one_device["batch"].items()}
    out = {}
    plans = []
    _record_plans_torch(monkeypatch, plans)
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = convert.from_reference(one_device["np_params"], cfg)
        for _, p in optim.leaves_with_path(params):
            p.requires_grad_()
        plans.clear()
        loss, m = ttf.forward_train(params, cfg, luffy, tb,
                                    torch.tensor(THR1), one_device["cap"])
        loss.backward()
        out[remat] = (loss.item(), list(plans),
                      list(optim.leaves_with_path(
                          optim.tree_map(lambda p: p.grad, params))))
    (l0, p0, g0), (l1, p1, g1) = out[False], out[True]
    assert l1 == l0
    assert [float(p.condense_plan.reused) for p in p0] == \
        [0.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    # the backward recomputes the layers last to first
    assert len(p1) == 2 * L1
    for i in range(L1):
        for pl in (p1[i], p1[2 * L1 - 1 - i]):
            assert float(pl.condense_plan.reused) == \
                float(p0[i].condense_plan.reused)
            assert torch.equal(pl.condense_plan.rep_idx,
                               p0[i].condense_plan.rep_idx)
    for (path, a), (_, b) in zip(g1, g0):
        if path == "embed/table":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# expert-parallel: the reference's reuse grid on 4 host devices
# ---------------------------------------------------------------------------

EB, ES, EM, ENODES, ETHR, ESLACK, EG, EL, ED = 8, 64, 4, 2, 0.4, 8.0, 32, \
    3, 256
# (name, routers zeroed, LuffyConfig fields beyond the base)
ECASES = [
    ("drift_signature", False, dict(plan_reuse="signature")),
    ("stable_signature", True, dict(plan_reuse="signature")),
    ("stable_always", True, dict(plan_reuse="always")),
    ("cond_signature", False, dict(plan_reuse="signature",
                                   enable_condensation=True)),
    ("cond_always_lsh", False, dict(plan_reuse="always",
                                    enable_condensation=True,
                                    condense_reuse="always",
                                    similarity_backend="lsh")),
]
# per-forward sums over the sublayers: bit for bit
ECOUNTERS = ("plans_built", "plans_reused", "plan_reuse_mismatch",
             "condense_built", "condense_reused", "measured_pairs")
# the cross-entropy bit for bit, except in this one case, where it is one
# f32 ulp from the reference's with every rep map, perm and count equal;
# with plan_reuse "off" the gap is the same (an f32 sum order of the
# exact-backend condensed forward at this shape, not the reuse)
ELOSS_ULP = ("cond_signature",)
# means over the 3 sublayers: the compiled reference multiplies the sum
# by the f32 reciprocal of 3 where the port divides, 1 ulp apart at most
EMEANS = ("condense_rate", "local_frac", "traffic_before", "traffic_after",
          "dispatch_drop", "combine_drop", "aux_loss")
EBITWISE = ("loss",) + ECOUNTERS + EMEANS

EORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.comm as rcomm
    import repro.comm.compat as compat
    import repro.core.moe_layer as jml
    from repro.config import LuffyConfig, ShapeConfig, reduced
    from repro.configs import get_config
    from repro.core.moe_layer import capacity_for
    from repro.data import SyntheticLM
    from repro.dist import make_dist
    from repro.launch.mesh import make_host_mesh, topology_for_mesh
    from repro.models.model import build_model
    B, S, M, NODES, THR, SLACK, G, L, D, CASES, BITWISE = %s

    def _sm(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = _sm
    rcomm.shard_map = _sm
    rec = []
    orig = jml.build_exchange_plan

    def wrap(*a, **kw):
        pl = orig(*a, **kw)
        jax.debug.callback(
            lambda i, dg, rep: rec.append((int(i), np.asarray(dg),
                                           np.asarray(rep))),
            pl.comm.index(), pl.dest_global, pl.rep_idx)
        return pl

    jml.build_exchange_plan = wrap
    mesh = make_host_mesh(model=M, nodes=NODES)
    dist = make_dist(mesh, "train", B, moe_arch=True,
                     topology=topology_for_mesh(mesh))
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2"), num_layers=L,
                                      d_model=D), compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    stable = dict(params)
    stable["layers"] = [dict(params["layers"][0])]
    stable["layers"][0]["moe"] = dict(params["layers"][0]["moe"])
    stable["layers"][0]["moe"]["router"] = {
        "w_gate": jnp.zeros_like(
            params["layers"][0]["moe"]["router"]["w_gate"])}
    shape = ShapeConfig("t", S, B, "train")
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLM(cfg, shape).batch(0).items()}
    batch["seq_len"] = jnp.asarray(
        np.random.default_rng(0).permutation(np.arange(S - B, S)),
        jnp.int32)
    cap = capacity_for(cfg.moe, B // M * S, cfg.moe.num_experts,
                       slack=SLACK)
    out = {"seq_len": np.asarray(batch["seq_len"])}
    fns = {}
    for name, zero, kw in CASES:
        lf = LuffyConfig(**dict(dict(enable_condensation=False,
                                     enable_migration=True,
                                     combine_slack=4.0, condense_group=G,
                                     use_kernels=True), **kw))
        key = repr(sorted(kw.items()))
        if key not in fns:
            fns[key] = jax.jit(lambda p, b, lf=lf: model.train_loss(
                p, b, jnp.float32(THR), luffy=lf, dist=dist, capacity=cap))
        rec.clear()
        loss, m = fns[key](stable if zero else params, batch)
        jax.effects_barrier()
        out[name + "/total"] = np.float32(loss)
        for k in BITWISE:
            out[name + "/" + k] = np.float32(m[k])
        seen = {}
        for i, dg, rep in rec:
            layer = seen.get(i, 0)
            seen[i] = layer + 1
            out[name + f"/perm{layer}/{i}"] = dg
            out[name + f"/rep{layer}/{i}"] = rep
    np.savez(sys.argv[1], **out)
    print("OK")
""") % repr((EB, ES, EM, ENODES, ETHR, ESLACK, EG, EL, ED, ECASES, EBITWISE))


@pytest.fixture(scope="module")
def ep_oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("reuse") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", EORACLE, str(path)],
                         cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    jcfg = dataclasses.replace(
        jreduced(jget_config("moe-gpt2"), num_layers=EL, d_model=ED),
        compute_dtype="float32")
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return {"npz": dict(np.load(path)),
            "params": jax.tree.map(np.asarray, params)}


def _ep_setup(ep_oracle, zero):
    tcfg = dataclasses.replace(
        reduced(get_config("moe-gpt2"), num_layers=EL, d_model=ED),
        compute_dtype="float32")
    params = convert.from_reference(ep_oracle["params"], tcfg)
    if zero:
        for layer in params["layers"]:
            layer["moe"]["router"]["w_gate"] = torch.zeros_like(
                layer["moe"]["router"]["w_gate"])
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        tcfg, ShapeConfig("t", ES, EB, "train")).batch(0).items()}
    batch["seq_len"] = torch.as_tensor(ep_oracle["npz"]["seq_len"])
    dist = make_dist(make_host_mesh(model=EM, nodes=ENODES), "train", EB,
                     moe_arch=True)
    cap = capacity_for(tcfg.moe, EB // EM * ES, tcfg.moe.num_experts,
                       slack=ESLACK)
    return tcfg, params, batch, dist, cap


def _ep_forward(ep_oracle, zero, kw, monkeypatch):
    tcfg, params, batch, dist, cap = _ep_setup(ep_oracle, zero)
    luffy = LuffyConfig(**dict(dict(enable_condensation=False,
                                    enable_migration=True,
                                    combine_slack=4.0, condense_group=EG),
                               **kw))
    plans = []
    _record_plans_torch(monkeypatch, plans)
    with torch.no_grad():
        loss, m = ttf.forward_train(params, tcfg, luffy, batch,
                                    torch.tensor(ETHR), cap, dist=dist)
    return loss.item(), {k: float(v) for k, v in m.items()}, plans


@pytest.mark.parametrize("name,zero,kw", ECASES, ids=[c[0] for c in ECASES])
def test_ep_reuse_matches_reference_grid(ep_oracle, monkeypatch, name, zero,
                                         kw):
    ref = ep_oracle["npz"]
    loss, m, plans = _ep_forward(ep_oracle, zero, kw, monkeypatch)
    for k in ECOUNTERS:
        assert np.float32(m[k]) == ref[name + "/" + k], (k, m[k],
                                                         ref[name + "/" + k])
    if name in ELOSS_ULP:
        np.testing.assert_allclose(m["loss"], ref[name + "/loss"],
                                   rtol=1.2e-7)
    else:
        assert np.float32(m["loss"]) == ref[name + "/loss"]
    for k in EMEANS:
        np.testing.assert_allclose(m[k], ref[name + "/" + k], rtol=1.2e-7,
                                   err_msg=k)
    # the total adds the router loss's sublayer mean
    np.testing.assert_allclose(loss, ref[name + "/total"], rtol=1.2e-7)
    assert len(plans) == EL
    T = EB // EM * ES
    for layer, pl in enumerate(plans):
        for r in range(EM):
            np.testing.assert_array_equal(
                pl.dest_global[r].numpy(), ref[name + f"/perm{layer}/{r}"],
                err_msg=f"layer {layer} rank {r} perm")
            rep = pl.condense_plan.rep_idx.reshape(EM, T)[r] - r * T
            np.testing.assert_array_equal(
                rep.numpy(), ref[name + f"/rep{layer}/{r}"],
                err_msg=f"layer {layer} rank {r} rep map")
    # the reference grid's counters
    if name == "drift_signature":
        assert (m["plans_built"], m["plans_reused"],
                m["plan_reuse_mismatch"]) == (3.0, 0.0, 2.0)
    elif name == "stable_signature" or name == "stable_always":
        assert (m["plans_built"], m["plans_reused"],
                m["plan_reuse_mismatch"]) == (1.0, 2.0, 0.0)
    elif name == "cond_signature":
        assert m["plans_built"] + m["plans_reused"] == 3.0
    else:
        assert (m["condense_built"], m["condense_reused"]) == (1.0, 2.0)
        assert (m["plans_built"], m["plans_reused"]) == (1.0, 2.0)
    # "signature" is bit for bit "off", but for the counters
    if kw["plan_reuse"] == "signature":
        off = dict(kw, plan_reuse="off")
        loss0, m0, plans0 = _ep_forward(ep_oracle, zero, off, monkeypatch)
        assert loss0 == loss
        for k in m:
            if k not in ("plans_built", "plans_reused",
                         "plan_reuse_mismatch"):
                assert m0[k] == m[k], k
        assert m0["plans_built"] == 3.0 and m0["plans_reused"] == 0.0
        for a, b in zip(plans0, plans):
            assert torch.equal(a.dest_global, b.dest_global)


def test_launcher_takes_the_reuse_flags(capsys):
    res = ttrain.main(["--reduced", "--steps", "1", "--model-axis", "4",
                       "--comm-mode", "hier", "--nodes", "2", "--hier-dedup",
                       "on", "--wire-dtype", "f8e4m3", "--plan-reuse",
                       "always", "--condense-reuse", "always",
                       "--similarity-backend", "lsh", "--lsh-bits", "4",
                       "--condense-max-age", "1", "--device", "cpu"])
    luffy = res["luffy"]
    assert (luffy.plan_reuse, luffy.condense_reuse, luffy.similarity_backend,
            luffy.lsh_bits, luffy.condense_reuse_max_age) == (
        "always", "always", "lsh", 4, 1)
    st = res["steps"][0]
    # 2 MoE sublayers: a build and a reuse of each plan
    assert (st["plans_built"], st["plans_reused"]) == (1.0, 1.0)
    assert (st["condense_built"], st["condense_reused"]) == (1.0, 1.0)
    assert np.isfinite(st["loss"])
    assert "plans=1/1 cplans=1/1" in capsys.readouterr().out
    args = ttrain.parse_args([])
    assert (args.plan_reuse, args.condense_reuse, args.similarity_backend,
            args.lsh_bits, args.condense_max_age) == ("off", "off", None,
                                                     None, 4)
    with pytest.raises(SystemExit):
        ttrain.parse_args(["--plan-reuse", "sometimes"])
