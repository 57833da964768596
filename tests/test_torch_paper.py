"""The paper's other two models in the port (repro_torch) against the JAX
reference, on the CPU, in one process: moe-transformerxl (causal, RoPE,
untied head) and moe-bert-large (non-causal, padded keys masked by
``seq_len``), reduced to 2 layers, d 128, 4 experts, B=2, S=256 with
condensation groups of 128; the Adafactor and SGD updates; the launcher.
The reference's weights reach the port through ``repro_torch.convert``;
batches come from the synthetic stream (lengths 169 and 195 of 256, so
the key mask has padding to hide).

Oracles, as in ``tests/test_torch_train.py``: the forward against
``forward_train`` with ``use_kernels=True`` (Pallas interpreted), the
gradients and the optimizer trajectories against ``jax.grad`` of the
``use_kernels=False`` path with ``pairwise_cosine`` patched, in this
process only, to kernel K2's formula.

Tolerances: the loss within 1e-5 relative at f32 and 1e-4 at bf16 with
equal rep maps in every layer; each gradient leaf within 1e-3 relative
and the global norm within 1e-4; attention 1e-5; serving 1e-4 with equal
greedy tokens (f32); 4-step Adafactor / SGD losses within 1e-4, the
final parameters within 1e-4 and the momentum within 1e-3 relative per
leaf; one update from the reference's state on the same gradients:
the parameters and second moments within 1e-6, Adafactor's bf16
momentum within one bf16 ulp of the reference's (see the test for
where the f32 sum cancels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.condense.backends as jbackends
import repro.condense.plan as jplan
from repro import optim as joptim
from repro import train_lib as jtrain
from repro.config import LuffyConfig as JLuffy
from repro.config import OptimConfig as JOptim
from repro.config import ShapeConfig as JShape
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import single_device
from repro.models import blocks as jbk
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

import repro_torch.condense.plan as tplan
from repro_torch import convert, optim, train_lib
from repro_torch.config import LuffyConfig, OptimConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core.moe_layer import capacity_for
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tbk
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model

ARCHS = ("moe-transformerxl", "moe-bert-large")
B, S, D = 2, 256, 128
THR = 0.6


def _cfgs(arch, cdt="float32", **kw):
    jcfg = dataclasses.replace(jreduced(jget_config(arch), d_model=D, **kw),
                               compute_dtype=cdt)
    tcfg = dataclasses.replace(reduced(get_config(arch), d_model=D, **kw),
                               compute_dtype=cdt)
    return jcfg, tcfg


def _k2_cosine(x, eps: float = 1e-8):
    """Kernel K2's formula in jnp (``repro/kernels/similarity.py``)."""
    xf = x.astype(jnp.float32)
    sq = jnp.sum(xf * xf, -1)
    inv = jax.lax.rsqrt(sq[:, None] * sq[None, :] + eps)
    return (xf @ xf.T * inv + 1.0) * 0.5


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        batch = JSyntheticLM(jcfg, JShape("train", S, B, "train")).batch(0)
        out[arch] = {"jparams": params,
                     "np_params": jax.tree.map(np.asarray, params),
                     "batch": batch, "cap": capacity_for(tcfg.moe, B * S, 4)}
    return out


def _record(monkeypatch, module, key, store):
    """Wrap ``module.condense_tokens`` to keep each call's rep map."""
    orig = module.condense_tokens

    def rec(*a, **kw):
        out = orig(*a, **kw)
        if key == "jax":
            jax.debug.callback(lambda r: store.append(np.asarray(r)),
                               out.rep_idx, ordered=True)
        else:
            store.append(out.rep_idx.numpy().copy())
        return out

    monkeypatch.setattr(module, "condense_tokens", rec)


def _jax_forward(su, jcfg, use_kernels, monkeypatch, grad=False,
                 batch=None):
    luffy = JLuffy(use_kernels=use_kernels)
    reps = []
    _record(monkeypatch, jplan, "jax", reps)
    batch = {k: jnp.asarray(v) for k, v in (batch or su["batch"]).items()}

    def f(p):
        return jtf.forward_train(p, jcfg, luffy, single_device(), batch,
                                 jnp.float32(THR), su["cap"])

    if grad:
        (loss, m), g = jax.value_and_grad(f, has_aux=True)(su["jparams"])
    else:
        (loss, m), g = f(su["jparams"]), None
    jax.effects_barrier()
    return float(loss), {k: float(v) for k, v in m.items()}, reps, g


def _torch_forward(su, tcfg, monkeypatch, batch=None):
    params = convert.from_reference(su["np_params"], tcfg)
    for _, p in optim.leaves_with_path(params):
        p.requires_grad_()
    reps = []
    _record(monkeypatch, tplan, "torch", reps)
    batch = {k: torch.as_tensor(v) for k, v in (batch or su["batch"]).items()}
    loss, m = ttf.forward_train(params, tcfg, LuffyConfig(), batch,
                                torch.tensor(THR), su["cap"])
    return loss, {k: float(v) for k, v in m.items()}, reps, params


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_kernel_path(setups, monkeypatch, arch, cdt):
    su = setups[arch]
    jcfg, tcfg = _cfgs(arch, cdt)
    assert (su["batch"]["seq_len"] < S).all()     # padded keys to mask
    j_loss, j_m, j_reps, _ = _jax_forward(su, jcfg, True, monkeypatch)
    loss, m, reps, _ = _torch_forward(su, tcfg, monkeypatch)
    assert len(reps) == len(j_reps) == 2
    for i, (a, b) in enumerate(zip(reps, j_reps)):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {i} rep map")
    tol = 1e-5 if cdt == "float32" else 1e-4
    np.testing.assert_allclose(loss.item(), j_loss, rtol=tol)
    for k in ("condense_rate", "measured_pairs", "dispatch_drop",
              "combine_drop", "local_frac"):
        assert m[k] == j_m[k], k
    np.testing.assert_allclose(m["aux_loss"], j_m["aux_loss"], rtol=tol)
    assert 0.1 < m["condense_rate"] < 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_f32_match_jax_grad(setups, monkeypatch, arch):
    su = setups[arch]
    jcfg, tcfg = _cfgs(arch)
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    _, _, j_reps, j_grads = _jax_forward(su, jcfg, False, monkeypatch,
                                         grad=True)
    loss, _, reps, params = _torch_forward(su, tcfg, monkeypatch)
    for i, (a, b) in enumerate(zip(reps, j_reps)):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {i} rep map")
    loss.backward()
    grads = convert.to_reference(
        optim.tree_map(lambda p: p.grad, params), tcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(j_grads))
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert sorted(map(str, got)) == sorted(map(str, want))
    assert "unembed" in str(sorted(map(str, got)))      # untied heads
    sq_got = sq_want = 0.0
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        sq_got += np.sum(g * g)
        sq_want += np.sum(w * w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-3, (jax.tree_util.keystr(path), err)
    np.testing.assert_allclose(np.sqrt(sq_got), np.sqrt(sq_want), rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_attn_key_mask_matches_reference(causal):
    """``attn_apply`` with ``kv_valid`` (ragged lengths, one row with a
    single valid key) against the reference's, f32, with and without
    RoPE; a masked key changes nothing."""
    r = np.random.default_rng(4)
    Bq, Sq = 3, 24
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        p = jax.tree.map(np.asarray, jbuild_model(jcfg).init(
            jax.random.PRNGKey(1)))["layers"][0]["attn"]
        p = {k: v[0] for k, v in p.items()}
        x = r.standard_normal((Bq, Sq, D)).astype(np.float32)
        lens = np.array([Sq, 17, 1])
        pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (Bq, Sq))
        valid = pos < lens[:, None]
        want, _ = jbk.attn_apply(jax.tree.map(jnp.asarray, p), jcfg,
                                 jnp.asarray(x), jnp.asarray(pos), layer=0,
                                 causal=causal, kv_valid=jnp.asarray(valid))
        tp = convert.tree_to_torch(p)
        got, _ = tbk.attn_apply(tp, tcfg, torch.as_tensor(x),
                                torch.as_tensor(pos), layer=0, causal=causal,
                                kv_valid=torch.as_tensor(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=arch)
        x2 = x.copy()
        x2[1, 17:] += 3.0                    # only masked keys move
        got2, _ = tbk.attn_apply(tp, tcfg, torch.as_tensor(x2),
                                 torch.as_tensor(pos), layer=0,
                                 causal=causal,
                                 kv_valid=torch.as_tensor(valid))
        assert torch.equal(got2[1, :17], got[1, :17])
    with pytest.raises(NotImplementedError, match="key-padding"):
        tbk.attn_apply(tp, tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                       layer=0, flash=True, kv_valid=torch.as_tensor(valid))


def test_transformerxl_at_250_runs_without_condensation(setups, monkeypatch):
    """At Table II's length 250, S is no multiple of the group of 128, so
    both packages turn condensation off (and K2 and K3 never run)."""
    su = setups["moe-transformerxl"]
    jcfg, tcfg = _cfgs("moe-transformerxl")
    batch = JSyntheticLM(jcfg, JShape("train", 250, B, "train")).batch(0)
    j_loss, j_m, j_reps, _ = _jax_forward(su, jcfg, True, monkeypatch,
                                          batch=batch)
    loss, m, reps, _ = _torch_forward(su, tcfg, monkeypatch, batch=batch)
    assert reps == [] and j_reps == []
    assert m["condense_rate"] == j_m["condense_rate"] == 0.0
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    """Batched prefill, a step-fed prompt and greedy decode of reduced
    f32 models through both engines; both serve causally, moe-bert-large
    included."""
    jcfg, tcfg = _cfgs(arch, num_layers=2)
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    jl = JLuffy(use_kernels=True, enable_condensation=False,
                enable_migration=False)
    Bs, Sp, gen = 2, 8, 4
    prompts = np.random.default_rng(5).integers(
        1, jcfg.vocab_size, (Bs, Sp)).astype(np.int32)
    s_max = Sp + gen
    want_pf = np.asarray(jengine.prefill(params, jcfg, jl, single_device(),
                                         jnp.asarray(prompts), s_max)[0])
    dec = jax.jit(lambda p, c, t: jengine.decode_step(
        p, jcfg, jl, single_device(), c, t))
    cache = jengine.cache_struct(jcfg, Bs, s_max, as_struct=False)
    model = build_model(tcfg, device="cpu", params=convert.from_reference(
        jax.tree.map(np.asarray, params), tcfg))
    tl = LuffyConfig(enable_condensation=False, enable_migration=False)
    got_pf = model.prefill(torch.as_tensor(prompts), s_max, luffy=tl)[0]
    np.testing.assert_allclose(got_pf.numpy(), want_pf, rtol=1e-4, atol=1e-4)
    tcache = model.new_cache(Bs, s_max)
    feed = prompts
    for t in range(Sp + gen):
        tok = feed[:, t:t + 1] if t < Sp else nxt
        want, cache = dec(params, cache, jnp.asarray(tok))
        got, tcache = model.decode_step(tcache, torch.as_tensor(tok),
                                        luffy=tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(got.argmax(-1).numpy(), nxt[:, 0])
        if t == Sp - 1:
            # the prefill is causal: its last position is the step feed's
            np.testing.assert_allclose(got.numpy(), got_pf.numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["adafactor", "sgd"])
def test_optimizer_state_matches_reference(setups, name):
    """Shapes and dtypes of every leaf of the state, Adafactor's factored
    second moments ({"r", "c"} on leaves whose last two dims are >= 128)
    included, on reduced moe-bert-large's parameters."""
    su = setups["moe-bert-large"]
    _, tcfg = _cfgs("moe-bert-large")
    js = joptim.init_opt_state(su["jparams"], JOptim(name=name))
    ts = optim.init_opt_state(convert.from_reference(su["np_params"], tcfg),
                              OptimConfig(name=name))
    for tree, jtree in ((ts.mu, js.mu), (ts.nu, js.nu)):
        # shapes through the converter (at f32: numpy has no bf16), then
        # dtypes by name, each tree being of one dtype
        ref = convert.to_reference(optim.tree_map(lambda t: t.float(), tree),
                                   tcfg)
        want = {jax.tree_util.keystr(p): v.shape
                for p, v in jax.tree_util.tree_leaves_with_path(jtree)}
        got = {jax.tree_util.keystr(p): v.shape
               for p, v in jax.tree_util.tree_leaves_with_path(ref)}
        assert got == want
        assert {str(v.dtype) for v in jax.tree.leaves(jtree)} == \
            {str(v.dtype).removeprefix("torch.")
             for _, v in optim.leaves_with_path(tree)}
    if name == "adafactor":
        factored = [p for p, v in optim.leaves_with_path(ts.nu)
                    if p.endswith("/r")]
        assert any("experts/w_up" in p for p in factored)
        assert all(v.dtype == torch.bfloat16
                   for _, v in optim.leaves_with_path(ts.mu))


def _bf16_ulp(a):
    a = np.abs(np.asarray(a, np.float32))
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("name", ["adafactor", "sgd"])
def test_optimizer_trajectory_matches_jax_loop(setups, monkeypatch, name):
    """Four train steps of reduced moe-bert-large (condensation on, the
    adaptive threshold from step 2) through both launchers' loop shape:
    losses and gradient norms, then every parameter and momentum leaf."""
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    su = setups["moe-bert-large"]
    jcfg, tcfg = _cfgs("moe-bert-large")
    steps = 4
    jocfg = JOptim(name=name, lr=1e-3, total_steps=steps, warmup_steps=2)
    ocfg = OptimConfig(name=name, lr=1e-3, total_steps=steps,
                       warmup_steps=2)
    jl, tl = JLuffy(use_kernels=False), LuffyConfig()
    data = JSyntheticLM(jcfg, JShape("train", S, B, "train"))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jl, jocfg, single_device(),
                                           su["cap"]))
    jp, jos = su["jparams"], joptim.init_opt_state(su["jparams"], jocfg)
    jls = jtrain.init_luffy_state()
    params = convert.from_reference(su["np_params"], tcfg)
    for _, p in optim.leaves_with_path(params):
        p.requires_grad_()
    tstep = train_lib.make_train_step(tcfg, tl, ocfg, su["cap"])
    tos = optim.init_opt_state(params, ocfg)
    tls = train_lib.init_luffy_state("cpu")
    for i in range(steps):
        b = data.batch(i)
        jp, jos, jls, jm = jstep(jp, jos, jls,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        params, tos, tls, tm = tstep(params, tos, tls,
                                     {k: torch.as_tensor(v)
                                      for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        assert float(tm["condense_rate"]) == float(jm["condense_rate"])
    assert int(tos.step) == int(jos.step) == steps
    got_p = dict(jax.tree_util.tree_leaves_with_path(
        convert.to_reference(params, tcfg)))
    for path, w in jax.tree_util.tree_leaves_with_path(jp):
        g, w = np.asarray(got_p[path], np.float64), np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)
    # the momentum normalises each gradient entry (Adafactor) or sums
    # them (SGD), so entries whose gradient nearly cancels differ more
    # than their leaf: each leaf within 1e-3 relative (2e-4 measured)
    mu = convert.to_reference(optim.tree_map(lambda m: m.float(), tos.mu),
                              tcfg)
    got_m = dict(jax.tree_util.tree_leaves_with_path(mu))
    for path, w in jax.tree_util.tree_leaves_with_path(jos.mu):
        w = np.asarray(w.astype(jnp.float32), np.float64)
        g = np.asarray(got_m[path], np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-3, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", ["adafactor", "sgd"])
def test_optimizer_updates_match_reference(name):
    """Four updates through both packages' update rules on a factored
    leaf [3, 128, 160], a leaf too narrow to factor, a norm scale (no
    weight decay) and a bias. Each port update starts from the
    reference's state before it (so a rounding difference does not
    compound) and takes the same gradients: the parameters, the second
    moments and SGD's f32 momentum within 1e-6, Adafactor's bf16
    momentum within one bf16 ulp (both plus, where the momentum sum
    cancels, four f32 ulps of the previous momentum)."""
    r = np.random.default_rng(11)
    tree = {"w": r.standard_normal((3, 128, 160)).astype(np.float32),
            "narrow": r.standard_normal((130, 5)).astype(np.float32),
            "norm": {"scale": r.standard_normal(160).astype(np.float32)},
            "layers": [{"b": r.standard_normal(7).astype(np.float32)}]}
    jcfg = JOptim(name=name, lr=1e-2, warmup_steps=2, total_steps=8)
    tcfg = OptimConfig(name=name, lr=1e-2, warmup_steps=2, total_steps=8)
    jp = jax.tree.map(jnp.asarray, tree)
    js = joptim.init_opt_state(jp, jcfg)

    def to_torch(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a.astype(np.float32)))
        return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t

    def leaves(t):
        return dict(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda a: np.asarray(a, np.float32), t)))

    ts0 = optim.init_opt_state(convert.tree_to_torch(tree), tcfg)
    assert optim.tree_map(lambda t: (t.shape, t.dtype), ts0.mu) == \
        optim.tree_map(lambda t: (t.shape, t.dtype),
                       jax.tree.map(to_torch, js.mu))
    for step in range(4):
        grads = jax.tree.map(lambda a: (r.standard_normal(a.shape) * 3.0)
                             .astype(np.float32), tree)
        tp = jax.tree.map(to_torch, jp)
        ts = optim.OptState(torch.tensor(int(js.step), dtype=torch.int32),
                            jax.tree.map(to_torch, js.mu),
                            jax.tree.map(to_torch, js.nu))
        mu_prev = leaves(js.mu)
        jp, js, jm = joptim.update(jp, jax.tree.map(jnp.asarray, grads), js,
                                   jcfg)
        tp, ts, tm = optim.update(tp, convert.tree_to_torch(grads), ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for got, want, what in (
                (tp, jp, "param"),
                (optim.tree_map(lambda m: m.float(), ts.mu), js.mu, "mu"),
                (ts.nu, js.nu, "nu")):
            got = leaves(jax.tree.map(lambda t: t.detach().float().numpy(),
                                      got))
            want = leaves(want)
            assert got.keys() == want.keys()
            for path, w in want.items():
                g, key = got[path], (what, step, jax.tree_util.keystr(path))
                if what == "mu":
                    # where the momentum's f32 sum b m + c u cancels, its
                    # rounding (a few ulps of m) is more than the result's
                    # ulp; the clip scale's global norm sums in another
                    # order
                    base = (_bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
                            if name == "adafactor" else 1e-6 * np.abs(w))
                    bound = base + 2.0 ** -21 * np.abs(mu_prev[path])
                    assert (np.abs(g - w) <= bound).all(), key
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                               err_msg=str(key))
    if name == "adafactor":
        assert set(ts.nu["w"]) == {"r", "c"}
        assert ts.nu["w"]["r"].shape == (3, 128)
        assert ts.nu["w"]["c"].shape == (3, 160)
        assert ts.nu["narrow"].shape == (130, 5)
        assert ts.mu["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_cpu_end_to_end(arch, optimizer):
    res = ttrain.main(["--arch", arch, "--reduced", "--d-model", "64",
                       "--layers", "1", "--steps", "2", "--seq-len", "128",
                       "--global-batch", "2", "--optimizer", optimizer,
                       "--device", "cpu"])
    assert res["optimizer"] == optimizer
    assert res["cfg"].causal == (arch == "moe-transformerxl")
    assert [s["step"] for s in res["steps"]] == [0, 1]
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert res["lstate"].wire_ef is None
