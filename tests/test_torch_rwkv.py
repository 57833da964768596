"""RWKV-6 (rwkv6-3b) in the port against the JAX reference, on the CPU.

Reduced rwkv6-3b (2 layers, d 256, 4 heads of 64), the reference's own
weights carried across by ``repro_torch.convert``, the same numpy inputs.
Tolerances: f32 within 1e-5 for the recurrence and the mixers (the two
frameworks sum the einsum and the products in another order) and 1e-4
for the model's logits; bf16 within 3e-2, the serve gate, for one mixer
(the two frameworks round bf16 products and activations at other
points), and within 5e-2 for the model's logits, the bf16 gate of
``test_torch_archs.py``: through two layers' bf16 residual stream the
logits (|logits| < 5) differ by 7.4e-3 on average and by up to 3.9e-2
(1.25 ulps of a logit in [2, 4), measured over the prefill and the
16-step chain); computing the mixes and activations in f32 with one
rounding, as XLA may fuse them, moves that by less than 1e-3, so the
difference is the products' and sums' own rounding. The port's decode
chain against its own prefill is held to the reference's
``test_ssm_decode_matches_prefill`` tolerance, 5e-3 at f32. The port's
side runs on one torch thread (``test_torch_archs.py``'s fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import ALIASES as JALIASES
from repro.configs import get_config as jget_config
from repro.dist import single_device
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

from repro_torch import checkpoint as tckpt
from repro_torch import convert, train_lib
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import ALIASES, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as kwkv
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model

from test_torch_archs import _one_torch_thread  # noqa: F401

ARCH = "rwkv6-3b"
B, S, GEN = 2, 12, 4
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JLUFFY = JLuffy(enable_condensation=False, enable_migration=False)
LUFFY = LuffyConfig(enable_condensation=False, enable_migration=False)


def _cfgs(cdt="float32"):
    return (dataclasses.replace(jreduced(jget_config(ARCH)),
                                compute_dtype=cdt),
            dataclasses.replace(reduced(get_config(ARCH)),
                                compute_dtype=cdt))


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("steps", [1, 5, 16])
@pytest.mark.parametrize("from_state", [False, True])
def test_wkv6_plain_version_matches_reference_core(steps, from_state):
    """K7's plain version against the reference's ``_rwkv6_core`` (its
    ``lax.scan``) at 4 heads of 64, from the zero state or a random one:
    y and the final state within 1e-5."""
    jcfg, _ = _cfgs()
    r = np.random.default_rng(steps + 10 * from_state)
    Bk, H, hd = 2, 4, 64
    r_, k, v = (r.standard_normal((Bk, steps, H, hd)).astype(np.float32)
                for _ in range(3))
    w = np.exp(-np.exp(r.standard_normal((Bk, steps, H, hd)) - 1.0)
               ).astype(np.float32)
    u = (r.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (r.standard_normal((Bk, H, hd, hd)).astype(np.float32) if from_state
          else np.zeros((Bk, H, hd, hd), np.float32))
    wy, ws = jssm._rwkv6_core({"u_bonus": jnp.asarray(u)}, jcfg, r_, k, v, w,
                              jnp.asarray(s0))
    y, st = ref.wkv6_scan_ref(*(_t(a) for a in (r_, k, v, w, u)),
                              _t(s0) if from_state else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(ws), atol=1e-5,
                               rtol=1e-5)
    # ops dispatches a CPU tensor to the plain version, which returns a
    # new final state and leaves the one it was given as it was
    s_in = _t(s0).clone()
    y2, st2 = ops.wkv6_scan(*(_t(a) for a in (r_, k, v, w, u)), s_in)
    assert torch.equal(st2, st) and torch.equal(y2, y)
    assert torch.equal(s_in, _t(s0))


def _mixer_params(jcfg, tcfg, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jp = {"ssm": jssm.rwkv6_init(k1, jcfg), "ffn": jssm.rwkv_cmix_init(k2,
                                                                       jcfg)}
    # a trained-looking decay and bonus: the init's are constants
    r = np.random.default_rng(seed)
    jp["ssm"]["w_bias"] = jnp.asarray(
        r.uniform(-6.0, -0.5, (jcfg.d_model,)).astype(np.float32))
    jp["ssm"]["mix_w"] = jnp.asarray(
        r.uniform(0.0, 1.0, (jcfg.d_model,)).astype(np.float32))
    tp = convert.tree_to_torch(jax.tree.map(np.asarray, jp))
    return jp, tp


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_time_mix_matches_reference(cdt):
    """``rwkv6_apply`` over a sequence, then ``rwkv6_step`` from a random
    state and token shift: outputs and the new states against the
    reference's, the given state left as it was."""
    jcfg, tcfg = _cfgs(cdt)
    jp, tp = _mixer_params(jcfg, tcfg, seed=1)
    r = np.random.default_rng(2)
    dt = getattr(torch, cdt)
    x = r.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    want = jssm.rwkv6_apply(jp["ssm"], jcfg, jnp.asarray(x).astype(cdt))
    got = tssm.rwkv6_apply(tp["ssm"], tcfg, _t(x, dt))
    assert got.dtype == dt and got.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[cdt], rtol=TOL[cdt])
    H = jcfg.d_model // 64
    st = {"S": r.standard_normal((B, H, 64, 64)).astype(np.float32),
          "x_prev": r.standard_normal((B, 1, jcfg.d_model)).astype(
              np.float32)}
    x1 = x[:, :1]
    wy, wst = jssm.rwkv6_step(jp["ssm"], jcfg, jnp.asarray(x1).astype(cdt),
                              {k: jnp.asarray(v) for k, v in st.items()})
    tst = {k: _t(v).clone() for k, v in st.items()}
    gy, gst = tssm.rwkv6_step(tp["ssm"], tcfg, _t(x1, dt), tst)
    assert torch.equal(tst["S"], _t(st["S"]))
    np.testing.assert_allclose(_np(gy), np.asarray(wy, np.float32),
                               atol=TOL[cdt], rtol=TOL[cdt])
    np.testing.assert_allclose(gst["S"].numpy(), np.asarray(wst["S"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(gst["x_prev"].numpy(),
                                  np.asarray(wst["x_prev"]))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(cdt):
    """``rwkv_cmix_apply`` over a sequence (the zero-padded shift) and at
    one token with the previous token's input."""
    jcfg, tcfg = _cfgs(cdt)
    jp, tp = _mixer_params(jcfg, tcfg, seed=3)
    r = np.random.default_rng(4)
    dt = getattr(torch, cdt)
    x = r.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    xp = r.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    cases = [((x,), None), ((x[:, :1],), xp)]
    for (xi,), prev in cases:
        want = jssm.rwkv_cmix_apply(
            jp["ffn"], jcfg, jnp.asarray(xi).astype(cdt),
            None if prev is None else jnp.asarray(prev))
        got = tssm.rwkv_cmix_apply(tp["ffn"], tcfg, _t(xi, dt),
                                   None if prev is None else _t(prev))
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=TOL[cdt], rtol=TOL[cdt])


_SERVED = {}


def _served(cdt):
    """The reduced model's prefill and a decode chain (the prompt fed a
    token a step, then GEN more) through both frameworks."""
    if cdt in _SERVED:
        return _SERVED[cdt]
    jcfg, tcfg = _cfgs(cdt)
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    dist = single_device()
    toks = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    s_max = S + GEN
    want = {"prefill": np.asarray(jax.jit(lambda p, t: jengine.prefill(
        p, jcfg, JLUFFY, dist, t, s_max)[0])(params, toks[:, :S]))}
    dec = jax.jit(lambda p, c, t: jengine.decode_step(p, jcfg, JLUFFY, dist,
                                                      c, t))
    cache = jengine.cache_struct(jcfg, B, s_max, as_struct=False)
    want["chain"] = []
    for t in range(S + GEN):
        lg, cache = dec(params, cache, toks[:, t:t + 1])
        want["chain"].append(np.asarray(lg))
    np_params = jax.tree.map(np.asarray, params)
    model = build_model(tcfg, device="cpu",
                        params=convert.from_reference(np_params, tcfg))
    lg, kvs = model.prefill(torch.as_tensor(toks[:, :S]), s_max, luffy=LUFFY)
    got = {"prefill": lg.numpy(), "kvs": kvs, "chain": []}
    tcache = model.new_cache(B, s_max)
    for t in range(S + GEN):
        lg, tcache = model.decode_step(tcache, torch.as_tensor(
            toks[:, t:t + 1]), luffy=LUFFY)
        got["chain"].append(lg.numpy())
    _SERVED[cdt] = (want, got, np_params, tcache)
    return _SERVED[cdt]


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_prefill_and_decode_chain_match_reference(cdt):
    want, got, _, tcache = _served(cdt)
    assert got["prefill"].shape == want["prefill"].shape == (B, 1024)
    assert got["kvs"] == [None, None]          # no K/V, no state returned
    np.testing.assert_allclose(got["prefill"], want["prefill"],
                               atol=MODEL_TOL[cdt], rtol=0)
    for t in range(S + GEN):
        np.testing.assert_allclose(got["chain"][t], want["chain"][t],
                                   atol=MODEL_TOL[cdt], rtol=0,
                                   err_msg=f"t={t}")
    layer = tcache["layers"][0]
    assert set(layer) == {"ssm_S", "ssm_xprev", "cmix_xprev"}
    assert layer["ssm_S"].shape == (B, 4, 64, 64)
    assert all(v.dtype == torch.float32 for v in layer.values())


def test_decode_chain_matches_prefill():
    """The port's own consistency at f32: the prompt's last decode step
    (K7's plain version at S = 1 from the carried state, the two token
    shifts) against the batched prefill's last-token logits."""
    _, got, _, _ = _served("float32")
    np.testing.assert_allclose(got["chain"][S - 1], got["prefill"],
                               atol=5e-3, rtol=5e-3)


def test_train_forward_loss_and_grads_match_reference():
    """The f32 train forward's loss within 1e-5 of the reference's, and
    every gradient leaf (autograd through K7's plain version) within
    1e-4 of ``jax.grad``'s by its relative norm error."""
    jcfg, tcfg = _cfgs()
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(5))
    r = np.random.default_rng(5)
    batch = {"tokens": r.integers(1, jcfg.vocab_size, (B, S)).astype(
        np.int32),
        "labels": r.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
        "seq_len": np.full((B,), S, np.int32)}
    batch["labels"][0, :3] = -1

    def f(p):
        return jtf.forward_train(p, jcfg, JLuffy(use_kernels=False),
                                 single_device(),
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jnp.float32(0.5), 8)

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    tparams = convert.from_reference(jax.tree.map(np.asarray, params), tcfg)
    leaves = [t for t in jax.tree_util.tree_leaves(tparams)]
    for t in leaves:
        t.requires_grad_()
    loss, _ = ttf.forward_train(tparams, tcfg, LUFFY,
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()},
                                torch.tensor(0.5), 8)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5,
                               rtol=1e-5)
    loss.backward()
    want = jax.tree_util.tree_leaves(convert.from_reference(
        jax.tree.map(np.asarray, j_grads), tcfg))
    assert len(want) == len(leaves)
    for got, w in zip(leaves, want):
        err = (got.grad - w).norm() / max(w.norm().item(), 1e-12)
        assert err.item() < 1e-4, (tuple(w.shape), err.item())


def test_init_layout_and_round_trips(tmp_path):
    """The port's own init has the reference's tree: keys, shapes and
    dtypes leaf for leaf (``u_bonus`` and ``w_bias`` f32); the
    reference's parameters cross to the port and back unchanged, and
    through the port's checkpoint into the reference's ``restore``."""
    jcfg, tcfg = _cfgs()
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    own = convert.to_reference(build_model(tcfg, device="cpu").params, tcfg)
    ref_leaves = jax.tree_util.tree_leaves_with_path(np_params)
    own_leaves = jax.tree_util.tree_leaves_with_path(own)
    assert [p for p, _ in own_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(own_leaves, ref_leaves):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    layer = build_model(tcfg, device="cpu").params["layers"][1]
    assert set(layer) == {"ssm", "ssm_norm", "ffn_norm", "ffn"}
    assert set(layer["ffn"]) == {"mix_k", "wk", "wv", "wr"}
    assert layer["ssm"]["u_bonus"].shape == (4, 64)
    tparams = convert.from_reference(np_params, tcfg)
    assert len(tparams["layers"]) == tcfg.num_layers
    back = convert.to_reference(tparams, tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    tckpt.save(str(tmp_path), back, step=3)
    got, step = jckpt.restore(str(tmp_path), params)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launcher_batch_step_and_continuous():
    """``launch.serve`` end to end on the CPU: the batched prefill, the
    step-wise feed and greedy decode (the feed's last logits within the
    bf16 serve gate of the batched prefill's), over two virtual ranks as
    over one (no MoE sublayer, so the same run), and a continuous run in
    which every request finishes and slots recycle."""
    base = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen", "3", "--device", "cpu"]
    res = tserve.main(base + ["--prefill", "batch"])
    assert res["tokens"].shape == (2, 3)
    assert np.isfinite(res["prefill_logits"].numpy()).all()
    np.testing.assert_allclose(res["step_logits"][-1].float().numpy(),
                               res["prefill_logits"].numpy(), atol=3e-2)
    m2 = tserve.main(base + ["--prefill", "batch", "--model-axis", "2"])
    assert torch.equal(m2["tokens"], res["tokens"])
    assert torch.equal(m2["prefill_logits"], res["prefill_logits"])
    cont = tserve.main(["--arch", ARCH, "--reduced", "--continuous",
                        "--batch", "2", "--prompt-len", "4", "--gen", "3",
                        "--requests", "5", "--burst", "2",
                        "--arrival-every", "2", "--device", "cpu"])
    assert cont["finished"] == 5 and cont["slot_churn"] >= 3
    assert all(len(t) == 3 for t in cont["requests"].values())


def test_kernel_wrapper_refuses():
    """K7's wrapper takes CUDA tensors only (a CPU one raises, it does not
    fall back), under grad mode too, where a CUDA operand would go
    through the kernel's backward; a head size of 64 and at least one
    step. Its backward's wrapper refuses a CPU tensor the same way. The
    arch trains (``check_trainable`` lets it through)."""
    r = torch.zeros((1, 2, 3, 64))
    u = torch.zeros((3, 64))
    with pytest.raises(ValueError, match="CUDA"):
        kwkv.wkv6_scan(r, r, r, r, u)
    with pytest.raises(ValueError, match="head size"):
        kwkv.wkv6_scan(*(torch.zeros((1, 2, 3, 32)),) * 4,
                       torch.zeros((3, 32)))
    with pytest.raises(ValueError, match="at least one step"):
        kwkv.wkv6_scan(*(torch.zeros((1, 0, 3, 64)),) * 4, u)
    with pytest.raises(TypeError, match="float32"):
        kwkv.wkv6_scan(r.double(), r, r, r, u)
    g = r.clone().requires_grad_()
    with pytest.raises(ValueError, match="CUDA"):
        kwkv.wkv6_scan(g, r, r, r, u)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        kwkv.wkv6_scan(g, r, r, r, u)
    with pytest.raises(ValueError, match="CUDA"):
        kwkv.wkv6_scan_bwd(r, r, r, r, u, None, r)
    train_lib.check_trainable(get_config(ARCH))


_BWD_S = 40    # no multiple of the card's 64-step checkpoint chunk


def _bwd_inputs(from_state, seed):
    r = np.random.default_rng(seed)
    Bk, H, hd = 2, 4, 64
    r_, k, v, dy = (r.standard_normal((Bk, _BWD_S, H, hd)).astype(np.float32)
                    for _ in range(4))
    w = np.exp(-np.exp(r.standard_normal((Bk, _BWD_S, H, hd)) - 1.0)
               ).astype(np.float32)
    u = (r.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (r.standard_normal((Bk, H, hd, hd)).astype(np.float32)
          if from_state else np.zeros((Bk, H, hd, hd), np.float32))
    ds = r.standard_normal((Bk, H, hd, hd)).astype(np.float32)
    return r_, k, v, w, u, s0, dy, ds


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("from_state", [False, True])
def test_wkv6_plain_backward_matches_autograd_and_jax_grad(from_state):
    """K7's plain backward (``ref.wkv6_scan_bwd_ref``, the reverse-time
    recurrence the card's kernel computes) at S = 40 from the zero state
    or a random one, with cotangents on y and on the final state: dr, dk,
    dv, dw, du and dS0 each within 1e-5 relative norm error of autograd
    through the plain forward and of ``jax.grad`` of the reference's
    ``_rwkv6_core``."""
    jcfg, _ = _cfgs()
    r_, k, v, w, u, s0, dy, ds = _bwd_inputs(from_state, 40 + from_state)
    got = ref.wkv6_scan_bwd_ref(*(_t(a) for a in (r_, k, v, w, u)),
                                _t(s0) if from_state else None, _t(dy),
                                _t(ds))

    def f(r_, k, v, w, u, s0):
        y, st = jssm._rwkv6_core({"u_bonus": u}, jcfg, r_, k, v, w, s0)
        return jnp.sum(y * dy) + jnp.sum(st * ds)

    want = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in (r_, k, v, w, u, s0)))
    ins = [_t(a).requires_grad_() for a in (r_, k, v, w, u, s0)]
    y, st = ref.wkv6_scan_ref(*ins)
    ((y * _t(dy)).sum() + (st * _t(ds)).sum()).backward()
    for name, g, a, j in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got,
                             ins, want):
        assert g.shape == a.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), a.grad.numpy()) < 1e-5, name
        assert _rel(g.numpy(), j) < 1e-5, name


def test_supports_long_decode_matches_reference():
    """Every registered arch, full and reduced, answers the reference's
    rule; rwkv6-3b is the attention-free arch that may run long_500k."""
    assert set(ALIASES) == set(JALIASES)
    for arch in ALIASES:
        for t, j in ((get_config(arch), jget_config(arch)),
                     (reduced(get_config(arch)),
                      jreduced(jget_config(arch)))):
            assert t.supports_long_decode == j.supports_long_decode, arch
    assert get_config(ARCH).supports_long_decode
    assert get_config(ARCH).attn is None
