"""The encoder-decoder seamless-m4t-large-v2 in the port against the JAX
reference, on the CPU, at its reduced size (2 encoder + 2 decoder
layers, d 256, 4 heads of 64, LayerNorm, GELU, prefix_dim 256): the
reference's own weights carried across by ``repro_torch.convert``, the
same numpy prompts and encoder frames.

Held at f32 compute within 1e-5: the encoder (``run_encoder`` against
``_run_encoder``), cross-attention (``attn_apply(kv=)`` at Sq != Sk, and
over 2048 keys through ``attend_chunked``), the prefill
(``prefill(enc_input=)``: logits and each layer's self and cross K/V),
a few decode steps from a cache whose ``ck`` / ``cv`` are the
prefill's against the reference's ``decode_step`` on its
``cache_struct(enc_len=)`` filled the same way, and the train forward's
loss (``forward_train`` with ``enc_input``). At the config's own bf16
compute the prefill's logits are held to the serve gate of 3e-2, and
the decode steps' (from the same cache bits) to ``test_torch_archs``'s
bf16 gate of 5e-2: there a decode step from identical inputs differs
by 0.03125 at one logit of 2048, every sublayer bit for bit but the
FFN's GELU, which the reference rounds to bf16 after each op and
``F.gelu`` once (one bf16 ulp on 40% of its entries). Each greedy token
of the port is one the reference's logits rank first within that gate
(bf16 logits tie exactly: the reference's first prefill row has two
maxima at 3.03125, which the port's rounding puts one ulp apart either
way). K5's plain version at Sq != Sk
against the reference's ``attend`` with an all-true mask (f32, 1e-5).
The converter round trip of the encoder subtree and a checkpoint each
package restores from the other, bit for bit. The launcher on the CPU.
The reference's own launcher cannot serve this arch (its prefill passes
no ``enc_input``), so parity is held at the engine's entry points. The
port's side runs on one torch thread (see ``test_torch_archs.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.dist import single_device
from repro.models import blocks as jbk
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

from repro_torch import checkpoint as tckpt
from repro_torch import convert, train_lib
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tbk
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import engine as tengine
from tests.test_torch_archs import TOL as ARCHS_TOL
from tests.test_torch_archs import _bits, _one_torch_thread

ARCH = "seamless-m4t-large-v2"
B, S, S_ENC, GEN = 2, 12, 20, 3
F32_TOL, BF16_TOL = 1e-5, 3e-2
BF16_DECODE_TOL = ARCHS_TOL["bfloat16"]

assert _one_torch_thread   # the module fixture, applied here too


def _cfgs(compute_dtype="float32"):
    return [dataclasses.replace(red(get(ARCH)), compute_dtype=compute_dtype)
            for red, get in ((jreduced, jget_config), (reduced, get_config))]


def _params(jcfg, seed=0):
    return jbuild_model(jcfg).init(jax.random.PRNGKey(seed))


def _inputs(jcfg, seed=7):
    r = np.random.default_rng(seed)
    prompts = r.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    enc = r.standard_normal((B, S_ENC, jcfg.prefix_dim)).astype(np.float32)
    return prompts, enc


def _luffy():
    return (JLuffy(enable_condensation=False, enable_migration=False),
            LuffyConfig(enable_condensation=False, enable_migration=False))


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


def _serve_both(cdt):
    """The reference's prefill and GEN decode steps from the cache its
    prefill fills, and the port's, fed the reference's greedy tokens,
    from the cache the port's prefill fills; at bf16 the port's cache
    holds the reference's prefill K/V bits instead, so that the decode
    step itself is held (the two prefills' bf16 K/V already differ by
    their rounding)."""
    jcfg, tcfg = _cfgs(cdt)
    params = _params(jcfg)
    np_params = jax.tree.map(np.asarray, params)
    prompts, enc = _inputs(jcfg)
    jl, tl = _luffy()
    s_max = S + GEN
    lg, kvs = jengine.prefill(params, jcfg, jl, single_device(), prompts,
                              s_max, enc_input=enc)
    (k, v), (ck, cv) = kvs[0]          # one period: stacked over layers
    ref_kvs = [tuple(tuple(convert.numpy_to_tensor(np.asarray(t[i]), "cpu")
                           for t in pair) for pair in ((k, v), (ck, cv)))
               for i in range(jcfg.num_layers)]
    cache = jengine.cache_struct(jcfg, B, s_max, enc_len=S_ENC,
                                 as_struct=False)
    g = cache["groups"][0]
    g["k"] = g["k"].at[:, :, :S].set(k)
    g["v"] = g["v"].at[:, :, :S].set(v)
    g["cpos"] = g["cpos"].at[:, :, :S].set(jnp.arange(S, dtype=jnp.int32))
    g["ck"], g["cv"] = ck, cv
    cache["pos"] = jnp.int32(S)
    ref = {"prefill": _np(lg), "k": _np(k), "v": _np(v), "ck": _np(ck),
           "cv": _np(cv), "gen": [], "tokens": []}
    logits = lg
    for _ in range(GEN):
        nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        ref["tokens"].append(nxt[:, 0])
        logits, cache = jengine.decode_step(params, jcfg, jl,
                                            single_device(), cache, nxt)
        ref["gen"].append(_np(logits))
    ref["tokens"] = np.stack(ref["tokens"], 1)

    model = build_model(tcfg, device="cpu",
                        params=convert.from_reference(np_params, tcfg))
    tlg, tkvs = model.prefill(torch.as_tensor(prompts), s_max, luffy=tl,
                              enc_input=torch.as_tensor(enc))
    got = {"prefill": _np(tlg), "kvs": tkvs, "gen": [], "tokens": []}
    tc = model.new_cache(B, s_max, enc_len=S_ENC)
    fill = tkvs if cdt == "float32" else ref_kvs
    for gg, ((tk, tv), _) in zip(tc["layers"], fill):
        gg["k"][:, :S] = tk
        gg["v"][:, :S] = tv
        gg["cpos"][:, :S] = torch.arange(S, dtype=torch.int32)
    tengine.write_cross_kv(tc, [ckv for _, ckv in fill])
    tc["pos"] = S
    logits = tlg
    for i in range(GEN):
        got["tokens"].append(torch.argmax(logits, -1).numpy())
        logits, tc = model.decode_step(
            tc, torch.as_tensor(ref["tokens"][:, i:i + 1]), luffy=tl)
        got["gen"].append(_np(logits))
    got["tokens"] = np.stack(got["tokens"], 1)
    return ref, got


_SERVED = {}


def _served(cdt):
    if cdt not in _SERVED:
        _SERVED[cdt] = _serve_both(cdt)
    return _SERVED[cdt]


def test_config_registered_and_reduced():
    from repro_torch.config import SSMConfig
    from repro_torch.configs import NOT_PORTED
    # every arch of the reference is registered, rwkv6-3b last; an
    # encoder-decoder with an SSM (no config has one) still raises
    assert NOT_PORTED == () and get_config("rwkv6-3b").attn is None
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(dataclasses.replace(_cfgs()[1], ssm=SSMConfig()),
                    device="cpu")
    full = get_config(ARCH)
    assert (full.kind, full.num_layers, full.num_encoder_layers) == \
        ("encdec", 24, 24)
    assert (full.d_model, full.d_ff, full.vocab_size) == (1024, 8192, 256206)
    assert not full.attn.use_rope and full.attn.head_dim == 64
    _, tcfg = _cfgs()
    assert (tcfg.num_layers, tcfg.num_encoder_layers, tcfg.prefix_dim) == \
        (2, 2, 256)
    p = build_model(tcfg, device="cpu").params
    assert len(p["encoder"]["layers"]) == 2
    assert set(p["layers"][0]) == {"attn_norm", "attn", "cross_norm",
                                   "cross_attn", "ffn_norm", "ffn"}
    assert "cross_attn" not in p["encoder"]["layers"][0]


def test_convert_encoder_round_trip_bitwise():
    """The reference's tree, encoder subtree included, into the port (one
    dict per encoder layer) and back, bit for bit."""
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, _params(jcfg, seed=5))
    tparams = convert.from_reference(params, tcfg)
    assert isinstance(tparams["encoder"]["layers"], list)
    w = params["encoder"]["layers"][0]["attn"]["wq"]
    np.testing.assert_array_equal(
        tparams["encoder"]["layers"][1]["attn"]["wq"].numpy(), w[1])
    back = convert.to_reference(tparams, tcfg)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    assert any("encoder" in jax.tree_util.keystr(p) for p, _ in want)
    for path, a in want:
        np.testing.assert_array_equal(got[path], a,
                                      err_msg=jax.tree_util.keystr(path))


def test_run_encoder_matches_reference():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    _, enc = _inputs(jcfg)
    enc_x = np.asarray(enc @ np.asarray(params["prefix_proj"]["w"]))
    want = jtf._run_encoder(params["encoder"], jcfg, _luffy()[0],
                            single_device(), jnp.asarray(enc_x))
    tparams = convert.from_reference(jax.tree.map(np.asarray, params), tcfg)
    got = ttf.run_encoder(tparams["encoder"], tcfg, torch.as_tensor(enc_x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    # ... and through encode(): the projection's rounding point too
    out, pos = ttf.encode(tparams, tcfg, torch.as_tensor(enc))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    assert pos.shape == (B, S_ENC) and int(pos[0, -1]) == S_ENC - 1


@pytest.mark.parametrize("sq,sk", [(S, S_ENC), (100, 3072)])
def test_cross_attn_apply_matches_reference(sq, sk):
    """Queries from the decoder, keys and values from the encoder output:
    Sq != Sk, every key live; at 3072 keys both packages stream through
    ``attend_chunked``. Output and the returned (k, v) within 1e-5."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    p = jax.tree.map(np.asarray, params["layers"][0]["cross_attn"])
    p = {k: v[0] for k, v in p.items()}
    r = np.random.default_rng(sq + sk)
    bq = 1 if sk > 2048 else B
    x = r.standard_normal((bq, sq, jcfg.d_model)).astype(np.float32)
    src = r.standard_normal((bq, sk, jcfg.d_model)).astype(np.float32)
    qpos = np.tile(np.arange(sq, dtype=np.int32), (bq, 1))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (bq, 1))
    want, (wk, wv) = jbk.attn_apply(p, jcfg, x, qpos, layer=0,
                                    kv=(src, kpos), causal=False)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    got, (gk, gv) = tbk.attn_apply(
        tp, tcfg, torch.as_tensor(x), torch.as_tensor(qpos), layer=0,
        kv=(torch.as_tensor(src), torch.as_tensor(kpos)), causal=True)
    assert got.shape == (bq, sq, jcfg.d_model) and gk.shape[1] == sk
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=F32_TOL,
                               rtol=0)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_flash_plain_version_at_sq_ne_sk(H, KV):
    """K5's plain version, non-causal at Sq != Sk (GQA too), against the
    reference's ``attend`` with an all-true mask; a causal or windowed
    call at Sq != Sk is refused."""
    r = np.random.default_rng(H)
    q = r.standard_normal((2, 37, H, 64)).astype(np.float32)
    k = r.standard_normal((2, 90, KV, 64)).astype(np.float32)
    v = r.standard_normal((2, 90, KV, 64)).astype(np.float32)
    mask = np.ones((2, 37, 90), bool)
    want = jbk.attend(q, k, v, mask, 0.125)
    got = tref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    for kw in ({"causal": True}, {"causal": False, "window": 8}):
        with pytest.raises(ValueError, match="Sq == Sk"):
            tref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                     torch.as_tensor(v), **kw)


def test_prefill_logits_and_caches_f32():
    ref, got = _served("float32")
    np.testing.assert_allclose(got["prefill"], ref["prefill"], atol=F32_TOL,
                               rtol=0)
    assert len(got["kvs"]) == 2
    for i, ((k, v), (ck, cv)) in enumerate(got["kvs"]):
        assert ck.shape == (B, S_ENC, 4, 64) and k.shape == (B, S, 4, 64)
        for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
            np.testing.assert_allclose(_np(t), ref[name][i], atol=F32_TOL,
                                       rtol=0, err_msg=f"layer {i} {name}")


def test_decode_steps_from_cross_cache_f32():
    ref, got = _served("float32")
    for i in range(GEN):
        np.testing.assert_allclose(got["gen"][i], ref["gen"][i],
                                   atol=F32_TOL, rtol=0, err_msg=f"gen {i}")
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_prefill_and_decode_bf16_serve_gate():
    """The config's bf16 compute: prefill logits within 3e-2, the decode
    steps from the reference's prefill K/V (``_serve_both``) within the
    archs' bf16 gate (the module docstring says why)."""
    ref, got = _served("bfloat16")
    np.testing.assert_allclose(got["prefill"], ref["prefill"], atol=BF16_TOL,
                               rtol=0)
    for i in range(GEN):
        np.testing.assert_allclose(got["gen"][i], ref["gen"][i],
                                   atol=BF16_DECODE_TOL, rtol=0,
                                   err_msg=f"gen {i}")
    for i, lg in enumerate([ref["prefill"]] + ref["gen"][:-1]):
        picked = np.take_along_axis(lg, got["tokens"][:, i:i + 1], 1)[:, 0]
        assert (picked >= lg.max(-1) - BF16_TOL).all(), (i, picked)


def test_cache_struct_and_admit_slot():
    """``ck`` / ``cv`` per layer in the compute dtype ([B, 0, ...] at the
    default enc_len, the reference's empty memory, which decodes to a
    zero cross term, as the reference's does); ``admit_slot`` leaves them
    as they are."""
    _, tcfg = _cfgs("bfloat16")
    jcfg, _ = _cfgs("bfloat16")
    c = tengine.cache_struct(tcfg, B, 8, device="cpu", enc_len=S_ENC)
    jc = jengine.cache_struct(jcfg, B, 8, enc_len=S_ENC, as_struct=False)
    assert c["layers"][0]["ck"].shape == jc["groups"][0]["ck"].shape[1:]
    assert c["layers"][0]["cv"].dtype == torch.bfloat16
    c["layers"][1]["ck"].fill_(1.5)
    tengine.admit_slot(c, 1, 3)
    assert bool((c["layers"][1]["ck"] == 1.5).all())
    assert tengine.cache_struct(tcfg, B, 8, device="cpu")["layers"][0][
        "ck"].shape == (B, 0, 4, 64)
    x = torch.randn(B, 1, tcfg.d_model)
    p = {k: torch.randn(tcfg.d_model, tcfg.d_model) for k in
         ("wq", "wk", "wv", "wo")}
    empty = torch.zeros((B, 0, 4, 64))
    assert bool((tengine.cross_attn_decode(
        p, dataclasses.replace(tcfg, compute_dtype="float32"), x, empty,
        empty) == 0).all())


def test_train_forward_loss_matches_reference():
    """The train forward with the encoder and each layer's cross
    sublayer (the full-sequence layer) against the reference's
    ``forward_train``, f32: the loss within 1e-5. The arch trains
    (``check_trainable`` lets it through), and the loss's backward
    reaches every leaf: the encoder's, the cross sublayers' and
    ``prefix_proj`` (``test_torch_dense_train.py`` holds the gradients
    to ``jax.grad``)."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    prompts, _ = _inputs(jcfg)
    r = np.random.default_rng(11)
    enc = r.standard_normal((B, S, jcfg.prefix_dim)).astype(np.float32)
    labels = r.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": prompts, "labels": labels,
             "seq_len": np.full((B,), S, np.int32), "enc_input": enc}
    jl, tl = _luffy()
    want, _ = jtf.forward_train(params, jcfg, jl, single_device(), batch,
                                jnp.float32(0.5), 0)
    tparams = convert.from_reference(jax.tree.map(np.asarray, params), tcfg)
    got, metrics = ttf.forward_train(
        tparams, tcfg, tl, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.tensor(0.5), 0)
    np.testing.assert_allclose(got.item(), float(want), atol=F32_TOL, rtol=0)
    train_lib.check_trainable(get_config(ARCH))
    leaves = [t for t in jax.tree_util.tree_leaves(tparams)]
    for t in leaves:
        t.requires_grad_()
    loss, _ = ttf.forward_train(
        tparams, tcfg, tl, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.tensor(0.5), 0)
    loss.backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
    assert tparams["prefix_proj"]["w"].grad.abs().max() > 0


def test_launcher_on_cpu():
    """The launcher's encoder-decoder path: a batched prefill, then the
    prompt fed against the cross K/V and greedy tokens; ``--prefill step``
    takes the same cross K/V (one untimed prefill) and decodes the same
    tokens. ``--continuous`` and ``--model-axis 2`` raise, naming their
    item."""
    args = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "16", "--gen", "3", "--device", "cpu"]
    res = tserve.main(args + ["--prefill", "batch"])
    assert torch.isfinite(res["prefill_logits"]).all()
    assert res["tokens"].shape == (2, 3)
    step = tserve.main(args + ["--prefill", "step"])
    assert torch.equal(step["tokens"], res["tokens"])
    torch.testing.assert_close(step["gen_logits"][-1], res["gen_logits"][-1],
                               atol=0, rtol=0)
    for extra in (["--continuous"], ["--model-axis", "2"]):
        with pytest.raises(NotImplementedError, match="item 8.8"):
            tserve.main(args + extra)


def test_checkpoint_each_package_restores_the_other(tmp_path):
    """An encoder-decoder tree in the reference's npz + ``spec.json``
    format: the reference's checkpoint restored by the port and the
    port's by the reference, bit for bit, and the same spec."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=9)
    want = jax.tree_util.tree_leaves_with_path(params)
    jckpt.save(str(tmp_path / "ref"), params, step=4, shard_mb=1)
    like = convert.to_reference(build_model(tcfg, device="cpu").params, tcfg)
    restored, step = tckpt.restore(str(tmp_path / "ref"), like)
    assert step == 4
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(want)
    for a, (path, w) in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(w)),
                                      err_msg=jax.tree_util.keystr(path))
    tparams = convert.from_reference(jax.tree.map(np.asarray, params), tcfg)
    tckpt.save(str(tmp_path / "port"), convert.to_reference(tparams, tcfg),
               step=4, shard_mb=1)
    back, step = jckpt.restore(str(tmp_path / "port"), params)
    assert step == 4
    for a, (path, w) in zip(jax.tree_util.tree_leaves(back), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))
    specs = [json.loads((tmp_path / d / "spec.json").read_text())
             for d in ("port", "ref")]
    assert specs[0] == specs[1]
