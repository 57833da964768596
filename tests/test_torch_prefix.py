"""internvl2-2b in the port against the JAX reference, on the CPU, at its
reduced size (2 layers, d 256, a prefix of 8 slots of width 256), f32
compute: the prefix projected by ``prefix_proj`` and put before the
prompt's embeddings, the prefill over prefix and prompt (positions
0..P+S-1), then greedy decoding from the cache the prefill's K/V fill,
against the reference's ``prefill(prefix=)`` and ``decode_step``:
logits within 1e-4 and greedy tokens equal. The launcher's text path (no
prefix, as the reference's launcher serves it). ``prefix_proj`` and the
shared expert's leaves (llama4-maverick's, bf16) through the converter
and the checkpoints, both ways, bit for bit. The launcher trains
internvl2 with a prefix batch. The port's side runs on one torch thread (see
``test_torch_archs.py``).
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
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

from repro_torch import checkpoint as tckpt
from repro_torch import convert, train_lib
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model
from tests.test_torch_archs import _bits, _one_torch_thread

ARCH = "internvl2-2b"
B, S, GEN = 2, 12, 4

assert _one_torch_thread   # the module fixture, applied here too


def _cfgs(arch=ARCH):
    """The reference's reduced config and the port's, f32 compute; a
    layer pattern longer than 2 (llama4's) cut to its first and last
    layer."""
    out = []
    for red, get in ((jreduced, jget_config), (reduced, get_config)):
        cfg = red(get(arch))
        wp = cfg.attn.window_pattern
        if cfg.num_layers > 2:
            cfg = dataclasses.replace(cfg, num_layers=2, attn=dataclasses.
                                      replace(cfg.attn,
                                              window_pattern=(wp[0], wp[-1])))
        out.append(dataclasses.replace(cfg, compute_dtype="float32"))
    return out


def _inputs(jcfg):
    r = np.random.default_rng(3)
    prompts = r.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    prefix = r.standard_normal(
        (B, jcfg.prefix_slots, jcfg.prefix_dim)).astype(np.float32)
    return prompts, prefix


def _jax_serve(jcfg, params, prompts, prefix):
    jl = JLuffy(enable_condensation=False, enable_migration=False)
    dist = single_device()
    n = jcfg.prefix_slots + S
    s_max = n + GEN
    logits, kvs = jax.jit(lambda p, t, x: jengine.prefill(
        p, jcfg, jl, dist, t, s_max, prefix=x))(params, prompts, prefix)
    first = np.asarray(logits)
    # its decode cache from the prefill's K/V (one period of one global
    # layer, stacked over the layer groups), as the port's is built
    cache = jengine.cache_struct(jcfg, B, s_max, as_struct=False)
    (k, v), _ = kvs[0]
    g = cache["groups"][0]
    g["k"] = g["k"].at[:, :, :n].set(k)
    g["v"] = g["v"].at[:, :, :n].set(v)
    g["cpos"] = g["cpos"].at[:, :, :n].set(jnp.arange(n, dtype=jnp.int32))
    cache["pos"] = jnp.int32(n)
    dec = jax.jit(lambda p, c, t: jengine.decode_step(p, jcfg, jl, dist, c,
                                                      t))
    toks, gen = [], []
    for _ in range(GEN):
        nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        toks.append(nxt[:, 0])
        logits, cache = dec(params, cache, nxt)
        gen.append(np.asarray(logits))
    return {"prefill": first, "tokens": np.stack(toks, 1), "gen": gen}


def _cache_from_prefill(model, kvs, n: int, s_max: int):
    """A decode cache holding the prefill's ``n`` positions, from its
    per-layer K/V (every layer of internvl2 is global: a full buffer)."""
    cache = model.new_cache(B, s_max)
    for g, (k, v) in zip(cache["layers"], kvs):
        g["k"][:, :n] = k
        g["v"][:, :n] = v
        g["cpos"][:, :n] = torch.arange(n, dtype=torch.int32)
    cache["pos"] = n
    return cache


def _torch_serve(tcfg, np_params, prompts, prefix, ref_tokens):
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    model = build_model(tcfg, device="cpu",
                        params=convert.from_reference(np_params, tcfg))
    n = tcfg.prefix_slots + S
    s_max = n + GEN
    logits, kvs = model.prefill(torch.as_tensor(prompts), s_max, luffy=luffy,
                                prefix=torch.as_tensor(prefix))
    assert all(k.shape[1] == n for k, _ in kvs)
    out = {"prefill": logits.numpy()}
    cache = _cache_from_prefill(model, kvs, n, s_max)
    toks, gen = [], []
    for i in range(GEN):
        toks.append(torch.argmax(logits, -1).numpy())
        # fed the reference's token, so later steps compare like with like
        logits, cache = model.decode_step(
            cache, torch.as_tensor(ref_tokens[:, i:i + 1]), luffy=luffy)
        gen.append(logits.numpy())
    out["tokens"], out["gen"] = np.stack(toks, 1), gen
    return out


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = _cfgs()
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    prompts, prefix = _inputs(jcfg)
    ref = _jax_serve(jcfg, params, prompts, prefix)
    return ref, _torch_serve(tcfg, jax.tree.map(np.asarray, params), prompts,
                             prefix, ref["tokens"])


def test_reduced_config_and_params():
    _, tcfg = _cfgs()
    assert (tcfg.prefix_slots, tcfg.prefix_dim) == (8, 256)
    assert not tcfg.uses_moe and tcfg.num_layers == 2
    p = build_model(tcfg, device="cpu").params
    assert p["prefix_proj"]["w"].shape == (256, tcfg.d_model)
    full = get_config(ARCH)
    assert (full.prefix_slots, full.prefix_dim) == (256, 1024)


def test_prefix_prefill_logits(served):
    ref, got = served
    assert got["prefill"].shape == ref["prefill"].shape
    np.testing.assert_allclose(got["prefill"], ref["prefill"], atol=1e-4,
                               rtol=0)


def test_decode_after_the_prefix(served):
    ref, got = served
    for i in range(GEN):
        np.testing.assert_allclose(got["gen"][i], ref["gen"][i], atol=1e-4,
                                   rtol=0, err_msg=f"gen {i}")
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_the_prefix_changes_the_logits(served):
    """The prefix is read: the prompt alone gives other logits."""
    _, got = served
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray,
                          jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    model = build_model(tcfg, device="cpu",
                        params=convert.from_reference(params, tcfg))
    prompts, _ = _inputs(jcfg)
    alone = model.prefill(torch.as_tensor(prompts), S, luffy=LuffyConfig(
        enable_condensation=False, enable_migration=False))[0].numpy()
    assert np.abs(alone - got["prefill"]).max() > 1e-2


def test_launcher_text_path():
    res = tserve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                       "--prompt-len", "16", "--gen", "2", "--prefill",
                       "batch", "--device", "cpu"])
    assert torch.isfinite(res["prefill_logits"]).all()
    assert res["tokens"].shape == (2, 2)


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_convert_and_checkpoint_round_trip(arch, tmp_path):
    """``prefix_proj/w`` (internvl2, f32) and ``moe/shared/*`` (llama4,
    bf16): the reference's tree into the port and back, bit for bit; the
    reference's checkpoint restored by the port, and the port's saved
    as the reference's files are."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.tree.map(np.asarray,
                          jbuild_model(jcfg).init(jax.random.PRNGKey(5)))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    key = "prefix_proj" if arch == ARCH else "shared"
    assert any(key in n for n in names)
    tparams = convert.from_reference(params, tcfg)
    back = convert.to_reference(tparams, tcfg)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(_bits(got[path]), _bits(w),
                                      err_msg=jax.tree_util.keystr(path))
    jckpt.save(str(tmp_path / "ref"), params, step=3, shard_mb=1)
    like = convert.to_reference(build_model(tcfg, device="cpu").params, tcfg)
    restored, step = tckpt.restore(str(tmp_path / "ref"), like)
    assert step == 3
    for a, (path, w) in zip(jax.tree_util.tree_leaves(restored), want):
        np.testing.assert_array_equal(_bits(a), _bits(w),
                                      err_msg=jax.tree_util.keystr(path))
    tckpt.save(str(tmp_path / "port"), back, step=3, shard_mb=1)
    specs = [json.loads((tmp_path / d / "spec.json").read_text())
             for d in ("port", "ref")]
    assert specs[0] == specs[1]


def test_internvl2_does_not_train_yet():
    """Training internvl2, which raised until its slice (the name is kept
    from then), now runs: ``check_trainable`` lets it through and the
    launcher takes two AdamW steps on the CPU over batches whose prefix
    of 8 random patch embeddings comes before 120 tokens, with finite
    losses and no MoE field in its records (``test_torch_dense_train.py``
    holds the losses to the reference's launcher)."""
    from repro_torch.launch import train as ttrain
    train_lib.check_trainable(get_config(ARCH))
    res = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq-len", "128", "--global-batch", "2", "--device",
                       "cpu"])
    assert res["cfg"].prefix_slots == 8
    assert [s["step"] for s in res["steps"]] == [0, 1]
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert all("capacity" not in s for s in res["steps"])
