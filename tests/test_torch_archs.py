"""The attention decoders of ROADMAP item 8.1 (olmoe-1b-7b, yi-34b,
stablelm-12b, starcoder2-15b, gemma3-12b) in the port against the JAX
reference, on the CPU, at their reduced sizes: the reference's own
weights (bf16 parameters for the four dense archs) carried across by
``repro_torch.convert``, the same numpy prompts.

Serving (reduced at a sequence hint of 32, so every window is 16): the
batched prefill and a step-wise feed of a prompt of 24 tokens, past
every window (the rings wrap), then 4 greedy tokens, against the
reference's serve engine (olmoe's with its einsum expert FFN).
f32 compute: logits within 1e-4 and greedy tokens equal. Also stablelm
at head_dim 160 and gemma3 at 256 (q_dim != d_model), two layers each
(gemma3's a local and a global one), at f32 and at the configs' own
bf16 compute: prefill logits within 5e-2 with the same greedy token
(logits up to ~4, whose bf16 ulp is 3.1e-2: the two frameworks round
bf16 products at other points and sum them in another order; measured
3.5e-2 stablelm (LayerNorm), 1.2e-2 gemma3). And gemma3's prefill at a
prompt of 3072 on one local and one global layer, where both packages
attend through their streaming path.
olmoe's LUFFY train step with condensation against ``jax.grad`` of the
reference's ``use_kernels=False`` path (its ``pairwise_cosine`` patched
to K2's formula in this process only, as ``test_torch_train.py`` does):
rep maps equal, loss within 1e-5, every gradient leaf within 1e-3
relative. bf16 leaves cross the converter and the checkpoints bit for
bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.condense.backends as jbackends
import repro.condense.plan as jplan
from repro import checkpoint as jckpt
from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.config import ShapeConfig as JShape
from repro.dist import single_device
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

import repro_torch.condense.plan as tplan
from repro_torch import checkpoint as tckpt
from repro_torch import convert, optim
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core.moe_layer import capacity_for
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model

ARCHS = ("olmoe-1b-7b", "yi-34b", "stablelm-12b", "starcoder2-15b",
         "gemma3-12b")
# (name, arch, head_dim override); a head-dim variant keeps two layers
# (gemma3's: one local, one global)
VARIANTS = [(a, a, None) for a in ARCHS] + [
    ("stablelm-12b@hd160", "stablelm-12b", 160),
    ("gemma3-12b@hd256", "gemma3-12b", 256)]
HD_VARIANTS = [v[0] for v in VARIANTS if v[2] is not None]
B, S, GEN = 2, 24, 4
SEQ_HINT = 32        # reduced windows of 16
LONG_S = 3072
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one thread: the suite runs in several processes
    at once, and torch's thread pool spread over every core in each slows
    these small ops twentyfold (a reduced gemma3's serve, 2.1 s on one
    thread against 56.0 s on eight, with seven other processes busy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, head_dim=None, compute_dtype="float32"):
    """The reference's reduced config and the port's; with ``head_dim``,
    that head width at two layers (the first and the last of the
    period, so gemma3 keeps a local and a global layer)."""
    out = []
    for cfg in (jreduced(jget_config(arch), seq_len_hint=SEQ_HINT),
                reduced(get_config(arch), seq_len_hint=SEQ_HINT)):
        if head_dim is not None:
            wp = cfg.attn.window_pattern
            cfg = dataclasses.replace(cfg, num_layers=2, attn=dataclasses.
                                      replace(cfg.attn, head_dim=head_dim,
                                              window_pattern=(wp[0], wp[-1])))
        out.append(dataclasses.replace(cfg, compute_dtype=compute_dtype))
    return out


def _variant_cfgs(name, compute_dtype="float32"):
    _, arch, hd = next(v for v in VARIANTS if v[0] == name)
    return _cfgs(arch, hd, compute_dtype)


def _serve_luffy(jcfg=None):
    """The reference's serve config and the port's. olmoe's reference runs
    its einsum expert FFN: its Pallas one, interpreted, computes the same
    f32 function here (``tests/test_torch_serve.py`` holds it at
    moe-gpt2's width) and took three times this file's olmoe time."""
    olmoe = jcfg is not None and jcfg.name.startswith("olmoe-1b-7b")
    return (JLuffy(use_kernels=not olmoe,
                   enable_condensation=False, enable_migration=False),
            LuffyConfig(enable_condensation=False, enable_migration=False))


def _params(jcfg, seed=0):
    return jbuild_model(jcfg).init(jax.random.PRNGKey(seed))


def _jax_serve(jcfg, params, prompts):
    jl, _ = _serve_luffy(jcfg)
    B = prompts.shape[0]
    dist = single_device()
    s_max = S + GEN
    pf = jax.jit(lambda p, t: jengine.prefill(p, jcfg, jl, dist, t,
                                              s_max)[0])
    dec = jax.jit(lambda p, c, t: jengine.decode_step(p, jcfg, jl, dist, c,
                                                      t))
    cache = jengine.cache_struct(jcfg, B, s_max, as_struct=False)
    for t in range(S):
        logits, cache = dec(params, cache, prompts[:, t:t + 1])
    step_last = np.asarray(logits)
    toks, gen = [], []
    for _ in range(GEN):
        nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        toks.append(nxt[:, 0])
        logits, cache = dec(params, cache, nxt)
        gen.append(np.asarray(logits))
    return {"prefill": np.asarray(pf(params, prompts)),
            "step_last": step_last, "tokens": np.stack(toks, 1),
            "gen": gen}


def _torch_serve(tcfg, np_params, prompts, ref_tokens):
    _, luffy = _serve_luffy()
    model = build_model(tcfg, device="cpu",
                        params=convert.from_reference(np_params, tcfg))
    tp = torch.as_tensor(prompts)
    B = prompts.shape[0]
    s_max = S + GEN
    out = {"prefill": model.prefill(tp, s_max, luffy=luffy)[0].numpy()}
    cache = model.new_cache(B, s_max)
    for t in range(S):
        logits, cache = model.decode_step(cache, tp[:, t:t + 1], luffy=luffy)
    out["step_last"] = logits.numpy()
    toks, gen = [], []
    for i in range(GEN):
        toks.append(torch.argmax(logits, -1).numpy())
        # fed the reference's token, so later steps compare like with like
        logits, cache = model.decode_step(
            cache, torch.as_tensor(ref_tokens[:, i:i + 1]), luffy=luffy)
        gen.append(logits.numpy())
    out["tokens"], out["gen"] = np.stack(toks, 1), gen
    return out


def _prefill_pair(jcfg, tcfg, params, prompts):
    """The batched prefill's last-token logits of the reference and of the
    port (the reference's weights), as numpy."""
    jl, luffy = _serve_luffy(jcfg)
    S_ = prompts.shape[1]
    want = np.asarray(jax.jit(lambda p, t: jengine.prefill(
        p, jcfg, jl, single_device(), t, S_)[0])(params, prompts))
    model = build_model(tcfg, device="cpu", params=convert.from_reference(
        jax.tree.map(np.asarray, params), tcfg))
    got = model.prefill(torch.as_tensor(prompts), S_, luffy=luffy)[0]
    return want, got.numpy()


_SERVED = {}


def _served(name):
    """Both packages' serve outputs of one variant; the head-dim variants
    (whose layers are their arch's but for the width) prefill only."""
    if name not in _SERVED:
        hd = next(v for v in VARIANTS if v[0] == name)[2]
        jcfg, tcfg = _variant_cfgs(name)
        params = _params(jcfg)
        np_params = jax.tree.map(np.asarray, params)
        prompts = np.random.default_rng(1).integers(
            1, jcfg.vocab_size, (B, S)).astype(np.int32)
        if hd is not None:
            want, got = _prefill_pair(jcfg, tcfg, params, prompts)
            _SERVED[name] = ({"prefill": want}, {"prefill": got})
        else:
            ref = _jax_serve(jcfg, params, prompts)
            _SERVED[name] = (ref, _torch_serve(tcfg, np_params, prompts,
                                               ref["tokens"]))
    return _SERVED[name]


def test_configs_registered():
    """The five are ported (``get_config`` returns each), and so is every
    other arch of the reference, rwkv6-3b included (llama4-maverick,
    internvl2, seamless and rwkv6: ``tests/test_torch_shared.py``,
    ``tests/test_torch_prefix.py``, ``tests/test_torch_encdec.py``,
    ``tests/test_torch_rwkv.py``); a name the reference lacks raises."""
    assert NOT_PORTED == ()
    assert get_config("rwkv6-3b").name == jget_config("rwkv6-3b").name
    with pytest.raises(NotImplementedError, match="not an architecture"):
        get_config("rwkv7-3b")
    for arch in ARCHS:
        assert get_config(arch).name == jget_config(arch).name
    assert reduced(get_config("gemma3-12b")).num_layers == 6
    assert reduced(get_config("gemma3-12b")).attn.window_pattern == \
        (64,) * 5 + (None,)
    assert reduced(get_config("yi-34b")).attn.num_kv_heads == 4


@pytest.mark.parametrize("name", [v[0] for v in VARIANTS])
def test_serve_prefill_logits_f32(name):
    ref, got = _served(name)
    assert got["prefill"].shape == ref["prefill"].shape
    np.testing.assert_allclose(got["prefill"], ref["prefill"],
                               atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_decode_past_window_f32(name):
    """The step feed's last logits and every greedy step's, past the
    reduced window (the ring buffers wrapped), and the greedy tokens."""
    ref, got = _served(name)
    np.testing.assert_allclose(got["step_last"], ref["step_last"],
                               atol=TOL["float32"], rtol=0)
    for i in range(GEN):
        np.testing.assert_allclose(got["gen"][i], ref["gen"][i],
                                   atol=TOL["float32"], rtol=0,
                                   err_msg=f"gen {i}")
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


@pytest.mark.parametrize("name", HD_VARIANTS)
def test_serve_prefill_logits_bf16(name):
    """The configs' own compute dtype, bf16 (see the module docstring for
    the tolerance), at the published head widths: stablelm's 160 (the
    arch with the largest error, its LayerNorm) and gemma3's 256: logits
    and the greedy token."""
    jcfg, tcfg = _variant_cfgs(name, compute_dtype="bfloat16")
    prompts = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, got = _prefill_pair(jcfg, tcfg, _params(jcfg), prompts)
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_gemma3_prefill_streams_at_3072():
    """A prompt of 3072 > ATTN_DIRECT_MAX: gemma3's two layer kinds, a
    banded local layer (window 1024) and a global one, through each
    package's streaming path, f32."""
    jcfg, tcfg = [dataclasses.replace(c, num_layers=2, attn=dataclasses.
                                      replace(c.attn,
                                              window_pattern=(1024, None)))
                  for c in _cfgs("gemma3-12b")]
    prompts = np.random.default_rng(3).integers(
        1, jcfg.vocab_size, (1, LONG_S)).astype(np.int32)
    want, got = _prefill_pair(jcfg, tcfg, _params(jcfg), prompts)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)


# --- olmoe's LUFFY train step ------------------------------------------------

TB, TS, THR = 2, 128, 0.6


def _k2_cosine(x, eps: float = 1e-8):
    """Kernel K2's formula in jnp (``repro/kernels/similarity.py``)."""
    xf = x.astype(jnp.float32)
    sq = jnp.sum(xf * xf, -1)
    inv = jax.lax.rsqrt(sq[:, None] * sq[None, :] + eps)
    return (xf @ xf.T * inv + 1.0) * 0.5


def _record(monkeypatch, module, store, on_jax):
    orig = module.condense_tokens

    def rec(*a, **kw):
        out = orig(*a, **kw)
        if on_jax:
            jax.debug.callback(lambda r: store.append(np.asarray(r)),
                               out.rep_idx, ordered=True)
        else:
            store.append(out.rep_idx.numpy().copy())
        return out

    monkeypatch.setattr(module, "condense_tokens", rec)


def test_olmoe_train_step_matches_jax_grad(monkeypatch):
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    params = _params(jcfg)
    batch = JSyntheticLM(jcfg, JShape("train", TS, TB, "train")).batch(0)
    cap = capacity_for(tcfg.moe, TB * TS, tcfg.moe.num_experts)
    j_reps, t_reps = [], []
    _record(monkeypatch, jplan, j_reps, True)
    _record(monkeypatch, tplan, t_reps, False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        return jtf.forward_train(p, jcfg, JLuffy(use_kernels=False),
                                 single_device(), jb, jnp.float32(THR), cap)

    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    jax.effects_barrier()
    tparams = convert.from_reference(jax.tree.map(np.asarray, params), tcfg)
    for _, p in optim.leaves_with_path(tparams):
        p.requires_grad_()
    loss, m = ttf.forward_train(tparams, tcfg, LuffyConfig(),
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()},
                                torch.tensor(THR), cap)
    loss.backward()
    assert len(t_reps) == len(j_reps) == tcfg.num_layers
    for i, (a, b) in enumerate(zip(t_reps, j_reps)):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {i} rep map")
    assert 0.0 < float(m["condense_rate"]) < 1.0
    assert float(m["condense_rate"]) == float(j_m["condense_rate"])
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    grads = convert.to_reference(optim.tree_map(lambda p: p.grad, tparams),
                                 tcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(j_grads))
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-3, (jax.tree_util.keystr(path), err)


def test_dense_archs_do_not_train_yet():
    from repro_torch.launch import train as ttrain
    with pytest.raises(NotImplementedError, match="item 8.7"):
        ttrain.main(["--arch", "gemma3-12b", "--reduced", "--steps", "1",
                     "--seq-len", "128", "--global-batch", "2", "--device",
                     "cpu"])


# --- bf16 leaves -------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma3_bf16():
    jcfg, tcfg = _cfgs("gemma3-12b")
    assert tcfg.param_dtype == "bfloat16"
    params = jax.tree.map(np.asarray, _params(jcfg, seed=4))
    return tcfg, params


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint16)


def test_bf16_convert_round_trip_bitwise(gemma3_bf16):
    tcfg, params = gemma3_bf16
    tparams = convert.from_reference(params, tcfg)
    assert tparams["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    back = convert.to_reference(tparams, tcfg)
    want = jax.tree_util.tree_leaves(params)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == convert.BF16_RAW and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_bf16_checkpoint_reference_save_port_restore(gemma3_bf16, tmp_path):
    tcfg, params = gemma3_bf16
    jckpt.save(str(tmp_path), params, step=2, shard_mb=1)
    like = convert.to_reference(build_model(tcfg, device="cpu").params,
                                tcfg)
    got, step = tckpt.restore(str(tmp_path), like)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # as tensors: bf16 ones of the same bits
    on_dev, _ = tckpt.restore(str(tmp_path), like, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(on_dev),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      _bits(b).view(np.int16))


def test_bf16_checkpoint_port_save_matches_reference_files(gemma3_bf16,
                                                          tmp_path):
    """The port's checkpoint of bf16 leaves is the reference's file for
    file: the same spec (dtype "bfloat16") and the same raw |V2 arrays.
    The reference's own ``restore`` cannot cast |V2 back to bfloat16
    (numpy has no such cast, for its own files too), so its side reads
    the arrays as np.load gives them and views them as bfloat16."""
    tcfg, params = gemma3_bf16
    tparams = convert.from_reference(params, tcfg)
    tckpt.save(str(tmp_path / "port"), convert.to_reference(tparams, tcfg),
               step=1)
    jckpt.save(str(tmp_path / "ref"), params, step=1)
    specs = [json.loads((tmp_path / d / "spec.json").read_text())
             for d in ("port", "ref")]
    assert specs[0] == specs[1]
    assert {e["dtype"] for e in specs[0]["leaves"]} == {"bfloat16"}
    with np.load(tmp_path / "port" / "shard_0.npz") as zp, \
            np.load(tmp_path / "ref" / "shard_0.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for key in zr.files:
            assert zp[key].dtype == zr[key].dtype
            np.testing.assert_array_equal(_bits(zp[key]), _bits(zr[key]))
        got = zp["t0"].view(jnp.bfloat16)
    want = jax.tree_util.tree_leaves(params)[0]
    np.testing.assert_array_equal(_bits(got), _bits(want))
