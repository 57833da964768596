"""The port's hymba serving slice (repro_torch) against the JAX reference.

Reduced hymba-1.5b (2 layers, d 256, window 64) with GQA kept: the
reduced config's 4 KV heads are replaced by 2 in both frameworks alike.
The reference's own weights are carried across by
``repro_torch.convert``; the same numpy prompts of S=128 positions,
twice the reduced window, so the batched prefill's window mask and the
decode cache's ring (W=64) both wrap. The reference runs its serve path
with ``attend`` and the ``lax.scan`` Mamba path (``REPRO_MAMBA_KERNEL``
unset); the port on the CPU takes K5's and K6's plain versions.

Tolerances: 5e-5 at f32 (sums in another order, and f32 cos/sin of the
RoPE angles a few ulps apart in the two frameworks; measured 2.4e-6 on
the prefill, 4.3e-6 on the decode chain); at bf16 two bf16 ulps of the
logits' magnitude (|logits| < 8, ulp 2^-5), since the frameworks round
bf16 intermediates at other places and K5 keeps the softmax weights in
f32 where ``attend`` casts them to bf16.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.dist import single_device
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

from repro_torch import convert
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model

B, S, GEN = 2, 128, 4
TOL = {"float32": 5e-5, "bfloat16": 2 * 2.0 ** -5}
LUFFY = LuffyConfig(enable_condensation=False, enable_migration=False)


def _gqa(cfg, cdt):
    return dataclasses.replace(
        cfg, compute_dtype=cdt,
        attn=dataclasses.replace(cfg.attn, num_kv_heads=2))


def _cfgs(cdt):
    return (_gqa(jreduced(jget_config("hymba-1.5b")), cdt),
            _gqa(reduced(get_config("hymba-1.5b")), cdt))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request):
    """Prefill and the step-wise decode chain through both frameworks."""
    cdt = request.param
    jcfg, tcfg = _cfgs(cdt)
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    luffy = JLuffy(enable_condensation=False, enable_migration=False)
    dist = single_device()
    toks = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    prompts = toks[:, :S]
    s_max = S + GEN
    ref = {"prefill": np.asarray(jax.jit(lambda p, t: jengine.prefill(
        p, jcfg, luffy, dist, t, s_max)[0])(params, prompts))}
    dec = jax.jit(lambda p, c, t: jengine.decode_step(p, jcfg, luffy, dist,
                                                      c, t))
    cache = jengine.cache_struct(jcfg, B, s_max, as_struct=False)
    ref["chain"] = []
    for t in range(S + GEN):
        logits, cache = dec(params, cache, toks[:, t:t + 1])
        ref["chain"].append(np.asarray(logits))

    np_params = jax.tree.map(np.asarray, params)
    model = build_model(tcfg, device="cpu",
                        params=convert.from_reference(np_params, tcfg))
    got = {"prefill": model.prefill(torch.as_tensor(prompts), s_max,
                                    luffy=LUFFY)[0].numpy()}
    tcache = model.new_cache(B, s_max)
    got["chain"] = []
    for t in range(S + GEN):
        logits, tcache = model.decode_step(
            tcache, torch.as_tensor(toks[:, t:t + 1]), luffy=LUFFY)
        got["chain"].append(logits.numpy())
    return cdt, ref, got, np_params, tcache


def test_prefill_logits(served):
    cdt, ref, got, _, _ = served
    assert got["prefill"].shape == ref["prefill"].shape == (B, 1024)
    np.testing.assert_allclose(got["prefill"], ref["prefill"],
                               atol=TOL[cdt], rtol=0)


def test_decode_chain_logits(served):
    """Every step of the prompt feed and past it: the ring cache (W=64)
    has wrapped once the feed passes position 64."""
    cdt, ref, got, _, tcache = served
    assert tcache["layers"][0]["k"].shape[1] == 64
    assert int(tcache["layers"][0]["cpos"].max()) == S + GEN - 1
    for t in range(S + GEN):
        np.testing.assert_allclose(got["chain"][t], ref["chain"][t],
                                   atol=TOL[cdt], rtol=0, err_msg=f"t={t}")


def test_decode_from_cache_matches_prefill(served):
    """The port's own consistency: the last prompt step of the chain (the
    ring, attn_decode and mamba_step) against the batched prefill's
    last-token logits (the window mask, K5's and K6's plain versions)."""
    cdt, _, got, _, _ = served
    np.testing.assert_allclose(got["chain"][S - 1], got["prefill"],
                               atol=TOL[cdt], rtol=0)


def test_convert_round_trip(served):
    """The ssm subtree crosses both ways leaf for leaf, a_log and d_skip
    in f32."""
    _, _, _, np_params, _ = served
    _, tcfg = _cfgs("float32")
    tp = convert.from_reference(np_params, tcfg)
    assert set(tp["layers"][0]["ssm"]) == set(np_params["layers"][0]["ssm"])
    assert tp["layers"][1]["ssm"]["a_log"].dtype == torch.float32
    assert "ssm_norm" not in tp["layers"][0] and "unembed" in tp
    back = convert.to_reference(tp, tcfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(np_params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_init_matches_reference_layout():
    """The port's own random init has the reference's tree, shapes and
    dtypes (hymba's untied head, a hybrid layer without ssm_norm)."""
    jcfg, tcfg = _cfgs("float32")
    jshapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(jshapes)}
    tp = build_model(tcfg, device="cpu", seed=0).params
    back = convert.to_reference(tp, tcfg)
    got = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
           for p, a in jax.tree_util.tree_leaves_with_path(back)}
    assert got == want


def test_launcher_cpu_end_to_end():
    res = tserve.main(["--arch", "hymba-1.5b", "--reduced", "--batch", "2",
                       "--prompt-len", "80", "--gen", "3", "--prefill",
                       "batch", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert res["prefill_logits"].shape == (2, 1024)
    assert np.isfinite(res["prefill_logits"].numpy()).all()
    # bf16 compute: the cache's last prompt step and the batched prefill
    # agree within two bf16 ulps of the logits
    np.testing.assert_allclose(res["step_logits"][-1].float().numpy(),
                               res["prefill_logits"].numpy(),
                               atol=TOL["bfloat16"])


def test_what_still_raises():
    """A stacked (not parallel) Mamba beside attention, which no config
    has, and training a hybrid (K5 and K6 have no backward yet) raise;
    RWKV-6, which raised until its slice, is registered. A prompt over
    2048 tokens, which raised until the streaming attention was ported,
    now prefills (hymba's attention core is K5, which streams at any
    length; on the CPU its plain version)."""
    assert get_config("rwkv6-3b").ssm.kind == "rwkv6"
    _, tcfg = _cfgs("float32")
    with pytest.raises(NotImplementedError, match="hybrids"):
        build_model(dataclasses.replace(tcfg, parallel_ssm=False),
                    device="cpu")
    model = build_model(tcfg, device="cpu", seed=0)
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "labels": torch.ones((1, 8), dtype=torch.int32),
             "seq_len": torch.full((1,), 8, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="backwards for K5 and K6"):
        model.forward_train(batch, torch.tensor(0.5), 8, luffy=LUFFY)
    logits, kvs = model.prefill(torch.ones((1, 2049), dtype=torch.int32),
                                2050, luffy=LUFFY)
    assert logits.shape == (1, tcfg.vocab_size)
    assert torch.isfinite(logits).all() and kvs[0][0].shape[1] == 2049
