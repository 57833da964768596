"""Continuous batching in the port (repro_torch) against the JAX
reference: slot recycling (``admit_slot``) and the ``--continuous``
serve loop.

admit_slot: after a warm-up decode that wraps the window ring, the
port's cache after admission equals the reference's (offset, pos and
cpos exactly, the zeroed Mamba rows exactly, k / v / Mamba state within
the f32 tolerance), and the recycled slot's logits are **bit for bit**
those of the same sequence decoded from a fresh cache (the recycling
invariant, ``serve/engine.py``). Cases: reduced moe-gpt2, the same with
a window of 6 so the ring wraps, reduced hymba (its Mamba state zeroed)
and reduced rwkv6-3b, the reference's own case (its WKV6 state and both
token shifts zeroed, no attention entries).

The loop: ``launch.serve.main([... "--continuous", "--device", "cpu"])``
on reduced moe-gpt2 at f32 compute, against the reference's scheduler
and ``engine.decode_step`` driven here with the same prompts, arrivals
and weights (the port's seeded weights through ``convert``): equal
tokens for every request, every model call's logits of the occupied
slots within 1e-4 (``test_torch_serve.py``'s f32 tolerance), and metrics
records whose keys, counters and occupancy equal the reference
registry's on the same raw dicts. With ``--plan-cache
--precompute-plans`` the loop builds no plan and its tokens and logits
are the uncached run's bit for bit. The decode runs without Pallas
(``use_kernels=False``) on the reference side: its expert FFN is the
plain einsum the Pallas kernel is tested against.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.dist import single_device
from repro.models.model import build_model as jbuild_model
from repro.obs import metrics as jmetrics
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched

from repro_torch import config as tconfig
from repro_torch import convert
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model
from repro_torch.plan import exchange as tex

TOL = 1e-4
JLUFFY = JLuffy(enable_condensation=False, enable_migration=False)
LUFFY = LuffyConfig(enable_condensation=False, enable_migration=False)


def _f32(cfg, window=None):
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if window is not None:
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, window_pattern=(window,)))
    return cfg


def _jdecode(jcfg):
    return jax.jit(lambda p, c, t: jengine.decode_step(
        p, jcfg, JLUFFY, single_device(), c, t))


def _layer_view(jcache, i, period):
    g, j = divmod(i, period)
    return {k: np.asarray(v[g]) for k, v in jcache["groups"][j].items()}


@pytest.mark.parametrize("arch,window", [("moe-gpt2", None),
                                         ("moe-gpt2", 6),
                                         ("hymba-1.5b", None),
                                         ("rwkv6-3b", None)])
def test_admit_slot_matches_reference_and_is_bitwise_fresh(arch, window):
    from repro.models.transformer import pattern_period
    jcfg = _f32(jreduced(jget_config(arch)), window)
    tcfg = _f32(reduced(get_config(arch)), window)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    model = build_model(tcfg, device="cpu", params=convert.from_reference(
        jax.tree.map(np.asarray, jparams), tcfg))
    B, s_max = 2, 16
    r = np.random.default_rng(3)
    # the first occupants run long enough to wrap the 6-token window
    # ring, so the recycled slot holds stale entries at every ring index
    warm = r.integers(1, tcfg.vocab_size, (B, 9)).astype(np.int32)
    seq = r.integers(1, tcfg.vocab_size, (7,)).astype(np.int32)
    other = r.integers(1, tcfg.vocab_size, (7,)).astype(np.int32)
    dec = _jdecode(jcfg)

    cache = model.new_cache(B, s_max)
    jcache = jengine.cache_struct(jcfg, B, s_max, as_struct=False)
    for t in range(warm.shape[1]):
        _, cache = model.decode_step(cache, torch.as_tensor(warm[:, t:t + 1]),
                                     luffy=LUFFY)
        _, jcache = dec(jparams, jcache, warm[:, t:t + 1])
    cache = model.admit_slot(cache, 0, cache["pos"])
    jcache = jengine.admit_slot(jcache, 0, int(jcache["pos"]))

    assert cache["pos"] == int(jcache["pos"]) == warm.shape[1]
    np.testing.assert_array_equal(cache["offset"].numpy(),
                                  np.asarray(jcache["offset"]))
    period = pattern_period(jcfg)
    attn = tcfg.attn is not None
    state = (() if tcfg.ssm is None else ("ssm_h", "ssm_conv") if attn
             else ("ssm_S", "ssm_xprev", "cmix_xprev"))
    for i, layer in enumerate(cache["layers"]):
        want = _layer_view(jcache, i, period)
        assert set(layer) == set(want), (set(layer), set(want))
        if attn:
            np.testing.assert_array_equal(layer["cpos"].numpy(),
                                          want["cpos"])
        for k in (("k", "v") if attn else ()) + state:
            np.testing.assert_allclose(layer[k].numpy(), want[k], atol=TOL,
                                       rtol=TOL, err_msg=f"layer {i} {k}")
        for k in state:
            assert not layer[k][0].any() and not want[k][0].any()
            assert layer[k][1].abs().sum() > 0

    def slot0(cache):
        out = []
        for t in range(seq.shape[0]):
            toks = torch.as_tensor(np.stack([seq[t], other[t]])[:, None])
            lg, cache = model.decode_step(cache, toks, luffy=LUFFY)
            out.append(lg[0].numpy())
        return np.stack(out)

    got = slot0(cache)
    fresh = slot0(model.new_cache(B, s_max))
    np.testing.assert_array_equal(got, fresh)
    # and the reference's recycled slot agrees within the f32 tolerance
    jgot = []
    for t in range(seq.shape[0]):
        lg, jcache = dec(jparams, jcache,
                         np.stack([seq[t], other[t]])[:, None])
        jgot.append(np.asarray(lg[0]))
    np.testing.assert_allclose(got, np.stack(jgot), atol=TOL, rtol=TOL)


ARGS = ["--reduced", "--continuous", "--batch", "3", "--prompt-len", "5",
        "--gen", "4", "--requests", "7", "--burst", "2", "--arrival-every",
        "3", "--device", "cpu", "--seed", "0"]


@pytest.fixture(scope="module")
def continuous(tmp_path_factory):
    """The port's launcher at f32 compute (uncached, then with a warm
    plan cache) and the reference loop on the same weights and stream."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tconfig, "reduced", lambda c: _f32(reduced(c)))
    tmp = tmp_path_factory.mktemp("continuous")
    try:
        res = tserve.main(ARGS + ["--metrics-json", str(tmp / "m.jsonl")])
        n0 = tex.BUILD_CALLS
        cached = tserve.main(ARGS + ["--plan-cache", str(tmp / "plans"),
                                     "--precompute-plans"])
        cached_builds = tex.BUILD_CALLS - n0
    finally:
        mp.undo()
    tcfg = _f32(reduced(get_config("moe-gpt2")))
    jcfg = _f32(jreduced(jget_config("moe-gpt2")))
    params = build_model(tcfg, device="cpu", seed=0).params
    jparams = jax.tree.map(jax.numpy.asarray,
                           convert.to_reference(params, tcfg))
    dec = _jdecode(jcfg)
    B, S, gen = 3, 5, 4
    cache = jengine.cache_struct(jcfg, B, S + gen, as_struct=False)
    sched = jsched.ContinuousScheduler(B)
    registry = jmetrics.MetricsRegistry(luffy=JLUFFY, run_info={
        "launcher": "serve", "arch": "moe-gpt2", "continuous": True,
        "batch": B, "prompt_len": S, "gen": gen})
    prompts, arrive = res["prompts"], res["arrival_step"]
    step = submitted = 0
    logits, records = [], []
    while True:
        while submitted < len(prompts) and arrive[submitted] <= step:
            sched.submit(prompts[submitted], gen, now=0.0)
            submitted += 1
        if sched.all_done():
            if submitted >= len(prompts):
                break
            step += 1
            continue
        for slot, _ in sched.admit(now=0.0):
            cache = jengine.admit_slot(cache, slot, int(cache["pos"]))
        lg, cache = dec(jparams, cache, sched.next_feed())
        logits.append(np.asarray(lg))
        sched.observe(np.asarray(lg), now=0.0)
        records.append(registry.observe(step, sched.step_metrics()))
        step += 1
    ref = {"requests": {q.rid: list(q.generated) for q in sched.done},
           "steps": step, "slot_churn": sched.slot_churn, "logits": logits,
           "records": records}
    got_records = [json.loads(line) for line in
                   (tmp / "m.jsonl").read_text().splitlines()]
    return res, cached, cached_builds, ref, got_records


def test_continuous_tokens_match_reference(continuous):
    res, _, _, ref, _ = continuous
    assert res["finished"] == 7 and res["requests"] == ref["requests"]
    assert all(len(t) == 4 for t in res["requests"].values())
    assert res["steps"] == ref["steps"]
    assert res["slot_churn"] == ref["slot_churn"] >= 4
    assert res["model_calls"] == len(ref["logits"]) < res["steps"] + 1


def test_continuous_logits_match_reference(continuous):
    res, _, _, ref, _ = continuous
    for i, (got, want, act) in enumerate(zip(res["step_logits"],
                                             ref["logits"],
                                             res["step_active"])):
        assert act.any()
        np.testing.assert_allclose(got[act], want[act], atol=TOL, rtol=TOL,
                                   err_msg=f"model call {i}")


def test_continuous_metrics_records_match_reference(continuous):
    res, _, _, ref, got = continuous
    want = json.loads(json.dumps(ref["records"]))
    assert len(got) == len(want) == res["model_calls"]
    slo = {"serve/queue_ms", "serve/ttft_ms", "serve/tpot_ms"}
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        assert g["metrics"].keys() == w["metrics"].keys()
        assert g["cumulative"] == w["cumulative"]
        for k, v in w["metrics"].items():
            if k in slo:
                assert g["metrics"][k] >= 0.0
            else:
                assert g["metrics"][k] == v, k
    assert got[0]["run"] == want[0]["run"]
    assert got[-1]["cumulative"]["serve/finished"] == 7.0


def test_continuous_warm_plan_cache_builds_nothing(continuous):
    res, cached, builds, _, _ = continuous
    assert builds == 0
    assert cached["plan_cache"]["misses"] == 0 and \
        cached["plan_cache"]["hits"] > 0
    assert cached["requests"] == res["requests"]
    for a, b in zip(cached["step_logits"], res["step_logits"]):
        np.testing.assert_array_equal(a, b)
