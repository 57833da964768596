"""The port's serving slice (repro_torch) against the JAX reference.

Reduced moe-gpt2, the reference's own weights carried across by
``repro_torch.convert``, the same numpy prompts. The reference runs its
serve path with the Pallas expert-FFN kernel in interpret mode
(``use_kernels=True``); the port runs on the CPU, where the expert FFN
takes the kernel's plain version. Tolerances: 1e-4 at f32 compute with
equal greedy tokens; 3e-2 at bf16, where the two frameworks round bf16
intermediates at different places.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import LuffyConfig as JLuffy
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.core import moe_layer as jmoe
from repro.dist import single_device
from repro.models.model import build_model as jbuild_model
from repro.serve import engine as jengine

from repro_torch import convert
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core import moe_layer as tmoe
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model

B, S, GEN = 2, 8, 8
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(compute_dtype):
    jcfg = dataclasses.replace(jreduced(jget_config("moe-gpt2")),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                               compute_dtype=compute_dtype)
    return jcfg, tcfg


def _jax_serve(compute_dtype):
    """Batched prefill, step-wise prompt feed and greedy decode through
    the reference engine; every output as numpy."""
    jcfg, _ = _cfgs(compute_dtype)
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    luffy = JLuffy(use_kernels=True, enable_condensation=False,
                   enable_migration=False)
    dist = single_device()
    prompts = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    s_max = S + GEN
    pf = jax.jit(lambda p, t: jengine.prefill(p, jcfg, luffy, dist, t,
                                              s_max)[0])
    dec = jax.jit(lambda p, c, t: jengine.decode_step(p, jcfg, luffy, dist,
                                                      c, t))
    cache = jengine.cache_struct(jcfg, B, s_max, as_struct=False)
    step = []
    for t in range(S):
        logits, cache = dec(params, cache, prompts[:, t:t + 1])
        step.append(np.asarray(logits))
    toks, gen = [], []
    for _ in range(GEN):
        nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        toks.append(nxt[:, 0])
        logits, cache = dec(params, cache, nxt)
        gen.append(np.asarray(logits))
    return {"params": jax.tree.map(np.asarray, params), "prompts": prompts,
            "prefill": np.asarray(pf(params, prompts)), "step": step,
            "tokens": np.stack(toks, 1), "gen": gen}


def _torch_serve(compute_dtype, ref):
    """The same through the port on the CPU; decode is fed the
    reference's greedy tokens so later steps compare like with like."""
    _, tcfg = _cfgs(compute_dtype)
    params = convert.from_reference(ref["params"], tcfg, device="cpu")
    model = build_model(tcfg, device="cpu", params=params)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    prompts = torch.as_tensor(ref["prompts"])
    s_max = S + GEN
    out = {"prefill": model.prefill(prompts, s_max, luffy=luffy)[0].numpy()}
    cache = model.new_cache(B, s_max)
    out["step"] = []
    for t in range(S):
        logits, cache = model.decode_step(cache, prompts[:, t:t + 1],
                                          luffy=luffy)
        out["step"].append(logits.numpy())
    out["tokens"], out["gen"] = [], []
    for i in range(GEN):
        out["tokens"].append(torch.argmax(logits, -1).numpy())
        fed = torch.as_tensor(ref["tokens"][:, i:i + 1])
        logits, cache = model.decode_step(cache, fed, luffy=luffy)
        out["gen"].append(logits.numpy())
    out["tokens"] = np.stack(out["tokens"], 1)
    return out


@pytest.fixture(scope="module")
def served():
    res = {}
    for cdt in ("float32", "bfloat16"):
        ref = _jax_serve(cdt)
        res[cdt] = (ref, _torch_serve(cdt, ref))
    return res


def test_configs_agree():
    """The port's copied configs equal the reference's field by field:
    reduced moe-gpt2; hymba-1.5b, moe-transformerxl, moe-bert-large and
    the attention decoders olmoe-1b-7b, yi-34b, stablelm-12b,
    starcoder2-15b, gemma3-12b, llama4-maverick-400b-a17b,
    internvl2-2b, seamless-m4t-large-v2 and rwkv6-3b, full and reduced
    (``causal``, ``param_dtype``, gemma3's six-layer period, the clamped
    GQA heads and windows, llama4's shared expert, internvl2's prefix,
    seamless's encoder depth and rwkv6's missing attention included);
    the defaults of
    LuffyConfig, OptimConfig and a ShapeConfig; and SHAPES. Each
    dataclass has the reference's fields and no other, but for
    ``LuffyConfig.use_kernels``: the reference's switch between its
    Pallas kernels and jnp, which the port makes by the tensor's device
    (a CUDA tensor launches the kernel, a CPU one runs its plain
    version)."""
    from repro import config as jconfig
    from repro_torch import config as tconfig
    for name in ("AttnConfig", "MoEConfig", "SSMConfig", "ModelConfig",
                 "ShapeConfig", "LuffyConfig", "OptimConfig"):
        got = {f.name for f in dataclasses.fields(getattr(tconfig, name))}
        want = {f.name for f in dataclasses.fields(getattr(jconfig, name))}
        if name == "LuffyConfig":
            want.discard("use_kernels")
        assert got == want, (name, sorted(want - got), sorted(got - want))
    for name in ("LuffyConfig", "OptimConfig"):
        got, want = getattr(tconfig, name)(), getattr(jconfig, name)()
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (name,
                                                                   f.name)
    shape = ("train", 256, 2, "train")
    assert dataclasses.astuple(tconfig.ShapeConfig(*shape)) == \
        dataclasses.astuple(jconfig.ShapeConfig(*shape))
    # the assigned input shapes (the dry run's --shape), field by field
    assert list(tconfig.SHAPES) == list(jconfig.SHAPES)
    for name, want in jconfig.SHAPES.items():
        got = tconfig.SHAPES[name]
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), (name,
                                                                   f.name)
    for cdt in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(cdt)
        for f in dataclasses.fields(tcfg):
            want = getattr(jcfg, f.name)
            got = getattr(tcfg, f.name)
            if dataclasses.is_dataclass(got):
                for g in dataclasses.fields(got):
                    assert getattr(got, g.name) == getattr(want, g.name), \
                        (f.name, g.name)
            else:
                assert got == want, f.name
    assert get_config("moe-gpt2").name == jget_config("moe-gpt2").name
    # the other archs at full width and reduced, every field and
    # sub-field
    for arch in ("hymba-1.5b", "moe-transformerxl", "moe-bert-large",
                 "olmoe-1b-7b", "yi-34b", "stablelm-12b", "starcoder2-15b",
                 "gemma3-12b", "llama4-maverick-400b-a17b", "internvl2-2b",
                 "seamless-m4t-large-v2", "rwkv6-3b"):
        for make in (lambda g: g(arch),
                     lambda g: (reduced if g is get_config else jreduced)(
                         g(arch))):
            tcfg, jcfg = make(get_config), make(jget_config)
            for f in dataclasses.fields(tcfg):
                got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
                if dataclasses.is_dataclass(got):
                    for g in dataclasses.fields(got):
                        assert getattr(got, g.name) == \
                            getattr(want, g.name), (arch, f.name, g.name)
                else:
                    assert got == want, (arch, f.name)
    assert not get_config("moe-bert-large").causal
    assert not reduced(get_config("moe-bert-large")).causal
    assert get_config("moe-transformerxl").causal


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_prefill_logits(served, cdt):
    ref, got = served[cdt]
    assert got["prefill"].shape == ref["prefill"].shape
    np.testing.assert_allclose(got["prefill"], ref["prefill"],
                               atol=TOL[cdt], rtol=0)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_stepwise_decode_logits(served, cdt):
    ref, got = served[cdt]
    for t in range(S):
        np.testing.assert_allclose(got["step"][t], ref["step"][t],
                                   atol=TOL[cdt], rtol=0, err_msg=f"t={t}")
    for i in range(GEN):
        np.testing.assert_allclose(got["gen"][i], ref["gen"][i],
                                   atol=TOL[cdt], rtol=0, err_msg=f"gen {i}")


def test_greedy_tokens_f32(served):
    ref, got = served["float32"]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_decode_from_cache_matches_prefill(served):
    """The port's own consistency: the last step-wise logits equal the
    batched prefill's last-token logits (f32)."""
    _, got = served["float32"]
    np.testing.assert_allclose(got["step"][-1], got["prefill"], atol=1e-4)


def test_convert_round_trip(served):
    ref, _ = served["float32"]
    _, tcfg = _cfgs("float32")
    back = convert.to_reference(
        convert.from_reference(ref["params"], tcfg), tcfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)


@pytest.mark.parametrize("mode", ["vanilla", "decode"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_moe_core_matches_reference(mode, cdt):
    """One MoE sublayer at M=1 with a capacity small enough to drop,
    against the reference's kernel path (the Pallas K1, interpreted)."""
    jcfg, tcfg = _cfgs(cdt)
    p = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    r = np.random.default_rng(4)
    n_seq, seq = (4, 8) if mode == "vanilla" else (16, 1)
    x = r.standard_normal((n_seq, seq, jcfg.d_model)).astype(np.float32)
    cap = 8
    jl = JLuffy(enable_condensation=False, enable_migration=False)
    jx = jax.numpy.asarray(x).astype(jcfg.compute_dtype)
    jsb = {"labels": np.zeros((n_seq, seq), np.int32),
           "seq_len": np.full((n_seq,), seq, np.int32)}
    y_ref, _, _, aux_ref = jmoe.moe_core(
        p, jx, jsb, jcfg, jl, mode=mode, capacity=cap, axis_name=None,
        threshold=jax.numpy.float32(1.0), use_kernel=True)
    tdt = getattr(torch, cdt)
    ty, tsb, s_next, aux = tmoe.moe_core(
        convert.tree_to_torch(jax.tree.map(np.asarray, p)),
        torch.as_tensor(x).to(tdt),
        {"seq_len": torch.full((n_seq,), seq, dtype=torch.int32)},
        tcfg, LuffyConfig(enable_condensation=False, enable_migration=False),
        mode=mode, capacity=cap)
    assert s_next is None
    assert float(aux_ref.dispatch_drop) > 0.0
    assert float(aux.dispatch_drop) == float(aux_ref.dispatch_drop)
    np.testing.assert_allclose(float(aux.aux_loss), float(aux_ref.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(y_ref, np.float32),
                               atol=1e-5 if cdt == "float32" else 3e-2)


def test_moe_core_later_slices_raise():
    """What the port does not run raises: an unknown planner objective.
    The "overlap" and "replicate" objectives run since slice 14: on one
    device migration is the identity and no replica lane exists, so each
    is the plain sublayer. The pipelined executor runs since slice 13 (``tests/test_torch_sched.py``
    holds it). Wire error feedback runs since slice 12: on one rank
    nothing crosses a wire, so the residual it returns is zero. Plan
    reuse, condense-plan reuse
    and the lsh similarity backend run since slice 11: on one device
    without a carry each is the plain sublayer (the lsh backend only
    measures fewer pairs), and an unknown mode is an error. A device
    holding part of the expert stack under a local comm context is an
    error (expert parallelism runs the whole stack over virtual ranks).
    Migration itself is the identity at M = 1."""
    _, tcfg = _cfgs("float32")
    g = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(g, tcfg, device="cpu")
    G = LuffyConfig().condense_group
    x = torch.randn((1, G, tcfg.d_model), generator=g)
    sb = {"seq_len": torch.full((1,), G, dtype=torch.int32)}
    thr = torch.tensor(0.5)
    shard = {**p, "experts": {k: w[:2] for k, w in p["experts"].items()}}
    with pytest.raises(ValueError, match="whole expert stack"):
        tmoe.moe_core(shard, x, sb, tcfg, LuffyConfig(), mode="migrate",
                      capacity=8, threshold=thr)
    with pytest.raises(ValueError, match="unknown plan_objective"):
        tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(plan_objective="nope"),
                      mode="vanilla", capacity=8, threshold=thr)
    y_traffic = tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(), mode="migrate",
                              capacity=8, threshold=thr)[0]
    for obj in ("overlap", "replicate"):
        y = tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(plan_objective=obj),
                          mode="migrate", capacity=8, threshold=thr)[0]
        assert torch.equal(y, y_traffic)
    ef_in = torch.randn((1, 1, G, tcfg.d_model), generator=g) * 1e-3
    _, _, _, _, _, _, ef = tmoe.moe_core_planned(
        p, x[None], {k: v[None] for k, v in sb.items()}, tcfg,
        LuffyConfig(wire_error_feedback=True, wire_dtype="f8e4m3"),
        mode="vanilla", capacity=8, threshold=thr, wire_ef=ef_in)
    assert ef.shape == ef_in.shape and not ef.any()
    y_mig = tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(), mode="migrate",
                          capacity=8, threshold=thr)[0]
    y_van = tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(), mode="vanilla",
                          capacity=8, threshold=thr)[0]
    assert torch.equal(y_mig, y_van)
    for luffy in (LuffyConfig(plan_reuse="signature"),
                  LuffyConfig(condense_reuse="signature"),
                  LuffyConfig(plan_reuse="always", condense_reuse="always")):
        y = tmoe.moe_core(p, x, sb, tcfg, luffy, mode="migrate", capacity=8,
                          threshold=thr)[0]
        assert torch.equal(y, y_van)
    _, _, _, aux = tmoe.moe_core(p, x, sb, tcfg,
                                 LuffyConfig(similarity_backend="lsh"),
                                 mode="vanilla", capacity=8, threshold=thr)
    _, _, _, aux_exact = tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(),
                                       mode="vanilla", capacity=8,
                                       threshold=thr)
    assert 0 < aux.measured_pairs < aux_exact.measured_pairs
    for luffy in (LuffyConfig(plan_reuse="sometimes"),
                  LuffyConfig(condense_reuse="sometimes")):
        with pytest.raises(ValueError, match="unknown"):
            tmoe.moe_core(p, x, sb, tcfg, luffy, mode="vanilla", capacity=8,
                          threshold=thr)
    with pytest.raises(ValueError, match="unknown similarity_backend"):
        tmoe.moe_core(p, x, sb, tcfg, LuffyConfig(similarity_backend="x"),
                      mode="vanilla", capacity=8, threshold=thr)


def test_launcher_cpu_end_to_end():
    res = tserve.main(["--reduced", "--batch", "2", "--prompt-len", "4",
                       "--gen", "3", "--prefill", "batch", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert np.isfinite(res["prefill_logits"].numpy()).all()
    # the cache's last prompt step and the batched prefill agree
    np.testing.assert_allclose(res["step_logits"][-1].float().numpy(),
                               res["prefill_logits"].numpy(), atol=3e-2)


def test_launcher_never_falls_back_to_cpu():
    """The default device is CUDA; without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--batch", "1", "--prompt-len", "2",
                     "--gen", "1"])


class _Parsed(Exception):
    pass


def _options(main, monkeypatch):
    """The option strings of the parser ``main`` builds: its
    ``parse_args`` is stopped before it parses (the reference's launchers
    import JAX only after that)."""
    import argparse

    def stop(parser, *a, **kw):
        raise _Parsed(parser)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        main()
    return {o for a in got.value.args[0]._actions for o in a.option_strings}


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launcher_flags_match_reference(launcher, monkeypatch):
    """Each port launcher defines every flag of the reference's, plus the
    documented port-only ``--device``, ``--seed`` and ``--num-layers``,
    and nothing else."""
    import importlib
    ref = importlib.import_module(f"repro.launch.{launcher}")
    port = importlib.import_module(f"repro_torch.launch.{launcher}")
    port_only = {"--device", "--seed", "--num-layers"}
    want = _options(ref.main, monkeypatch)
    got = _options(port.parse_args, monkeypatch)
    assert got == want | port_only, (sorted(got - want - port_only),
                                     sorted(want - got))
