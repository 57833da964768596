"""The port's expert-parallel serving over virtual ranks (sequence-sharded
prefill; the decode is the one-device one, which the reference's
all-reduce decode equals there) and its sequence-sharded train shape,
against the JAX reference on a 4-device ``(data=1, model=4)`` host mesh,
on the CPU.

Reduced moe-gpt2 (2 layers, d 256) with 8 experts (``max_experts=8``),
so that a rank holds two experts and top-2 routing can overflow a rank's
capacity: at 4 experts and capacity factor 2 a rank's capacity equals
its token count, and nothing can drop. The reference runs once per
module in a subprocess (``--xla_force_host_platform_device_count=4``)
that writes an .npz; the port gets the same parameters through
``repro_torch.convert``.

Oracles:
- ``make_dist``'s three modes: the reference's decisions field by field
  (model size, sequence axis, batch divisor, FSDP group) and the
  capacities derived from them (prefill, decode, tokens per rank);
- prefill: ``engine.prefill`` under ``make_dist(mesh, "prefill", ...)``
  with ``use_kernels=True`` (Pallas interpreted) and, in the subprocess
  only, ``shard_map(check_vma=False)``, as ``tests/test_torch_ep.py``
  does; the prompt is three token ids, which piles the routing onto a
  few experts and overflows a rank's capacity, so the M = 4 prefill
  differs from the M = 1 one and a wrong token order on a rank would
  drop other tokens. Last-token logits within 1e-5 at f32 and 3e-2 (the
  serve tolerance) at bf16;
- decode: the port's decode step against the reference's
  ``engine.decode_step`` under ``make_dist(mesh, "decode", ...)`` (the
  all-reduce decode), unpatched: 8 step-fed and 4 greedy steps. f32:
  equal tokens, logits within 1e-5 (the reference's 2-D expert FFN forms
  its hidden in the compute dtype, K1 in f32); bf16: the reference's
  tokens fed, see ``test_ep_decode_matches_reference`` for what its
  rounding costs;
- the sequence-sharded train shape (B=2, S=128, M=4): loss within 1e-5
  relative, ``dispatch_drop`` and ``local_frac`` bitwise, every gradient
  leaf within 1e-5 of ``jax.grad`` of the ``use_kernels=False`` path,
  unpatched.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model

import repro_torch.kernels.ops as kops
import repro_torch.plan.exchange as tex
from repro_torch import convert, optim, train_lib
from repro_torch.config import LuffyConfig, ShapeConfig, reduced
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.dist import make_dist
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import engine

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S, FEED, GEN, M, E = 4, 16, 8, 4, 4, 8
TB, TS = 2, 128                        # the sequence-sharded train shape
BATCHES = (1, 2, 4, 6, 8)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SERVE = dict(enable_condensation=False, enable_migration=False)

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.comm as rcomm
    import repro.comm.compat as compat
    from repro import train_lib
    from repro.config import LuffyConfig, ShapeConfig, reduced
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.dist import make_dist, single_device
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import build_model
    from repro.serve import engine
    B, S, FEED, GEN, M, E, TB, TS, BATCHES = %s
    out = {}
    mesh = make_host_mesh(model=M)
    assert dict(mesh.shape) == {"data": 1, "model": M}, mesh.shape

    def cfg_of(cdt):
        return dataclasses.replace(
            reduced(get_config("moe-gpt2"), max_experts=E), compute_dtype=cdt)

    params = build_model(cfg_of("float32")).init(jax.random.PRNGKey(0))
    cfg = cfg_of("float32")
    for mode in ("train", "prefill", "decode"):
        for gb in BATCHES:
            for moe in (0, 1):
                d = make_dist(mesh, mode, gb, moe_arch=bool(moe))
                out[f"dist/{mode}/{gb}/{moe}"] = np.array([
                    d.model_size, d.seq_axis is not None,
                    d.batch_size_divisor, d.axis_size(d.fsdp_axes),
                    engine.prefill_capacity(cfg, d, gb, TS),
                    engine.decode_capacity(cfg, d, gb),
                    train_lib.tokens_per_device(
                        cfg, ShapeConfig("t", TS, gb, "train"), d)])

    # the sequence-sharded train shape: the jnp path, unpatched
    shape = ShapeConfig("train", TS, TB, "train")
    dt = make_dist(mesh, "train", TB, moe_arch=True)
    assert dt.seq_axis is not None
    lf = LuffyConfig()
    cap = train_lib.capacity_for_bucket(cfg, shape, dt, lf, 0)
    batch = {k: jnp.asarray(v)
             for k, v in SyntheticLM(cfg, shape).batch(0).items()}
    f = lambda p: build_model(cfg).train_loss(
        p, batch, jnp.float32(0.6), luffy=lf, dist=dt, capacity=cap)
    (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    out["train/loss"] = np.float32(loss)
    out["train/capacity"] = np.int64(cap)
    for k in ("dispatch_drop", "local_frac", "condense_rate"):
        out["train/" + k] = np.float32(m[k])
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        out["train/grad/" + jax.tree_util.keystr(path)] = np.asarray(leaf)

    # decode: all-reduce over the model axis, unpatched; at bf16 also the
    # one-device decode (K1's rounding points), fed the same tokens
    rng = np.random.default_rng(3)
    feed = rng.integers(1, cfg.vocab_size, (B, FEED)).astype(np.int32)
    s_max = S + GEN
    dd = make_dist(mesh, "decode", B, moe_arch=True)
    sl = LuffyConfig(use_kernels=True, enable_condensation=False,
                     enable_migration=False)
    for cdt, name, dist in (("float32", "ep", dd), ("bfloat16", "ep", dd),
                            ("bfloat16", "one", single_device())):
        c = cfg_of(cdt)
        dec = jax.jit(lambda p, ca, t, c=c, dist=dist: engine.decode_step(
            p, c, sl, dist, ca, t))
        cache = engine.cache_struct(c, B, s_max, as_struct=False)
        key = f"decode/{cdt}/{name}/"
        for t in range(FEED):
            logits, cache = dec(params, cache, feed[:, t:t + 1])
            out[key + f"step{t}"] = np.asarray(logits)
        toks = []
        for i in range(GEN):
            if name == "ep":
                nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)
            else:
                nxt = out[f"decode/{cdt}/ep/tokens"][:, i]
            toks.append(nxt)
            logits, cache = dec(params, cache, nxt[:, None])
            out[key + f"gen{i}"] = np.asarray(logits)
        out[key + "tokens"] = np.stack(toks, 1)

    # prefill: the kernel path, shard_map's vma check off
    def _sm(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = _sm
    rcomm.shard_map = _sm
    prompts = np.random.default_rng(1).integers(1, 4, (B, S)).astype(np.int32)
    pd = make_dist(mesh, "prefill", B, moe_arch=True)
    for cdt in ("float32", "bfloat16"):
        c = cfg_of(cdt)
        pf = jax.jit(lambda p, t, c=c: engine.prefill(p, c, sl, pd, t,
                                                      s_max)[0])
        out[f"prefill/{cdt}"] = np.asarray(pf(params, prompts))
    out["prefill/prompts"] = prompts
    out["decode/feed"] = feed
    np.savez(sys.argv[1], **out)
    print("OK")
""") % repr((B, S, FEED, GEN, M, E, TB, TS, BATCHES))


def _cfgs(cdt):
    jcfg = dataclasses.replace(jreduced(jget_config("moe-gpt2"),
                                        max_experts=E), compute_dtype=cdt)
    tcfg = dataclasses.replace(reduced(get_config("moe-gpt2"),
                                       max_experts=E), compute_dtype=cdt)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep_serve") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    jcfg, _ = _cfgs("float32")
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return {"npz": dict(np.load(path)),
            "params": jax.tree.map(np.asarray, params)}


def _model(oracle, cdt):
    _, tcfg = _cfgs(cdt)
    return build_model(tcfg, device="cpu", params=convert.from_reference(
        oracle["params"], tcfg))


def _mesh():
    return make_host_mesh(model=M)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_make_dist_matches_reference(oracle, mode):
    """Each mode's decisions and the capacities they give, field by field
    against the reference's, for batches that do and do not split."""
    _, cfg = _cfgs("float32")
    for gb in BATCHES:
        for moe in (0, 1):
            d = make_dist(_mesh(), mode, gb, moe_arch=bool(moe))
            want = oracle["npz"][f"dist/{mode}/{gb}/{moe}"]
            got = [d.model_size, d.seq_sharded, d.batch_size_divisor, 1,
                   engine.prefill_capacity(cfg, gb, TS, d),
                   train_lib.tokens_per_device(
                       ShapeConfig("t", TS, gb, "train"), d)]
            np.testing.assert_array_equal(got, want[[0, 1, 2, 3, 4, 6]],
                                          err_msg=f"{mode} B={gb} moe={moe}")
            if mode == "decode":
                # the decode reads no context: its capacity is the
                # one-device one at every batch
                assert engine.decode_capacity(cfg, gb) == want[5], gb
    with pytest.raises(ValueError, match="shape mode"):
        make_dist(_mesh(), "serve", 4, moe_arch=True)


def _prefill(model, prompts, dist, monkeypatch):
    """Last-token logits, and each MoE sublayer's dispatch drop per rank."""
    drops = []
    orig = tex.build_exchange_plan

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        drops.append(pl.dispatch_drop)
        return pl

    monkeypatch.setattr(tex, "build_exchange_plan", rec)
    luffy = LuffyConfig(**SERVE)
    logits = model.prefill(prompts, S + GEN, luffy=luffy, dist=dist)[0]
    return logits.numpy(), torch.stack(drops)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_ep_prefill_matches_reference(oracle, monkeypatch, cdt):
    ref = oracle["npz"]
    model = _model(oracle, cdt)
    prompts = torch.as_tensor(ref["prefill/prompts"])
    pd = make_dist(_mesh(), "prefill", B, moe_arch=True)
    assert pd.seq_sharded
    got, drops = _prefill(model, prompts, pd, monkeypatch)
    # the prompt overflows a rank's capacity: tokens were dropped
    assert drops.shape == (2, M) and float(drops.max()) > 0.0
    np.testing.assert_allclose(got, ref[f"prefill/{cdt}"], rtol=0,
                               atol=TOL[cdt])
    one, _ = _prefill(model, prompts, None, monkeypatch)
    assert np.abs(got - one).max() > 1e-3


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_ep_decode_matches_reference(oracle, cdt):
    """The port's decode step, which serves every model axis, against
    the reference's all-reduce decode over 4 ranks. f32: within 1e-5,
    equal greedy tokens. bf16: the reference's 2-D expert FFN rounds at
    each einsum and K1 once, and at this size that moves a later layer's
    routing near a tie (its own all-reduce and one-device decodes differ
    by up to ~0.2 in logits): the port is held within 3e-2 of the
    reference's one-device decode, whose expert FFN keeps K1's rounding
    points, and no further from its all-reduce decode than that decode
    is from its one-device one, plus 3e-2."""
    ref = oracle["npz"]
    model = _model(oracle, cdt)
    # a rank's decode capacity is the one-device one (module docstring
    # of repro_torch.dist)
    assert make_dist(_mesh(), "decode", B,
                     moe_arch=True).batch_size_divisor == 1
    luffy = LuffyConfig(**SERVE)
    feed = torch.as_tensor(ref["decode/feed"])
    tol = TOL[cdt]
    cache = {"c": model.new_cache(B, S + GEN)}
    key = f"decode/{cdt}/ep/"

    def step(tokens, name):
        lg, cache["c"] = model.decode_step(cache["c"], tokens, luffy=luffy)
        got = lg.numpy()
        want = ref[key + name]
        if cdt == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=name)
        else:
            one = ref[f"decode/{cdt}/one/" + name]
            np.testing.assert_allclose(got, one, rtol=0, atol=tol,
                                       err_msg=name)
            assert np.abs(got - want).max() <= \
                np.abs(want - one).max() + tol, name
        return got

    for t in range(FEED):
        got = step(feed[:, t:t + 1], f"step{t}")
    toks = ref[key + "tokens"]
    for i in range(GEN):
        if cdt == "float32":
            np.testing.assert_array_equal(np.argmax(got, -1), toks[:, i])
        got = step(torch.as_tensor(toks[:, i:i + 1]), f"gen{i}")


def test_seq_sharded_train_matches_reference(oracle):
    """Loss, drop and locality ledger, and every gradient leaf of the
    sequence-sharded train shape (B=2 over M=4) against jax.grad."""
    ref = oracle["npz"]
    _, tcfg = _cfgs("float32")
    params = convert.from_reference(oracle["params"], tcfg)
    for _, p in optim.leaves_with_path(params):
        p.requires_grad_()
    shape = ShapeConfig("train", TS, TB, "train")
    dist = make_dist(_mesh(), "train", TB, moe_arch=True)
    assert dist.seq_sharded and dist.batch_size_divisor == 1
    luffy = LuffyConfig()
    cap = train_lib.capacity_for_bucket(tcfg, shape, luffy, 0, dist)
    assert cap == ref["train/capacity"]
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(tcfg, shape).batch(0).items()}
    loss, m = ttf.forward_train(params, tcfg, luffy, batch,
                                torch.tensor(0.6), cap, dist=dist)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["train/loss"], rtol=1e-5)
    for k in ("dispatch_drop", "local_frac", "condense_rate"):
        assert np.float32(m[k].item()) == ref["train/" + k], k
    assert m["dispatch_drop"] > 0.0      # the layout decides which drop
    grads = convert.to_reference(optim.tree_map(lambda p: p.grad, params),
                                 tcfg)
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        w = ref["train/grad/" + jax.tree_util.keystr(path)].astype(np.float64)
        g = np.asarray(g, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)


def _count_k1(monkeypatch):
    calls = []
    orig = kops.expert_ffn

    def rec(h, *a, **kw):
        calls.append(tuple(h.shape))
        return orig(h, *a, **kw)

    monkeypatch.setattr(kops, "expert_ffn", rec)
    return calls


def test_ep_serve_launcher_cpu_end_to_end(monkeypatch, capsys):
    """--model-axis 4 through the launcher: K1 once per MoE sublayer in
    each batched prefill and decode step (every rank's rows in one call),
    decode bit-equal to --model-axis 1 at the reduced config's f32."""
    argv = ["--reduced", "--batch", "4", "--prompt-len", "16", "--gen", "4",
            "--prefill", "batch", "--device", "cpu"]
    calls = _count_k1(monkeypatch)
    ep = tserve.main(argv + ["--model-axis", "4"])
    n_layers = reduced(get_config("moe-gpt2")).num_layers
    assert len(calls) == n_layers * (tserve.N_BATCHED_PREFILLS + 16 + 4)
    E4 = reduced(get_config("moe-gpt2")).moe.num_experts
    assert {c[0] for c in calls} == {E4}
    assert "prefill seq_sharded=True" in capsys.readouterr().out
    one = tserve.main(argv)
    assert ep["model_axis"] == 4 and one["model_axis"] == 1
    assert torch.equal(ep["tokens"], one["tokens"])
    for a, b in zip(ep["step_logits"] + ep["gen_logits"],
                    one["step_logits"] + one["gen_logits"]):
        assert torch.equal(a, b)
    assert torch.isfinite(ep["prefill_logits"]).all()


def test_hymba_model_axis_changes_nothing():
    """An arch without MoE sublayers takes --model-axis and serves the
    same bits."""
    argv = ["--arch", "hymba-1.5b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "2", "--prefill", "batch",
            "--device", "cpu"]
    one = tserve.main(argv)
    ep = tserve.main(argv + ["--model-axis", "4"])
    assert torch.equal(ep["prefill_logits"], one["prefill_logits"])
    assert torch.equal(ep["tokens"], one["tokens"])
    for a, b in zip(ep["step_logits"] + ep["gen_logits"],
                    one["step_logits"] + one["gen_logits"]):
        assert torch.equal(a, b)


def test_seq_sharded_train_launcher_cpu(capsys):
    res = ttrain.main(["--reduced", "--steps", "2", "--model-axis", "4",
                       "--global-batch", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res["dist"].seq_sharded
    assert not res["luffy"].enable_condensation
    assert not res["luffy"].enable_migration
    assert "sequence-sharded, condensation and migration off" in out
    for s in res["steps"]:
        assert np.isfinite(s["loss"]) and s["condense_rate"] == 0.0
        assert s["local_frac"] == 0.25


def test_unsplittable_shapes_raise():
    """A sequence that does not split over the model axis."""
    _, tcfg = _cfgs("float32")
    model = build_model(tcfg, device="cpu", seed=0)
    pd = make_dist(_mesh(), "prefill", 2, moe_arch=True)
    toks = torch.ones((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="10 positions does not split"):
        model.prefill(toks, 12, luffy=LuffyConfig(**SERVE), dist=pd)
