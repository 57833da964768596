"""llama4-maverick-400b-a17b in the port against the JAX reference, on
the CPU, at its reduced size: the shared expert beside the routed ones,
the 3:1 chunked-local:global attention, and ``decode_overlap``'s
pricing.

The parity tests cut the reduced config to two layers, a chunked-local
one and the global one (the launcher runs the whole reduced period).

- Serving (reduced at a sequence hint of 32, so each chunk is 16 and the
  prompt of 24 crosses a chunk boundary; bf16 parameters, f32 compute):
  the batched prefill, the step-wise feed and 4 greedy tokens against
  the reference's serve engine (its Pallas expert FFN interpreted), with
  ``test_torch_archs.py``'s helpers, logits within 1e-4 and greedy
  tokens equal; ``attn_apply(flash=True)`` on the CPU
  (K5's plain version, the chunks folded into the batch) against the
  reference's ``attn_apply`` with its chunked mask, at S a multiple of
  the chunk, with a ragged tail and inside one chunk, 1e-5.
- The train step (reduced, f32 parameters, condensation on) against
  ``jax.grad`` of the reference's ``use_kernels=False`` path (K2's
  formula patched into this process only, as ``test_torch_archs.py``
  does): rep maps equal, loss within 1e-5, every gradient leaf within
  1e-3 relative, the shared expert's leaves included.
- Migrate mode over 4 virtual ranks (condensation off), the forward
  against the reference's 4-device ``(node=2, local=2)`` host mesh in a
  subprocess: loss within 1e-5, migration perms and the ledger bit for
  bit. There the shared expert reads ``rms(y)``, the post-combine hidden
  at the sequences' new homes, as the reference has it.
- ``decode_overlap`` serves sync's tokens and logits bit for bit (the
  port's decode has no collective to overlap); the modeled dry run's
  ledger for the full config and the serve launcher's tuned knobs equal
  the reference's, both pricing the shared FFN.
- Training llama4 (bf16 parameters) raises, naming item 8.7.
The port's side runs on one torch thread (see ``test_torch_archs.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.condense.backends as jbackends
import repro.condense.plan as jplan
from repro.comm.topology import Topology as JTopology
from repro.config import SHAPES as JSHAPES
from repro.config import LuffyConfig as JLuffy
from repro.config import ShapeConfig as JShape
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import single_device
from repro.launch.mesh import PEAK_FLOPS_BF16 as JPEAK
from repro.models import blocks as jb
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild_model
from repro.obs import autotune as jat

import repro_torch.condense.plan as tplan
from repro_torch import convert, optim, train_lib
from repro_torch.config import SHAPES, LuffyConfig, ShapeConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core.moe_layer import capacity_for
from repro_torch.dist import make_dist
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import blocks as tb
from repro_torch.models import transformer as ttf
from tests.test_torch_archs import (GEN, S, _jax_serve, _k2_cosine,
                                    _one_torch_thread, _record, _torch_serve)

ARCH = "llama4-maverick-400b-a17b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
SEQ_HINT = 32        # reduced chunks of 16
B = 2
TB, TS, THR = 2, 128, 0.6
MB, MS, M, NODES, SLACK = 8, 128, 4, 2, 4.0

assert _one_torch_thread   # the module fixture, applied here too


def _cfgs(compute_dtype="float32", seq_len_hint=SEQ_HINT, pair=True, **kw):
    """The reference's reduced config and the port's; with ``pair`` (the
    parity tests') cut to two layers, the period's first and last: one
    chunked-local layer and the global one, the two layer kinds (as
    ``test_torch_archs.py`` cuts its head-dim variants)."""
    out = []
    for red, get in ((jreduced, jget_config), (reduced, get_config)):
        cfg = red(get(ARCH), seq_len_hint=seq_len_hint)
        if pair:
            wp = cfg.attn.window_pattern
            cfg = dataclasses.replace(cfg, num_layers=2, attn=dataclasses.
                                      replace(cfg.attn,
                                              window_pattern=(wp[0], wp[-1])))
        out.append(dataclasses.replace(cfg, compute_dtype=compute_dtype,
                                       **kw))
    return out


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = _cfgs()
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    ref = _jax_serve(jcfg, params, prompts)
    return ref, _torch_serve(tcfg, jax.tree.map(np.asarray, params),
                             prompts, ref["tokens"])


def test_reduced_config_keeps_the_chunks_and_the_shared_expert():
    _, tcfg = _cfgs(pair=False)
    assert tcfg.num_layers == 4
    assert tcfg.attn.window_pattern == (16, 16, 16, None)
    assert tcfg.attn.chunked_local and tcfg.moe.num_shared_experts == 1
    assert tcfg.param_dtype == "bfloat16" and S > 16
    p = ttf.init_params(tcfg, generator=torch.Generator(), device="cpu")
    sh = p["layers"][0]["moe"]["shared"]
    d, f = tcfg.d_model, tcfg.moe.d_ff
    assert sh["w_up"].shape == sh["w_gate"].shape == (d, f)
    assert sh["w_down"].shape == (f, d)
    assert p["layers"][0]["moe"]["experts"]["w_up"].dtype == torch.bfloat16


def test_serve_prefill_logits(served):
    ref, got = served
    assert got["prefill"].shape == ref["prefill"].shape
    np.testing.assert_allclose(got["prefill"], ref["prefill"], atol=1e-4,
                               rtol=0)


def test_serve_decode_past_the_chunk(served):
    """The step feed's last logits (24 positions: the second chunk's
    keys only in the chunked layers) and every greedy step's, and the
    greedy tokens."""
    ref, got = served
    np.testing.assert_allclose(got["step_last"], ref["step_last"],
                               atol=1e-4, rtol=0)
    for i in range(GEN):
        np.testing.assert_allclose(got["gen"][i], ref["gen"][i], atol=1e-4,
                                   rtol=0, err_msg=f"gen {i}")
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


@pytest.mark.parametrize("seq", [48, 40, 12])
def test_flash_chunked_against_the_reference_mask(seq):
    """A chunked-local layer (chunk 16) through ``attn_apply(flash=True)``
    on the CPU, the chunks folded into the batch for K5's plain version
    (48: three whole chunks; 40: two and a tail of 8; 12: inside one),
    against the reference's ``attn_apply`` (``attend`` with the mask
    ``q // W == k // W``), f32."""
    jcfg, tcfg = _cfgs()
    a = tcfg.attn
    r = np.random.default_rng(seq)
    d = tcfg.d_model
    p = {n: r.standard_normal(s).astype(np.float32) / np.sqrt(d) for n, s in
         (("wq", (d, a.q_dim)), ("wk", (d, a.kv_dim)),
          ("wv", (d, a.kv_dim)), ("wo", (a.q_dim, d)))}
    x = r.standard_normal((3, seq, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (3, seq))
    want = jax.jit(lambda p_, x_, pos_: jb.attn_apply(
        p_, jcfg, x_, pos_, layer=0, causal=True)[0])(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos))
    got = tb.attn_apply({k: torch.as_tensor(v) for k, v in p.items()}, tcfg,
                        torch.as_tensor(x), torch.as_tensor(pos), layer=0,
                        causal=True, flash=True)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_flash_chunked_counts_its_launches(monkeypatch):
    """The fold launches K5 once for whole chunks, twice with a tail,
    once inside one chunk, and the result is the per-row causal
    attention of each chunk."""
    calls = []
    orig = tb.ops.flash_attention

    def count(q, k, v, **kw):
        calls.append((tuple(q.shape), kw.get("window")))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(tb.ops, "flash_attention", count)
    r = torch.Generator().manual_seed(0)
    for S_, want in ((32, [((6, 16, 4, 8), None)]),
                     (40, [((6, 16, 4, 8), None), ((3, 8, 4, 8), None)]),
                     (10, [((3, 10, 4, 8), None)])):
        q = torch.randn((3, S_, 4, 8), generator=r)
        k, v = (torch.randn((3, S_, 2, 8), generator=r) for _ in range(2))
        calls.clear()
        got = tb.flash_chunked(q, k, v, 16, causal=True, scale=0.3)
        assert calls == want, S_
        for c0 in range(0, S_, 16):
            sl = slice(c0, c0 + 16)
            np.testing.assert_allclose(
                got[:, sl], orig(q[:, sl], k[:, sl], v[:, sl], causal=True,
                                 scale=0.3), atol=1e-6, rtol=0)


def test_train_step_matches_jax_grad(monkeypatch):
    """One device, condensation on, f32 parameters: the shared expert's
    gradients come through the same step."""
    monkeypatch.setattr(jbackends, "pairwise_cosine", _k2_cosine)
    jcfg, tcfg = _cfgs(seq_len_hint=TS, param_dtype="float32")
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    batch = JSyntheticLM(jcfg, JShape("train", TS, TB, "train")).batch(0)
    cap = capacity_for(tcfg.moe, TB * TS, tcfg.moe.num_experts)
    j_reps, t_reps = [], []
    _record(monkeypatch, jplan, j_reps, True)
    _record(monkeypatch, tplan, t_reps, False)
    jbt = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        return jtf.forward_train(p, jcfg, JLuffy(use_kernels=False),
                                 single_device(), jbt, jnp.float32(THR), cap)

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
    assert any("shared" in jax.tree_util.keystr(p) for p in want)
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-3, (jax.tree_util.keystr(path), err)


# --- migrate mode over 4 ranks ----------------------------------------------

MIGRATE_KEYS = ("local_frac", "traffic_before", "traffic_after",
                "dispatch_drop", "combine_drop")

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.core.moe_layer as jml
    from repro import train_lib
    from repro.config import LuffyConfig, ShapeConfig, reduced
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.dist import make_dist
    from repro.launch.mesh import make_host_mesh, topology_for_mesh
    from repro.models.model import build_model
    ARCH, B, S, M, NODES, THR, SLACK, KEYS = %s
    mesh = make_host_mesh(model=M, nodes=NODES)
    dist = make_dist(mesh, "train", B, moe_arch=True,
                     topology=topology_for_mesh(mesh))
    shape = ShapeConfig("train", S, B, "train")
    cfg = reduced(get_config(ARCH), seq_len_hint=S)
    wp = cfg.attn.window_pattern
    cfg = dataclasses.replace(cfg, num_layers=2, attn=dataclasses.replace(
        cfg.attn, window_pattern=(wp[0], wp[-1])), param_dtype="float32",
        compute_dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLM(cfg, shape).batch(0).items()}
    lf = LuffyConfig(enable_condensation=False, combine_slack=SLACK)
    cap = train_lib.capacity_for_bucket(cfg, shape, dist, lf, 0)
    rec = []
    orig = jml.build_exchange_plan

    def wrap(*a, **kw):
        pl = orig(*a, **kw)
        jax.debug.callback(
            lambda i, dg: rec.append((int(i), np.asarray(dg))),
            pl.comm.index(), pl.dest_global)
        return pl

    jml.build_exchange_plan = wrap
    loss, m = jax.jit(lambda p, b: build_model(cfg).train_loss(
        p, b, jnp.float32(THR), luffy=lf, dist=dist, capacity=cap))(
        params, batch)
    jax.effects_barrier()
    out = {"loss": np.float32(loss), "cap": np.int64(cap)}
    for k in KEYS:
        out[k] = np.float32(m[k])
    seen = {}
    for i, dg in rec:
        layer = seen.get(i, 0)
        seen[i] = layer + 1
        out[f"perm{layer}/{i}"] = dg
    np.savez(sys.argv[1], **out)
    print("OK")
""") % repr((ARCH, MB, MS, M, NODES, THR, SLACK, MIGRATE_KEYS))


@pytest.fixture(scope="module")
def migrate_oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("shared") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", ORACLE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def test_migrate_forward_matches_reference(migrate_oracle, monkeypatch):
    """Migration on, condensation off, f32: the shared expert on the
    migrated hidden ``rms(y)``."""
    import repro_torch.plan.exchange as tex
    ref = migrate_oracle
    jcfg, tcfg = _cfgs(seq_len_hint=MS, param_dtype="float32")
    # the subprocess's parameters: the same init, drawn again here
    np_params = jax.tree.map(np.asarray,
                             jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    plans = []
    orig = tex.build_exchange_plan

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        plans.append(pl)
        return pl

    monkeypatch.setattr(tex, "build_exchange_plan", rec)
    dist = make_dist(make_host_mesh(model=M, nodes=NODES), "train", MB,
                     moe_arch=True)
    lf = LuffyConfig(enable_condensation=False, combine_slack=SLACK)
    shape = ShapeConfig("t", MS, MB, "train")
    cap = train_lib.capacity_for_bucket(tcfg, shape, lf, 0, dist)
    assert cap == int(ref["cap"])
    batch = JSyntheticLM(jcfg, JShape("t", MS, MB, "train")).batch(0)
    loss, m = ttf.forward_train(convert.from_reference(np_params, tcfg),
                                tcfg, lf, {k: torch.as_tensor(v) for k, v in
                                           batch.items()},
                                torch.tensor(THR), cap, dist=dist)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    for k in MIGRATE_KEYS:
        assert np.float32(m[k].item()) == ref[k], k
    assert m["traffic_after"] < m["traffic_before"]
    assert len(plans) == tcfg.num_layers
    for layer, pl in enumerate(plans):
        assert pl.migrate
        for r in range(M):
            np.testing.assert_array_equal(pl.dest_global[r].numpy(),
                                          ref[f"perm{layer}/{r}"])


# --- decode_overlap ----------------------------------------------------------

SERVE = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "20",
         "--gen", "4", "--model-axis", "4", "--prefill", "batch", "--device",
         "cpu"]


def test_decode_overlap_is_sync_bit_for_bit():
    runs = {mode: tserve.main(SERVE + ["--exec-mode", mode])
            for mode in ("sync", "decode_overlap")}
    a, b = runs["sync"], runs["decode_overlap"]
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["prefill_logits"], b["prefill_logits"])
    for x, y in zip(a["step_logits"] + a["gen_logits"],
                    b["step_logits"] + b["gen_logits"]):
        assert torch.equal(x, y)


def test_dryrun_ledger_prices_the_shared_ffn():
    """The modeled ledger of the full config, decode section included,
    equals the reference's (the port's peak set to the reference's)."""
    from repro.launch.dryrun import comm_traffic_ledger as jledger
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  devices=np.zeros((16, 16)))
    tmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  devices=np.zeros((16, 16)))
    for shape in ("train_4k", "decode_32k"):
        want = jledger(jget_config(ARCH), JSHAPES[shape], jmesh, nodes=4)
        got = tdry.comm_traffic_ledger(get_config(ARCH), SHAPES[shape],
                                       tmesh, peak_flops=JPEAK, nodes=4)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True), shape
        assert got["decode"]["shared_ffn_ms"] > 0.0
        assert got["decode"]["overlap_ms"] < got["decode"]["sync_ms"]


def test_serve_autotune_prices_the_shared_ffn(tmp_path):
    """The serve launcher's search: the reference's search on the same
    workload, shared FFN included (``d_ff_shared``), knob for knob; the
    reference given the port's FFN speed, the card's peak."""
    from repro_torch.obs.autotune import DEFAULT_FFN_SPEED
    res = tserve.main(SERVE + ["--autotune", str(tmp_path)])
    tuned = res["tuned"]
    _, tcfg = _cfgs(pair=False)
    Bv, Sv = 2, 20
    want = jat.autotune_config(
        topo=JTopology.flat(M), backend="cpu", tokens=Bv * Sv,
        top_k=tcfg.moe.top_k, d_model=tcfg.d_model, d_ff=tcfg.moe.d_ff,
        num_layers=tcfg.num_layers, n_slots=Bv,
        num_experts=tcfg.moe.num_experts, group_size=min(128, Sv),
        decode_tokens=Bv, d_ff_shared=tcfg.moe.d_ff,
        ffn_speed=DEFAULT_FFN_SPEED)
    assert tuned.workload["d_ff_shared"] == tcfg.moe.d_ff > 0
    assert tuned.key == want.key
    assert tuned.knobs == want.knobs
    assert tuned.workload == want.workload
    assert tuned.modeled_step_ms == want.modeled_step_ms
    assert tuned.default_step_ms == want.default_step_ms
    assert json.dumps(tuned.top) == json.dumps(want.top)


def test_llama4_does_not_train_yet():
    from repro_torch.launch import train as ttrain
    with pytest.raises(NotImplementedError, match="item 8.7"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1",
                     "--seq-len", "128", "--global-batch", "2", "--device",
                     "cpu"])
    with pytest.raises(NotImplementedError, match="item 8.7"):
        train_lib.check_trainable(get_config(ARCH))
