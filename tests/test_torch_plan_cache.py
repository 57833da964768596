"""The port's plan format, plan cache and serving templates
(``repro_torch.plan.serial``, ``repro_torch.plan.cache``,
``instantiate_plan``) against the JAX reference's, on the CPU, in
process.

- A reference ``to_bytes`` of a serving template, and of a one-device
  plan (condensed, with reuse signatures), loads through the port's
  ``from_bytes`` with every field equal; the port's blob of the same
  template is byte-equal to the reference's, one device and over 4
  ranks (pipelined, with its estimate), and the reference loads it; bf16
  arrays cross both ways as raw 16-bit words; a bad magic, another
  version or another params version raises ``PlanFormatError``.
- ``plan_key`` and ``topology_fingerprint`` slugs equal the reference's.
- ``PlanCache``: memory, disk spill, LRU eviction, a cold cache served
  from disk and a corrupt file as a miss (``tests/test_plan_cache.py``).
- A template-bound exchange is bit for bit a built one, one device and
  over 4 ranks; a warm-cache prefill and decode (the serve launcher with
  ``--plan-cache --precompute-plans``) make zero ``build_exchange_plan``
  calls with logits and tokens bit for bit the uncached run's.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.comm import CommContext as JComm
from repro.comm.topology import Topology as JTopology
from repro.config import LuffyConfig as JLuffy
from repro.configs import get_config as jget_config
from repro.core import moe_layer as jml
from repro.core.gating import gate_apply as jgate_apply
from repro.plan import cache as jcache
from repro.plan import exchange as jexchange
from repro.plan import serial as jserial

import repro_torch.plan.exchange as tex
from repro_torch.comm.hierarchical import CommContext
from repro_torch.comm.topology import Topology
from repro_torch.config import LuffyConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core import moe_layer as tmoe
from repro_torch.core.gating import gate_apply
from repro_torch.launch import serve as tserve
from repro_torch.plan import cache as tcache
from repro_torch.plan import serial as tserial


def _np(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


TEMPLATES = [
    # (comm mode, M, exec mode, pipeline chunks, wire dtype, hier dedup)
    ("local", 1, "sync", 4, "f32", "off"),
    ("flat", 4, "pipeline", 4, "f32", "off"),
    ("hier", 4, "pipeline", 0, "f8e4m3", "on"),
    ("hier", 4, "sync", 4, "bf16", "off"),
]


def _templates(cm, M, ex, nc, wd, dd):
    kw = dict(exec_mode=ex, pipeline_chunks=nc, wire_dtype=wd,
              hier_dedup=dd, comm_mode=cm if M > 1 else "flat",
              enable_condensation=False, enable_migration=False)
    cfg, jcfg = get_config("moe-gpt2"), jget_config("moe-gpt2")
    shape = dict(n_seq=2, seq_len=512, capacity=256)
    if M == 1:
        comm, jkw = None, {}
    else:
        topo = Topology(2, 2) if cm == "hier" else Topology.flat(4)
        jtopo = JTopology(2, 2) if cm == "hier" else JTopology.flat(4)
        comm = CommContext.build(cm, M, topo)
        jkw = dict(comm_mode=cm, topo=jtopo, M=M,
                   axes=("node", "local") if cm == "hier" else ("model",))
    t = tcache.build_plan_template(cfg, LuffyConfig(**kw), comm=comm,
                                   **shape)
    j = jcache.build_plan_template(jcfg, JLuffy(**kw), **shape, **jkw)
    return t, j


@pytest.mark.parametrize("spec", TEMPLATES)
def test_template_blobs_byte_equal(spec):
    t, j = _templates(*spec)
    blob, jblob = tserial.to_bytes(t), jserial.to_bytes(j)
    assert blob == jblob
    assert tserial.to_bytes(t, params_version="7") == \
        jserial.to_bytes(j, params_version="7")
    back = jserial.from_bytes(blob)            # the reference reads it
    assert back.chunks == j.chunks and back.estimate == j.estimate
    got = tserial.from_bytes(jblob)            # and the port the reference's
    for f in ("mode", "migrate", "condense", "pipelined", "capacity",
              "objective", "group_size", "combine_slack", "use_kernel",
              "wire", "wire_dtype"):
        assert getattr(got, f) == getattr(j, f), f
    assert tuple(got.chunks) == tuple(j.chunks)
    assert got.estimate == t.estimate and (got.estimate is None) == \
        (j.estimate is None)
    if j.estimate is not None:
        assert tuple(got.estimate) == tuple(j.estimate)
    assert got.comm == t.comm
    assert tserial.to_bytes(got) == jblob


def _ref_plan(reuse: bool, gate_dtype=None):
    """A one-device reference plan, condensed, built eagerly."""
    from repro.models.blocks import _dtype
    cfg = dataclasses.replace(jget_config("moe-gpt2"), d_model=32,
                              num_layers=2, compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, d_ff=64))
    import jax
    p = jml.moe_init(jax.random.PRNGKey(0), cfg)
    r = np.random.default_rng(1)
    x = jnp.asarray(r.standard_normal((2, 16, 32)), jnp.float32)
    sb = {"labels": jnp.zeros((2, 16), jnp.int32),
          "seq_len": jnp.asarray([12, 16], jnp.int32)}
    luffy = JLuffy(enable_condensation=True, enable_migration=False,
                   condense_group=16,
                   plan_reuse="signature" if reuse else "off",
                   condense_reuse="signature" if reuse else "off")
    xn = jml._rms(x.reshape(-1, 32), p["norm"]["scale"]).astype(
        _dtype(cfg.compute_dtype))
    gate = jgate_apply(p["router"], xn, cfg.moe.top_k)
    carry = None
    if reuse:
        from repro.condense.plan import CondenseCarry
        carry = CondenseCarry(jnp.zeros((32,), jnp.int32),
                              jnp.zeros((32,), jnp.int32),
                              jnp.zeros((2,), jnp.float32),
                              jnp.zeros((2,), jnp.float32))
    plan = jexchange.build_exchange_plan(
        gate, xn, cfg, luffy, JComm.local(), mode="vanilla", capacity=64,
        sideband=sb, threshold=jnp.float32(0.9), group_size=16,
        reuse_from=jexchange.invalid_signature(2, 1) if reuse else None,
        condense_reuse_from=carry)
    if gate_dtype is not None:
        plan = plan._replace(gate_weights=plan.gate_weights.astype(
            gate_dtype))
    return plan


@pytest.mark.parametrize("reuse", [False, True])
def test_reference_plan_loads_field_for_field(reuse):
    j = _ref_plan(reuse)
    assert j.condense
    got = tserial.from_bytes(jserial.to_bytes(j))
    for f in tserial._ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if b is None:
            continue
        a, b = _np(a), np.asarray(b)
        if f in tserial._PER_RANK:            # the port's rank axis
            assert a.shape[0] == 1
            a = a[0]
        elif f in tserial._RANK_SCALARS:      # [M] = [1], a scalar there
            assert a.shape == (1,) and b.shape == ()
            b = b[None]
        elif isinstance(a, np.ndarray) and b.shape == ():
            b = b[None]                       # a scalar, 1-d in a blob
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in tserial._COND_FIELDS:
        a, b = getattr(got.condense_plan, f), getattr(j.condense_plan, f)
        assert (a is None) == (b is None), f
        if b is not None:
            a, b = _np(a), np.asarray(b)
            np.testing.assert_array_equal(a, b.reshape(a.shape), err_msg=f)
    assert (got.signature is None) == (j.signature is None) == (not reuse)
    if reuse:
        for a, b in zip(got.signature, j.signature):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(got.condense_plan.signature,
                        j.condense_plan.signature):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert got.comm == CommContext.local() and not got.migrate
    # and back: the port's blob of the loaded plan is the reference's
    assert tserial.to_bytes(got) == jserial.to_bytes(j)


def test_bf16_crosses_both_ways():
    j = _ref_plan(False, gate_dtype=jnp.bfloat16)
    got = tserial.from_bytes(jserial.to_bytes(j))
    assert got.gate_weights.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.gate_weights[0].float().numpy(),
        np.asarray(j.gate_weights).astype(np.float32))
    back = jserial.from_bytes(tserial.to_bytes(got))
    assert back.gate_weights.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back.gate_weights).view(np.uint16),
        np.asarray(j.gate_weights).view(np.uint16))
    assert ml_dtypes.bfloat16 == np.asarray(back.gate_weights).dtype


def test_format_errors():
    t, _ = _templates(*TEMPLATES[0])
    blob = tserial.to_bytes(t, params_version="3")
    with pytest.raises(tserial.PlanFormatError, match="magic"):
        tserial.from_bytes(b"XXXX" + blob[4:])
    bad = blob[:4] + (3).to_bytes(2, "little") + blob[6:]
    with pytest.raises(tserial.PlanFormatError, match="version"):
        tserial.from_bytes(bad)
    with pytest.raises(tserial.PlanFormatError, match="params_version"):
        tserial.from_bytes(blob, expect_params_version="4")
    assert tserial.from_bytes(blob, expect_params_version="3").capacity \
        == 256
    with pytest.raises(tserial.PlanFormatError):
        tserial.from_bytes(b"LF")
    two = t._replace(aux_loss=torch.zeros(2))
    with pytest.raises(TypeError, match="one rank"):
        tserial.to_bytes(two)


def test_plan_keys_equal():
    for topo, jtopo, M in ((None, None, 1),
                           (Topology(2, 2), JTopology(2, 2), 4),
                           (Topology(2, 4, inter_bw=3e9, inter_lat=1e-5),
                            JTopology(2, 4, inter_bw=3e9, inter_lat=1e-5),
                            8)):
        assert tcache.topology_fingerprint(topo, M) == \
            jcache.topology_fingerprint(jtopo, M)
        if topo is not None:
            fast = dataclasses.replace(topo, inter_bw=9e9, intra_lat=2e-6)
            jfast = jtopo.with_links(inter_bw=9e9, intra_lat=2e-6)
            assert tcache.topology_fingerprint(fast, M) == \
                jcache.topology_fingerprint(jfast, M) != \
                tcache.topology_fingerprint(topo, M)
        for mode, obj, o_ms, wd in (("vanilla", "traffic", -1.0, "f32"),
                                    ("migrate", "replicate", 0.3, "f8e4m3"),
                                    ("decode", "overlap", -1.0, "bf16")):
            kw = dict(n_seq=4, seq_len=128, d_model=768, capacity=64,
                      top_k=2, num_experts=16, mode=mode, objective=obj,
                      exec_mode="pipeline", pipeline_chunks=0,
                      comm_mode="hier", M=M, gpu_speed=1e11, d_ff=3072,
                      hier_dedup="on", params_version="2",
                      chunk_overhead_ms=o_ms, wire_dtype=wd)
            assert tcache.plan_key(topo=topo, **kw) == \
                jcache.plan_key(topo=jtopo, **kw)


def test_plan_cache_memory_disk_and_eviction(tmp_path):
    cfg = reduced(get_config("moe-gpt2"))
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    cache = tcache.PlanCache(tmp_path, mem_capacity=2)
    keys = []
    for n_seq in (1, 2, 4):
        key = tcache.plan_key(n_seq=n_seq, seq_len=16, d_model=cfg.d_model,
                              capacity=64, top_k=2, num_experts=4,
                              mode="vanilla", objective="traffic",
                              exec_mode="sync", pipeline_chunks=1,
                              comm_mode="local", topo=None, M=1)
        cache.put(key, tcache.build_plan_template(
            cfg, luffy, n_seq=n_seq, seq_len=16, capacity=64))
        keys.append(key)
    assert len(cache) == 2 and (tmp_path / f"{keys[0]}.plan").exists()
    got = cache.get(keys[0])
    assert got is not None and got.capacity == 64 and cache.disk_loads == 1
    cold = tcache.PlanCache(tmp_path)
    assert all(cold.get(k) is not None for k in keys)
    assert cold.disk_loads == 3
    (tmp_path / f"{keys[1]}.plan").write_bytes(b"garbage")
    assert tcache.PlanCache(tmp_path).get(keys[1]) is None
    assert tcache.PlanCache(tmp_path, params_version="9").get(keys[0]) \
        is None
    assert len(set(keys)) == 3


@pytest.mark.parametrize("M", [1, 4])
def test_template_exchange_equals_built(M):
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                              compute_dtype="float32")
    g = torch.Generator().manual_seed(7)
    p = tmoe.moe_init(g, cfg, device="cpu")
    n_seq, S = 2, 16
    x = torch.randn((M, n_seq, S, cfg.d_model), generator=g)
    sb = {"seq_len": torch.tensor([[12, 16]] * M, dtype=torch.int32)}
    comm = None if M == 1 else CommContext.build("flat", M,
                                                 Topology.flat(M))
    for ex in ("sync", "pipeline"):
        nl = LuffyConfig(enable_condensation=False, enable_migration=False,
                         exec_mode=ex, pipeline_chunks=2)
        xn = tex._rms(x.reshape(M, n_seq * S, -1), p["norm"]["scale"])
        gate = gate_apply(p["router"], xn, cfg.moe.top_k)
        n0 = tex.BUILD_CALLS
        built = tex.build_exchange_plan(gate, xn, cfg, nl, mode="vanilla",
                                        capacity=64, sideband=sb, comm=comm)
        assert tex.BUILD_CALLS == n0 + 1
        tmpl = tserial.from_bytes(tserial.to_bytes(
            tcache.build_plan_template(cfg, nl, n_seq=n_seq, seq_len=S,
                                       capacity=64, comm=comm)))
        inst = tex.instantiate_plan(tmpl, gate, xn, cfg, capacity=64,
                                    sideband=sb, comm=comm)
        assert tex.BUILD_CALLS == n0 + 1
        assert inst.chunks == built.chunks and \
            inst.pipelined == built.pipelined == (ex == "pipeline" and M > 1)
        y1 = tex.execute_plan(p, x, built, cfg, dict(sb))
        y2 = tex.execute_plan(p, x, inst, cfg, dict(sb))
        assert torch.equal(y1[0], y2[0])
        # the ledger, but for the template's mark (the reference's: a
        # bound template counts as a reused plan)
        for name, a, b in zip(y1[1]._fields, y1[1], y2[1]):
            if name == "plans_reused":
                assert a.sum() == 0 and torch.all(b == 1.0)
            else:
                assert torch.equal(a, b), name
        with pytest.raises(ValueError, match="decode"):
            tex.instantiate_decode_plan(tmpl, gate, xn, cfg, capacity=64,
                                        sideband=sb, comm=comm)


@pytest.mark.parametrize("model_axis", ["1", "4"])
def test_serve_warm_cache_makes_no_plans(tmp_path, capsys, model_axis):
    """The launcher with ``--plan-cache --precompute-plans``: zero
    ``build_exchange_plan`` calls after the warm-up, prefill and decode
    logits and tokens bit for bit the uncached run's."""
    args = ["--reduced", "--batch", "4", "--prompt-len", "32", "--gen", "4",
            "--prefill", "batch", "--device", "cpu", "--model-axis",
            model_axis]
    cold = tserve.main(args)
    n0 = tex.BUILD_CALLS
    warm = tserve.main(args + ["--plan-cache", str(tmp_path),
                               "--precompute-plans", "--plan-objective",
                               "replicate"])
    out = capsys.readouterr().out
    assert tex.BUILD_CALLS == n0
    assert "precomputed prefill plan: " in out and "plan_objective=" \
        "replicate" in out
    assert warm["plan_cache"]["misses"] == 0 and \
        warm["plan_cache"]["hits"] > 0
    assert torch.equal(cold["prefill_logits"], warm["prefill_logits"])
    assert torch.equal(cold["tokens"], warm["tokens"])
    for a, b in zip(cold["step_logits"] + cold["gen_logits"],
                    warm["step_logits"] + warm["gen_logits"]):
        assert torch.equal(a, b)
    # a second process over the same directory loads from disk
    again = tserve.main(args + ["--plan-cache", str(tmp_path),
                                "--plan-objective", "replicate"])
    capsys.readouterr()
    assert tex.BUILD_CALLS == n0
    assert again["plan_cache"]["disk_loads"] == 2
    assert torch.equal(again["prefill_logits"], cold["prefill_logits"])
