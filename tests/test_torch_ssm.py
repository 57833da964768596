"""The port's K5 and K6 plain versions, RoPE and the Mamba mixer
(repro_torch) against the JAX reference on the same numpy inputs.

K5: the port's plain version ``ref.flash_attention_ref`` (GQA read by
expanding KV heads) against the reference's oracle and against the
Pallas kernel in interpret mode, tolerances 2e-5 at f32 and 3e-2 at
bf16 (``tests/test_kernels.py``: f32 sums in another order; one bf16
rounding of the output). K6: the port's plain version against the
reference's oracle ``ref.mamba_scan_ref`` at 2e-5 (f32 sums over the
state in another order, through the recurrence). The Pallas K6 is not
the oracle here: on this JAX it fails in interpret mode
(``jax.experimental.pallas`` has no ``store``, ``mamba_scan.py:57``).
The Mamba mixer runs the reference's ``lax.scan`` path
(``REPRO_MAMBA_KERNEL`` unset).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jb
from repro.models import ssm as jssm

from repro_torch import convert
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as kfa
from repro_torch.kernels import mamba_scan as kms
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks as tb
from repro_torch.models import ssm as tssm

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(B, S, H, KV, hd, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _to_jax(arrs, dtype, n_rep):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrs)
    return q, jnp.repeat(k, n_rep, axis=2), jnp.repeat(v, n_rep, axis=2)


CASES = [(True, None), (True, 32), (False, None), (False, 32)]


@pytest.mark.parametrize("causal,window", CASES)
@pytest.mark.parametrize("KV", [4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_oracle(causal, window, KV, dtype):
    arrs = _qkv(2, 100, 4, KV, 32, seed=KV)            # ragged S
    got = ops.flash_attention(*(torch.as_tensor(a).to(getattr(torch, dtype))
                                for a in arrs), causal=causal, window=window)
    want = jref.flash_attention_ref(*_to_jax(arrs, dtype, 4 // KV),
                                    causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("causal,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_interpret(causal, window, dtype):
    """The Pallas K5 (interpret mode, kv expanded as it asserts) on a
    windowed GQA input of 128 positions."""
    arrs = _qkv(2, 128, 4, 2, 32, seed=7)
    got = ops.flash_attention(*(torch.as_tensor(a).to(getattr(torch, dtype))
                                for a in arrs), causal=causal, window=window,
                              scale=0.2)
    want = jops.flash_attention(*_to_jax(arrs, dtype, 2), causal=causal,
                                window=window, scale=0.2, bq=64, bk=64,
                                interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _scan_inputs(B, S, di, N, seed):
    r = np.random.default_rng(seed)
    dt = (np.abs(r.standard_normal((B, S, di))) * 0.1).astype(np.float32)
    x = r.standard_normal((B, S, di)).astype(np.float32)
    bm = r.standard_normal((B, S, N)).astype(np.float32)
    cm = r.standard_normal((B, S, N)).astype(np.float32)
    a = -np.exp(r.standard_normal((di, N))).astype(np.float32)
    return dt, x, bm, cm, a


@pytest.mark.parametrize("B,S,di,N", [(1, 32, 32, 8), (2, 64, 64, 16),
                                      (2, 100, 200, 16), (1, 1, 48, 16)])
def test_mamba_scan_plain_matches_reference_oracle(B, S, di, N):
    """y against ``ref.mamba_scan_ref``; the final state, which the
    reference's oracle drops, against the recurrence in float64."""
    arrs = _scan_inputs(B, S, di, N, seed=S + di)
    y, h = ops.mamba_scan(*map(torch.as_tensor, arrs))
    want = jref.mamba_scan_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    dt, x, bm, _, a = (v.astype(np.float64) for v in arrs)
    h64 = np.zeros((B, di, N))
    for t in range(S):
        h64 = (np.exp(dt[:, t, :, None] * a) * h64
               + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
    assert h.shape == (B, di, N) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), h64, atol=2e-5, rtol=2e-5)


def _fused_inputs(B, S, di, N, cdt, seed, dt_rank=7):
    """The fused entry's operands as ``_mamba_inner`` passes them: x in the
    compute dtype, z the second half of one [B,S,2di] product (a strided
    view), B and C column slices of one f32 projection."""
    r = np.random.default_rng(seed)
    xz = torch.as_tensor(r.standard_normal((B, S, 2 * di)),
                         dtype=torch.float32).to(getattr(torch, cdt))
    x, z = torch.chunk(xz, 2, dim=-1)
    proj = torch.as_tensor(r.standard_normal((B, S, dt_rank + 2 * N)),
                           dtype=torch.float32)
    _, bm, cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt_lin = torch.as_tensor(r.standard_normal((B, S, di)) - 1.0,
                             dtype=torch.float32)
    bias = torch.as_tensor(r.standard_normal(di) * 0.5, dtype=torch.float32)
    d_skip = torch.as_tensor(r.standard_normal(di), dtype=torch.float32)
    a = -torch.exp(torch.as_tensor(r.standard_normal((di, N)),
                                   dtype=torch.float32))
    return dt_lin, bias, x.contiguous(), z, d_skip, bm, cm, a


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,N", [(2, 70, 96, 16), (1, 33, 40, 8)])
def test_mamba_scan_fused_plain_is_the_mixers_ops(cdt, B, S, di, N):
    """The fused entry's plain version, and ``ops.mamba_scan_fused`` on
    CPU tensors, are bit for bit the op sequence the mixer ran around the
    scan before the passes were fused (softplus of dt_lin + bias, the
    f32 scan, skip, silu gate, rounding), with z a strided view."""
    dt_lin, bias, x, z, d_skip, bm, cm, a = _fused_inputs(B, S, di, N, cdt,
                                                          seed=di + S)
    assert not z.is_contiguous() and not bm.is_contiguous()
    dt = torch.logaddexp(dt_lin + bias.float(), torch.zeros(()))
    xf = x.float()
    y, h = ref.mamba_scan_ref(dt, xf, bm, cm, a)
    y = y + d_skip * xf
    y = (y * torch.nn.functional.silu(z.float())).to(x.dtype)
    got = ref.mamba_scan_fused_ref(dt_lin, bias, x, z, d_skip, bm, cm, a)
    via_ops = ops.mamba_scan_fused(dt_lin, bias, x, z, d_skip, bm, cm, a)
    for gy, gh in (got, via_ops):
        assert gy.dtype == x.dtype and torch.equal(gy, y)
        assert torch.equal(gh, h)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_mamba_scan_fused_plain_matches_reference(cdt):
    """The fused entry's plain version against the same steps of the
    reference's ``_mamba_inner`` in JAX (softplus, the oracle's scan,
    skip, gate, rounding) on the same numpy inputs, at ``MIXER_TOL``."""
    args = _fused_inputs(2, 70, 96, 16, cdt, seed=21)
    dt_lin, bias, x, z, d_skip, bm, cm, a = (
        jnp.asarray(t.float().numpy()) for t in args)
    jdt = getattr(jnp, cdt)
    xj, zj = x.astype(jdt), z.astype(jdt)
    dt = jax.nn.softplus(dt_lin + bias)
    xf = xj.astype(jnp.float32)
    want = jref.mamba_scan_ref(dt, xf, bm, cm, a)
    want = ((want + d_skip * xf) * jax.nn.silu(zj.astype(jnp.float32))
            ).astype(jdt)
    got, _ = ops.mamba_scan_fused(*args)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=MIXER_TOL[cdt], rtol=MIXER_TOL[cdt])


def test_mamba_scan_fused_dispatch():
    """CPU tensors take the fused entry's plain version and launch
    nothing; the CUDA wrapper raises on them (no fallback)."""
    args = _fused_inputs(1, 8, 16, 16, "bfloat16", seed=0)
    before = (kms.mamba_scan.launches, kms.mamba_scan_fused.launches)
    y, h = ops.mamba_scan_fused(*args)
    assert (kms.mamba_scan.launches, kms.mamba_scan_fused.launches) == before
    assert y.dtype == torch.bfloat16 and h.shape == (1, 16, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        kms.mamba_scan_fused(*args)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the ops take the plain versions and launch nothing; the
    CUDA wrappers raise on CPU tensors (no fallback)."""
    q, k, v = map(torch.as_tensor, _qkv(1, 8, 2, 1, 8, seed=0))
    arrs = [torch.as_tensor(a) for a in _scan_inputs(1, 8, 16, 16, seed=0)]
    before = (kfa.flash_attention.launches, kms.mamba_scan.launches)
    ops.flash_attention(q, k, v, window=4)
    ops.mamba_scan(*arrs)
    assert (kfa.flash_attention.launches, kms.mamba_scan.launches) == before
    with pytest.raises(ValueError, match="CUDA device"):
        kfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        kms.mamba_scan(*arrs)
    meta = torch.empty((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no version"):
        ops.flash_attention(meta, meta, meta)


def test_apply_rope():
    """Positions up to 2079 (hymba's prompt plus 32 tokens): f32 cos/sin
    of the same angles differ by a few ulps between XLA and torch, so
    1e-5 absolute on unit-scale inputs, not bitwise."""
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 40, 3, 64)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(2040, 2080)]).astype(np.int32)
    got = tb.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4)
    want = jb.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tb.rope_freqs(64, 1e4).numpy(),
                               np.asarray(jb.rope_freqs(64, 1e4)), rtol=1e-6)


def _mamba_cfgs(cdt):
    jcfg = dataclasses.replace(jreduced(jget_config("hymba-1.5b")),
                               compute_dtype=cdt)
    tcfg = dataclasses.replace(reduced(get_config("hymba-1.5b")),
                               compute_dtype=cdt)
    return jcfg, tcfg


# f32: sums in another order through the conv, projections and the
# scan; bf16: the two frameworks round the bf16 conv and silu at other
# places (one bf16 ulp of the output's unit scale)
MIXER_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_mamba_apply_matches_reference(cdt, monkeypatch):
    monkeypatch.delenv("REPRO_MAMBA_KERNEL", raising=False)
    jcfg, tcfg = _mamba_cfgs(cdt)
    p = jssm.mamba_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(6).standard_normal(
        (2, 70, jcfg.d_model)).astype(np.float32)
    want = jssm.mamba_apply(p, jcfg, jnp.asarray(x).astype(cdt))
    tp = convert.tree_to_torch(jax.tree.map(np.asarray, p))
    assert tp["a_log"].dtype == tp["d_skip"].dtype == torch.float32
    got = tssm.mamba_apply(tp, tcfg, torch.as_tensor(x).to(getattr(torch,
                                                                    cdt)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=MIXER_TOL[cdt], rtol=MIXER_TOL[cdt])


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_mamba_step_matches_reference(cdt, monkeypatch):
    """Six decode steps from the zero state: outputs and the carried h
    and conv tail."""
    monkeypatch.delenv("REPRO_MAMBA_KERNEL", raising=False)
    jcfg, tcfg = _mamba_cfgs(cdt)
    p = jssm.mamba_init(jax.random.PRNGKey(4), jcfg)
    tp = convert.tree_to_torch(jax.tree.map(np.asarray, p))
    xs = np.random.default_rng(8).standard_normal(
        (6, 2, 1, jcfg.d_model)).astype(np.float32)
    jst = jssm.mamba_init_state(jcfg, 2)
    tst = tssm.mamba_init_state(tcfg, 2, device="cpu")
    for x in xs:
        jy, jst = jssm.mamba_step(p, jcfg, jnp.asarray(x).astype(cdt), jst)
        ty, tst = tssm.mamba_step(tp, tcfg, torch.as_tensor(x).to(
            getattr(torch, cdt)), tst)
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy, np.float32),
                                   atol=MIXER_TOL[cdt], rtol=MIXER_TOL[cdt])
    for key in ("h", "conv"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   atol=MIXER_TOL[cdt], rtol=MIXER_TOL[cdt])
