"""The port's expert FFN (kernel K1) against the reference.

On the CPU the port's ``ops.expert_ffn`` takes the kernel's plain
version; it is held against ``repro.kernels.ref.expert_ffn_ref`` and the
Pallas kernel in interpret mode (which rejects ragged R, so R=160 goes
against the ref only). Tolerances follow ``tests/test_kernels.py``:
1e-4 for f32, 5e-2 for bf16. The CUDA kernel itself runs only on the
card: ``tests/test_torch_gpu.py`` holds it against this plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import expert_ffn as kexp
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(E, R, d, F, seed=0):
    r = np.random.default_rng(seed)
    h = r.standard_normal((E, R, d)).astype(np.float32)
    ws = [(r.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((E, d, F), (E, d, F), (E, F, d))]
    return h, ws


def _port(h, ws, h_dtype, act):
    th = torch.as_tensor(h).to(getattr(torch, h_dtype))
    return ops.expert_ffn(th, *[torch.as_tensor(w) for w in ws], act)


@pytest.mark.parametrize("E,R,d,F", [(2, 128, 128, 256), (4, 8, 64, 192)])
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_matches_reference_and_pallas(E, R, d, F, h_dtype, act):
    h, ws = _inputs(E, R, d, F)
    got = _port(h, ws, h_dtype, act)
    assert got.dtype == getattr(torch, h_dtype)
    jh = jnp.asarray(h).astype(h_dtype)
    jw = [jnp.asarray(w) for w in ws]
    tol = TOL[h_dtype]
    for want in (jref.expert_ffn_ref(jh, *jw, act),
                 jops.expert_ffn(jh, *jw, act, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ragged_rows_match_reference(h_dtype, act):
    h, ws = _inputs(2, 160, 64, 128, seed=1)
    got = _port(h, ws, h_dtype, act)
    want = jref.expert_ffn_ref(jnp.asarray(h).astype(h_dtype),
                               *[jnp.asarray(w) for w in ws], act)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[h_dtype], rtol=TOL[h_dtype])


def test_dispatch_is_by_device():
    """CPU tensors take the plain version; any other device without a
    kernel raises, and the CUDA wrapper refuses non-CUDA tensors."""
    h, ws = _inputs(1, 8, 16, 32)
    before = kexp.expert_ffn.launches
    got = _port(h, ws, "float32", "silu")
    want = ref.expert_ffn_ref(torch.as_tensor(h),
                              *[torch.as_tensor(w) for w in ws], "silu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kexp.expert_ffn.launches == before
    meta = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no version"):
        ops.expert_ffn(meta, meta, meta, meta, "silu")
    with pytest.raises(ValueError, match="CUDA device"):
        kexp.expert_ffn(*[torch.as_tensor(a) for a in (h, *ws)], "silu")


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bwd_bf16_rounding_model_matches_reference_grad(act, w_dtype):
    """The tensor-core backward's arithmetic (bf16 h and dy; the weights,
    P, DU and DG as bf16 hi + lo terms; f32 sums; dh in bf16) against
    jax.grad of the reference's f32 expert FFN and against autograd
    through the port's f32 plain version, at ragged R = 160, within the
    bf16 tolerance."""
    h, ws = _inputs(4, 160, 128, 192, seed=5)
    dy = np.random.default_rng(6).standard_normal(h.shape).astype(np.float32)
    th = torch.as_tensor(h).to(torch.bfloat16)
    tdy = torch.as_tensor(dy).to(torch.bfloat16)
    tw = [torch.as_tensor(w).to(getattr(torch, w_dtype)) for w in ws]
    got = ref.expert_ffn_bwd_bf16_ref(th, *tw, tdy, act)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    tol = TOL["bfloat16"]
    args = [jnp.asarray(t.float().numpy()) for t in (th, *tw)]
    _, vjp = jax.vjp(lambda *a: jref.expert_ffn_ref(*a, act), *args)
    want = vjp(jnp.asarray(tdy.float().numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   atol=tol, rtol=tol)
    leaves = [t.float().requires_grad_() for t in (th, *tw)]
    ref.expert_ffn_ref(*leaves, act).backward(tdy.float())
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g.float(), leaf.grad, atol=tol, rtol=tol)


def test_bf16_split_holds_sixteen_bits():
    """hi + lo of ``bf16_split`` within 2^-16 of x (relative); a bf16 x is
    its own hi with lo = 0."""
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(4096)
                        .astype(np.float32)) * 10.0
    hi, lo = ref.bf16_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.all((hi.float() + lo.float() - x).abs()
                     <= x.abs() * 2.0 ** -16)
    xb = x.to(torch.bfloat16)
    hb, lb = ref.bf16_split(xb)
    assert torch.equal(hb, xb) and torch.all(lb == 0)
