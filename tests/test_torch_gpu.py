"""Hand-written CUDA kernels of repro_torch against their plain PyTorch
versions, on the card. Marked ``gpu``: each test skips, from inside the
test, where there is no CUDA device. This file imports no JAX, so it
runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import expert_ffn as kexp
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(E, R, d, F, seed=0):
    r = np.random.default_rng(seed)
    h = r.standard_normal((E, R, d)).astype(np.float32)
    ws = [(r.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((E, d, F), (E, d, F), (E, F, d))]
    return h, ws


@pytest.mark.gpu
@pytest.mark.parametrize("R", [8, 160, 256])
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_kernel_matches_plain(R, h_dtype, act):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, ws = _inputs(4, R, 256, 512, seed=2)
    before = kexp.expert_ffn.launches
    th = torch.as_tensor(h).to(getattr(torch, h_dtype)).cuda()
    tw = [torch.as_tensor(w).cuda() for w in ws]
    got = ops.expert_ffn(th, *tw, act)
    torch.cuda.synchronize()
    assert kexp.expert_ffn.launches == before + 1
    want = ref.expert_ffn_ref(th, *tw, act)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[h_dtype], rtol=TOL[h_dtype])


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 256, 512), (4, 160, 256, 512),
                                   (4, 256, 256, 512), (16, 8, 768, 3072),
                                   (16, 160, 768, 3072),
                                   (16, 2048, 768, 3072)])
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_backward_matches_plain(shape, h_dtype, act):
    """K1's CUDA backward against autograd through the plain version, at
    small widths and at moe-gpt2's (R = 2048 is the train shape)."""
    _cuda_or_skip()
    E, R, d, F = shape
    h, ws = _inputs(E, R, d, F, seed=3)
    dy = np.random.default_rng(4).standard_normal(h.shape).astype(np.float32)
    dt = getattr(torch, h_dtype)
    th = torch.as_tensor(h).to(dt).cuda().requires_grad_()
    tw = [torch.as_tensor(w).cuda().requires_grad_() for w in ws]
    tdy = torch.as_tensor(dy).to(dt).cuda()
    before = (kexp.expert_ffn.launches, kexp.expert_ffn_bwd.launches)
    ops.expert_ffn(th, *tw, act).backward(tdy)
    torch.cuda.synchronize()
    assert (kexp.expert_ffn.launches, kexp.expert_ffn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    got = [th.grad] + [w.grad for w in tw]
    rh = th.detach().clone().requires_grad_()
    rw = [w.detach().clone().requires_grad_() for w in tw]
    ref.expert_ffn_ref(rh, *rw, act).backward(tdy)
    want = [rh.grad] + [w.grad for w in rw]
    for name, g, w in zip(("dh", "dw_up", "dw_gate", "dw_down"), got, want):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[h_dtype],
                                   rtol=TOL[h_dtype], msg=name)
    # no atomics, no split reduction: a second launch repeats bit for bit
    again = kexp.expert_ffn_bwd(th.detach(), *(w.detach() for w in tw),
                                tdy, act)
    assert torch.equal(again[0], got[0])
    assert all(torch.equal(a, g) for a, g in zip(again[1:], got[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("NG,G,d", [(64, 128, 768), (3, 96, 40),
                                    (3, 200, 64)])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_masked_similarity_kernel_matches_plain(NG, G, d, x_dtype):
    """K2 against its plain version, at the train path's 64 groups of
    [128, 768] and at ragged sizes; whole masked-off tiles come back
    exactly zero (the tile early-out)."""
    from repro_torch.kernels import similarity as ksim
    _cuda_or_skip()
    r = np.random.default_rng(5)
    x = torch.as_tensor(r.standard_normal((NG, G, d)).astype(np.float32))
    x = x.to(getattr(torch, x_dtype)).cuda()
    mask = torch.as_tensor(r.random((NG, G, G)) < 0.4).cuda()
    mask[1] = False                          # a group with nothing to measure
    mask[2, :64, 64:] = False                # one skipped tile
    before = ksim.masked_similarity.launches
    got = ops.masked_similarity(x, mask)
    torch.cuda.synchronize()
    assert ksim.masked_similarity.launches == before + 1
    want = ref.masked_similarity_ref(x, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[1] == 0) and torch.all(got[2, :64, 64:] == 0)
    assert torch.all(got[~mask] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,n_idx", [(8192, 768, 8192), (1000, 7, 1000),
                                       (2048, 64, 32)])
def test_gather_rows_kernel_bitwise_and_grad(dtype, T, d, n_idx):
    """K3 and its backward at the train path's [8192, 768], at a ragged
    row size, and with long runs of one representative (32 of 2048 rows
    taken). The backward is bitwise the plain version on the CPU, which
    sums in the same order, and repeats bit for bit."""
    from repro_torch.kernels import condense as kcond
    _cuda_or_skip()
    r = np.random.default_rng(6)
    y = torch.as_tensor(r.standard_normal((T, d)).astype(np.float32))
    y = y.to(getattr(torch, dtype)).cuda().requires_grad_()
    idx = torch.as_tensor(r.integers(0, n_idx, T)).cuda()
    before = (kcond.gather_rows.launches, kcond.gather_rows_bwd.launches)
    got = ops.gather_rows(y, idx)
    torch.cuda.synchronize()
    assert kcond.gather_rows.launches == before[0] + 1
    assert torch.equal(got, ref.gather_rows_ref(y, idx))
    dy = torch.as_tensor(r.standard_normal((T, d)).astype(np.float32))
    dy = dy.to(y.dtype).cuda()
    got.backward(dy)
    torch.cuda.synchronize()
    assert kcond.gather_rows_bwd.launches == before[1] + 1
    want = ref.gather_rows_bwd_ref(dy.cpu(), idx.cpu(), T)
    assert y.grad.dtype == y.dtype
    assert torch.equal(y.grad.cpu(), want)
    assert torch.equal(kcond.gather_rows_bwd(dy, idx, T), y.grad)
