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
@pytest.mark.parametrize("shape", [(4, 8, 256, 512), (4, 160, 192, 320),
                                   (16, 160, 768, 3072)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_tensor_cores_bf16_weights(shape, act):
    """K1's tensor-core route with bf16 weights passed in directly (no
    cast), at F and d multiples of 64 but not of 128 (columns past N in
    the last tile) and at moe-gpt2's widths; a second launch repeats bit
    for bit."""
    _cuda_or_skip()
    E, R, d, F = shape
    h, ws = _inputs(E, R, d, F, seed=8)
    th = torch.as_tensor(h).to(torch.bfloat16).cuda()
    tw = [torch.as_tensor(w).to(torch.bfloat16).cuda() for w in ws]
    assert kexp.route(th.dtype, tw[0].dtype, d, F) == "wgmma"
    casts = kexp.weight_bf16.casts
    got = ops.expert_ffn(th, *tw, act)
    torch.cuda.synchronize()
    assert kexp.weight_bf16.casts == casts
    want = ref.expert_ffn_ref(th, *tw, act)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert torch.equal(kexp.expert_ffn(th, *tw, act), got)


@pytest.mark.gpu
def test_expert_ffn_weight_cache_follows_in_place_updates():
    """An in-place copy_ into an f32 weight (as AdamW's update) makes the
    tensor-core route cast again: the result is the plain version's on
    the new weights, not the cached copy's."""
    _cuda_or_skip()
    h, ws = _inputs(4, 160, 256, 512, seed=9)
    _, ws2 = _inputs(4, 160, 256, 512, seed=10)
    th = torch.as_tensor(h).to(torch.bfloat16).cuda()
    tw = [torch.as_tensor(w).cuda() for w in ws]
    first = ops.expert_ffn(th, *tw, "gelu")
    casts = kexp.weight_bf16.casts
    assert torch.equal(ops.expert_ffn(th, *tw, "gelu"), first)
    assert kexp.weight_bf16.casts == casts            # a warm cache
    for w, w2 in zip(tw, ws2):
        w.copy_(torch.as_tensor(w2))
    got = ops.expert_ffn(th, *tw, "gelu")
    torch.cuda.synchronize()
    assert kexp.weight_bf16.casts == casts + 3
    want = ref.expert_ffn_ref(th, *tw, "gelu")
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert not torch.equal(got, first)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 256, 512), (4, 160, 192, 320)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_backward_tensor_cores(shape, act):
    """K1's tensor-core backward (bf16 h and dy, f32 weights) against the
    f32 plain version within the bf16 tolerance and against its rounding
    model within 1e-2 of each gradient's largest entry, at a decode-like R
    and at d, F multiples of 64 but not of 128; a second launch repeats
    bit for bit; the backward reads the forward's bf16 weight copies (no
    new cast) and makes each weight's second term once."""
    _cuda_or_skip()
    E, R, d, F = shape
    h, ws = _inputs(E, R, d, F, seed=11)
    dy = np.random.default_rng(12).standard_normal(h.shape).astype(np.float32)
    th = torch.as_tensor(h).to(torch.bfloat16).cuda().requires_grad_()
    tw = [torch.as_tensor(w).cuda().requires_grad_() for w in ws]
    tdy = torch.as_tensor(dy).to(torch.bfloat16).cuda()
    assert kexp.bwd_route(th.dtype, tw[0].dtype, d, F) == "wgmma"
    out = ops.expert_ffn(th, *tw, act)
    casts = (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts)
    out.backward(tdy)
    torch.cuda.synchronize()
    assert (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts) == (
        casts[0], casts[1] + 3)
    got = [th.grad] + [w.grad for w in tw]
    rh = th.detach().clone().requires_grad_()
    rw = [w.detach().clone().requires_grad_() for w in tw]
    ref.expert_ffn_ref(rh, *rw, act).backward(tdy)
    want = [rh.grad] + [w.grad for w in rw]
    model = ref.expert_ffn_bwd_bf16_ref(th.detach(), *(w.detach() for w in tw),
                                        tdy, act)
    for name, g, w, m in zip(("dh", "dw_up", "dw_gate", "dw_down"), got,
                             want, model):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"], msg=name)
        err = (g.float() - m.float()).abs().max().item()
        assert err <= 1e-2 * m.float().abs().max().item(), name
    again = kexp.expert_ffn_bwd(th.detach(), *(w.detach() for w in tw), tdy,
                                act)
    assert torch.equal(again[0], got[0])
    assert all(torch.equal(a, g) for a, g in zip(again[1:], got[1:]))
    assert (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts) == (
        casts[0], casts[1] + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d", [(8192, 768), (1000, 7), (300, 3000)])
def test_gather_rows_kernel_int32_index(dtype, T, d):
    """K3 with the index as int32 (read as it is, no conversion) and as
    int64, at the train path's rows, at d = 7 (2- or 4-byte copy words)
    and at a row longer than one pass of the warp's loads: bitwise."""
    from repro_torch.kernels import condense as kcond
    _cuda_or_skip()
    r = np.random.default_rng(13)
    y = torch.as_tensor(r.standard_normal((T, d)).astype(np.float32))
    y = y.to(getattr(torch, dtype)).cuda()
    idx = torch.as_tensor(r.integers(0, T, T)).cuda()
    want = ref.gather_rows_ref(y, idx)
    for ix in (idx.to(torch.int32), idx):
        before = kcond.gather_rows.launches
        got = kcond.gather_rows(y, ix)
        torch.cuda.synchronize()
        assert kcond.gather_rows.launches == before + 1
        assert torch.equal(got, want)


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
@pytest.mark.parametrize("NG,G,d", [(64, 128, 768), (3, 96, 48),
                                    (3, 200, 64)])
def test_masked_similarity_tensor_cores(NG, G, d):
    """K2's bf16 route (wgmma, 64 x 128 tiles) against its plain version at
    1e-5, at the train path's 64 groups of [128, 768], at d not a multiple
    of the 64-wide slab and at a ragged G; skipped tiles and masked entries
    exactly zero; a second launch bit for bit the first."""
    from repro_torch.kernels import similarity as ksim
    _cuda_or_skip()
    assert ksim.route(torch.bfloat16, d) == "wgmma"
    r = np.random.default_rng(15)
    x = torch.as_tensor(r.standard_normal((NG, G, d)).astype(np.float32))
    x = x.to(torch.bfloat16).cuda()
    mask = torch.as_tensor(r.random((NG, G, G)) < 0.4).cuda()
    mask[1] = False                          # a group with nothing to measure
    mask[2, :64, :] = False                  # skipped 64-row tiles
    mask[0, :, 5] = True                     # a column measured everywhere
    before = ksim.masked_similarity.launches
    got = ops.masked_similarity(x, mask)
    torch.cuda.synchronize()
    assert ksim.masked_similarity.launches == before + 1
    want = ref.masked_similarity_ref(x, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[1] == 0) and torch.all(got[~mask] == 0)
    assert torch.all(got[2, :64] == 0)
    assert torch.equal(ops.masked_similarity(x, mask), got)


def _skip_rule_inputs(NG, G, d, x_dtype, history, seed=16):
    """Rows near 8 centres, the path's strided int64 expert ids and a
    carried similarity from the plain version of a first block (pairs
    known high and known low), or none."""
    r = np.random.default_rng(seed)
    c = r.standard_normal((8, d))
    x = c[r.integers(0, 8, (NG, G))] + 0.6 * r.standard_normal((NG, G, d))
    x = torch.as_tensor(x.astype(np.float32)).to(getattr(torch, x_dtype))
    top2 = torch.as_tensor(r.integers(0, 16, (NG * G, 2))).cuda()
    expert = top2[:, 0].reshape(NG, G)
    x = x.cuda()
    s_prev = None
    if history:
        x0 = torch.as_tensor(x.float().cpu().numpy()[:, ::-1].copy()).cuda()
        s_prev = ref.masked_similarity_fused_ref(
            x0, expert, torch.full((NG, G, G), 0.5, device="cuda"), 0.8,
            0.2)[0].contiguous()
        s_prev[0, 3, :] = float("nan")
    return x, expert, s_prev


@pytest.mark.gpu
@pytest.mark.parametrize("NG,G,d,x_dtype,history", [
    (64, 128, 768, "bfloat16", True),     # the train path, a carried s_prev
    (64, 128, 768, "bfloat16", False),
    (64, 128, 768, "float32", True),      # f32 compute: the FMA kernel
    (5, 96, 64, "bfloat16", False),       # a ragged G, no s_prev
    (3, 200, 64, "bfloat16", True),       # 8 tiles a group: the most
    (3, 120, 40, "bfloat16", True)])      # the FMA kernel, a ragged G
def test_masked_similarity_fused_matches_plain(NG, G, d, x_dtype, history):
    """K2's fused entry against its plain version on the same card
    tensors: measured pairs within 1e-5, every other entry (0, or 1 where
    s_prev > s1) bit for bit, measured_frac bitwise at G = 128 and within
    one f32 ulp elsewhere; both counters; a second launch bit for bit."""
    from repro_torch.kernels import similarity as ksim
    _cuda_or_skip()
    x, expert, s_prev = _skip_rule_inputs(NG, G, d, x_dtype, history)
    before = (ksim.masked_similarity.launches,
              ksim.masked_similarity_fused.launches)
    sim, frac = ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2)
    torch.cuda.synchronize()
    assert (ksim.masked_similarity.launches,
            ksim.masked_similarity_fused.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want, wfrac = ref.masked_similarity_fused_ref(x, expert, s_prev, 0.8,
                                                  0.2)
    same = expert[:, :, None] == expert[:, None, :]
    measured = same.clone()
    if s_prev is not None:
        measured &= ~(s_prev > 0.8) & ~(s_prev < 0.2)
        assert bool(torch.any(same & (s_prev > 0.8)))
    assert torch.equal(sim[~measured], want[~measured])
    torch.testing.assert_close(sim[measured], want[measured], atol=1e-5,
                               rtol=1e-5)
    if G == 128:
        assert torch.equal(frac, wfrac)
    else:
        torch.testing.assert_close(frac, wfrac, atol=0, rtol=1.2e-7)
    assert torch.equal(frac.cpu(), measured.float().cpu().mean(dim=(1, 2)))
    again = ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2)
    assert torch.equal(again[0], sim) and torch.equal(again[1], frac)


@pytest.mark.gpu
@pytest.mark.parametrize("NG,G,d,x_dtype,history,bits", [
    (64, 128, 768, "bfloat16", True, 8),  # the lsh train path, carried
    (64, 128, 768, "bfloat16", False, 8),
    (64, 128, 768, "bfloat16", False, 1),  # two buckets: cross-bucket tiles
    (64, 128, 768, "float32", True, 8),    # f32 compute: the FMA kernel
    (5, 96, 64, "bfloat16", False, 2),     # a ragged G, no s_prev
    (3, 120, 40, "bfloat16", True, 1)])    # the FMA kernel, a ragged G
def test_masked_similarity_fused_with_lsh_codes_matches_plain(
        NG, G, d, x_dtype, history, bits):
    """K2's fused entry restricted to LSH buckets against its plain
    version: the pairs it measures (uncertain, same bucket) within 1e-5,
    every other entry (0 across buckets, 1 where s_prev > s1) bit for
    bit, measured_frac bitwise at G = 128 (within one f32 ulp elsewhere)
    and the restricted count; the lsh counter; a repeat bit for bit; the
    exact entry's result unchanged beside it."""
    from repro_torch.condense.backends import lsh_codes
    from repro_torch.kernels import similarity as ksim
    _cuda_or_skip()
    x, expert, s_prev = _skip_rule_inputs(NG, G, d, x_dtype, history)
    code = lsh_codes(x, bits=bits, seed=0)
    before = (ksim.masked_similarity_fused.launches,
              ksim.masked_similarity_fused.lsh_launches)
    sim, frac = ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2,
                                            code=code)
    torch.cuda.synchronize()
    assert (ksim.masked_similarity_fused.launches,
            ksim.masked_similarity_fused.lsh_launches) == (before[0] + 1,
                                                           before[1] + 1)
    want, wfrac = ref.masked_similarity_fused_ref(x, expert, s_prev, 0.8,
                                                  0.2, code)
    same = expert[:, :, None] == expert[:, None, :]
    uncertain = same.clone()
    if s_prev is not None:
        uncertain &= ~(s_prev > 0.8) & ~(s_prev < 0.2)
    measured = uncertain & (code[:, :, None] == code[:, None, :])
    assert bool(torch.any(uncertain & ~measured))
    assert torch.equal(sim[~measured], want[~measured])
    torch.testing.assert_close(sim[measured], want[measured], atol=1e-5,
                               rtol=1e-5)
    if G == 128:
        assert torch.equal(frac, wfrac)
    else:
        torch.testing.assert_close(frac, wfrac, atol=0, rtol=1.2e-7)
    assert torch.equal(frac.cpu(), measured.float().cpu().mean(dim=(1, 2)))
    again = ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2,
                                        code=code)
    assert torch.equal(again[0], sim) and torch.equal(again[1], frac)
    exact, efrac = ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2)
    ewant, ewfrac = ref.masked_similarity_fused_ref(x, expert, s_prev, 0.8,
                                                    0.2)
    em = uncertain
    assert torch.equal(exact[~em], ewant[~em])
    torch.testing.assert_close(exact[em], ewant[em], atol=1e-5, rtol=1e-5)
    assert torch.equal(efrac.cpu(), em.float().cpu().mean(dim=(1, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("G,d", [(264, 64), (200, 40)])
def test_masked_similarity_fused_refuses_a_group_past_one_cluster(G, d):
    """A group of more than 8 tiles (G > 256 on the tensor cores, G > 128
    on the FMA kernel) does not fit one cluster: the fused entry raises
    before it launches."""
    from repro_torch.kernels import similarity as ksim
    _cuda_or_skip()
    x, expert, s_prev = _skip_rule_inputs(2, G, d, "bfloat16", False)
    before = ksim.masked_similarity_fused.launches
    with pytest.raises(ValueError, match="cluster"):
        ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2)
    assert ksim.masked_similarity_fused.launches == before


@pytest.mark.gpu
def test_masked_similarity_misaligned_views():
    """An s_prev view one float into its storage and a mask view one byte
    into its storage (the kernels read them in 16- and 4-byte words) give
    what their contiguous copies give."""
    _cuda_or_skip()
    NG, G, d = 4, 128, 64
    x, expert, s_prev = _skip_rule_inputs(NG, G, d, "bfloat16", True)
    sp = torch.empty(s_prev.numel() + 1, device="cuda")[1:].view_as(s_prev)
    sp.copy_(s_prev)
    assert sp.data_ptr() % 16
    want = ops.masked_similarity_fused(x, expert, s_prev, 0.8, 0.2)
    got = ops.masked_similarity_fused(x, expert, sp, 0.8, 0.2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    mask = expert[:, :, None] == expert[:, None, :]
    mk = torch.empty(mask.numel() + 1, dtype=torch.bool,
                     device="cuda")[1:].view_as(mask)
    mk.copy_(mask)
    assert mk.data_ptr() % 4
    assert torch.equal(ops.masked_similarity(x, mk),
                       ops.masked_similarity(x, mask))


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


def _group_local_map(r, n_groups, G, reps_per_group):
    reps = np.sort(np.stack([r.choice(G, reps_per_group, replace=False)
                             for _ in range(n_groups)]), axis=1)
    rep_of = np.take_along_axis(
        reps, r.integers(0, reps_per_group, (n_groups, G)), axis=1)
    rep_of[np.arange(n_groups)[:, None], reps] = reps
    return (rep_of + G * np.arange(n_groups)[:, None]).reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_groups,G,d,reps", [
    (64, 128, 768, 9),        # the train path's [8192, 768]
    (8, 128, 768, 1),         # one representative per group
    (8, 128, 768, 128),       # every token its own representative
    (16, 128, 7, 5),          # a ragged row (2-byte words at bf16)
    (5, 96, 40, 3)])
def test_gather_rows_grouped_backward_bitwise(dtype, n_groups, G, d, reps):
    """K3's group-local backward, through the autograd path the
    un-condense takes: bit for bit the general entry (sort + segmented
    sum), the CPU plain version and a second launch."""
    from repro_torch.kernels import condense as kcond
    _cuda_or_skip()
    r = np.random.default_rng(12)
    T = n_groups * G
    idx = torch.as_tensor(_group_local_map(r, n_groups, G, reps)).cuda()
    y = torch.as_tensor(r.standard_normal((T, d)).astype(np.float32))
    y = y.to(getattr(torch, dtype)).cuda().requires_grad_()
    dy = torch.as_tensor(r.standard_normal((T, d)).astype(np.float32))
    dy = dy.to(y.dtype).cuda()
    before = kcond.gather_rows_bwd.launches
    ops.gather_rows(y, idx, G).backward(dy)
    torch.cuda.synchronize()
    assert kcond.gather_rows_bwd.launches == before + 1
    general = kcond.gather_rows_bwd(dy, idx, T)
    assert y.grad.dtype == y.dtype
    assert torch.equal(y.grad, general)
    assert torch.equal(y.grad.cpu(), ref.gather_rows_bwd_ref(
        dy.cpu(), idx.cpu(), T))
    assert torch.equal(kcond.gather_rows_bwd(dy, idx, T, G), y.grad)


def _u8(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["f8e4m3", "bf16", "f32"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T,d,R", [(8192, 768, 16384), (64, 33, 96)])
def test_pack_quantize_kernel_bitwise(wire, x_dtype, T, d, R):
    """K4 against its plain version, bitwise (uint8 views of payload and
    scales), at the train path's [8192, 768] rows and 4 ranks x 2 nodes x
    2048 wire slots, and at d=33 (zero padding) with empty slots; a
    second launch repeats bit for bit."""
    from repro_torch.kernels import pack as kpack
    _cuda_or_skip()
    r = np.random.default_rng(7)
    x = torch.as_tensor((r.standard_normal((T, d)) * 3).astype(np.float32))
    x[1] = 0.0                                   # all-zero blocks
    x = x.to(getattr(torch, x_dtype)).cuda()
    tok = torch.as_tensor(r.integers(-1, T, R), dtype=torch.int32).cuda()
    tok[::5] = -1
    before = (kpack.pack_quant.launches, kpack.pack_cast.launches)
    q, sc = ops.pack_quantize(x, tok, wire)
    torch.cuda.synchronize()
    f8 = wire == "f8e4m3"
    assert (kpack.pack_quant.launches, kpack.pack_cast.launches) == (
        before[0] + f8, before[1] + (not f8))
    wq, wsc = ref.pack_quantize_ref(x, tok, wire)
    assert q.dtype == wq.dtype and q.shape == wq.shape
    assert torch.equal(_u8(q), _u8(wq))
    assert (sc is None) == (wsc is None)
    if f8:
        assert torch.equal(sc, wsc)
        assert torch.equal(sc.cpu(), ref.pack_quantize_ref(
            x.cpu(), tok.cpu(), wire)[1])
    q2, sc2 = ops.pack_quantize(x, tok, wire)
    assert torch.equal(_u8(q2), _u8(q))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["empty", "full", "path"])
@pytest.mark.parametrize("wire", ["f8e4m3", "bf16"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [768, 40, 33])
def test_pack_quantize_maps_and_widths(d, x_dtype, wire, fill):
    """K4's forward on both wires, bitwise its plain version: the vector
    f8 kernel at d = 768 and d = 40 (a padded scale block), the scalar one
    at d = 33, with every slot empty, every slot filled, and the path's
    quarter filled."""
    from repro_torch.kernels import pack as kpack
    _cuda_or_skip()
    r = np.random.default_rng(17)
    T, R = 512, 1000
    x = torch.as_tensor((r.standard_normal((T, d)) * 5).astype(np.float32))
    x[3] = 0.0
    x = x.to(getattr(torch, x_dtype)).cuda()
    tok = {"empty": np.full(R, -1),
           "full": r.integers(0, T, R),
           "path": np.where(r.random(R) < 0.26, r.integers(0, T, R), -1)}
    tok = torch.as_tensor(tok[fill], dtype=torch.int32).cuda()
    tok[tok == 7] = 3                            # some all-zero rows
    q, sc = ops.pack_quantize(x, tok, wire)
    wq, wsc = ref.pack_quantize_ref(x, tok, wire)
    assert q.dtype == wq.dtype and q.shape == wq.shape
    assert torch.equal(_u8(q), _u8(wq))
    if wire == "f8e4m3":
        assert torch.equal(sc, wsc)
    assert torch.equal(_u8(ops.pack_quantize(x, tok, wire)[0]), _u8(q))


@pytest.mark.gpu
def test_pack_quantize_f8_edges():
    """Blocks whose payload lands on +-448 exactly and one ulp above,
    e4m3's ties, its subnormals and signed zeros: bitwise PyTorch's own
    cast."""
    from repro_torch.kernels import pack as kpack
    _cuda_or_skip()
    up = float(np.nextafter(np.float32(448.0), np.float32(1e9)))
    vals = [448.0, -448.0, up, -up, 464.0, 440.0, 1e-9, -2.0 ** -10,
            2.0 ** -9, 0.0, -0.0, 3.0, -17.5]
    x = torch.zeros((4, 64))
    x[0, :len(vals)] = torch.tensor(vals)
    x[1, :32] = 448.0
    x[2, 32:] = -torch.linspace(0, 448, 32)
    x[3, :3] = torch.tensor([up, 1.0, -up])
    x = x.cuda()
    tok = torch.arange(4, dtype=torch.int32).cuda()
    q, sc = kpack.pack_quant(x, tok)
    wq, wsc = ref.pack_quantize_ref(x, tok, "f8e4m3")
    assert torch.equal(_u8(q), _u8(wq)) and torch.equal(sc, wsc)
    assert torch.equal(_u8(q).cpu(), _u8(ref.pack_quantize_ref(
        x.cpu(), tok.cpu(), "f8e4m3")[0]))
    assert int(_u8(q)[1, 0]) == 0x7E         # 448 is e4m3fn's largest


def _payload_share(x, tok, g):
    """The share of the filled rows' entries whose payload cotangent
    f8(g * scale) is nonzero: how much of the kernel's ct_q / scale term
    a check exercises."""
    from repro_torch.comm import dtypes as wdt
    src = x if tok is None else ref.pack_rows_ref(x, tok)
    _, sc = wdt.quantize_rows(src, "f8e4m3")
    ct_q = (g.float().reshape(g.shape[0], -1, wdt.SCALE_BLOCK)
            * sc[..., None]).to(wdt.F8)
    filled = slice(None) if tok is None else tok >= 0
    return (ct_q.float()[filled] != 0).float().mean().item()


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tok", [True, False])
@pytest.mark.parametrize("g_scale", [1.0, 1e-2, 1e-4])
def test_pack_quant_backward_matches_plain(x_dtype, with_tok, g_scale):
    """K4's backward kernel (the reference's transpose of the f8 codec)
    against its plain version within 1e-6 of the largest entry (two
    32-element sums in another order; 2e-2 at bf16, one rounding of the
    result), and repeating bit for bit, at the cotangent scales of the
    CPU codec test: at 1 most payload cotangents f8(g * scale) are
    nonzero, at 1e-2 and 1e-4 none are on the filled rows (the tie term
    alone)."""
    from repro_torch.kernels import pack as kpack
    _cuda_or_skip()
    r = np.random.default_rng(8)
    T, d, R = 2048, 768, 4096
    dt = getattr(torch, x_dtype)
    x = torch.as_tensor((r.standard_normal((T, d)) * 2).astype(np.float32))
    x = x.to(dt).cuda()
    tok = torch.as_tensor(r.integers(-1, T, R), dtype=torch.int32).cuda() \
        if with_tok else None
    g = torch.as_tensor((r.standard_normal((R if with_tok else T, d))
                         * g_scale).astype(np.float32)).to(dt).cuda()
    share = _payload_share(x, tok, g)
    if g_scale == 1.0:
        assert share > 0.5
    else:
        assert share == 0.0
    before = kpack.pack_quant_bwd.launches
    got = ops.pack_quant_bwd(x, tok, g)
    torch.cuda.synchronize()
    assert kpack.pack_quant_bwd.launches == before + 1
    want = ref.pack_quant_bwd_ref(x, tok, g)
    tol = 1e-6 if x_dtype == "float32" else 2e-2
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= tol * scale
    assert torch.equal(ops.pack_quant_bwd(x, tok, g), got)


def _wire_map(r, T, n_groups, slots):
    """A dedup-wire slot -> token map as ``condense.wire.dedup_dispatch``
    builds it: per (rank, node) group of ``slots``, a filled prefix of
    distinct tokens, then empty slots (-1)."""
    tok = np.full((n_groups, slots), -1, np.int32)
    for grp in range(n_groups):
        n = int(r.integers(0, slots + 1))
        tok[grp, :n] = r.choice(T, n, replace=False)
    return tok.reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["train_map", "d33", "d40", "empty_rows"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_pack_quant_backward_maps_and_widths(case, x_dtype):
    """K4's backward on the path's own kind of map (the train row map: 4
    ranks x 2 nodes of 1024 slots, filled prefixes), at d = 33 (the scalar
    kernel), d = 40 (the vector kernel with a part-filled scale block) and
    with every other row empty (tok = -1): within 1e-6 of the largest
    entry at f32 and 2e-2 at bf16, repeating bit for bit, one launch."""
    from repro_torch.kernels import pack as kpack
    _cuda_or_skip()
    r = np.random.default_rng(11)
    dt = getattr(torch, x_dtype)
    T, d = {"train_map": (2048, 768), "d33": (64, 33), "d40": (64, 40),
            "empty_rows": (512, 768)}[case]
    if case == "train_map":
        tok = _wire_map(r, T, 8, 1024)
    else:
        tok = r.integers(0, T, 2 * T).astype(np.int32)
        tok[::2 if case == "empty_rows" else 5] = -1
    x = torch.as_tensor((r.standard_normal((T, d)) * 2).astype(np.float32))
    x[3] = 0.0                                   # all-zero blocks
    x = x.to(dt).cuda()
    tok = torch.as_tensor(tok).cuda()
    g = torch.as_tensor(r.standard_normal((tok.numel(), d)).astype(
        np.float32)).to(dt).cuda()
    before = kpack.pack_quant_bwd.launches
    got = ops.pack_quant_bwd(x, tok, g)
    torch.cuda.synchronize()
    assert kpack.pack_quant_bwd.launches == before + 1
    want = ref.pack_quant_bwd_ref(x, tok, g)
    assert got.dtype == dt and got.shape == want.shape
    tol = 1e-6 if x_dtype == "float32" else 2e-2
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= tol * scale
    assert torch.equal(ops.pack_quant_bwd(x, tok, g), got)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["f8e4m3", "bf16", "f32"])
@pytest.mark.parametrize("g_scale", [1.0, 1e-2])
def test_wire_backward_matches_plain_autograd(wire, g_scale):
    """The wire's gradient on the card (K4 forward, the K4 backward
    kernel on the f8 wire) against the plain path: autograd through the
    plain pack and cast on the cast wires (equal), the plain backward on
    the CPU on the f8 wire (2e-2 of the largest entry: bf16 rows), at a
    cotangent scale that drives the f8 payload cotangent (1) and one
    that zeroes it (1e-2)."""
    from repro_torch.condense.wire import _Ship
    from repro_torch.kernels import pack as kpack
    _cuda_or_skip()
    r = np.random.default_rng(9)
    T, d = 2048, 768
    x = torch.as_tensor(r.standard_normal((T, d)).astype(np.float32)) \
        .to(torch.bfloat16)
    # two "nodes": each token heads to at most one slot of each
    back = torch.stack([torch.as_tensor(r.permutation(T)),
                        torch.as_tensor(r.permutation(T)) + T], 1)
    back[torch.as_tensor(r.random((T, 2)) < 0.4)] = -1
    tok = torch.full((2 * T + 1,), -1, dtype=torch.int32)
    tok[torch.where(back >= 0, back, 2 * T).reshape(-1)] = \
        torch.arange(T, dtype=torch.int32)[:, None].expand(T, 2).reshape(-1)
    tok = tok[:2 * T]
    g = torch.as_tensor((r.standard_normal((2, T, d)) * g_scale)
                        .astype(np.float32)).to(torch.bfloat16)

    def ship(dev):
        xs = x.to(dev).requires_grad_()
        y = _Ship.apply(xs, tok.to(dev), back.to(dev), lambda t: t, wire,
                        torch.bfloat16, (2, T))
        y.backward(g.to(dev))
        return xs.grad

    before = kpack.pack_quant_bwd.launches
    got = ship("cuda")
    torch.cuda.synchronize()
    assert kpack.pack_quant_bwd.launches == before + (wire == "f8e4m3")
    if wire == "f8e4m3":
        want = ship("cpu")
        err = (got.cpu().float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max()
    else:
        xs = x.cuda().requires_grad_()
        q, _ = ref.pack_quantize_ref(xs, tok.cuda(), wire)
        q.reshape(2, T, d).to(torch.bfloat16).backward(g.cuda())
        assert torch.equal(got, xs.grad)


# K5 at hymba's batched-prefill shape (bf16, 25 heads on 5 KV heads,
# window 1024), without a window, non-causal, and at a ragged S in f32.
# bf16 at hd 64 and 128 runs the tensor-core kernel: its edges are a
# ragged S (rows past S zero-filled by TMA and masked), a window edge not
# aligned to a 128-key tile, S shorter than one query tile and H == KV;
# bf16 at hd 32 keeps the FMA kernel's bf16 instantiation tested.
# Tolerances as tests/test_kernels.py: 2e-5 f32 (sums in another order),
# 3e-2 bf16 (bf16 roundings of the output and, on the tensor cores, of
# the softmax weights before P V; scores and sums f32 in both).
FLASH_CASES = [((4, 2048, 25, 5, 64), "bfloat16", True, 1024),
               ((2, 512, 8, 2, 64), "float32", True, None),
               ((2, 512, 8, 2, 64), "float32", False, None),
               ((2, 100, 4, 2, 32), "float32", True, 30),
               ((1, 100, 4, 4, 128), "bfloat16", False, 17),
               ((2, 100, 25, 5, 64), "bfloat16", True, 30),
               ((2, 1000, 8, 2, 64), "bfloat16", True, 1000),
               ((2, 64, 4, 2, 64), "bfloat16", True, None),
               ((2, 300, 4, 4, 64), "bfloat16", True, 100),
               ((2, 1024, 8, 2, 128), "bfloat16", True, 300),
               ((2, 100, 4, 2, 32), "bfloat16", True, 30)]


def _flash_qkv(shape, dtype, seed, q_scale=1.0):
    B, S, H, KV, hd = shape
    r = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [torch.as_tensor(r.standard_normal(s).astype(np.float32) * c)
            .to(dt).cuda() for s, c in (((B, S, H, hd), q_scale),
                                        ((B, S, KV, hd), 1.0),
                                        ((B, S, KV, hd), 1.0))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(shape, dtype, causal, window):
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    dt = getattr(torch, dtype)
    q, k, v = _flash_qkv(shape, dtype, seed=shape[1] + shape[4])
    before = kfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", [(True, 200), (False, None)])
def test_flash_attention_kernel_large_logits(causal, window):
    """q scaled by 8 (logits of tens): the tensor-core kernel's running
    max, its NEG / clamp path and the rescaling of acc, at 3e-2."""
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    q, k, v = _flash_qkv((2, 512, 8, 2, 64), "bfloat16", seed=8, q_scale=8.0)
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.gpu
def test_flash_attention_kernel_repeats_bitwise():
    """A second launch at hymba's prefill shape is bitwise equal to the
    first: no atomics, no split over keys."""
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    q, k, v = _flash_qkv((4, 2048, 25, 5, 64), "bfloat16", seed=15)
    a = kfa.flash_attention(q, k, v, causal=True, window=1024)
    b = kfa.flash_attention(q, k, v, causal=True, window=1024)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K5 at the head dims of stablelm-12b (160) and gemma3-12b (256), bf16 (the
# tensor-core kernel: at 160 the third TMA box runs past hd and loads
# zeros; at 256 a producer warpgroup gives its registers to the
# consumers) and f32 (the FMA kernel's 64-column instantiation), with GQA
# groups of 1, 2, 4, 7 and 12 (olmoe, gemma3, stablelm, yi, starcoder2),
# windows, ragged S and S over 2048. Tolerances as above.
FLASH_WIDE_CASES = [((2, 300, 4, 2, 160), "bfloat16", True, None),
                    ((2, 100, 4, 4, 160), "bfloat16", True, 30),
                    ((1, 200, 6, 2, 160), "bfloat16", False, None),
                    ((2, 300, 4, 2, 256), "bfloat16", True, None),
                    ((2, 100, 8, 2, 256), "bfloat16", True, 30),
                    ((1, 200, 6, 2, 256), "bfloat16", False, None),
                    ((1, 2500, 16, 8, 256), "bfloat16", True, 1024),
                    ((1, 2304, 14, 2, 128), "bfloat16", True, None),
                    ((1, 4200, 12, 1, 128), "bfloat16", True, 4096),
                    ((2, 300, 4, 2, 160), "float32", True, None),
                    ((2, 300, 4, 2, 256), "float32", True, 100),
                    ((1, 64, 2, 1, 256), "float32", False, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal,window", FLASH_WIDE_CASES)
def test_flash_attention_kernel_wide_heads(shape, dtype, causal, window):
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    q, k, v = _flash_qkv(shape, dtype, seed=shape[1] + shape[4])
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    again = kfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # each query row within a share of its own norm: at S in the
    # thousands a row's outputs are ~0.02-0.05, under the elementwise
    # gate, and a key tile left out of its band moves the row by ~0.25
    g, w = got.float(), want.float()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
    assert row <= (1e-4 if dtype == "float32" else 1e-2), row


# K5 without a mask, as an encoder-decoder's encoder (Sq == Sk) and its
# cross-attention (Sq decoder positions against Sk encoder ones) run it:
# (B, Sq, Sk, H, KV, hd). Ragged key tails (Sk not a multiple of the
# 64- or 128-key tile, Sk under one tile), Sk above and below Sq, GQA
# groups of 1, 4 and 8, both routes (bf16 at hd 64 / 128 / 160 / 256 on
# the tensor cores, bf16 at hd 32 and f32 on the FMA kernel).
FLASH_CROSS_CASES = [((2, 512, 512, 16, 16, 64), "bfloat16"),
                     ((2, 256, 1000, 16, 16, 64), "bfloat16"),
                     ((2, 100, 3000, 16, 16, 64), "bfloat16"),
                     ((2, 300, 77, 8, 2, 64), "bfloat16"),
                     ((1, 129, 65, 8, 1, 128), "bfloat16"),
                     ((2, 100, 333, 4, 2, 160), "bfloat16"),
                     ((1, 77, 300, 6, 2, 256), "bfloat16"),
                     ((1, 50, 200, 4, 4, 32), "bfloat16"),
                     ((2, 256, 1000, 16, 16, 64), "float32"),
                     ((2, 100, 3000, 8, 1, 64), "float32"),
                     ((2, 64, 37, 8, 2, 128), "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", FLASH_CROSS_CASES)
def test_flash_attention_kernel_cross_shapes(shape, dtype):
    """K5 non-causal at Sq != Sk against its plain version: elementwise
    (2e-5 f32, 3e-2 bf16) and each query row within 1e-4 / 1e-2 of its
    norm; one launch through ``ops``; a second launch bit for bit."""
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    B, Sq, Sk, H, KV, hd = shape
    r = np.random.default_rng(Sq + Sk + hd)
    dt = getattr(torch, dtype)
    q, k, v = [torch.as_tensor(r.standard_normal(s).astype(np.float32))
               .to(dt).cuda() for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                        (B, Sk, KV, hd))]
    before = kfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=False)
    again = kfa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before + 2
    assert got.shape == q.shape and got.dtype == dt
    assert torch.equal(got, again)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    g, w = got.float(), want.float()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
    assert row <= (1e-4 if dtype == "float32" else 1e-2), row


@pytest.mark.gpu
def test_flash_attention_cross_keys_stay_in_their_batch_row():
    """A ragged last key tile reads zeros past Sk, never the next batch
    row's keys: batch row 0 alone gives the same output bit for bit as
    inside a batch of 2 whose row 1 holds huge keys and values."""
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    r = np.random.default_rng(3)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = [torch.as_tensor(r.standard_normal(s).astype(np.float32))
                   .to(dtype).cuda() for s in ((2, 100, 8, 64),
                                               (2, 77, 8, 64),
                                               (2, 77, 8, 64))]
        k[1], v[1] = 1e3, 1e3
        both = kfa.flash_attention(q, k, v, causal=False)
        alone = kfa.flash_attention(q[:1].clone(), k[:1].clone(),
                                    v[:1].clone(), causal=False)
        torch.cuda.synchronize()
        assert torch.equal(both[:1], alone)


@pytest.mark.gpu
def test_flash_attention_refuses_masks_at_sq_ne_sk():
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    q = torch.zeros((1, 10, 2, 64), device="cuda")
    k = torch.zeros((1, 20, 2, 64), device="cuda")
    for kw in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="Sq == Sk"):
            kfa.flash_attention(q, k, k, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,N", [(4, 2048, 3200, 16), (2, 100, 200, 16),
                                      (1, 33, 70, 8), (3, 1, 48, 16)])
def test_mamba_scan_kernel_matches_plain(B, S, di, N):
    """K6 and its final state against the per-step recurrence, 2e-5 (f32
    sums over the state in another order); hymba's prefill shape, a
    ragged S and di, N = 8 and a single step."""
    _cuda_or_skip()
    from repro_torch.kernels import mamba_scan as kms
    r = np.random.default_rng(di)
    dt = torch.as_tensor(np.abs(r.standard_normal((B, S, di))) * 0.1,
                         dtype=torch.float32).cuda()
    x = torch.as_tensor(r.standard_normal((B, S, di)),
                        dtype=torch.float32).cuda()
    bm, cm = (torch.as_tensor(r.standard_normal((B, S, N)),
                              dtype=torch.float32).cuda() for _ in range(2))
    a = -torch.exp(torch.as_tensor(r.standard_normal((di, N)),
                                   dtype=torch.float32)).cuda()
    before = kms.mamba_scan.launches
    y, h = ops.mamba_scan(dt, x, bm, cm, a)
    torch.cuda.synchronize()
    assert kms.mamba_scan.launches == before + 1
    wy, wh = ref.mamba_scan_ref(dt, x, bm, cm, a)
    torch.testing.assert_close(y, wy, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(h, wh, atol=2e-5, rtol=2e-5)


def _bf16_excess(got, want, tol=2e-5):
    """|got - want| over one bf16 ulp of the larger magnitude of the two
    plus the f32 gate's ``tol * (1 + |want|)``, elementwise: at most 1
    where two values within the f32 gate round to bf16 apart (the f32
    term covers the elements where y + d_skip * x cancels, whose ulp is
    far below the scan's f32 error)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    return (g - w).abs() / (ulp + tol * (1.0 + w.abs()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,N", [(4, 2048, 3200, 16), (2, 100, 200, 16),
                                      (1, 33, 70, 8), (3, 1, 48, 16)])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_mamba_scan_fused_kernel_matches_plain(B, S, di, N, x_dtype):
    """The fused K6 entry (softplus, scan, skip, gate, rounding) against
    its plain version, the ops of ``_mamba_inner`` one by one: z the second
    half of one [B,S,2di] product and B, C column slices of one projection,
    as the model passes them. f32: y and the final state within 2e-5 (the
    scan's sums in another order); bf16: y within one bf16 ulp of each
    element plus the f32 gate (the rounding of values within 2e-5), the
    state within 2e-5. One launch, counted by both K6 counters."""
    _cuda_or_skip()
    from repro_torch.kernels import mamba_scan as kms
    r = np.random.default_rng(di + S)
    dt = getattr(torch, x_dtype)

    def rn(*shape, scale=1.0):
        return torch.as_tensor(r.standard_normal(shape) * scale,
                               dtype=torch.float32).cuda()

    x, z = torch.chunk(rn(B, S, 2 * di).to(dt), 2, dim=-1)
    x = x.contiguous()
    _, bm, cm = torch.split(rn(B, S, 7 + 2 * N), [7, N, N], dim=-1)
    args = (rn(B, S, di) - 1.0, rn(di, scale=0.5), x, z, rn(di), bm, cm,
            -torch.exp(rn(di, N)))
    before = (kms.mamba_scan.launches, kms.mamba_scan_fused.launches)
    y, h = ops.mamba_scan_fused(*args)
    torch.cuda.synchronize()
    assert (kms.mamba_scan.launches, kms.mamba_scan_fused.launches) == (
        before[0] + 1, before[1] + 1)
    wy, wh = ref.mamba_scan_fused_ref(*args)
    assert y.dtype == dt and y.shape == wy.shape
    torch.testing.assert_close(h, wh, atol=2e-5, rtol=2e-5)
    if x_dtype == "float32":
        torch.testing.assert_close(y, wy, atol=2e-5, rtol=2e-5)
    else:
        assert _bf16_excess(y, wy).max().item() <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_expert_ffn_chunk_rows_bitwise(h_dtype):
    """The pipelined executor's chunk of the dense wire: 4 source ranks x
    a quarter of the capacity. K1 on a chunk's rows (and the RMS norm
    before it) gives the same bits as the same rows of one launch over
    the whole capacity, [16, 4 x 512, 768] x 3072, on each route."""
    _cuda_or_skip()
    from repro_torch.plan.exchange import _rms
    from repro_torch.sched import plan_chunks
    E, M, C, d, F = 16, 4, 512, 768, 3072
    h, ws = _inputs(E, M * C, d, F, seed=11)
    dt = getattr(torch, h_dtype)
    x = torch.as_tensor(h).cuda()
    tw = [torch.as_tensor(w).cuda() for w in ws]
    scale = torch.rand(d, device="cuda") + 0.5
    full = ops.expert_ffn(_rms(x, scale).to(dt), *tw, "gelu")
    full = full.reshape(E, M, C, d)
    for ch in (plan_chunks(C, 4), plan_chunks(C, 3)):
        for o, s in ch.slices():
            xk = x.reshape(E, M, C, d)[:, :, o:o + s]
            hk = _rms(xk, scale).to(dt).reshape(E, M * s, d)
            got = ops.expert_ffn(hk, *tw, "gelu").reshape(E, M, s, d)
            assert torch.equal(got, full[:, :, o:o + s]), (ch, o, s)


@pytest.mark.gpu
@pytest.mark.parametrize("hier_dedup", ["off", "on"])
def test_pipeline_side_stream_equals_sync(hier_dedup):
    """A reduced EP forward and backward on the card: pipeline (the
    collectives on the side stream) equals sync bit for bit in the loss
    and the forward metrics, gradients within 1e-5, and K1 launches once
    per chunk on the dense wire and once on the dedup wire."""
    _cuda_or_skip()
    import dataclasses
    from repro_torch import optim
    from repro_torch.config import LuffyConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import capacity_for
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as ttf
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2")),
                              compute_dtype="float32")
    B, S = 8, 128
    model = build_model(cfg, device="cuda", seed=0)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             SyntheticLM(cfg, ShapeConfig("t", S, B, "train")).batch(0)
             .items()}
    dist = make_dist(make_host_mesh(model=4, nodes=2), "train", B,
                     moe_arch=True)
    cap = capacity_for(cfg.moe, B // 4 * S, cfg.moe.num_experts)
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    runs = []
    for ex in ("sync", "pipeline"):
        lf = LuffyConfig(comm_mode="hier", hier_dedup=hier_dedup,
                         wire_dtype="f8e4m3", combine_slack=4.0,
                         exec_mode=ex, pipeline_chunks=4)
        params = optim.tree_map(
            lambda p: p.detach().clone().requires_grad_(), model.params)
        before = kexp.expert_ffn.launches
        loss, m = ttf.forward_train(params, cfg, lf, batch,
                                    torch.tensor(0.6, device="cuda"), cap,
                                    dist=dist)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss, m, kexp.expert_ffn.launches - before,
                     {n: p.grad for n, p in optim.leaves_with_path(params)}))
    (ls, ms, ks, gs), (lp, mp, kp, gp) = runs
    assert ks == n_moe
    assert kp == (4 * n_moe if hier_dedup == "off" else n_moe)
    assert torch.equal(ls, lp)
    for key in ms:
        assert torch.equal(torch.as_tensor(ms[key]),
                           torch.as_tensor(mp[key])), key
    for n, g in gs.items():
        assert ((gp[n] - g).norm() / max(g.norm(), 1e-12)).item() <= 1e-5, n


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 24, 256, 512), (8, 160, 192, 320),
                                   (8, 256, 96, 200)])
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lanes", [(-1, -1, -1, -1), (-1, 0, -1, 5)])
def test_expert_ffn_group_map_matches_plain(shape, h_dtype, lanes):
    """K1 with a group map (4 ranks of 2 experts, each with a replica
    lane: all idle, or one live lane a node) against its plain version,
    the mapped stack: forward and backward (f32 1e-4, bf16 5e-2, both
    routes; (96, 200) takes the FMA kernels at bf16 too), idle groups
    exactly zero, no bf16 copy beyond the stack's own."""
    _cuda_or_skip()
    E, R, d, F = shape
    M, e_local = 4, E // 4
    w_idx = torch.tensor([g for m in range(M) for g in
                          [m * e_local + j for j in range(e_local)]
                          + [lanes[m]]], dtype=torch.int32, device="cuda")
    G = w_idx.numel()
    r = np.random.default_rng(5)
    th = torch.as_tensor(r.standard_normal((G, R, d)).astype(np.float32)) \
        .to(getattr(torch, h_dtype)).cuda()
    tw = [torch.as_tensor((r.standard_normal(s) * 0.05).astype(np.float32))
          .cuda() for s in ((E, d, F), (E, d, F), (E, F, d))]
    dy = torch.randn(th.shape, device="cuda").to(th.dtype)
    tol = TOL[h_dtype]
    kexp.expert_ffn(th[:E].contiguous(), *tw, "gelu")       # the copies
    kexp.expert_ffn_bwd(th[:E].contiguous(), *tw, dy[:E].contiguous(),
                        "gelu")
    casts = (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts)
    lanes_before = kexp.lanes.launches
    got = ops.expert_ffn(th, *tw, "gelu", w_idx)
    grads = kexp.expert_ffn_bwd(th, *tw, dy, "gelu", w_idx)
    torch.cuda.synchronize()
    assert kexp.lanes.launches == lanes_before + 1
    assert (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts) == casts
    torch.testing.assert_close(
        got.float(), ref.expert_ffn_ref(th, *tw, "gelu", w_idx).float(),
        atol=tol, rtol=tol)
    idle = w_idx < 0
    assert torch.all(got[idle] == 0) and torch.all(grads[0][idle] == 0)
    leaves = [t.detach().clone().requires_grad_() for t in (th, *tw)]
    out = ref.expert_ffn_ref(*leaves, "gelu", w_idx)
    want = torch.autograd.grad(out, leaves, dy)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moe-gpt2", "hymba-1.5b", "rwkv6-3b"])
def test_recycled_slot_bitwise_fresh_on_card(arch):
    """A decode slot recycled by ``admit_slot`` after its ring wrapped
    gives the fresh cache's logits bit for bit on the card (K1 decodes
    the moe-gpt2 case, K7 the rwkv6 one, which has no ring)."""
    _cuda_or_skip()
    import dataclasses
    from repro_torch.config import LuffyConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = reduced(get_config(arch))
    if cfg.attn is not None:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window_pattern=(6,)))
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    model = build_model(cfg, device="cuda", seed=3)
    r = np.random.default_rng(3)
    warm = torch.as_tensor(r.integers(1, cfg.vocab_size, (2, 9)),
                           dtype=torch.int32, device="cuda")
    seq = torch.as_tensor(r.integers(1, cfg.vocab_size, (7, 2, 1)),
                          dtype=torch.int32, device="cuda")

    def feed(cache):
        out = []
        for t in range(seq.shape[0]):
            lg, cache = model.decode_step(cache, seq[t], luffy=luffy)
            out.append(lg[0].clone())
        return torch.stack(out)

    cache = model.new_cache(2, 16)
    for t in range(warm.shape[1]):
        _, cache = model.decode_step(cache, warm[:, t:t + 1], luffy=luffy)
    before = kexp.expert_ffn.launches
    got = feed(model.admit_slot(cache, 0, cache["pos"]))
    assert torch.equal(got, feed(model.new_cache(2, 16)))
    assert (kexp.expert_ffn.launches > before) == cfg.uses_moe


@pytest.mark.gpu
def test_fenced_span_covers_k1():
    """A fenced phase span lasts at least the device time of the K1
    launch inside it (CUDA events around the same launch)."""
    _cuda_or_skip()
    from repro_torch.obs import trace as obs_trace
    h, ws = _inputs(16, 2048, 768, 3072, seed=1)
    th = torch.as_tensor(h).to(torch.bfloat16).cuda()
    tw = [torch.as_tensor(w).cuda() for w in ws]
    ops.expert_ffn(th, *tw, "gelu")                 # build and warm up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    tracer = obs_trace.activate(obs_trace.Tracer(fence=True))
    try:
        before = kexp.expert_ffn.launches
        with obs_trace.phase("expert_ffn") as sp:
            t0.record()
            y = ops.expert_ffn(th, *tw, "gelu")
            t1.record()
            y = sp.fence(y)
    finally:
        obs_trace.deactivate()
    assert kexp.expert_ffn.launches == before + 1
    (e,) = tracer.spans("expert_ffn")
    assert e["dur"] / 1e3 >= t0.elapsed_time(t1)


@pytest.mark.gpu
def test_checkpoint_round_trip_onto_card(tmp_path):
    _cuda_or_skip()
    from repro_torch import checkpoint, convert, optim
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = reduced(get_config("moe-gpt2"))
    params = build_model(cfg, device="cuda", seed=4).params
    tree = convert.to_reference(params, cfg)
    checkpoint.save(str(tmp_path), tree, step=5)
    got, step = checkpoint.restore(str(tmp_path), tree, device="cuda")
    back = convert.from_reference(checkpoint.restore(str(tmp_path),
                                                     tree)[0], cfg,
                                  device="cuda")
    assert step == 5
    for (_, a), (_, b) in zip(optim.leaves_with_path(back),
                              optim.leaves_with_path(params)):
        assert a.is_cuda and torch.equal(a, b.detach())
    assert all(t.is_cuda for _, t in checkpoint._flatten(got))


@pytest.mark.gpu
@pytest.mark.parametrize("R", [8, 192])
def test_expert_ffn_bf16_weights_at_llama4_width(R):
    """K1 with bf16 h and bf16 weights at llama4-maverick's d 5120 x F
    8192 on 3 experts (the decode's 8 rows and the prefill's 192),
    against its plain version on the same bf16 tensors, 5e-2; no weight
    cast is made."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(56)
    E, d, F = 3, 5120, 8192
    h = torch.randn((E, R, d), generator=g, device="cuda").bfloat16()
    ws = [(torch.randn(s, generator=g, device="cuda") / s[1] ** 0.5)
          .bfloat16() for s in ((E, d, F), (E, d, F), (E, F, d))]
    assert kexp.route(h.dtype, ws[0].dtype, d, F) == "wgmma"
    casts = kexp.weight_bf16.casts
    got = ops.expert_ffn(h, *ws, "silu")
    torch.cuda.synchronize()
    assert kexp.weight_bf16.casts == casts
    want = ref.expert_ffn_ref(h, *ws, "silu")
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1024, 1280, 200])
def test_flash_chunked_matches_plain(S):
    """A chunked-local layer of chunk 512 through the unchanged K5, the
    chunks folded into the batch (1024: two whole chunks, one launch;
    1280: a tail of 256, two launches; 200: inside one chunk), bf16 at
    hd 128, 10 heads on 2 KV heads (llama4's 5 to 1), against the plain
    version of the chunked-local function: ``attend`` with the causal
    mask ``q // W == k // W``, 3e-2."""
    _cuda_or_skip()
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.models import blocks as bk
    g = torch.Generator(device="cuda").manual_seed(S)
    W, B, H, KV, hd = 512, 2, 10, 2, 128
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    before = kfa.flash_attention.launches
    got = bk.flash_chunked(q, k, v, W, causal=True, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches - before == (2 if S > W and S % W
                                                     else 1)
    pos = torch.arange(S, device="cuda")
    mask = bk.make_attn_mask(pos, pos, causal=True, window=W, chunked=True)
    want = bk.attend(q, k, v, mask, hd ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=0)


def _wkv6_inputs(B, S, H, seed, state=True):
    """K7's operands as the time-mix gives them: r, k, v ~ N(0, 1), decays
    w = exp(-exp(z)) with z uniform in [-8, 1] (memories of one step to
    some three thousand), a bonus of 0.1 N(0, 1), a random state."""
    r = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).cuda()

    rk = [t(r.standard_normal((B, S, H, 64))) for _ in range(3)]
    w = t(np.exp(-np.exp(r.uniform(-8.0, 1.0, (B, S, H, 64)))))
    u = t(r.standard_normal((H, 64)) * 0.1)
    s0 = t(r.standard_normal((B, H, 64, 64))) if state else None
    return (*rk, w, u, s0)


def _norm_err(got, want, dims):
    """The largest ||got - want|| / ||want|| over ``dims`` (a row of y
    over the head, or a head's whole state)."""
    d = torch.linalg.vector_norm(got - want, dim=dims)
    n = torch.linalg.vector_norm(want, dim=dims).clamp_min(1e-30)
    return (d / n).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,state", [(4, 2048, 40, False),
                                         (4, 2048, 40, True),
                                         (4, 1, 40, True),
                                         (1, 1, 40, True),
                                         (2, 1000, 4, True),
                                         (3, 5, 2, False),
                                         (2, 15, 40, True),
                                         (2, 16, 40, True),
                                         (2, 17, 40, True),
                                         (2, 35, 40, True),
                                         (1, 35, 167, True)])
def test_wkv6_kernel_matches_plain(B, S, H, state):
    """K7 against its plain version: y within 2e-5 of each row's norm and
    the final state within 2e-5 of each head's state norm (f32 sums in
    another order, fused multiply-adds); rwkv6-3b's prefill [4,2048,40]
    from the zero state and a random one, its decode step [4,1,40] from a
    random state, a ragged S, S at the edges of K7's 16-step chunk
    (15, 16, 17, 35), 167 heads (668 blocks: the last wave of 660 on an
    H100 partial), and a second launch bit for bit the first."""
    _cuda_or_skip()
    from repro_torch.kernels import wkv6 as kwkv
    args = _wkv6_inputs(B, S, H, seed=S + H, state=state)
    before = kwkv.wkv6_scan.launches
    y, st = ops.wkv6_scan(*args)
    y2, st2 = ops.wkv6_scan(*args)
    torch.cuda.synchronize()
    assert kwkv.wkv6_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    wy, wst = ref.wkv6_scan_ref(*args)
    assert _norm_err(y, wy, (-1,)) <= 2e-5
    assert _norm_err(st, wst, (-2, -1)) <= 2e-5


@pytest.mark.gpu
def test_wkv6_chained_steps_bitwise_one_launch():
    """S launches at S = 1, each from the state the last returned (as the
    decode step carries it), equal one launch over S bit for bit: y and
    the state; S = 67 crosses four of K7's 16-step chunks and ends in a
    partial one."""
    _cuda_or_skip()
    r, k, v, w, u, s0 = _wkv6_inputs(1, 67, 40, seed=7)
    y, st = ops.wkv6_scan(r, k, v, w, u, s0)
    state = s0
    ys = []
    for t in range(r.shape[1]):
        yt, state = ops.wkv6_scan(r[:, t:t + 1], k[:, t:t + 1],
                                  v[:, t:t + 1], w[:, t:t + 1], u, state)
        ys.append(yt)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(state, st)


@pytest.mark.gpu
def test_wkv6_kernel_refuses_grad_and_widths():
    """Grad mode with an operand that requires grad goes through K7's
    autograd function (its backward launches once a call), under no_grad
    K7 launches alone; a head size other than 64 and an empty sequence
    raise, as does an operand on the CPU."""
    _cuda_or_skip()
    from repro_torch.kernels import wkv6 as kwkv
    r, k, v, w, u, s0 = _wkv6_inputs(1, 3, 2, seed=1)
    g = r.clone().requires_grad_()
    y, _ = kwkv.wkv6_scan(g, k, v, w, u, s0)
    assert type(y.grad_fn).__name__ == "WKV6ScanBackward"
    before = kwkv.wkv6_scan_bwd.launches
    y.sum().backward()
    assert kwkv.wkv6_scan_bwd.launches == before + 1
    with torch.no_grad():
        y, _ = kwkv.wkv6_scan(g, k, v, w, u, s0)
    assert y.grad_fn is None
    with pytest.raises(ValueError, match="head size"):
        kwkv.wkv6_scan(*(t[..., :32] for t in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="at least one step"):
        kwkv.wkv6_scan(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    with pytest.raises(ValueError, match="CUDA"):
        kwkv.wkv6_scan(r, k, v, w, u.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,state", [(4, 2048, 40, False),
                                         (1, 2048, 40, True),
                                         (2, 1000, 4, True),
                                         (3, 5, 2, False),
                                         (2, 130, 4, True),
                                         (2, 5, 4, True),
                                         (2, 6, 4, True),
                                         (2, 7, 4, True),
                                         (2, 13, 4, True),
                                         (2, 27, 4, True),
                                         (2, 37, 87, True),
                                         (1, 100, 1, True)])
def test_wkv6_backward_kernel_matches_plain(B, S, H, state):
    """K7's backward (``csrc/wkv6_bwd.cu``) against its plain version
    with cotangents on y and the final state: each of dr, dk, dv, dw, du
    and dS0 within 1e-4 of its norm; a second call bit for bit; each
    checkpoint K7's state over the same prefix bit for bit
    (``BWD_CHUNK``-step launches chained through the state). S = 5, 6, 7,
    13 and 27 sit at the edges of its 6-step sub-chunks and 12-step
    checkpoint intervals (130 and 1000 leave the last chunk partial);
    87 heads at B = 2 give 696 blocks, a partial last round at 4 or 5
    blocks an SM; B = H = 1 is a single cluster."""
    _cuda_or_skip()
    from repro_torch.kernels import wkv6 as kwkv
    r, k, v, w, u, s0 = _wkv6_inputs(B, S, H, seed=S + 3 * H, state=state)
    gen = np.random.default_rng(S)
    dy = torch.as_tensor(gen.standard_normal((B, S, H, 64)),
                         dtype=torch.float32).cuda()
    ds = torch.as_tensor(gen.standard_normal((B, H, 64, 64)),
                         dtype=torch.float32).cuda()
    got = kwkv.wkv6_scan_bwd(r, k, v, w, u, s0, dy, ds, checkpoints=True)
    again = kwkv.wkv6_scan_bwd(r, k, v, w, u, s0, dy, ds, checkpoints=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.wkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, ds)
    for a, b in zip(got, want):
        assert ((a - b).norm() / b.norm()).item() <= 1e-4
    ckpt, state = got[6], s0
    assert torch.equal(ckpt[:, :, 0], torch.zeros_like(ckpt[:, :, 0])
                       if s0 is None else s0)
    with torch.no_grad():
        for c in range(1, ckpt.shape[2]):
            sl = slice(kwkv.BWD_CHUNK * (c - 1), kwkv.BWD_CHUNK * c)
            _, state = kwkv.wkv6_scan(r[:, sl], k[:, sl], v[:, sl], w[:, sl],
                                      u, state)
            assert torch.equal(state, ckpt[:, :, c])
