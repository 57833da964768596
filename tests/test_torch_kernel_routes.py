"""The choices the port makes around K1's, K2's and K3's card kernels, on
the CPU: K1's forward and backward routes and K2's route (tensor cores or
f32 FMAs) as pure functions of types and widths, the cache of bf16 weight
copies (and the backward's second bf16 terms) the tensor-core routes
read, and the group-local un-condense whose card backward needs no global sort,
held against the JAX reference (K3's Pallas kernel in interpret mode, and
the VJP of the reference's gather) on a map made from a numpy seed.
Values and gradients bitwise: a gather copies rows, and its f32 gradient
adds each representative's rows in index order on both sides.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.condense import plan as tplan
from repro_torch.kernels import expert_ffn as kexp

BF16, F32 = torch.bfloat16, torch.float32


ROUTES = [
    (BF16, F32, 768, 3072, "wgmma"),      # the paths: bf16 rows, f32 masters
    (BF16, BF16, 768, 3072, "wgmma"),
    (BF16, F32, 64, 192, "wgmma"),        # F a multiple of 64, not of 128
    (F32, F32, 768, 3072, "fma"),         # f32 keeps f32 math
    (F32, BF16, 768, 3072, "fma"),
    (BF16, F32, 33, 3072, "fma"),         # d not a multiple of 64
    (BF16, BF16, 768, 100, "fma"),        # F not a multiple of 64
    (BF16, F32, 32, 64, "fma"),
]


@pytest.mark.parametrize("h,w,d,F,want", ROUTES)
def test_k1_route_by_type_and_width(h, w, d, F, want):
    assert kexp.route(h, w, d, F) == want
    assert kexp.route(h, w, d, F) == want          # no state
    with pytest.raises(TypeError):
        kexp.route(torch.float16, w, d, F)


@pytest.mark.parametrize("h,w,d,F,want", ROUTES)
def test_k1_bwd_route_by_type_and_width(h, w, d, F, want):
    """The backward takes the forward's rule, through a function of its
    own that a caller may replace alone."""
    assert kexp.bwd_route(h, w, d, F) == want
    assert kexp.bwd_route(h, w, d, F) == kexp.route(h, w, d, F)
    with pytest.raises(TypeError):
        kexp.bwd_route(h, torch.float16, d, F)


SIM_ROUTES = [
    (BF16, 768, "wgmma"),      # the train path: bf16 rows of moe-gpt2's width
    (BF16, 48, "wgmma"),       # d a multiple of 16, not of the 64-wide slab
    (BF16, 16, "wgmma"),
    (BF16, 40, "fma"),       # d a multiple of 8, not of 16
    (BF16, 33, "fma"),
    (F32, 768, "fma"),       # f32 rows keep f32 math
    (F32, 64, "fma"),
]


@pytest.mark.parametrize("x,d,want", SIM_ROUTES)
def test_k2_route_by_type_and_width(x, d, want):
    from repro_torch.kernels import similarity as ksim
    assert ksim.route(x, d) == want
    assert ksim.route(x, d) == want              # no state
    with pytest.raises(TypeError):
        ksim.route(torch.float16, d)


# K5's route: bf16 at the configs' head dims on the tensor cores (hd 64,
# 128, 160, 256), everything else on FMAs
FLASH_ROUTES = [(BF16, 64, "wgmma"), (BF16, 128, "wgmma"),
                (BF16, 160, "wgmma"), (BF16, 256, "wgmma"),
                (BF16, 32, "fma"), (BF16, 192, "fma"), (F32, 128, "fma"),
                (F32, 256, "fma")]


@pytest.mark.parametrize("dtype,hd,want", FLASH_ROUTES)
def test_k5_route_by_type_and_head_dim(dtype, hd, want):
    from repro_torch.kernels import flash_attn as kfa
    assert kfa.route(dtype, hd) == want
    assert kfa.MAX_HEAD_DIM == 256


def test_k5_wrapper_refuses_a_cpu_tensor():
    """The wrapper launches or raises: a CPU tensor is refused before any
    build or launch (``ops.flash_attention`` takes the plain version
    there)."""
    from repro_torch.kernels import flash_attn as kfa
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(q, q, q)


def test_weight_cast_cache_hits_misses_and_holds_no_tensor():
    w = torch.randn((2, 64, 128))
    before = kexp.weight_bf16.casts
    c1 = kexp.weight_bf16(w)
    assert c1.dtype == BF16 and torch.equal(c1, w.to(BF16))
    assert kexp.weight_bf16(w) is c1                 # same version: a hit
    assert kexp.weight_bf16.casts == before + 1
    w.add_(1.0)                                      # an in-place update
    c2 = kexp.weight_bf16(w)
    assert c2 is not c1 and torch.equal(c2, w.to(BF16))
    assert kexp.weight_bf16.casts == before + 2
    wb = w.to(BF16)
    assert kexp.weight_bf16(wb) is wb                # bf16 is used as is
    assert kexp.weight_bf16.casts == before + 2
    ref, key = weakref.ref(w), kexp._cache_key(w)
    del w
    gc.collect()
    assert ref() is None                             # no strong reference
    assert key not in kexp._WEIGHT_CACHE             # and its copy is gone


def test_weight_lo_term_cached_per_version_beside_the_copy():
    """The backward's second bf16 term of an f32 weight: made once per
    version from the forward's cached copy (no second cast), holding the
    weight to 16 bits; an in-place update makes both anew."""
    w = torch.randn((2, 64, 128)) * 0.05
    casts = kexp.weight_bf16.casts
    lo_casts = kexp.weight_bf16.lo_casts
    hi = kexp.weight_bf16(w)
    lo = kexp.weight_bf16_lo(w)
    assert lo.dtype == BF16 and kexp.weight_bf16_lo(w) is lo
    assert kexp.weight_bf16(w) is hi
    assert (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts) == (
        casts + 1, lo_casts + 1)
    assert torch.equal(lo, (w - hi.float()).to(BF16))
    err = (hi.float() + lo.float() - w).abs()
    assert torch.all(err <= w.abs() * 2.0 ** -16)
    w.mul_(2.0)
    lo2 = kexp.weight_bf16_lo(w)                     # a new version
    assert lo2 is not lo
    assert (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts) == (
        casts + 2, lo_casts + 2)
    with pytest.raises(TypeError):
        kexp.weight_bf16_lo(w.to(BF16))              # bf16 is exact


def test_weight_cast_cache_hits_through_a_detached_alias():
    """The backward under non-reentrant checkpointing gets the weights as
    detached aliases: they read the copy and the remainder made for the
    weight (same memory, layout and version); a view of other layout and
    an update through the alias miss."""
    w = torch.randn((2, 64, 128), requires_grad=True)
    hi = kexp.weight_bf16(w)
    lo = kexp.weight_bf16_lo(w)
    casts = (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts)
    alias = w.detach()
    assert kexp.weight_bf16(alias) is hi and kexp.weight_bf16_lo(alias) is lo
    assert (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts) == casts
    part = alias[:1]                                 # another layout
    assert kexp.weight_bf16(part) is not hi
    assert kexp.weight_bf16.casts == casts[0] + 1
    alias.add_(1.0)                                  # shared version counter
    hi2 = kexp.weight_bf16(w)
    assert hi2 is not hi and torch.equal(hi2, w.detach().to(BF16))


class _CastProbe(torch.autograd.Function):
    """Reads the weight's bf16 copy in its forward and its backward, as
    K1's autograd function does; records what the backward saw."""

    @staticmethod
    def forward(ctx, x, w):
        kexp.weight_bf16(w)
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _CastProbe.seen.append(w)
        kexp.weight_bf16(w)
        return g @ w.t(), x.t() @ g


def test_weight_cast_cache_hits_in_a_checkpointed_backward():
    """Under torch.utils.checkpoint (non-reentrant, as the train path's
    remat), the backward sees a detached alias of the weight, not the
    weight; the copy made in the forward still serves it and the
    recompute: one cast per weight and version."""
    from torch.utils.checkpoint import checkpoint
    w = torch.randn((8, 8), requires_grad=True)
    x = torch.randn((4, 8), requires_grad=True)
    _CastProbe.seen = []
    before = kexp.weight_bf16.casts
    checkpoint(_CastProbe.apply, x, w, use_reentrant=False).sum().backward()
    assert len(_CastProbe.seen) == 1 and _CastProbe.seen[0] is not w
    assert kexp.weight_bf16.casts == before + 1
    assert torch.equal(w.grad, x.t() @ torch.ones((4, 8)))


def test_weight_cast_cache_misses_on_a_new_tensor_of_equal_values():
    w = torch.randn((1, 64, 64))
    c1 = kexp.weight_bf16(w)
    w2 = w.clone()
    before = kexp.weight_bf16.casts
    c2 = kexp.weight_bf16(w2)
    assert c2 is not c1 and torch.equal(c2, c1)
    assert kexp.weight_bf16.casts == before + 1


def _group_local_map(seed, n_groups, G, reps_per_group):
    """Each token sent to one of its group's representatives, the
    representatives to themselves (as condense_tokens makes the map)."""
    r = np.random.default_rng(seed)
    reps = np.sort(np.stack([r.choice(G, reps_per_group, replace=False)
                             for _ in range(n_groups)]), axis=1)
    rep_of = np.take_along_axis(
        reps, r.integers(0, reps_per_group, (n_groups, G)), axis=1)
    rep_of[np.arange(n_groups)[:, None], reps] = reps
    return (rep_of + G * np.arange(n_groups)[:, None]).reshape(-1).astype(
        np.int32)


@pytest.mark.parametrize("n_groups,G,d,reps", [(4, 128, 48, 9),
                                               (3, 128, 7, 1),
                                               (2, 64, 16, 64)])
def test_uncondense_group_local_matches_reference_bitwise(n_groups, G, d,
                                                          reps):
    idx = _group_local_map(21, n_groups, G, reps)
    T = n_groups * G
    assert np.all(idx // G == np.arange(T) // G)
    r = np.random.default_rng(22)
    y = r.standard_normal((T, d)).astype(np.float32)
    dy = r.standard_normal((T, d)).astype(np.float32)
    ty = torch.as_tensor(y).requires_grad_()
    got = tplan.uncondense(ty, torch.as_tensor(idx), G)
    want = jops.gather_rows(jnp.asarray(y), jnp.asarray(idx),
                            bt=G, interpret=True)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.as_tensor(dy))
    _, vjp = jax.vjp(lambda v: jref.gather_rows_ref(v, jnp.asarray(idx)),
                     jnp.asarray(y))
    (g_ref,) = vjp(jnp.asarray(dy))
    np.testing.assert_array_equal(ty.grad.numpy(), np.asarray(g_ref))
    # the same as without the group size (the plain version needs no sort)
    ty2 = torch.as_tensor(y).requires_grad_()
    tplan.uncondense(ty2, torch.as_tensor(idx)).backward(torch.as_tensor(dy))
    assert torch.equal(ty2.grad, ty.grad)


# ---------------------------------------------------------------------------
# K1's group map (replica lanes): the plain version against the
# reference's concatenated stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h_dtype", [F32, BF16])
def test_k1_group_map_plain_version_is_the_concatenated_stack(h_dtype):
    """``ref.expert_ffn_ref(..., w_idx)`` over 4 ranks of 2 experts, each
    with a lane (idle, or an intra-node peer's expert), equals the plain
    version on the reference's concatenation ``[w_rank; w[src] * live]``
    rank by rank, forward and autograd (the same f32 products, so bit for
    bit); an idle lane's rows are zero and add nothing to any gradient."""
    from repro_torch.kernels import ref
    r = np.random.default_rng(24)
    E, M, R, d, F = 8, 4, 24, 32, 48
    e_local = E // M
    src = [-1, 0, 5, -1]                    # each rank's lane
    w_idx = torch.tensor([g for m in range(M) for g in
                          [m * e_local + j for j in range(e_local)]
                          + [src[m]]], dtype=torch.int32)
    G = w_idx.numel()
    h = torch.as_tensor(r.standard_normal((G, R, d)), dtype=F32).to(h_dtype)
    ws = [torch.as_tensor(r.standard_normal(s) * 0.1, dtype=F32)
          for s in ((E, d, F), (E, d, F), (E, F, d))]
    dy = torch.as_tensor(r.standard_normal((G, R, d)), dtype=F32).to(h_dtype)

    def run(stacked):
        leaves = [w.clone().requires_grad_() for w in ws]
        hh = h.clone().requires_grad_()
        if stacked:
            def stack(w):
                parts = []
                for m in range(M):
                    live = float(src[m] >= 0)
                    parts += [w[m * e_local:(m + 1) * e_local],
                              w[max(src[m], 0)][None] * live]
                return torch.cat(parts)
            out = ref.expert_ffn_ref(hh, *(stack(w) for w in leaves),
                                     "gelu")
        else:
            out = ref.expert_ffn_ref(hh, *leaves, "gelu", w_idx)
        out.backward(dy)
        return out, hh.grad, [w.grad for w in leaves]

    got, gh, gw = run(False)
    want, wh, ww = run(True)
    assert torch.equal(got, want) and torch.equal(gh, wh)
    for a, b in zip(gw, ww):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    idle = (w_idx < 0).nonzero().reshape(-1)
    assert torch.all(got[idle] == 0) and torch.all(gh[idle] == 0)
    # and the plain version repeats bit for bit
    assert torch.equal(run(False)[2][0], gw[0])
