"""The choices the port makes around K1's and K3's card kernels, on the
CPU: K1's route (tensor cores or f32 FMAs) as a pure function of types
and widths, the cache of bf16 weight copies the tensor-core route reads,
and the group-local un-condense whose card backward needs no global sort,
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


@pytest.mark.parametrize("h,w,d,F,want", [
    (BF16, F32, 768, 3072, "wgmma"),      # the paths: bf16 rows, f32 masters
    (BF16, BF16, 768, 3072, "wgmma"),
    (BF16, F32, 64, 192, "wgmma"),        # F a multiple of 64, not of 128
    (F32, F32, 768, 3072, "fma"),         # f32 keeps f32 math
    (F32, BF16, 768, 3072, "fma"),
    (BF16, F32, 33, 3072, "fma"),         # d not a multiple of 64
    (BF16, BF16, 768, 100, "fma"),        # F not a multiple of 64
    (BF16, F32, 32, 64, "fma"),
])
def test_k1_route_by_type_and_width(h, w, d, F, want):
    assert kexp.route(h, w, d, F) == want
    assert kexp.route(h, w, d, F) == want          # no state
    with pytest.raises(TypeError):
        kexp.route(torch.float16, w, d, F)


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
    ref, key = weakref.ref(w), id(w)
    del w
    gc.collect()
    assert ref() is None                             # no strong reference
    assert key not in kexp._WEIGHT_CACHE             # and its copy is gone


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
