"""K7's arithmetic form, on the CPU, against the plain version and an f64
recurrence; and the wrapper's alignment rule.

``csrc/wkv6.cu`` computes y_t = r_t^T S + v (sum_i r_i u_i k_i), the bonus
summed once a step in f64, where the plain version
(:func:`repro_torch.kernels.ref.wkv6_scan_ref`) computes
r_t^T (S + u k_t v_t^T) per element. The two are equal in exact
arithmetic; this emulates the kernel's form in torch (f32 state and
partial sums, f64 bonus) at a small size and holds its y to the kernel's
gate, 2e-5 of each row's norm, against both. The card's own launches are
checked in ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 63.
"""
import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as kwkv

TOL = 2e-5


def _inputs(B, S, H, seed, state):
    """r, k, v ~ N(0, 1), decays exp(-exp(z)) with z in [-8, 1], a bonus
    of 0.1 N(0, 1), a random state or zeros, as phase 63 draws them."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    r, k, v = (t(rng.standard_normal((B, S, H, 64))) for _ in range(3))
    w = t(np.exp(-np.exp(rng.uniform(-8.0, 1.0, (B, S, H, 64)))))
    u = t(rng.standard_normal((H, 64)) * 0.1)
    s0 = t(rng.standard_normal((B, H, 64, 64))) if state else None
    return r, k, v, w, u, s0


def _kernel_form(r, k, v, w, u, state=None, lanes=16):
    """y and the state as K7 orders them: per step the lanes' partial sums
    of r_i S_ij over their rows (lane q the rows 4q..4q+3), added in a
    tree, plus v_j a_t with a_t summed in f64; the state updated from
    kv = k_i v_j."""
    B, S, H, hd = r.shape
    st = (torch.zeros((B, H, hd, hd)) if state is None else state.clone())
    uk = u.double()[None]                                    # [1,H,hd]
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        part = (rt[..., None] * st).reshape(B, H, lanes, hd // lanes, hd)
        acc = part.sum(3)                                    # [B,H,lanes,hd]
        while acc.shape[2] > 1:
            acc = acc[:, :, 0::2] + acc[:, :, 1::2]
        a_t = (rt.double() * (uk * kt.double())).sum(-1).float()
        ys.append(acc[:, :, 0] + vt * a_t[..., None])
        st = wt[..., None] * st + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, 1), st


def _f64(r, k, v, w, u, state=None):
    """The recurrence in f64, step by step."""
    r, k, v, w, u = (x.double() for x in (r, k, v, w, u))
    B, S, H, hd = r.shape
    st = (torch.zeros((B, H, hd, hd), dtype=torch.float64)
          if state is None else state.double())
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               st + u[..., None] * kv))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, 1), st


def _row_err(got, want):
    d = torch.linalg.vector_norm(got.double() - want.double(), dim=-1)
    n = torch.linalg.vector_norm(want.double(), dim=-1).clamp_min(1e-30)
    return (d / n).max().item()


def test_kernel_form_matches_plain_and_f64_recurrence():
    """The kernel's form (bonus out of the state loop, summed in f64)
    against the plain version and an f64 recurrence at 3 heads, 40 steps,
    from the zero state and a random one: y within 2e-5 of each row's
    norm, the state within 2e-5 of each head's state norm."""
    for seed, state in ((0, False), (1, True)):
        args = _inputs(2, 40, 3, seed, state)
        y, st = _kernel_form(*args)
        wy, wst = ref.wkv6_scan_ref(*args)
        y64, st64 = _f64(*args)
        assert _row_err(y, y64) <= TOL and _row_err(y, wy) <= TOL
        for got in (st, wst):
            d = torch.linalg.vector_norm((got.double() - st64).flatten(2), dim=-1)
            n = torch.linalg.vector_norm(st64.flatten(2), dim=-1)
            assert (d / n).max().item() <= TOL


def test_aligned_copies_only_views_off_the_16_byte_grid():
    """The wrapper hands the kernel 16-byte aligned operands: a view that
    starts 4 bytes into its storage comes back as an aligned copy with
    the same values; an aligned contiguous tensor comes back as is."""
    base = torch.arange(65, dtype=torch.float32)
    off = base[1:]
    assert off.data_ptr() % 16 == 4
    got = kwkv._aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    assert kwkv._aligned(base).data_ptr() == base.data_ptr()
