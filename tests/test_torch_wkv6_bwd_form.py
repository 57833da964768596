"""K7's backward's order of sums, on the CPU, against the plain version,
an f64 recurrence and the order of the design it replaced.

``csrc/wkv6_bwd.cu`` takes every cross-lane sum out of its step loop:
each lane writes its partial of dr, dk and dw over its eight columns (a
fused multiply-add chain over each four, columns in order, then their
sum, the first level of the row's tree) and dv's sum over its two rows
to shared memory, and every few steps the block sums them in fixed
trees, dr, dk and dw over a row's lanes pairwise, dv over each 16-row
group's eight pair sums in order and then over the four groups in order
(the groups' partials meet through the cluster's shared memory). This
emulates that order in torch (f32 partials; a multiply-add rounded once
from f64) at a small size and holds the gradients to the kernel's gate,
1e-4 of each gradient's norm, against ``ref.wkv6_scan_bwd_ref`` and an
f64 autograd; it also emulates the order of the former design (a lane's
four columns, every lane's butterfly over the row, a pair shuffle, then
warps and blocks in order) and shows the two give the same bits. The
order does not depend on the row blocks a (batch, head): a 16-row group
is summed inside whichever block holds it, and the groups in order. The
card's own launches are checked in ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 66.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

TOL = 1e-4
HD = 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, seed, state):
    """r, k, v ~ N(0, 1), decays exp(-exp(z)) with z in [-8, 1], a bonus
    of 0.1 N(0, 1), a cotangent dy ~ N(0, 1), and with ``state`` a random
    initial state and a cotangent on the final state (else None)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    r, k, v = (t(rng.standard_normal((B, S, H, HD))) for _ in range(3))
    w = t(np.exp(-np.exp(rng.uniform(-8.0, 1.0, (B, S, H, HD)))))
    u = t(rng.standard_normal((H, HD)) * 0.1)
    dy = t(rng.standard_normal((B, S, H, HD)))
    s0 = t(rng.standard_normal((B, H, HD, HD))) if state else None
    ds = t(rng.standard_normal((B, H, HD, HD))) if state else None
    return r, k, v, w, u, s0, dy, ds


def _fma(a, b, c):
    """a b + c rounded to f32 from f64 (a b is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def _lanes(a, b):
    """Each lane's partial over its four columns: [..., 64] -> [..., 16],
    lane q the chain fma(a_j, b_j, .) over j = 4 q .. 4 q + 3 in order."""
    a4 = a.reshape(*a.shape[:-1], HD // 4, 4)
    b4 = b.reshape(*b.shape[:-1], HD // 4, 4)
    acc = torch.zeros(torch.broadcast_shapes(a4.shape, b4.shape)[:-1])
    for e in range(4):
        acc = _fma(a4[..., e], b4[..., e], acc)
    return acc


def _tree(x):
    """The lanes (last dim) summed pairwise: partners at distance 1, 2, 4,
    then 8, as the redesigned kernel's rounds sum them."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _butterfly(x):
    """Every lane's sum after the xor rounds of the former design's
    shuffles (lane l adds lane l ^ o's value, o = 1, 2, 4, 8); all equal."""
    idx = torch.arange(x.shape[-1])
    o = 1
    while o < x.shape[-1]:
        x = x + x[..., idx ^ o]
        o <<= 1
    assert bool((x == x[..., :1]).all())
    return x[..., 0]


def _dv_cluster(prod):
    """dv's sum over the rows of ``prod`` [..., 64 rows, 64] as the
    redesigned kernel orders it: row pairs, then each 16-row group's eight
    pair sums in order (inside its block), then the four groups' partials
    in order (across the cluster)."""
    pairs = prod[..., 0::2, :] + prod[..., 1::2, :]          # [..., 32, 64]
    parts = []
    for grp in range(4):
        s = pairs[..., 8 * grp, :]
        for m in range(1, 8):
            s = s + pairs[..., 8 * grp + m, :]
        parts.append(s)
    return ((parts[0] + parts[1]) + parts[2]) + parts[3]


def _dv_former(prod):
    """The former design's dv sum: a warp's two rows by a shuffle, the
    eight warps of a block in order in shared memory, the four blocks'
    partials in order by a third launch."""
    blocks = []
    for blk in range(4):
        rows = prod[..., 16 * blk:16 * blk + 16, :]
        warps = [rows[..., 2 * wp, :] + rows[..., 2 * wp + 1, :]
                 for wp in range(8)]
        s = warps[0]
        for m in range(1, 8):
            s = s + warps[m]
        blocks.append(s)
    s = blocks[0]
    for m in range(1, 4):
        s = s + blocks[m]
    return s


def _emulate(r, k, v, w, u, s0, dy, ds_T, *, former=False):
    """The backward in the kernel's order of sums (``former``: the order
    of the design it replaced). Returns (dr, dk, dv, dw, du, dS0)."""
    B, S, H, _ = r.shape
    st = torch.zeros((B, H, HD, HD)) if s0 is None else s0.clone()
    states = []
    for t in range(S):                 # K7's rounding: fma(w, S, k v)
        states.append(st)
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        st = _fma(w[:, t, :, :, None].expand_as(st), st, kv)
    a = torch.zeros((B, S, H), dtype=torch.float64)
    vd = torch.zeros((B, S, H), dtype=torch.float64)
    for i in range(HD):                # f64, i in order, rounded once
        a = a + r[..., i].double() * (u[:, i].double() * k[..., i].double())
        vd = vd + v[..., i].double() * dy[..., i].double()
    a, vd = a.float(), vd.float()
    ds = torch.zeros((B, H, HD, HD)) if ds_T is None else ds_T.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_rows = torch.zeros((B, H, HD))
    rowsum = _butterfly if former else _tree
    for t in reversed(range(S)):
        sp, rt, kt, vt, wt, yt = (states[t], r[:, t], k[:, t], v[:, t],
                                  w[:, t], dy[:, t])
        vdt = vd[:, t, :, None]
        pr = rowsum(_lanes(sp, yt[:, :, None, :]))
        pk = rowsum(_lanes(ds, vt[:, :, None, :]))
        pw = rowsum(_lanes(ds, sp))
        dr[:, t] = _fma(u * kt, vdt, pr)
        dk[:, t] = _fma(rt * u, vdt, pk)
        dw[:, t] = pw
        du_rows = _fma(rt * kt, vdt, du_rows)
        prod = ds * kt[..., None]
        p = _dv_former(prod) if former else _dv_cluster(prod)
        dv[:, t] = _fma(a[:, t, :, None].expand_as(yt), yt, p)
        ds = _fma(wt[..., None].expand_as(ds), ds,
                  rt[..., None] * yt[:, :, None, :])
    du = du_rows[0]
    for b in range(1, B):              # over the batch in its order
        du = du + du_rows[b]
    return dr, dk, dv, dw, du, ds


def _rel(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-300)).item()


@pytest.mark.parametrize("state", [False, True])
def test_bwd_order_matches_plain_f64_and_former_order(state):
    """At [2,70,2,64] (from the zero state, y's cotangent alone; and from
    a random state with a cotangent on the final state): the redesigned
    order within 1e-4 of each gradient's norm of the plain backward and of
    an f64 autograd through the plain forward, and bit for bit the former
    design's order."""
    args = _inputs(2, 70, 2, 33 + state, state)
    got = _emulate(*args)
    want = ref.wkv6_scan_bwd_ref(*args)
    r, k, v, w, u, s0, dy, ds = args
    ins = [None if x is None else x.double().requires_grad_()
           for x in (r, k, v, w, u, s0)]
    y64, st64 = ref.wkv6_scan_ref(*ins)
    loss = (y64 * dy.double()).sum()
    if ds is not None:
        loss = loss + (st64 * ds.double()).sum()
    loss.backward()
    names = ("dr", "dk", "dv", "dw", "du", "dS0")
    for name, g, wp, x in zip(names, got, want, ins):
        assert _rel(g, wp) <= TOL, name
        if x is not None:
            assert _rel(g, x.grad) <= TOL, name
    former = _emulate(*args, former=True)
    for name, g, f in zip(names, got, former):
        assert torch.equal(g, f), name


def test_partials_swizzle_round_trips():
    """The shared-memory swizzle of the row partials: lane q (of 8) of row
    pair p writes float4 slot ((q / 2) ^ (p / 2)) % 4, half q % 2; the
    round reads slot m ^ ((p / 2) % 4) as lanes 2 m and 2 m + 1. Each slot
    holds one lane pair, the reads find lanes in order, and the 32
    threads of a warp's stores (four row pairs) and of the round's loads
    (eight row pairs, four steps) meet no bank more often than their bytes
    need."""
    for p in range(32):
        slots = {}
        for q in range(8):
            slots.setdefault(((q >> 1) ^ (p >> 1)) & 3, []).append(
                (q, q & 1))
        for m in range(4):
            assert slots[m ^ ((p >> 1) & 3)] == [(2 * m, 0), (2 * m + 1, 1)]

    def banks(word):
        return {(word + x) % 32 for x in range(4)}

    # the round: a warp's eight row pairs read slot m ^ ((p / 2) % 4) of
    # their 16 words; four steps share the banks, so four wavefronts
    for m in range(4):
        seen = [banks(16 * p + 4 * (m ^ ((p >> 1) & 3))) for p in range(8)]
        assert len(set().union(*seen)) == 32
    # the step loop: a warp's four row pairs, eight lanes a float2 each
    for p0 in range(0, 32, 4):
        words = [16 * p + 4 * (((q >> 1) ^ (p >> 1)) & 3) + 2 * (q & 1) + x
                 for p in range(p0, p0 + 4) for q in range(8)
                 for x in range(2)]
        assert len(set(words)) == 64
        assert all(sum(1 for wd in words if wd % 32 == bk) == 2
                   for bk in range(32))
