"""The deduplicated hierarchical wire (counterpart of
``repro/condense/wire.py``), for every rank at once.

Tensors are rank-major (``repro_torch.comm.hierarchical``). Dispatch
packs one row per (token, destination node) into ``[N, C_u, d]`` per
rank with kernel K4 (gate mask, dedup pack and the wire codec in one
pass), crosses nodes once with it, fans it out on the node's links and
rebuilds the dense expert rows through a re-expansion map that rides
the ordinary dense exchange. Combine pre-reduces each (token, node) on
the expert side, finishes the node sum with an intra-node reduce-scatter
and sends one partial row back across nodes; the receiver adds the node
partials in ascending node order. Migrate mode keys the pre-reduce by
each row's destination in the migrated frame, so the partials land at
the sequences' new homes.

Summation order: every scatter-add on this path has at most two writers
per slot under top-2 on two nodes (a token's copies), and two addends
sum exactly in either order, so a run repeats bit for bit. With more
writers (top-k > 2 or more nodes) the node partials are still added in
ascending node order and the local reduce-scatter in ascending local
rank, but a pre-reduce slot's writers add in the scatter's order.

The gradient of the wire is the reference's (``repro.comm.dtypes``
transposes, step for step; see :mod:`repro_torch.comm.dtypes`): each
collective is a permutation that is its own transpose, so the backward
moves cotangents back through the same collective.

``chunks=`` (a :class:`~repro_torch.sched.ChunkPlan` over the unique-row
axis, or the token axis of the migrate-mode combine) runs the node hop
as the reference's ``_node_hop`` does: K4's pack-quantize (or the codec)
runs once over the whole payload, then each chunk's hop runs on the
pipeline's side stream (:mod:`repro_torch.sched.pipeline`) while the
previous chunk dequantizes and fans out on the current one, and the
chunks reassemble in slot order. The hop is a permutation and the codec
row-wise, so the result is the one-shot hop's bit for bit; the backward
hops the cotangent chunk by chunk the same way.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.comm import dtypes as wdt
from repro_torch.comm.hierarchical import CommContext
from repro_torch.kernels import ops as kops
from repro_torch.sched.pipeline import run_pipeline, share, side_stream
from repro_torch.sched.plan import ChunkPlan


def _hop_bytes(hop: Callable, t):
    """Move ``t`` through a permutation collective; f8 moves as bytes."""
    if t is None:
        return None
    if t.dtype == wdt.F8:
        return hop(t.view(torch.uint8)).view(wdt.F8)
    return hop(t)


def _chunk(t, chunks: ChunkPlan, k: int):
    """Chunk ``k`` of ``t [M, A*R, ...]`` along R (``chunks.capacity``),
    as ``[M, A*s_k, ...]``."""
    M, R, rest = t.shape[0], chunks.capacity, t.shape[2:]
    o, s = chunks.offsets[k], chunks.sizes[k]
    return t.reshape(M, t.shape[1] // R, R, *rest)[:, :, o:o + s] \
        .reshape(M, -1, *rest)


def _unchunk(parts, chunks: ChunkPlan):
    """The chunks ``[M, A*s_k, ...]`` back in slot order, ``[M, A*R, ...]``."""
    M, rest = parts[0].shape[0], parts[0].shape[2:]
    return torch.cat([p.reshape(M, -1, s, *rest)
                      for p, s in zip(parts, chunks.sizes)], dim=2) \
        .reshape(M, -1, *rest)


def _hop_chunks(hop: Callable, ts, chunks: Optional[ChunkPlan],
                land: Callable):
    """``land`` of the tensors ``ts`` (None kept) moved through ``hop``:
    in one piece, or chunk by chunk over ``chunks``, each chunk's hop on
    the side stream and its ``land`` on the current one."""
    if chunks is None or chunks.n_chunks <= 1:
        return land(tuple(_hop_bytes(hop, t) for t in ts))
    stream = side_stream(ts[0].device)
    share(stream, ts)
    outs, _ = run_pipeline(
        chunks.n_chunks,
        dispatch=lambda k: tuple(
            None if t is None else _hop_bytes(hop, _chunk(t, chunks, k))
            for t in ts),
        compute=lambda k, p: land(p), stream=stream)
    return _unchunk(outs, chunks)


def _sum_nodes(x):
    """Sum over dim 1 (the node axis) in ascending node order."""
    acc = x[:, 0]
    for n in range(1, x.shape[1]):
        acc = acc + x[:, n]
    return acc


def _unpack_t(g_rows, back_idx):
    """Transpose of the dedup pack: token t's cotangent is the sum of its
    wire rows' cotangents (``back_idx [T, N]``, -1 = none), added in
    ascending node order as the reference's transpose sums them."""
    safe = back_idx.clamp(min=0)
    got = g_rows.index_select(0, safe.reshape(-1)).reshape(
        *back_idx.shape, g_rows.shape[-1])
    return _sum_nodes(got * (back_idx >= 0)[..., None].to(got.dtype))


class _Ship(torch.autograd.Function):
    """Rows through the wire: quantize (with the dedup pack, kernel K4,
    when ``tok`` is given), cross ``hop`` (chunk by chunk over
    ``chunks``, :func:`_hop_chunks`), dequantize to ``out_dtype`` and,
    when ``fan`` (a comm context) is given, fan out over the node's
    ranks (``fan.local_all_gather``). The backward is the reference's
    transpose of the same chain."""

    @staticmethod
    def forward(ctx, x, tok, back_idx, hop, wire_dtype, out_dtype,
                shape, chunks=None, fan=None):
        d = x.shape[-1]
        if tok is None:
            q, sc = wdt.quantize_rows(x, wire_dtype)
        else:
            q, sc = kops.pack_quantize(x, tok, wire_dtype)
            q = q.reshape(*shape, q.shape[-1])
            sc = None if sc is None else sc.reshape(*shape, sc.shape[-1])

        def land(p):
            y = wdt.dequantize_rows(p[0], p[1], out_dtype, d)
            return y if fan is None else fan.local_all_gather(y)

        ctx.save_for_backward(x, tok, back_idx)
        ctx.hop, ctx.wire_dtype, ctx.q_dtype = hop, wire_dtype, q.dtype
        ctx.chunks, ctx.fan = chunks, fan
        return _hop_chunks(hop, (q, sc), chunks, land)

    @staticmethod
    def backward(ctx, g):
        x, tok, back_idx = ctx.saved_tensors
        hop, wire, chunks = ctx.hop, ctx.wire_dtype, ctx.chunks
        if ctx.fan is not None:
            g = ctx.fan.local_all_gather_t(g)
        if wire == "f8e4m3":
            # the row-local transposes commute with the permutation, so
            # the cotangent moves back first and one kernel does the rest
            d = x.shape[-1]
            g_src = _hop_chunks(hop, (g.to(x.dtype),), chunks,
                                lambda p: p[0]).reshape(-1, d)
            g_rows = kops.pack_quant_bwd(x.reshape(-1, d), tok, g_src)
            g_rows = g_rows.reshape(g.shape)
        else:
            # a cast wire casts the cotangent to the wire's type and back
            g_rows = _hop_chunks(hop, (g.to(ctx.q_dtype),), chunks,
                                 lambda p: p[0].to(x.dtype))
        if tok is not None:
            g_rows = _unpack_t(g_rows.reshape(-1, x.shape[-1]), back_idx)
        return g_rows, None, None, None, None, None, None, None, None


def ship_rows(comm_fn: Callable, buf, d: int, wire_dtype: str):
    """Move ``buf [M, ..., w >= d]`` through a permutation collective with
    its first ``d`` columns at the wire dtype; the trailing columns ship
    beside them at full precision. ``"f32"`` ships the buffer as is."""
    if wire_dtype == "f32":
        return comm_fn(buf)
    x = _Ship.apply(buf[..., :d], None, None, comm_fn, wire_dtype,
                    buf.dtype, None)
    if buf.shape[-1] == d:
        return x
    return torch.cat([x, comm_fn(buf[..., d:])], dim=-1)


def dedup_capacity(tokens: int, e_local: int, local: int,
                   capacity: int) -> int:
    """Unique-row capacity per (source rank, destination node): at most
    one row per token and per dispatch slot of the node, so it never
    overflows."""
    bound = min(tokens, e_local * local * capacity)
    return max(8, ((bound + 7) // 8) * 8)


def dedup_dispatch(xf, expert_idx, gate_w, valid, pos, *,
                   comm: CommContext, e_local: int, capacity: int,
                   wire_dtype: str = "f32",
                   dest_gpos: Optional[torch.Tensor] = None,
                   prim: Optional[torch.Tensor] = None,
                   chunks: Optional[ChunkPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Dict]:
    """Ship the deduplicated payload and rebuild the dense expert rows.

    xf: [M, T, d] payload rows (compute dtype); expert_idx, gate_w,
    valid, pos: [M, T, k] routing (valid excludes condensed and dropped
    rows). Returns ``(x_rows [M, E_local, M, C, d], gw [M, E_local, M,
    C], rvalid, state)``: per expert rank, the rows of each source
    rank's dispatch slots, bit for bit the dense wire's after the wire
    codec. Migrate mode (``dest_gpos [M, T]``, ``prim [M, T, k]``) adds
    each row's destination position and primary flag to the map.
    ``chunks`` (over ``dedup_capacity``) pipelines the node hop and its
    dequantize and fan-out; K4 runs once."""
    N, L = comm.nodes, comm.local_size
    M = N * L
    _, T, k = expert_idx.shape
    d = xf.shape[-1]
    C = capacity
    E = e_local * M
    cdt = xf.dtype
    dev = xf.device
    ranks = comm.index(dev)
    arN = torch.arange(N, device=dev)

    node_of = (expert_idx // e_local) // L                    # [M, T, k]
    hit = (node_of[..., None] == arN) & valid[..., None]      # [M,T,k,N]
    headed = hit.any(dim=2)                                   # [M, T, N]
    h_i = headed.long()
    urank = torch.cumsum(h_i, dim=1) - h_i                    # [M, T, N]
    C_u = dedup_capacity(T, e_local, L, C)
    un_safe = torch.where(headed, urank, torch.zeros_like(urank))

    # slot -> token map over every rank's [N, C_u] wire rows (-1 empty);
    # each occupied slot has exactly one token
    R = M * N * C_u
    slot = (ranks[:, None, None] * N + arN) * C_u + urank     # [M, T, N]
    back_idx = torch.where(headed, slot, torch.full_like(slot, -1))
    gid = (ranks[:, None, None] * T
           + torch.arange(T, device=dev)[None, :, None]).expand(M, T, N)
    tok = torch.full((R + 1,), -1, dtype=torch.int32, device=dev)
    tok[torch.where(headed, slot, torch.full_like(slot, R)).reshape(-1)] = \
        gid.reshape(-1).to(torch.int32)
    tok = tok[:R]
    ug = _Ship.apply(xf.reshape(M * T, d), tok,
                     back_idx.reshape(M * T, N), comm.node_all_to_all,
                     wire_dtype, cdt, (M, N * C_u), chunks,
                     comm)                                    # [M, L*N*C_u, d]

    # re-expansion map in the dense dispatch layout, exact in f32:
    # (uslot + 1, gate weight) [+ (dest_gpos + 1, primary flag)]
    u_copy = torch.gather(urank, 2, node_of)                  # [M, T, k]
    cols = [(u_copy + 1).float(), gate_w.float()]
    if dest_gpos is not None:
        cols.append((dest_gpos.float()[..., None] + 1.0).expand(M, T, k))
        cols.append(prim.float())
    w = len(cols)
    mvals = torch.stack(cols, -1).reshape(M * T * k, w)
    flat = (ranks[:, None, None] * E + expert_idx) * C + pos  # [M, T, k]
    flat = torch.where(valid, flat, torch.full_like(flat, M * E * C))
    mbuf = torch.zeros((M * E * C + 1, w), dtype=torch.float32, device=dev)
    mbuf = mbuf.index_copy(0, flat.reshape(-1), mvals)[:M * E * C]
    mbuf = comm.all_to_all(mbuf.reshape(M, E, C, w))
    rmeta = mbuf.reshape(M, M, e_local, C, w).transpose(1, 2)  # [M,El,M,C,w]
    u = torch.round(rmeta[..., 0]).long() - 1
    rvalid = u >= 0
    u_safe = u.clamp(min=0)
    gw = (rmeta[..., 1] * rvalid.float()).to(cdt)
    m_ids = torch.arange(M, device=dev)
    gi = (m_ids % L) * N + m_ids // L                         # row block in ug
    rows = ((ranks[:, None, None, None] * (L * N)
             + gi[None, None, :, None]) * C_u + u_safe)       # [M,El,M,C]
    x_rows = ug.reshape(M * L * N * C_u, d).index_select(
        0, rows.reshape(-1)).reshape(*rows.shape, d)
    x_rows = x_rows * rvalid[..., None].to(cdt)

    occ = h_i.float().sum(dim=1)                              # [M, N]
    my_node = ranks // L
    state = {"headed": headed, "un_safe": un_safe, "u_safe": u_safe,
             "rvalid": rvalid, "N": N, "L": L, "M": M, "C_u": C_u, "T": T,
             "shipped_rows": occ.sum(dim=1) - occ[m_ids, my_node]}
    if dest_gpos is not None:
        dg = torch.round(rmeta[..., 2]).long() - 1
        state["dgpos"] = torch.where(rvalid, dg, torch.full_like(dg, -1))
        state["prim"] = (rmeta[..., 3] * rvalid.float()).to(cdt)
    return x_rows, gw, rvalid, state


def dedup_combine(out_rows, state, *, comm: CommContext,
                  wire_dtype: str = "f32",
                  chunks: Optional[ChunkPlan] = None):
    """Return gate-weighted expert rows [M, E_local, M, C, d] to their
    source tokens with per-node pre-reduction. Returns delta [M, T, d].
    ``chunks`` (over ``dedup_capacity``) pipelines the return hop."""
    N, L, M, C_u = state["N"], state["L"], state["M"], state["C_u"]
    rvalid, u_safe = state["rvalid"], state["u_safe"]
    headed, un_safe = state["headed"], state["un_safe"]
    d = out_rows.shape[-1]
    cdt = out_rows.dtype
    dev = out_rows.device
    T = headed.shape[1]
    ranks = comm.index(dev)
    m_grid = torch.arange(M, device=dev)[None, None, :, None]
    dst = (ranks[:, None, None, None] * M + m_grid) * C_u + u_safe
    dst = torch.where(rvalid, dst, torch.full_like(dst, M * M * C_u))
    comb = torch.zeros((M * M * C_u + 1, d), dtype=cdt, device=dev)
    comb = comb.index_add(0, dst.reshape(-1), out_rows.reshape(-1, d))
    comb = comb[:M * M * C_u].reshape(M, N, L, C_u, d).transpose(1, 2)
    part = comm.local_psum_scatter(comb.reshape(M, L * N * C_u, d))
    pback = _Ship.apply(part, None, None, comm.node_all_to_all, wire_dtype,
                        cdt, None, chunks).reshape(M, N, C_u, d)
    idx = ((ranks[:, None, None] * N + torch.arange(N, device=dev))
           * C_u + un_safe)                                   # [M, T, N]
    g = pback.reshape(M * N * C_u, d).index_select(0, idx.reshape(-1))
    g = g.reshape(M * T, N, d) * headed.reshape(M * T, N, 1).to(cdt)
    return _sum_nodes(g).reshape(M, T, d)


def dedup_combine_migrate(out_rows, state, *, comm: CommContext,
                          wire_dtype: str = "f32",
                          chunks: Optional[ChunkPlan] = None):
    """Dest-keyed combine: rows [M, E_local, M, C, d], gate-weighted and
    carrying the primary copy's residual, land at each token's position
    in the migrated frame. Returns y [M, T, d] at the new homes.
    ``chunks`` (over the T token positions) pipelines the return hop."""
    N, L, M, T = state["N"], state["L"], state["M"], state["T"]
    dgpos = state["dgpos"]
    d = out_rows.shape[-1]
    cdt = out_rows.dtype
    dev = out_rows.device
    ranks = comm.index(dev)
    live = dgpos >= 0
    dst = ranks[:, None, None, None] * (M * T) + dgpos        # (rank, dd, dp)
    dst = torch.where(live, dst, torch.full_like(dst, M * M * T))
    comb = torch.zeros((M * M * T + 1, d), dtype=cdt, device=dev)
    comb = comb.index_add(0, dst.reshape(-1), out_rows.reshape(-1, d))
    comb = comb[:M * M * T].reshape(M, N, L, T, d).transpose(1, 2)
    part = comm.local_psum_scatter(comb.reshape(M, L * N * T, d))
    pback = _Ship.apply(part, None, None, comm.node_all_to_all, wire_dtype,
                        cdt, None, chunks).reshape(M, N, T, d)
    return _sum_nodes(pback)
