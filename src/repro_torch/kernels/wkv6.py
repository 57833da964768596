"""The WKV6 recurrence on the card: the wrapper of ``csrc/wkv6.cu``
(kernel K7), the core of RWKV-6's time-mix
(``models/ssm.py::_rwkv6_core``). It replaces no Pallas kernel: the
reference runs this recurrence as a ``lax.scan``
(``repro/models/ssm.py::_rwkv6_core``), which on the card would be six
launches a token a layer. Plain version:
:func:`repro_torch.kernels.ref.wkv6_scan_ref`.

The kernel splits a (batch, head) over G blocks of 64 / G state columns;
a group of 16 lanes shares four columns, each lane holding four of their
rows in registers, and a producer warp stages chunks of T steps of r, k,
w and v in shared memory by cp.async, tracked by mbarriers
(:func:`occupancy` reports G, T and the layout). The rank-one bonus is
summed once a step in f64, a_t = sum_i r_i u_i k_i, and added as
v_j a_t, so y rounds otherwise than the plain version's r^T (S + u k v^T);
the state update rounds as the recurrence writes it, and a step computes
the same bits at any position of any launch.

With grad mode on and an operand that requires grad, :func:`wkv6_scan`
goes through :class:`WKV6Scan`: its forward is the same launch, its
backward :func:`wkv6_scan_bwd`, the hand-written backward
(``csrc/wkv6_bwd.cu``: a checkpoint pass of the state every
``BWD_CHUNK`` steps, then the chunks walked in reverse from their
checkpoints by a cluster of four blocks a (batch, head), the row sums
taken a few steps at a time out of the step loop and dv's block partials
summed through the cluster's shared memory; plain version
:func:`repro_torch.kernels.ref.wkv6_scan_bwd_ref`). It saves only its
inputs, so a remat recompute (the forward run again in the backward)
rebuilds nothing it relies on. Under ``torch.no_grad`` or
``inference_mode`` (serving) the wrapper launches K7 alone and saves
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIM = 64


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy where it is not)."""
    if t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def _check(r, k, v, w, u, state):
    ts = [t for t in (r, k, v, w, u, state) if t is not None]
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"K7 takes float32 only, got "
                        f"{[t.dtype for t in ts]}")
    if r.dim() != 4:
        raise ValueError(f"r must be [B,S,H,hd], got {tuple(r.shape)}")
    B, S, H, hd = r.shape
    if hd != HEAD_DIM:
        raise ValueError(f"K7 takes a head size of {HEAD_DIM}, got {hd}")
    if S == 0:
        raise ValueError("the recurrence needs at least one step")
    sshape = (B, H, hd, hd)
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, hd)
            or (state is not None and state.shape != sshape)):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)} do not fit [B,S,H,hd] and "
                         f"[H,hd] (state [B,H,hd,hd])")
    if any(t.device.type != "cuda" or t.device != r.device for t in ts):
        raise ValueError(f"K7's operands must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")


def _launch(r, k, v, w, u, state):
    """One K7 launch on checked operands: (y, the final state)."""
    B, S, H, hd = r.shape
    # the kernel moves r, k, v, w and the state 16 bytes at a time: a view
    # that starts off that grid (never one the time-mix or the decode cache
    # makes) is copied first
    r, k, v, w = (_aligned(t) for t in (r, k, v, w))
    u = u.contiguous()
    if state is not None:
        state = _aligned(state)
    y = torch.empty_like(r)
    out_state = torch.empty((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    fn = _build.entry("wkv6", "wkv6_launch", 8, 4)
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            y.data_ptr(), out_state.data_ptr(), B, S, H, hd,
            _build.raw_stream(r.device.index))
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError {rc}")
    wkv6_scan.launches += 1
    return y, out_state


class WKV6Scan(torch.autograd.Function):
    """K7 under autograd: the forward launch, and :func:`wkv6_scan_bwd`
    as the backward. Saves the inputs only; an unused final state's
    cotangent reaches the kernel as null (zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        return _launch(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, d_state):
        r, k, v, w, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = wkv6_scan_bwd(r, k, v, w, u, state, dy,
                                                d_state)
        return dr, dk, dv, dw, du, None if state is None else ds0


def wkv6_scan(r, k, v, w, u, state=None):
    """r, k, v, w: [B,S,H,64]; u: [H,64]; state: [B,H,64,64] laid out
    [k][v] (None: zeros); all float32 on one CUDA device, S >= 1.
    Launches K7 on the current stream; returns (y [B,S,H,64] f32, the
    final state [B,H,64,64] f32, a new tensor). Adds one to
    ``wkv6_scan.launches`` per launch. With grad mode on and an operand
    that requires grad, the result carries :class:`WKV6Scan`'s backward."""
    _check(r, k, v, w, u, state)
    ts = [t for t in (r, k, v, w, u, state) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return WKV6Scan.apply(r, k, v, w, u, state)
    return _launch(r, k, v, w, u, state)


wkv6_scan.launches = 0

# steps between the backward's checkpoints, as csrc/wkv6_bwd.cu fixes
# them (C there; it sizes the checkpoint workspace, and the kernel refuses
# a workspace of another size)
BWD_CHUNK = 12


def wkv6_scan_bwd(r, k, v, w, u, state, dy, d_state=None, *,
                  checkpoints: bool = False):
    """The gradients of :func:`wkv6_scan` (``csrc/wkv6_bwd.cu``; plain
    version ``ref.wkv6_scan_bwd_ref``): r, k, v, w, dy [B,S,H,64]; u
    [H,64]; state (None: zeros) and d_state, the final state's cotangent
    (None: zeros), [B,H,64,64]; all float32 on one CUDA device. Returns
    (dr, dk, dv, dw [B,S,H,64], du [H,64], dS_0 [B,H,64,64]), and with
    ``checkpoints`` also the states the backward starts its chunks from,
    [B,H,ceil(S/BWD_CHUNK),64,64]: chunk c's is the state after its first
    ``BWD_CHUNK`` c steps, K7's bit for bit. One call launches three
    kernels on the current stream (the checkpoint pass, the reverse walk
    in clusters, du's sum over the batch) and adds one to
    ``wkv6_scan_bwd.launches``."""
    _check(r, k, v, w, u, state)
    _check(r, dy, dy, dy, u, d_state)
    B, S, H, hd = r.shape
    r, k, v, w, dy = (_aligned(t.detach()) for t in (r, k, v, w, dy))
    u = u.detach().contiguous()
    state = None if state is None else _aligned(state.detach())
    d_state = None if d_state is None else _aligned(d_state.detach())
    dev = r.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    nch = -(-S // BWD_CHUNK)
    ckpt, at, vdy = f32(B, H, nch, hd, hd), f32(B, S, H), f32(B, S, H)
    du_part = f32(B, H, hd)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = f32(H, hd), f32(B, H, hd, hd)
    fn = _build.entry("wkv6_bwd", "wkv6_bwd_launch", 18, 5)
    rc = fn(*(None if t is None else t.data_ptr()
              for t in (r, k, v, w, u, state, dy, d_state, ckpt, at, vdy,
                        du_part, dr, dk, dv, dw, du, ds0)),
            B, S, H, hd, nch, _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd launch failed: cudaError {rc}")
    wkv6_scan_bwd.launches += 1
    out = (dr, dk, dv, dw, du, ds0)
    return out + (ckpt,) if checkpoints else out


wkv6_scan_bwd.launches = 0


BWD_DESIGN = ("threads_per_block", "smem_per_block", "registers",
              "local_bytes", "blocks_per_sm", "clusters", "G", "D", "C",
              "DR", "ckpt_registers", "ckpt_local_bytes")


def bwd_occupancy() -> dict:
    """The backward as built: the reverse walk's threads and shared bytes
    a block, registers and local (spill) bytes a thread, resident blocks
    an SM and clusters on the card at the train shape's grid (the
    occupancy calculator, not a measurement); its design, G (blocks a
    (batch, head), one cluster), D (steps a sub-chunk), C (steps between
    checkpoints), DR (steps a round of sums); the checkpoint pass's
    registers and local bytes a thread."""
    out = torch.zeros(len(BWD_DESIGN), dtype=torch.int32)
    rc = _build.entry("wkv6_bwd", "wkv6_bwd_design", 1, 0)(
        out.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd_design failed: cudaError {rc}")
    return dict(zip(BWD_DESIGN, out.tolist()))


def occupancy() -> dict:
    """The built kernel's design and what the card keeps resident of it:
    G (blocks a head), T (steps a chunk), columns a lane, lanes a column,
    threads and shared bytes a block, resident blocks an SM (the CUDA
    occupancy calculator, not a measurement), registers and local (spill)
    bytes a thread."""
    out = torch.zeros(9, dtype=torch.int32)
    rc = _build.entry("wkv6", "wkv6_occupancy", 1, 0)(out.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"wkv6_occupancy failed: cudaError {rc}")
    return dict(zip(("G", "T", "columns_per_lane", "lanes_per_column",
                     "threads_per_block", "smem_per_block", "blocks_per_sm",
                     "registers", "local_bytes"), out.tolist()))
