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

Forward only: with grad mode on and an operand that requires grad the
wrapper raises, since the kernel has no backward yet (ROADMAP Queue 1
item 8.7) and autograd would otherwise see no gradient at all.
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


def wkv6_scan(r, k, v, w, u, state=None):
    """r, k, v, w: [B,S,H,64]; u: [H,64]; state: [B,H,64,64] laid out
    [k][v] (None: zeros); all float32 on one CUDA device, S >= 1.
    Launches K7 on the current stream; returns (y [B,S,H,64] f32, the
    final state [B,H,64,64] f32, a new tensor). Adds one to
    ``wkv6_scan.launches`` per launch."""
    ts = [t for t in (r, k, v, w, u, state) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "wkv6_scan (K7) is forward only: its backward is not ported "
            "yet (ROADMAP Queue 1 item 8.7); run under torch.no_grad or "
            "torch.inference_mode")
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
    # the kernel moves r, k, v, w and the state 16 bytes at a time: a view
    # that starts off that grid (never one the time-mix or the decode cache
    # makes) is copied first
    r, k, v, w = (_aligned(t) for t in (r, k, v, w))
    u = u.contiguous()
    if state is not None:
        state = _aligned(state)
    y = torch.empty_like(r)
    out_state = torch.empty(sshape, dtype=torch.float32, device=r.device)
    fn = _build.entry("wkv6", "wkv6_launch", 8, 4)
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            y.data_ptr(), out_state.data_ptr(), B, S, H, hd,
            _build.raw_stream(r.device.index))
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError {rc}")
    wkv6_scan.launches += 1
    return y, out_state


wkv6_scan.launches = 0


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
