"""Selective SSM scan on the card: the wrappers of ``csrc/mamba_scan.cu``
(the port of Pallas kernel K6, ``repro/kernels/mamba_scan.py::
mamba_scan``), the scan of hymba's Mamba branch over a whole sequence
from the zero state. Any S and any d_inner; both entries also return the
final state, which the Pallas kernel computes too. Forward only.

:func:`mamba_scan` is K6's contract (plain version
:func:`repro_torch.kernels.ref.mamba_scan_ref`); :func:`mamba_scan_fused`
launches the same kernel with the f32 passes around the scan in
``models/ssm.py::_mamba_inner`` taken in (plain version
:func:`repro_torch.kernels.ref.mamba_scan_fused_ref`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)


def _rows(t):
    """``t`` [B, S, w] as the kernel reads it: rows of unit stride, one
    stride between consecutive (b, s) rows. Returns (t, row stride): a
    row-sliced view such as ``torch.split`` or ``torch.chunk`` gives as
    it is, anything else as a contiguous copy."""
    if t.stride(-1) == 1 and t.stride(0) == t.shape[1] * t.stride(1):
        return t, t.stride(1)
    return t.contiguous(), t.shape[-1]


def _launch(dt, bias, x, z, dskip, bmat, cmat, a):
    """Checks what both entries share and launches; None marks an operand
    of the fused entry alone."""
    fused = z is not None
    ts = [t for t in (dt, bias, x, z, dskip, bmat, cmat, a) if t is not None]
    if any(t.device.type != "cuda" or t.device != dt.device for t in ts):
        raise ValueError(f"the scan's operands must lie on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    B, S, di = dt.shape
    N = a.shape[-1]
    if (x.shape != dt.shape or bmat.shape != (B, S, N)
            or cmat.shape != (B, S, N) or a.shape != (di, N)
            or (fused and (z.shape != dt.shape or bias.shape != (di,)
                           or dskip.shape != (di,)))):
        raise ValueError(f"shapes dt {tuple(dt.shape)}, x {tuple(x.shape)}, "
                         f"B {tuple(bmat.shape)}, C {tuple(cmat.shape)}, a "
                         f"{tuple(a.shape)} do not fit [B,S,di], [B,S,N], "
                         f"[di,N] (fused: z [B,S,di], bias and d_skip [di])")
    if N not in STATE_DIMS:
        raise ValueError(f"state size N={N} is not one of {STATE_DIMS}")
    if S == 0:
        raise ValueError("the scan needs at least one step")
    dt, x, a = dt.contiguous(), x.contiguous(), a.contiguous()
    (bmat, bs), (cmat, cs) = _rows(bmat), _rows(cmat)
    zs = 0
    if fused:
        z, zs = _rows(z)
        bias, dskip = bias.contiguous(), dskip.contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    fn = _build.entry("mamba_scan", "mamba_scan_launch", 10, 9)
    ptr = [None if t is None else t.data_ptr()
           for t in (dt, bias, x, z, dskip, bmat, cmat, a)]
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptr, y.data_ptr(), h.data_ptr(), B, S, di, N, zs, bs, cs,
                int(fused), int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {rc}")
    mamba_scan.launches += 1
    return y, h


def mamba_scan(dt, x, bmat, cmat, a):
    """dt, x: [B,S,di]; bmat, cmat: [B,S,N]; a: [di,N]; all float32 on one
    CUDA device, N in ``STATE_DIMS``. Launches the kernel on the current
    stream; returns (y [B,S,di], h [B,di,N]), the final state. Adds one
    to ``mamba_scan.launches`` per launch."""
    ts = (dt, x, bmat, cmat, a)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the scan takes float32 only, got "
                        f"{[t.dtype for t in ts]}")
    return _launch(dt, None, x, None, None, bmat, cmat, a)


mamba_scan.launches = 0


def mamba_scan_fused(dt_lin, dt_bias, x, z, d_skip, bmat, cmat, a):
    """``_mamba_inner``'s tail in one launch: dt = softplus(dt_lin +
    dt_bias), the scan, then ``(y + d_skip * x) * silu(z)`` rounded to x's
    type, all math in f32. dt_lin [B,S,di], bmat and cmat [B,S,N], a
    [di,N] float32; dt_bias and d_skip [di], any float type (read as
    f32); x and z [B,S,di] in one type, float32 or bfloat16 (z may be a
    row-sliced view, as ``torch.chunk`` gives it). Returns (y [B,S,di]
    in x's type, h [B,di,N] f32). Adds one to ``mamba_scan.launches``
    and to ``mamba_scan_fused.launches`` per launch."""
    f32 = (dt_lin, bmat, cmat, a)
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError(f"dt_lin, bmat, cmat and a must be float32, got "
                        f"{[t.dtype for t in f32]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or z.dtype != x.dtype:
        raise TypeError(f"x and z must be one type, float32 or bfloat16, "
                        f"got {x.dtype} and {z.dtype}")
    out = _launch(dt_lin, dt_bias.float(), x, z, d_skip.float(), bmat, cmat,
                  a)
    mamba_scan_fused.launches += 1
    return out


mamba_scan_fused.launches = 0


def occupancy(fused: bool, dtype) -> dict:
    """What the card can keep resident of the N = 16 instance the prefill
    launches (``fused`` with x in ``dtype``, or the f32 contract entry):
    blocks per SM, threads per block and shared memory per block, from
    the CUDA occupancy calculator (not a measurement)."""
    out = torch.zeros(3, dtype=torch.int32)
    fn = _build.entry("mamba_scan", "mamba_scan_occupancy", 1, 3)
    rc = fn(out.data_ptr(), 16, int(fused), int(dtype == torch.bfloat16),
            None)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_occupancy failed: cudaError {rc}")
    blocks, threads, smem = out.tolist()
    return dict(blocks_per_sm=blocks, threads_per_block=threads,
                smem_per_block=smem, warps_per_sm=blocks * threads // 32)
