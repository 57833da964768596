"""Selective SSM scan on the card: the wrapper of ``csrc/mamba_scan.cu``
(the port of Pallas kernel K6, ``repro/kernels/mamba_scan.py::
mamba_scan``), the scan of hymba's Mamba branch over a whole sequence
from the zero state. Any S and any d_inner; it also returns the final
state, which the Pallas kernel computes too. Forward only. The plain
version is :func:`repro_torch.kernels.ref.mamba_scan_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)


def mamba_scan(dt, x, bmat, cmat, a):
    """dt, x: [B,S,di]; bmat, cmat: [B,S,N]; a: [di,N]; all float32 on one
    CUDA device, N in ``STATE_DIMS``. Launches the kernel on the current
    stream; returns (y [B,S,di], h [B,di,N]), the final state. Adds one
    to ``mamba_scan.launches`` per launch."""
    ts = (dt, x, bmat, cmat, a)
    if any(t.device.type != "cuda" or t.device != dt.device for t in ts):
        raise ValueError(f"dt, x, bmat, cmat, a must lie on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the scan takes float32 only, got "
                        f"{[t.dtype for t in ts]}")
    B, S, di = dt.shape
    N = a.shape[-1]
    if (x.shape != dt.shape or bmat.shape != (B, S, N)
            or cmat.shape != (B, S, N) or a.shape != (di, N)):
        raise ValueError(f"shapes dt {tuple(dt.shape)}, x {tuple(x.shape)}, "
                         f"B {tuple(bmat.shape)}, C {tuple(cmat.shape)}, a "
                         f"{tuple(a.shape)} do not fit [B,S,di], [B,S,N], "
                         f"[di,N]")
    if N not in STATE_DIMS:
        raise ValueError(f"state size N={N} is not one of {STATE_DIMS}")
    ts = [t.contiguous() for t in ts]
    y = torch.empty_like(ts[0])
    h = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    fn = _build.entry("mamba_scan", "mamba_scan_launch", 7, 4)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ts), y.data_ptr(), h.data_ptr(),
                B, S, di, N, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {rc}")
    mamba_scan.launches += 1
    return y, h


mamba_scan.launches = 0
