"""Masked pairwise similarity on the card: the wrapper of
``csrc/similarity.cu`` (the port of Pallas kernel K2,
``repro/kernels/similarity.py::masked_similarity``).

``out[g] = where(mask[g], (x[g] @ x[g].T * rsqrt(xx * yy + 1e-8) + 1) / 2,
0)`` for x [NG, G, d] in f32 or bf16, one launch over every group. The
source says what bounds the kernel and how it is laid out; the plain
version is :func:`repro_torch.kernels.ref.masked_similarity_ref`. The
similarity carries no gradient (it feeds only comparisons), so there is
no backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def masked_similarity(x, mask):
    """x: [NG, G, d]; mask: [NG, G, G] bool. Launches the kernel on the
    current stream; returns [NG, G, G] f32. Adds one to
    ``masked_similarity.launches`` per launch."""
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"x and mask must lie on one CUDA device, got "
                         f"{x.device} and {mask.device}")
    if x.dtype not in _DTYPES or mask.dtype != torch.bool:
        raise TypeError(f"x must be float32 or bfloat16 and mask bool, got "
                        f"{x.dtype} and {mask.dtype}")
    if x.dim() != 3 or tuple(mask.shape) != (x.shape[0], x.shape[1],
                                             x.shape[1]):
        raise ValueError(f"x must be [NG, G, d] and mask [NG, G, G], got "
                         f"{tuple(x.shape)} and {tuple(mask.shape)}")
    NG, G, d = x.shape
    if NG > 65535:
        raise ValueError(f"NG={NG} exceeds the launch grid (65535)")
    x, mask = x.contiguous(), mask.contiguous()
    out = torch.empty((NG, G, G), dtype=torch.float32, device=x.device)
    fn = _build.entry("similarity", "masked_similarity_launch", 3, 4)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), mask.data_ptr(), out.data_ptr(), NG, G, d,
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"masked_similarity launch failed: cudaError {rc}")
    masked_similarity.launches += 1
    return out


masked_similarity.launches = 0
