"""Wire dtypes: the byte model of the compressed exchange and its codec
(counterpart of ``repro/comm/dtypes.py``).

``f32`` is the identity wire (rows ship at the compute dtype), ``bf16``
a cast, ``f8e4m3`` a float8_e4m3fn payload with one f32 scale per
``SCALE_BLOCK`` elements, ``scale = amax * (1/448)`` (1.0 for an
all-zero block). The executed ledger divides by the same
:func:`wire_row_bytes` / :func:`wire_precision` the reference defines,
so ``shipped == flat / (dedup * precision)`` holds exactly.

The codec's gradient is the reference's, not autograd's. JAX
differentiates ``quantize_rows`` then ``dequantize_rows`` by
transposing each primitive: the cotangent of the f8 payload is itself
cast to float8_e4m3fn (after the multiply by the block scale), the
scale's cotangent runs back through the block max and is shared evenly
among ties, and a cast wire casts the cotangent. :func:`dequantize_t`
and :func:`quantize_t` are those transposes, step for step.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

WIRE_DTYPES = ("f32", "bf16", "f8e4m3")
SCALE_BLOCK = 32
F8_MAX = 448.0
# 1/448 rounded to f32 once, as the reference's traced constant is
F8_INV = float(np.float32(1.0 / F8_MAX))
F8 = torch.float8_e4m3fn


def validate_wire_dtype(wire_dtype: str) -> str:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}")
    return wire_dtype


def wire_itemsize(wire_dtype: str, compute_itemsize: int) -> int:
    """Bytes per payload element on the wire (never wider than compute)."""
    if wire_dtype == "f32":
        return compute_itemsize
    if wire_dtype == "bf16":
        return min(2, compute_itemsize)
    if wire_dtype == "f8e4m3":
        return 1
    raise ValueError(f"unknown wire_dtype {wire_dtype!r}")


def scale_bytes(d_model: int, wire_dtype: str) -> int:
    """Bytes of f32 block scales per shipped row (f8 only)."""
    if wire_dtype != "f8e4m3":
        return 0
    return 4 * math.ceil(d_model / SCALE_BLOCK)


def wire_row_bytes(d_model: int, wire_dtype: str,
                   compute_itemsize: int) -> float:
    """Bytes one row occupies on the node-crossing wire: the payload, the
    f8 scales and the 2 side columns at the compute dtype."""
    return (d_model * wire_itemsize(wire_dtype, compute_itemsize)
            + scale_bytes(d_model, wire_dtype) + 2 * compute_itemsize)


def wire_precision(d_model: int, wire_dtype: str,
                   compute_itemsize: int) -> float:
    """Full-precision row bytes over wire row bytes (1.0 on f32)."""
    full = (d_model + 2) * compute_itemsize
    return full / wire_row_bytes(d_model, wire_dtype, compute_itemsize)


def pad_to_block(d_model: int) -> int:
    return SCALE_BLOCK * math.ceil(d_model / SCALE_BLOCK)


def _blocks(x):
    """[..., d] -> f32 [..., d_pad/32, 32], zero-padded."""
    d = x.shape[-1]
    xf = x.float()
    if pad_to_block(d) != d:
        xf = F.pad(xf, (0, pad_to_block(d) - d))
    return xf.reshape(*xf.shape[:-1], -1, SCALE_BLOCK)


def _scales(amax):
    one = torch.ones((), dtype=torch.float32, device=amax.device)
    return torch.where(amax > 0, amax * F8_INV, one)


def quantize_rows(x, wire_dtype: str
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rows [..., d] for the wire: ``(x, None)`` on f32, ``(bf16 cast,
    None)`` on bf16, else the f8 payload [..., d_pad] and the f32
    scales [..., d_pad/32] (multiply by the reciprocal for the scale,
    divide for the payload, exactly as the reference)."""
    if wire_dtype == "f32":
        return x, None
    if wire_dtype == "bf16":
        return x.to(torch.bfloat16), None
    if wire_dtype != "f8e4m3":
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    blocks = _blocks(x)
    scales = _scales(blocks.abs().amax(dim=-1))
    q = (blocks / scales[..., None]).reshape(*x.shape[:-1], -1)
    return q.to(F8), scales


def dequantize_rows(q, scales, out_dtype, d_model: int):
    """Inverse of :func:`quantize_rows` at ``out_dtype``."""
    if scales is None:
        return q.to(out_dtype)
    x = (q.float().reshape(*q.shape[:-1], -1, SCALE_BLOCK)
         * scales[..., None]).reshape(*q.shape[:-1], -1)
    return x[..., :d_model].to(out_dtype)


# ---------------------------------------------------------------------------
# the reference's gradient of the f8 codec, split where the wire splits it

def dequantize_t(g, q, scales):
    """Transpose of :func:`dequantize_rows` (f8) at the receiving end.

    g: [..., d] cotangent of the dequantized rows; q, scales: what was
    received. Returns ``(ct_q, ct_scales)``: the payload's cotangent
    ``f8(g * scale)`` held as f32 (its values are e4m3 values), and the
    scales' ``sum(q * g)`` per block."""
    bk = _blocks(g)
    bb = q.float().reshape(*q.shape[:-1], -1, SCALE_BLOCK)
    ct_scales = torch.sum(bb * bk, dim=-1)
    ct_q = (bk * scales[..., None]).to(F8).float()
    return ct_q, ct_scales


def quantize_t(x, ct_q, ct_scales):
    """Transpose of :func:`quantize_rows` (f8) at the sending end.

    x: [..., d] the rows that were quantized; ct_q [..., nb, 32] and
    ct_scales [..., nb] from :func:`dequantize_t` (moved back through
    the wire). Returns the f32 cotangent of x [..., d]: the payload's
    ``ct_q / scale``, plus the scale's cotangent through ``amax`` shared
    evenly among the block's ties, signed by each tie."""
    g = _blocks(x)
    h = g.abs()
    amax = h.amax(dim=-1)
    ties = (h == amax[..., None]).float()
    n = ties.sum(dim=-1)
    live = amax > 0
    v = _scales(amax)
    bw = torch.sum((ct_q * (1.0 / (v * v))[..., None]) * g, dim=-1)
    cb = ct_scales + (-bw)
    cc = torch.where(live, cb, torch.zeros_like(cb))
    ch = ((cc * F8_INV) / n)[..., None] * ties
    zero = torch.zeros_like(ch)
    pos = g >= 0
    out = (ct_q / v[..., None] + torch.where(pos, ch, zero)) \
        + (-torch.where(pos, zero, ch))
    return out.reshape(*x.shape[:-1], -1)[..., :x.shape[-1]]
