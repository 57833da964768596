"""Dedup-wire pack and quantize on the card: the wrappers of
``csrc/pack.cu``, the port of Pallas kernel K4
(``repro/kernels/pack.py::pack_quantize``).

Wire row ``r`` is source row ``x[tok[r]]`` (a zero row where ``tok[r]``
is -1), then either block-quantized to float8_e4m3fn with f32 scales
(:func:`pack_quant`, the f8 wire) or cast to the wire's type
(:func:`pack_cast`, the f32 and bf16 wires). Both are bit for bit the
plain version, :func:`repro_torch.kernels.ref.pack_quantize_ref`.

The reference has no gradient for its kernel (it trains through the
scatter-then-quantize path, which JAX transposes). The port's
:func:`pack_quant_bwd` is that transpose for the f8 wire as one kernel:
the cotangent of the dequantized rows (moved back to the sending rank)
-> the cotangent of the packed rows, the e4m3 cast of the scaled
cotangent included. Its plain version is
:func:`repro_torch.kernels.ref.pack_quant_bwd_ref`; the wire composes
them in :mod:`repro_torch.condense.wire`.
"""
from __future__ import annotations

import torch

from repro_torch.comm import dtypes as wdt
from repro_torch.kernels import _build


def _check(x, tok):
    if x.device.type != "cuda" or tok.device != x.device:
        raise ValueError(f"x and tok must lie on one CUDA device, got "
                         f"{x.device} and {tok.device}")
    if x.dtype is not torch.float32 and x.dtype is not torch.bfloat16:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or tok.dim() != 1:
        raise ValueError(f"x must be [T, d] and tok [R], got "
                         f"{tuple(x.shape)} and {tuple(tok.shape)}")
    if tok.dtype is not torch.int32:
        tok = tok.to(torch.int32)
    return x.contiguous(), tok.contiguous()


# C entries of csrc/pack.cu by name, looked up at first use
_ENTRIES = {}


def _run(fn_name: str, n_ptr: int, n_int: int, x, *args):
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        fn = _ENTRIES[fn_name] = _build.entry("pack", fn_name, n_ptr, n_int)
    dev = x.device
    if dev.index == _build.current_device():
        rc = fn(*args, _build.raw_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {rc}")


def pack_quant(x, tok):
    """x: [T, d] f32 or bf16 on a CUDA device; tok: [R] integer, each -1
    or in [0, T). Returns ``(q [R, d_pad] float8_e4m3fn, scales [R,
    d_pad/32] f32)``. Adds one to ``pack_quant.launches`` per launch."""
    x, tok = _check(x, tok)
    T, d = x.shape
    R, d_pad = tok.shape[0], wdt.pad_to_block(d)
    q = x.new_empty((R, d_pad), dtype=wdt.F8)
    sc = x.new_empty((R, d_pad // wdt.SCALE_BLOCK), dtype=torch.float32)
    _run("pack_quant_launch", 4, 5, x, x.data_ptr(), tok.data_ptr(),
         q.data_ptr(), sc.data_ptr(), R, T, d, d_pad,
         int(x.dtype is torch.bfloat16))
    pack_quant.launches += 1
    return q, sc


pack_quant.launches = 0


def pack_cast(x, tok, out_dtype):
    """x, tok as :func:`pack_quant`; returns the packed rows [R, d] in
    ``out_dtype`` (f32 or bf16). Adds one to ``pack_cast.launches`` per
    launch."""
    x, tok = _check(x, tok)
    if out_dtype is not torch.float32 and out_dtype is not torch.bfloat16:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    T, d = x.shape
    R = tok.shape[0]
    out = x.new_empty((R, d), dtype=out_dtype)
    _run("pack_cast_launch", 3, 5, x, x.data_ptr(), tok.data_ptr(),
         out.data_ptr(), R, T, d, int(x.dtype is torch.bfloat16),
         int(out_dtype is torch.bfloat16))
    pack_cast.launches += 1
    return out


pack_cast.launches = 0


def pack_quantize(x, tok, wire_dtype: str = "f32"):
    """The reference kernel's contract: ``(q, scales)`` exactly as
    ``quantize_rows`` of the packed rows (scales None on a cast wire)."""
    if wire_dtype == "f8e4m3":
        return pack_quant(x, tok)
    out = x.dtype if wire_dtype == "f32" else torch.bfloat16
    return pack_cast(x, tok, out), None


def pack_quant_bwd(x, tok, g):
    """x: [T, d] f32 or bf16 on a CUDA device; tok: [R] integer (-1 or in
    [0, T)) or None (the rows are x's own, R = T); g: [R, d] in x's type,
    the cotangent of the dequantized rows. Returns the cotangent of the
    packed rows [R, d] in x's type. Adds one to ``pack_quant_bwd.launches``
    per launch."""
    if tok is None:
        x = x.contiguous()
        if x.device.type != "cuda" or x.dim() != 2:
            raise ValueError(f"x must be [T, d] on a CUDA device, got "
                             f"{tuple(x.shape)} on {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    else:
        x, tok = _check(x, tok)
    T, d = x.shape
    R = T if tok is None else tok.shape[0]
    g = g.to(x.dtype).contiguous()
    if tuple(g.shape) != (R, d):
        raise ValueError(f"g must be [{R}, {d}], got {tuple(g.shape)}")
    dx = torch.empty((R, d), dtype=x.dtype, device=x.device)
    _run("pack_quant_bwd_launch", 4, 5, x, x.data_ptr(),
         None if tok is None else tok.data_ptr(), g.data_ptr(),
         dx.data_ptr(), R, T, d, wdt.pad_to_block(d),
         int(x.dtype == torch.bfloat16))
    pack_quant_bwd.launches += 1
    return dx


pack_quant_bwd.launches = 0
