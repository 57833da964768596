"""Grouped gated expert FFN on the card: the wrapper of
``csrc/expert_ffn.cu`` (the port of Pallas kernel K1,
``repro/kernels/expert_ffn.py::expert_ffn``).

``out[e] = (act(h[e] @ w_gate[e]) * (h[e] @ w_up[e])) @ w_down[e]`` with
f32 math, for h [E, R, d] in f32 or bf16 and weights in f32 or bf16.
The source says what bounds the kernel and how it is laid out; the
plain version is :func:`repro_torch.kernels.ref.expert_ffn_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACT_CODES = {"silu": 0, "gelu": 1}
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("expert_ffn")
    fn = lib.expert_ffn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(h, w_up, w_gate, w_down, act_name):
    if act_name not in ACT_CODES:
        raise ValueError(f"act must be one of {sorted(ACT_CODES)}, "
                         f"got {act_name!r}")
    ts = {"h": h, "w_up": w_up, "w_gate": w_gate, "w_down": w_down}
    for name, t in ts.items():
        if t.device.type != "cuda" or t.device != h.device:
            raise ValueError(f"{name} must lie on h's CUDA device "
                             f"({h.device}), got {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-d tensor, got "
                             f"shape {tuple(t.shape)}")
    if not (w_up.dtype == w_gate.dtype == w_down.dtype):
        raise TypeError("w_up, w_gate and w_down must share one dtype")
    E, R, d = h.shape
    F = w_up.shape[-1]
    want = {"w_up": (E, d, F), "w_gate": (E, d, F), "w_down": (E, F, d)}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(ts[name].shape)}")
    if E > 65535 or (R + 63) // 64 > 65535:
        raise ValueError(f"E={E}, R={R} exceed the launch grid "
                         f"(E <= 65535, R <= 65535 * 64)")


def expert_ffn(h, w_up, w_gate, w_down, act_name: str = "silu"):
    """Launch the kernel on the current stream; raises on a refused
    launch. Adds one to ``expert_ffn.launches`` per launch."""
    _check(h, w_up, w_gate, w_down, act_name)
    E, R, d = h.shape
    F = w_up.shape[-1]
    out = torch.empty_like(h)
    hid = torch.empty((E, R, F), dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.expert_ffn_launch(
            h.data_ptr(), w_up.data_ptr(), w_gate.data_ptr(),
            w_down.data_ptr(), out.data_ptr(), hid.data_ptr(),
            E, R, d, F, int(h.dtype == torch.bfloat16),
            int(w_up.dtype == torch.bfloat16), ACT_CODES[act_name], stream)
    if rc != 0:
        raise RuntimeError(f"expert_ffn launch failed: cudaError {rc}")
    expert_ffn.launches += 1
    return out


expert_ffn.launches = 0
