"""Grouped gated expert FFN on the card: the wrappers of
``csrc/expert_ffn.cu`` (the port of Pallas kernel K1,
``repro/kernels/expert_ffn.py::expert_ffn``) and of its backward,
``csrc/expert_ffn_bwd.cu``, which the reference does not have (XLA
differentiates its einsum path).

``out[e] = (act(h[e] @ w_gate[e]) * (h[e] @ w_up[e])) @ w_down[e]`` for
h [E, R, d] in f32 or bf16 and weights in f32 or bf16. :func:`route`
picks the forward's kernels, as K5's dispatch does, by type and width:

* ``"wgmma"`` (bf16 h, d and F multiples of 64): Hopper's tensor cores,
  bf16 products summed in f32, the hidden ``act(gt) * up`` rounded to
  bf16 before the down product, the output bf16. f32 weights (the
  paths' masters) are read through bf16 copies, one cast per weight
  tensor and version (:func:`weight_bf16`): an optimizer step's in-place
  update or a new tensor makes a new copy, and a dropped tensor's copy
  goes with it.
* ``"fma"`` (f32 h, or other widths): f32 FMAs, f32 math throughout.

:class:`ExpertFFN` is the autograd function over the forward and the
backward kernel: it saves h and the weights as given (f32 masters stay
f32 in the backward, which recomputes the hidden in f32 FMAs). The
sources say what bounds the kernels and how they are laid out; the
plain version is :func:`repro_torch.kernels.ref.expert_ffn_ref`, whose
autograd gradient is the backward's plain version.
"""
from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

ACT_CODES = {"silu": 0, "gelu": 1}
_DTYPES = (torch.float32, torch.bfloat16)
TC_WIDTH = 64   # the tensor-core route's d and F are multiples of this


def route(h_dtype, w_dtype, d: int, F: int) -> str:
    """The forward's kernels for h of ``h_dtype`` and weights of
    ``w_dtype`` (f32 or bf16) at widths d, F: ``"wgmma"`` for bf16 h at
    d and F multiples of 64, else ``"fma"``. f32 h keeps f32 math (TF32
    or bf16 products would break its 1e-4 contract)."""
    if h_dtype not in _DTYPES or w_dtype not in _DTYPES:
        raise TypeError(f"h and the weights must be float32 or bfloat16, "
                        f"got {h_dtype} and {w_dtype}")
    if h_dtype == torch.bfloat16 and d % TC_WIDTH == 0 \
            and F % TC_WIDTH == 0:
        return "wgmma"
    return "fma"


# id(w) -> (a weak reference to w, w._version at the cast, the bf16 copy)
_WEIGHT_CACHE: Dict[int, Tuple[weakref.ref, int, torch.Tensor]] = {}


def weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """``w`` in bf16: itself if it is bf16, else its cast, made once per
    version of ``w`` and kept while ``w`` lives (the entry holds ``w``
    only weakly and goes when ``w`` is freed). Adds one to
    ``weight_bf16.casts`` per cast made."""
    if w.dtype == torch.bfloat16:
        return w
    key = id(w)
    hit = _WEIGHT_CACHE.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    cast = w.detach().to(torch.bfloat16, memory_format=torch.contiguous_format)
    _WEIGHT_CACHE[key] = (
        weakref.ref(w, lambda _, k=key: _WEIGHT_CACHE.pop(k, None)),
        w._version, cast)
    weight_bf16.casts += 1
    return cast


weight_bf16.casts = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned, as TMA reads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


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
    """Launch the forward on the current stream through :func:`route`'s
    kernels; raises on a refused launch. Adds one to
    ``expert_ffn.launches`` per launch (two kernels)."""
    _check(h, w_up, w_gate, w_down, act_name)
    E, R, d = h.shape
    F = w_up.shape[-1]
    tc = route(h.dtype, w_up.dtype, d, F) == "wgmma"
    if tc:
        h = _aligned(h)
        w_up, w_gate, w_down = (_aligned(weight_bf16(w))
                                for w in (w_up, w_gate, w_down))
    out = torch.empty_like(h)
    hid = torch.empty((E, R, F), dtype=torch.bfloat16 if tc else
                      torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (h.data_ptr(), w_up.data_ptr(), w_gate.data_ptr(),
                w_down.data_ptr(), out.data_ptr(), hid.data_ptr())
        if tc:
            fn = _build.entry("expert_ffn", "expert_ffn_wgmma_launch", 6, 5)
            rc = fn(*ptrs, E, R, d, F, ACT_CODES[act_name], stream)
        else:
            fn = _build.entry("expert_ffn", "expert_ffn_launch", 6, 7)
            rc = fn(*ptrs, E, R, d, F, int(h.dtype == torch.bfloat16),
                    int(w_up.dtype == torch.bfloat16), ACT_CODES[act_name],
                    stream)
    if rc != 0:
        raise RuntimeError(f"expert_ffn launch failed: cudaError {rc}")
    expert_ffn.launches += 1
    return out


expert_ffn.launches = 0


def expert_ffn_bwd(h, w_up, w_gate, w_down, dy, act_name: str = "silu"):
    """Launch the backward on the current stream: returns (dh in h's
    dtype, dw_up, dw_gate, dw_down in f32). Raises on a refused launch.
    Adds one to ``expert_ffn_bwd.launches`` per launch (three kernels)."""
    _check(h, w_up, w_gate, w_down, act_name)
    if dy.shape != h.shape or dy.dtype != h.dtype or dy.device != h.device:
        raise ValueError(f"dy must match h ({tuple(h.shape)}, {h.dtype}, "
                         f"{h.device}), got {tuple(dy.shape)}, {dy.dtype}, "
                         f"{dy.device}")
    dy = dy.contiguous()
    E, R, d = h.shape
    F = w_up.shape[-1]
    dh = torch.empty_like(h)
    f32 = dict(dtype=torch.float32, device=h.device)
    dwu = torch.empty(w_up.shape, **f32)
    dwg = torch.empty(w_gate.shape, **f32)
    dwd = torch.empty(w_down.shape, **f32)
    scratch = [torch.empty((E, R, F), **f32) for _ in range(3)]
    fn = _build.entry("expert_ffn_bwd", "expert_ffn_bwd_launch", 12, 7)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(h.data_ptr(), dy.data_ptr(), w_up.data_ptr(),
                w_gate.data_ptr(), w_down.data_ptr(), dh.data_ptr(),
                dwu.data_ptr(), dwg.data_ptr(), dwd.data_ptr(),
                *(t.data_ptr() for t in scratch), E, R, d, F,
                int(h.dtype == torch.bfloat16),
                int(w_up.dtype == torch.bfloat16), ACT_CODES[act_name],
                stream)
    if rc != 0:
        raise RuntimeError(f"expert_ffn_bwd launch failed: cudaError {rc}")
    expert_ffn_bwd.launches += 1
    return dh, dwu, dwg, dwd


expert_ffn_bwd.launches = 0


class ExpertFFN(torch.autograd.Function):
    """K1 forward and backward as one differentiable op (CUDA only)."""

    @staticmethod
    def forward(ctx, h, w_up, w_gate, w_down, act_name):
        ctx.act_name = act_name
        ctx.save_for_backward(h, w_up, w_gate, w_down)
        return expert_ffn(h, w_up, w_gate, w_down, act_name)

    @staticmethod
    def backward(ctx, dy):
        h, w_up, w_gate, w_down = ctx.saved_tensors
        dh, dwu, dwg, dwd = expert_ffn_bwd(h, w_up, w_gate, w_down,
                                           dy.to(h.dtype), ctx.act_name)
        return (dh, dwu.to(w_up.dtype), dwg.to(w_gate.dtype),
                dwd.to(w_down.dtype), None)
