"""Grouped gated expert FFN on the card: the wrappers of
``csrc/expert_ffn.cu`` (the port of Pallas kernel K1,
``repro/kernels/expert_ffn.py::expert_ffn``) and of its backward,
``csrc/expert_ffn_bwd.cu``, which the reference does not have (XLA
differentiates its einsum path).

``out[e] = (act(h[e] @ w_gate[e]) * (h[e] @ w_up[e])) @ w_down[e]`` for
h [E, R, d] in f32 or bf16 and weights in f32 or bf16. An optional group
map ``w_idx`` (int32 [E] on h's device) lets row group e read weight group
``w_idx[e]`` of a stack [Ew, ...], -1 marking an idle group (zero output,
no products): the expert-parallel path's replica lanes run an intra-node
peer's expert through it, so the lanes read the one f32 master stack and
its cached bf16 copy, and a weight's gradient sums every group that reads
it inside the kernel. :func:`route`
picks the forward's kernels and :func:`bwd_route` the backward's, by one
rule of type and width (as K5's dispatch does):

* ``"wgmma"`` (bf16 h, d and F multiples of 64): Hopper's tensor cores,
  bf16 products summed in f32. The forward rounds the hidden
  ``act(gt) * up`` to bf16 before the down product and returns bf16. f32
  weights (the paths' masters) are read through bf16 copies, one cast
  per weight tensor and version (:func:`weight_bf16`): an optimizer
  step's in-place update or a new tensor makes a new copy, and a dropped
  tensor's copy goes with it. The backward carries f32 weights as two
  bf16 terms, the forward's copy and :func:`weight_bf16_lo`'s remainder
  (made once per version too), and P, DU and DG likewise, so that its
  sums stay within the 5e-2 the port holds K1 to against f32 math; its
  weight gradients are f32, dh bf16. The rounding model is
  :func:`repro_torch.kernels.ref.expert_ffn_bwd_bf16_ref`.
* ``"fma"`` (f32 h, or other widths): f32 FMAs, f32 math throughout.

:class:`ExpertFFN` is the autograd function over the forward and the
backward kernels: it saves h and the weights as given. The sources say
what bounds the kernels and how they are laid out; the plain version is
:func:`repro_torch.kernels.ref.expert_ffn_ref`, whose autograd gradient
is the backward's plain version.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

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


def bwd_route(h_dtype, w_dtype, d: int, F: int) -> str:
    """The backward's kernels, by :func:`route`'s rule (a function of its
    own, so that a caller can force one direction alone)."""
    return route(h_dtype, w_dtype, d, F)


# the weight's memory and layout -> [a weak reference to the tensor the
# copy was made from, its _version then, the bf16 copy, the bf16 remainder
# w - copy or None until asked for]. Keyed by memory, not by the tensor
# object: the backward under non-reentrant checkpointing gets detached
# aliases of the weights (the same memory and version counter).
_WEIGHT_CACHE: Dict[tuple, list] = {}


def _cache_key(w: torch.Tensor) -> tuple:
    return (w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device)


def _cached(w: torch.Tensor):
    hit = _WEIGHT_CACHE.get(_cache_key(w))
    if hit is not None and hit[0]() is not None and hit[1] == w._version:
        return hit
    return None


def _drop(key, ref):
    """The weak reference's callback: forget the entry it guards."""
    hit = _WEIGHT_CACHE.get(key)
    if hit is not None and hit[0] is ref:
        del _WEIGHT_CACHE[key]


def weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """``w`` in bf16: itself if it is bf16, else its cast, made once per
    version of ``w``'s memory and kept while the tensor it was made from
    lives (the entry holds that tensor only weakly and goes when it is
    freed); an alias of ``w`` with its layout (``w.detach()``) reads the
    same copy. Adds one to ``weight_bf16.casts`` per cast made."""
    if w.dtype == torch.bfloat16:
        return w
    hit = _cached(w)
    if hit is not None:
        return hit[2]
    key = _cache_key(w)
    cast = w.detach().to(torch.bfloat16, memory_format=torch.contiguous_format)
    _WEIGHT_CACHE[key] = [weakref.ref(w, lambda r, k=key: _drop(k, r)),
                          w._version, cast, None]
    weight_bf16.casts += 1
    return cast


weight_bf16.casts = 0


def weight_bf16_lo(w: torch.Tensor) -> torch.Tensor:
    """The remainder ``bf16(w - weight_bf16(w))`` of an f32 ``w``: with
    the copy, ``w`` to 16 bits. Made once per version of ``w`` and kept
    beside the copy (reading the copy through the cache); adds one to
    ``weight_bf16.lo_casts`` per remainder made."""
    if w.dtype == torch.bfloat16:
        raise TypeError("a bf16 weight is exact: it has no remainder")
    hi = weight_bf16(w)
    entry = _cached(w)
    if entry[3] is None:
        entry[3] = torch.sub(w.detach(), hi).to(torch.bfloat16)
        weight_bf16.lo_casts += 1
    return entry[3]


weight_bf16.lo_casts = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned, as TMA reads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check(h, w_up, w_gate, w_down, act_name, w_idx=None):
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
    Ew = w_up.shape[0] if w_idx is not None else E
    want = {"w_up": (Ew, d, F), "w_gate": (Ew, d, F), "w_down": (Ew, F, d)}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(ts[name].shape)}")
    if w_idx is not None and (
            w_idx.dtype != torch.int32 or tuple(w_idx.shape) != (E,)
            or w_idx.device != h.device or not w_idx.is_contiguous()):
        raise ValueError(f"w_idx must be a contiguous int32 [{E}] tensor on "
                         f"{h.device}, got {w_idx.dtype} "
                         f"{tuple(w_idx.shape)} on {w_idx.device}")
    if max(E, Ew) > 65535 or (R + 63) // 64 > 65535:
        raise ValueError(f"E={E}, R={R} exceed the launch grid "
                         f"(E <= 65535, R <= 65535 * 64)")


class LaneCount:
    """A launch counter (``launches``) for the launches of a wrapper that
    take a group map."""

    def __init__(self):
        self.launches = 0


lanes = LaneCount()       # forward launches with a map
lanes_bwd = LaneCount()   # backward launches with a map


def _ptr(w_idx) -> Optional[int]:
    return None if w_idx is None else w_idx.data_ptr()


def expert_ffn(h, w_up, w_gate, w_down, act_name: str = "silu", w_idx=None):
    """Launch the forward on the current stream through :func:`route`'s
    kernels; raises on a refused launch. ``w_idx``: the group map (None:
    group e reads weights e), its entries in [-1, Ew). Adds one to
    ``expert_ffn.launches`` per launch (two kernels, and with a map a
    third that zeroes the idle groups' rows), and with a map one to
    ``lanes.launches``."""
    _check(h, w_up, w_gate, w_down, act_name, w_idx)
    E, R, d = h.shape
    F = w_up.shape[-1]
    Ew = w_up.shape[0]
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
                w_down.data_ptr(), out.data_ptr(), hid.data_ptr(),
                _ptr(w_idx))
        if tc:
            fn = _build.entry("expert_ffn", "expert_ffn_wgmma_launch", 7, 6)
            rc = fn(*ptrs, E, Ew, R, d, F, ACT_CODES[act_name], stream)
        else:
            fn = _build.entry("expert_ffn", "expert_ffn_launch", 7, 8)
            rc = fn(*ptrs, E, Ew, R, d, F, int(h.dtype == torch.bfloat16),
                    int(w_up.dtype == torch.bfloat16), ACT_CODES[act_name],
                    stream)
    if rc != 0:
        raise RuntimeError(f"expert_ffn launch failed: cudaError {rc}")
    expert_ffn.launches += 1
    lanes.launches += w_idx is not None
    return out


expert_ffn.launches = 0


def expert_ffn_bwd(h, w_up, w_gate, w_down, dy, act_name: str = "silu",
                   w_idx=None):
    """Launch the backward on the current stream through
    :func:`bwd_route`'s kernels: returns (dh in h's dtype, dw_up, dw_gate,
    dw_down in f32, shaped like the weights; with ``w_idx`` a weight's
    gradient sums the groups that read it, and an idle group's dh is
    zero). Raises on a refused launch. Adds one to
    ``expert_ffn_bwd.launches`` per launch (three kernels on the FMA route,
    six on the tensor cores, and with a map one more for the idle dh), and
    with a map one to ``lanes_bwd.launches``."""
    _check(h, w_up, w_gate, w_down, act_name, w_idx)
    if dy.shape != h.shape or dy.dtype != h.dtype or dy.device != h.device:
        raise ValueError(f"dy must match h ({tuple(h.shape)}, {h.dtype}, "
                         f"{h.device}), got {tuple(dy.shape)}, {dy.dtype}, "
                         f"{dy.device}")
    E, R, d = h.shape
    F = w_up.shape[-1]
    Ew = w_up.shape[0]
    tc = bwd_route(h.dtype, w_up.dtype, d, F) == "wgmma"
    dh = torch.empty_like(h)
    f32 = dict(dtype=torch.float32, device=h.device)
    dwu = torch.empty(w_up.shape, **f32)
    dwg = torch.empty(w_gate.shape, **f32)
    dwd = torch.empty(w_down.shape, **f32)
    ws = (w_up, w_gate, w_down)
    act = ACT_CODES[act_name]
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            h, dy = _aligned(h), _aligned(dy)
            split = w_up.dtype != torch.bfloat16
            his = [_aligned(weight_bf16(w)) for w in ws]
            los = [_aligned(weight_bf16_lo(w)) for w in ws] if split else his
            # P, DU, DG, each as its hi and lo bf16 terms, then dhh in
            # f32 (two planes)
            scratch = torch.empty((8, E, R, F), dtype=torch.bfloat16,
                                  device=h.device)
            fn = _build.entry("expert_ffn_bwd", "expert_ffn_bwd_wgmma_launch",
                              14, 7)
            rc = fn(h.data_ptr(), dy.data_ptr(),
                    *(t.data_ptr() for t in (*his, *los)), dh.data_ptr(),
                    dwu.data_ptr(), dwg.data_ptr(), dwd.data_ptr(),
                    scratch.data_ptr(), _ptr(w_idx), E, Ew, R, d, F,
                    int(split), act, stream)
        else:
            dy = dy.contiguous()
            scratch = [torch.empty((E, R, F), **f32) for _ in range(3)]
            fn = _build.entry("expert_ffn_bwd", "expert_ffn_bwd_launch", 13, 8)
            rc = fn(h.data_ptr(), dy.data_ptr(),
                    *(w.data_ptr() for w in ws), dh.data_ptr(),
                    dwu.data_ptr(), dwg.data_ptr(), dwd.data_ptr(),
                    *(t.data_ptr() for t in scratch), _ptr(w_idx), E, Ew,
                    R, d, F,
                    int(h.dtype == torch.bfloat16),
                    int(w_up.dtype == torch.bfloat16), act, stream)
    if rc != 0:
        raise RuntimeError(f"expert_ffn_bwd launch failed: cudaError {rc}")
    expert_ffn_bwd.launches += 1
    lanes_bwd.launches += w_idx is not None
    return dh, dwu, dwg, dwd


expert_ffn_bwd.launches = 0


class ExpertFFN(torch.autograd.Function):
    """K1 forward and backward as one differentiable op (CUDA only), with
    an optional group map (not differentiated)."""

    @staticmethod
    def forward(ctx, h, w_up, w_gate, w_down, act_name, w_idx=None):
        ctx.act_name = act_name
        ctx.save_for_backward(h, w_up, w_gate, w_down, w_idx)
        return expert_ffn(h, w_up, w_gate, w_down, act_name, w_idx)

    @staticmethod
    def backward(ctx, dy):
        h, w_up, w_gate, w_down, w_idx = ctx.saved_tensors
        dh, dwu, dwg, dwd = expert_ffn_bwd(h, w_up, w_gate, w_down,
                                           dy.to(h.dtype), ctx.act_name,
                                           w_idx)
        return (dh, dwu.to(w_up.dtype), dwg.to(w_gate.dtype),
                dwd.to(w_down.dtype), None, None)
