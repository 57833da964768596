"""Streaming-softmax attention on the card: the wrapper of
``csrc/flash_attn.cu`` (the port of Pallas kernel K5,
``repro/kernels/flash_attn.py::flash_attention``), the attention core of
every decoder's batched prefill on the card (hymba's, and since slice 17
every other arch's whose mask it takes; since slice 19 also an
encoder-decoder's encoder, non-causal, and its cross-attention, from Sq
decoder positions to Sk encoder positions). Causal and sliding-window
masks by position (0..S-1 in every row), fully masked key tiles never
visited, grouped KV heads read in place; without a mask the keys may
number other than the queries. Forward only (no backward yet: ROADMAP
Queue 2).
The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.

What bounds it is operations at the bf16 tensor-core rate, so the source
dispatches by dtype and head dim (:func:`route`): bf16 at hd 64, 128,
160 or 256 runs on the tensor cores (``wgmma`` for Q K^T and P V, K/V
tiles brought in by TMA through a ring of mbarrier-guarded stages; P is
rounded to bf16 before P V, as :func:`repro_torch.models.blocks.attend`
rounds it), everything else (f32 at any hd, bf16 at other hd) on plain
f32 FMAs. Both take the Pallas kernel's arithmetic and repeat bit for
bit (no atomics). Any hd that is a multiple of 4 up to 256 is taken.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
# bf16 head dims the tensor-core kernel takes (the configs' 64, 128, 160
# and 256)
TC_HEAD_DIMS = (64, 128, 160, 256)


def route(dtype, hd: int) -> str:
    """The kernel a launch takes: "wgmma" (bf16 at a head dim of
    ``TC_HEAD_DIMS``) or "fma" (everything else)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS \
        else "fma"


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None):
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KV,hd] with H % KV == 0, one CUDA
    device, all float32 or all bfloat16; hd % 4 == 0 and hd <= 256;
    Sk == Sq unless the launch is neither causal nor windowed (cross-
    attention: every key live). Launches the kernel on the current
    stream; returns [B,Sq,H,hd] in q's dtype. Adds one to
    ``flash_attention.launches`` per launch."""
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"q, k, v must lie on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError(f"q must be [B,Sq,H,hd] and k, v [B,Sk,KV,hd], "
                         f"Sq, Sk >= 1, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Sq != Sk and (causal or window is not None):
        raise ValueError(f"a causal or windowed launch takes Sq == Sk (its "
                         f"mask is by position), got Sq={Sq}, Sk={Sk}")
    if H % KV or hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes H % KV == 0, hd % 4 == 0 and hd "
                         f"<= {MAX_HEAD_DIM}, got H={H} KV={KV} hd={hd}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    scale = scale or 1.0 / math.sqrt(hd)
    # TMA reads from 16-byte-aligned addresses; a contiguous view can sit
    # at any offset of its storage
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.entry("flash_attn", "flash_attention_launch", 4, 9, 1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KV, hd, int(causal), int(window or 0),
                int(q.dtype == torch.bfloat16), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
