"""Kernel dispatch by the tensor's device (counterpart of
``repro/kernels/ops.py``).

A tensor on the CPU takes the kernel's plain version
(:mod:`repro_torch.kernels.ref`, differentiated by autograd); a CUDA
tensor launches the hand-written kernel, which builds at first use, or
raises. There is no fallback from one to the other. On the card the
differentiable kernels go through their autograd functions, so a
backward launches the kernels' own backward.
"""
from __future__ import annotations

from repro_torch.kernels import condense as _condense
from repro_torch.kernels import expert_ffn as _expert_ffn
from repro_torch.kernels import flash_attn as _flash_attn
from repro_torch.kernels import mamba_scan as _mamba_scan
from repro_torch.kernels import pack as _pack
from repro_torch.kernels import ref
from repro_torch.kernels import similarity as _similarity
from repro_torch.kernels import wkv6 as _wkv6


def _device(t, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no version for device {t.device}")
    return t.device.type


def expert_ffn(h, w_up, w_gate, w_down, act_name: str = "silu", w_idx=None):
    """``w_idx``: K1's group map (int32 [E], -1 idle), None the identity."""
    if _device(h, "expert_ffn") == "cpu":
        return ref.expert_ffn_ref(h, w_up, w_gate, w_down, act_name, w_idx)
    return _expert_ffn.ExpertFFN.apply(h, w_up, w_gate, w_down, act_name,
                                       w_idx)


def masked_similarity(x, mask):
    if _device(x, "masked_similarity") == "cpu":
        return ref.masked_similarity_ref(x, mask)
    return _similarity.masked_similarity(x, mask)


def masked_similarity_fused(x, expert, s_prev, s1: float, s2: float,
                            code=None):
    if _device(x, "masked_similarity_fused") == "cpu":
        return ref.masked_similarity_fused_ref(x, expert, s_prev, s1, s2,
                                               code)
    return _similarity.masked_similarity_fused(x, expert, s_prev, s1, s2,
                                               code)


def gather_rows(y, rep_idx, group_size=None):
    """``group_size`` G: rep_idx keeps every row in its group of G, and the
    card's backward sorts within groups (the plain version needs no sort)."""
    if _device(y, "gather_rows") == "cpu":
        return ref.gather_rows_ref(y, rep_idx)
    return _condense.GatherRows.apply(y, rep_idx, group_size)


def pack_quantize(x, tok, wire_dtype: str = "f32"):
    if _device(x, "pack_quantize") == "cpu":
        return ref.pack_quantize_ref(x, tok, wire_dtype)
    return _pack.pack_quantize(x, tok, wire_dtype)


def pack_quant_bwd(x, tok, g):
    if _device(x, "pack_quant_bwd") == "cpu":
        return ref.pack_quant_bwd_ref(x, tok, g)
    return _pack.pack_quant_bwd(x, tok, g)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    if _device(q, "flash_attention") == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    return _flash_attn.flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale)


def mamba_scan(dt, x, bmat, cmat, a):
    if _device(dt, "mamba_scan") == "cpu":
        return ref.mamba_scan_ref(dt, x, bmat, cmat, a)
    return _mamba_scan.mamba_scan(dt, x, bmat, cmat, a)


def mamba_scan_fused(dt_lin, dt_bias, x, z, d_skip, bmat, cmat, a):
    if _device(dt_lin, "mamba_scan_fused") == "cpu":
        return ref.mamba_scan_fused_ref(dt_lin, dt_bias, x, z, d_skip, bmat,
                                        cmat, a)
    return _mamba_scan.mamba_scan_fused(dt_lin, dt_bias, x, z, d_skip, bmat,
                                        cmat, a)


def wkv6_scan(r, k, v, w, u, state=None):
    if _device(r, "wkv6_scan") == "cpu":
        return ref.wkv6_scan_ref(r, k, v, w, u, state)
    return _wkv6.wkv6_scan(r, k, v, w, u, state)
