"""Kernel dispatch by the tensor's device (counterpart of
``repro/kernels/ops.py``).

A tensor on the CPU takes the kernel's plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the
hand-written kernel, which builds at first use, or raises. There is no
fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import expert_ffn as _expert_ffn
from repro_torch.kernels import ref


def expert_ffn(h, w_up, w_gate, w_down, act_name: str = "silu"):
    if h.device.type == "cpu":
        return ref.expert_ffn_ref(h, w_up, w_gate, w_down, act_name)
    if h.device.type == "cuda":
        return _expert_ffn.expert_ffn(h, w_up, w_gate, w_down, act_name)
    raise ValueError(f"expert_ffn has no version for device {h.device}")
