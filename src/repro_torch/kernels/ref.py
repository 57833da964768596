"""Plain PyTorch versions of the hand-written kernels (counterpart of
``repro/kernels/ref.py``). The CPU path runs them; on the card they are
what each kernel is held against."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": _gelu_tanh}


def expert_ffn_ref(h, w_up, w_gate, w_down, act_name: str = "silu"):
    """h: [E, R, d]; w_up/w_gate: [E, d, f]; w_down: [E, f, d].
    f32 math throughout, result cast to ``h.dtype``."""
    act = ACTS[act_name]
    hf = h.float()
    up = torch.einsum("erd,edf->erf", hf, w_up.float())
    gt = torch.einsum("erd,edf->erf", hf, w_gate.float())
    out = torch.einsum("erf,efd->erd", act(gt) * up, w_down.float())
    return out.to(h.dtype)
