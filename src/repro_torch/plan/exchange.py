"""Plan/execute split for the MoE exchange (counterpart of
``repro/plan/exchange.py``), single device.

:func:`build_exchange_plan` decides dispatch slots and capacity drops
from the router output; :func:`execute_plan` packs the dispatch buffer,
runs the expert FFN and combines. This slice ports one device (M = 1),
modes ``vanilla`` and ``decode``, synchronous execution on the dense
wire, with no condensation, migration or replica lanes; anything else
raises ``NotImplementedError`` naming the slice that brings it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.core.gating import GateOutput, dispatch_positions
from repro_torch.kernels import ops as kops


class MoEAux(NamedTuple):
    aux_loss: torch.Tensor        # [] router load-balance loss
    dispatch_drop: torch.Tensor   # [] fraction of kept rows dropped


class ExchangePlan(NamedTuple):
    """Every decision about one single-device exchange, as data."""
    capacity: int                 # per-expert dispatch capacity C
    expert_idx: torch.Tensor      # [T, k] expert ids
    gate_weights: torch.Tensor    # [T, k] combine weights
    positions: torch.Tensor       # [T, k] dispatch buffer positions
    valid: torch.Tensor           # [T, k] row takes a dispatch slot
    aux_loss: torch.Tensor
    dispatch_drop: torch.Tensor


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    v = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(v + eps) * scale.float()


def expert_ffn(ew, h, act_name: str):
    """h: [E_local, R, d] normed inputs -> [E_local, R, d], in h's dtype.
    The reference's kernel path (``use_kernel=True``): the f32-math
    kernel K1 gets the rows and the f32 weights as they are."""
    return kops.expert_ffn(h, ew["w_up"], ew["w_gate"], ew["w_down"],
                           act_name)


def build_exchange_plan(gate: GateOutput, xn, cfg: ModelConfig,
                        luffy: LuffyConfig, *, mode: str, capacity: int,
                        sideband: Dict[str, torch.Tensor]) -> ExchangePlan:
    """Decide one single-device exchange: dispatch slots and drops.

    gate: router output over ``xn`` [T, d] (T = n_seq * S); sideband
    must hold ``seq_len`` [n_seq]. No payload moves here."""
    if mode not in ("vanilla", "decode"):
        raise NotImplementedError(
            f"exchange mode {mode!r}: migration comes with the expert-"
            f"parallel slice; this slice runs 'vanilla' and 'decode'")
    if luffy.enable_condensation and mode != "decode":
        raise NotImplementedError(
            "token condensation comes with the training slice; serving "
            "runs with enable_condensation=False")
    m = cfg.moe
    T = xn.shape[0]
    n_seq = sideband["seq_len"].shape[0]
    S = T // n_seq
    pos_in_seq = torch.arange(S, device=xn.device)[None].expand(n_seq, S)
    token_valid = (pos_in_seq < sideband["seq_len"][:, None]).reshape(T)
    keep = token_valid[:, None].expand(T, m.top_k)
    pos = dispatch_positions(gate.expert_idx, keep, m.num_experts)
    valid = keep & (pos < capacity)
    kept = keep.float().sum()
    d_drop = 1.0 - valid.float().sum() / torch.clamp(kept, min=1.0)
    return ExchangePlan(capacity=capacity, expert_idx=gate.expert_idx,
                        gate_weights=gate.gate_weights, positions=pos,
                        valid=valid, aux_loss=gate.aux_loss,
                        dispatch_drop=d_drop)


def execute_plan(params, x, plan: ExchangePlan, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, MoEAux]:
    """Pack the dispatch buffer, run the expert FFN, combine.

    x: [n_seq, S, d] pre-norm hidden. Returns ``(x + moe_delta, aux)``.
    Rounding follows the reference: rows are packed in the compute dtype,
    RMS-normed from those rounded rows, scaled by the compute-dtype gate
    weight and summed over k in the compute dtype."""
    from repro_torch.models.blocks import _dtype
    m = cfg.moe
    cdt = _dtype(cfg.compute_dtype)
    n_seq, S, d = x.shape
    T, E, C, k = n_seq * S, m.num_experts, plan.capacity, m.top_k
    xf = x.reshape(T, d)

    # ---- dispatch pack: slot e*C + pos; dropped copies go to a trash
    # row past the end, so every kept slot is written exactly once
    v_f = plan.valid.reshape(-1)
    slot = plan.expert_idx.reshape(-1) * C + plan.positions.reshape(-1)
    slot = torch.where(v_f, slot, torch.full_like(slot, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=cdt, device=x.device)
    buf[slot] = xf.to(cdt).repeat_interleave(k, dim=0)
    rows = buf[:E * C].reshape(E, C, d)

    # ---- expert FFN on the RMS-normed rows
    h = _rms(rows, params["norm"]["scale"]).to(cdt)
    y = expert_ffn(params["experts"], h, cfg.act)
    y = torch.cat([y.reshape(E * C, d),
                   torch.zeros((1, d), dtype=y.dtype, device=y.device)])

    # ---- combine: each copy's row back to its token, gate-weighted
    gw = plan.gate_weights.reshape(-1, 1).to(cdt) * v_f[:, None].to(cdt)
    vals = y[slot] * gw                                       # [T*k, d]
    delta = vals.reshape(T, k, d).sum(dim=1)
    y_tok = xf + delta.to(xf.dtype)
    return y_tok.reshape(n_seq, S, d), MoEAux(plan.aux_loss,
                                              plan.dispatch_drop)
