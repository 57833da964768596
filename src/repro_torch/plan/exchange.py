"""Plan/execute split for the MoE exchange (counterpart of
``repro/plan/exchange.py``), single device.

:func:`build_exchange_plan` decides the condensation map (§V), dispatch
slots and capacity drops from the router output; :func:`execute_plan`
packs the dispatch buffer, runs the expert FFN, combines and
un-condenses. This slice ports one device (M = 1): modes ``vanilla``,
``decode`` and ``migrate`` (which is the identity on one device, as in
the reference, whose migration needs M > 1), synchronous execution on
the dense wire, the ``exact`` similarity backend without plan reuse.
Expert parallelism (M > 1) raises ``NotImplementedError`` naming the
queue item that brings it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.condense.plan import (CondenseCarry, CondensePlan,
                                       build_condense_plan,
                                       identity_condense_plan, uncondense)
from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.core.gating import GateOutput, dispatch_positions
from repro_torch.kernels import ops as kops

MODES = ("vanilla", "migrate", "decode")


class MoEAux(NamedTuple):
    """The reference's per-sublayer ledger, the fields one device has."""
    aux_loss: torch.Tensor        # [] router load-balance loss
    dispatch_drop: torch.Tensor   # [] fraction of kept rows dropped
    combine_drop: torch.Tensor    # [] 0: nothing regroups on one device
    condense_rate: torch.Tensor   # [] fraction of tokens condensed
    local_frac: torch.Tensor      # [] 1: every combine row stays local
    measured_pairs: torch.Tensor  # [] pairs the similarity measured
    condense_built: torch.Tensor  # [] 1 when the similarity build ran
    condense_reused: torch.Tensor  # [] 1 when a carried map was reused


class ExchangePlan(NamedTuple):
    """Every decision about one single-device exchange, as data."""
    condense: bool                # condensation active this call
    capacity: int                 # per-expert dispatch capacity C
    group_size: int               # condensation group G
    expert_idx: torch.Tensor      # [T, k] expert ids
    gate_weights: torch.Tensor    # [T, k] combine weights
    positions: torch.Tensor       # [T, k] dispatch buffer positions
    valid: torch.Tensor           # [T, k] row takes a dispatch slot
    aux_loss: torch.Tensor
    dispatch_drop: torch.Tensor
    condense_plan: CondensePlan


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


def _check_one_device(params, cfg: ModelConfig):
    e_local = params["experts"]["w_up"].shape[0]
    if e_local != cfg.moe.num_experts:
        raise NotImplementedError(
            f"expert parallelism: this device holds {e_local} of "
            f"{cfg.moe.num_experts} experts (M > 1), which comes with "
            f"the expert-parallel slice (ROADMAP Queue 1 item 3)")


def build_exchange_plan(gate: GateOutput, xn, cfg: ModelConfig,
                        luffy: LuffyConfig, *, mode: str, capacity: int,
                        sideband: Dict[str, torch.Tensor], threshold=None,
                        s_prev: Optional[torch.Tensor] = None,
                        condense_carry: Optional[CondenseCarry] = None
                        ) -> ExchangePlan:
    """Decide one single-device exchange: condensation map, dispatch
    slots and drops.

    gate: router output over ``xn`` [T, d] (T = n_seq * S); sideband
    must hold ``seq_len`` [n_seq]. Condensation runs when
    ``luffy.enable_condensation`` and the mode is not ``decode``; it
    needs ``threshold`` (an f32 scalar tensor) and takes the carried
    similarity ``s_prev`` (reshaped to [n_groups, G, G]) when given.
    Condensed tokens take no dispatch slot. No payload moves here."""
    if mode not in MODES:
        raise ValueError(f"exchange mode {mode!r}: one of {MODES}")
    m = cfg.moe
    T = xn.shape[0]
    n_seq = sideband["seq_len"].shape[0]
    S = T // n_seq
    G = luffy.condense_group
    pos_in_seq = torch.arange(S, device=xn.device)[None].expand(n_seq, S)
    token_valid = (pos_in_seq < sideband["seq_len"][:, None]).reshape(T)
    keep = token_valid[:, None].expand(T, m.top_k)

    do_condense = luffy.enable_condensation and mode != "decode"
    if do_condense:
        if threshold is None:
            raise ValueError("condensation needs a threshold")
        cp = build_condense_plan(
            xn, gate.expert_idx[:, 0], threshold, group_size=G,
            s_prev=None if s_prev is None else s_prev.reshape(-1, G, G),
            s1=luffy.s1, s2=luffy.s2, backend=luffy.similarity_backend,
            reuse_mode=luffy.condense_reuse, carry=condense_carry)
        keep = keep & cp.is_rep[:, None]
    else:
        cp = identity_condense_plan(T, luffy.similarity_backend,
                                    device=xn.device)

    pos = dispatch_positions(gate.expert_idx, keep, m.num_experts)
    valid = keep & (pos < capacity)
    kept = keep.float().sum()
    d_drop = 1.0 - valid.float().sum() / torch.clamp(kept, min=1.0)
    return ExchangePlan(condense=do_condense, capacity=capacity,
                        group_size=G, expert_idx=gate.expert_idx,
                        gate_weights=gate.gate_weights, positions=pos,
                        valid=valid, aux_loss=gate.aux_loss,
                        dispatch_drop=d_drop, condense_plan=cp)


def execute_plan(params, x, plan: ExchangePlan, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, MoEAux, Optional[Dict]]:
    """Pack the dispatch buffer, run the expert FFN, combine, and
    un-condense.

    x: [n_seq, S, d] pre-norm hidden. Returns ``(x + moe_delta, aux,
    cond_carry)``, ``cond_carry`` being the condense-reuse carry for the
    next sublayer (None without condensation). Rounding follows the
    reference: rows are packed in the compute dtype, RMS-normed from
    those rounded rows, scaled by the compute-dtype gate weight and
    summed over k in the compute dtype. Un-condense replaces each
    condensed token's whole output row (residual included) by its
    representative's."""
    from repro_torch.models.blocks import _dtype
    _check_one_device(params, cfg)
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
    buf = buf.index_copy(0, slot, xf.to(cdt).repeat_interleave(k, dim=0))
    rows = buf[:E * C].reshape(E, C, d)

    # ---- expert FFN on the RMS-normed rows
    h = _rms(rows, params["norm"]["scale"]).to(cdt)
    y = expert_ffn(params["experts"], h, cfg.act)
    y = torch.cat([y.reshape(E * C, d),
                   torch.zeros((1, d), dtype=y.dtype, device=y.device)])

    # ---- combine: each copy's row back to its token, gate-weighted
    # index_select, not y[slot]: its backward is an index_add_, where
    # advanced indexing's sorts the indices (15 ms per layer at B=8,
    # S=1024 on an H100). Each kept slot is read by one copy only, so the
    # index_add_ adds one value into zero per row, exact in any order:
    # the gradient repeats bit for bit. Only the trash row, whose
    # gradient is dropped, takes several.
    gw = plan.gate_weights.reshape(-1, 1).to(cdt) * v_f[:, None].to(cdt)
    vals = y.index_select(0, slot) * gw                       # [T*k, d]
    delta = vals.reshape(T, k, d).sum(dim=1)
    y_tok = xf + delta.to(xf.dtype)

    cp = plan.condense_plan
    cond_carry = None
    if plan.condense:
        y_tok = uncondense(y_tok, cp.rep_idx)
        if cp.signature is not None:
            sig = cp.signature
            cond_carry = {
                "rep": (cp.rep_idx % plan.group_size).reshape(n_seq, S),
                "cexp": sig.expert.reshape(n_seq, S),
                "age": sig.age, "valid": sig.valid}
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = MoEAux(plan.aux_loss, plan.dispatch_drop, z, cp.rate,
                 torch.ones_like(z), cp.measured_pairs,
                 z if cp.built is None else cp.built,
                 z if cp.reused is None else cp.reused)
    return y_tok.reshape(n_seq, S, d), aux, cond_carry
