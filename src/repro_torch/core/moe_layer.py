"""The MoE sublayer on one device (counterpart of
``repro/core/moe_layer.py``): parameters, capacity, and
``moe_core_planned`` = gate + build + execute. On one device it is also
the whole of the reference's ``models/transformer.py::_moe_apply_dist``."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.condense.plan import CondenseCarry
from repro_torch.config import LuffyConfig, MoEConfig, ModelConfig
from repro_torch.core.gating import gate_apply, gate_init
from repro_torch.plan.exchange import (MoEAux, _rms, build_exchange_plan,
                                       execute_plan)


def moe_init(generator, cfg: ModelConfig, *, device):
    """Expert stack [E, ...], router and the MoE RMS-norm scale."""
    from repro_torch.models.blocks import _dtype
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    pdt = _dtype(cfg.param_dtype)
    scale_down = 1.0 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(pdt)

    return {
        "router": gate_init(generator, d, E, device=device),
        "experts": {
            "w_up": normal((E, d, f), 1.0 / math.sqrt(d)),
            "w_gate": normal((E, d, f), 1.0 / math.sqrt(d)),
            "w_down": normal((E, f, d), scale_down / math.sqrt(f)),
        },
        "norm": {"scale": torch.ones((d,), dtype=pdt, device=device)},
    }


def capacity_for(moe: MoEConfig, tokens_local: int, num_experts: int,
                 rate: float = 0.0, slack: Optional[float] = None) -> int:
    """Static per-(source, expert) capacity, condensation-bucket scaled."""
    cf = slack if slack is not None else moe.capacity_factor
    c = int(math.ceil(cf * tokens_local * moe.top_k * (1.0 - rate)
                      / num_experts))
    return max(8, ((c + 7) // 8) * 8)


def moe_core_planned(params, x, sideband: Dict[str, torch.Tensor],
                     cfg: ModelConfig, luffy: LuffyConfig, *, mode: str,
                     capacity: int, threshold=None,
                     s_prev: Optional[torch.Tensor] = None,
                     condense_carry: Optional[CondenseCarry] = None):
    """One MoE sublayer: gate on the RMS-normed tokens, build the plan
    (condensing when ``luffy.enable_condensation`` and the mode is not
    ``decode``), execute it. x: [n_seq, S, d] pre-norm hidden;
    ``threshold`` an f32 scalar tensor, ``s_prev`` the similarity carried
    from the previous MoE sublayer. Returns ``(x + moe_delta, sideband,
    s_next, aux, plan, cond_carry)``; on one device the sideband is
    unchanged, and ``s_next`` / ``cond_carry`` are None without
    condensation."""
    from repro_torch.models.blocks import _dtype
    n_seq, S, d = x.shape
    xn = _rms(x.reshape(n_seq * S, d), params["norm"]["scale"]) \
        .to(_dtype(cfg.compute_dtype))
    gate = gate_apply(params["router"], xn, cfg.moe.top_k)
    plan = build_exchange_plan(gate, xn, cfg, luffy, mode=mode,
                               capacity=capacity, sideband=sideband,
                               threshold=threshold, s_prev=s_prev,
                               condense_carry=condense_carry)
    y, aux, cond_carry = execute_plan(params, x, plan, cfg)
    return (y, dict(sideband), plan.condense_plan.s_next, aux, plan,
            cond_carry)


def moe_core(params, x, sideband: Dict[str, torch.Tensor], cfg: ModelConfig,
             luffy: LuffyConfig, *, mode: str, capacity: int, threshold=None,
             s_prev: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                        Optional[torch.Tensor], MoEAux]:
    """The reference's 4-tuple ``(x + moe_delta, sideband, s_next, aux)``
    of :func:`moe_core_planned`."""
    return moe_core_planned(params, x, sideband, cfg, luffy, mode=mode,
                            capacity=capacity, threshold=threshold,
                            s_prev=s_prev)[:4]
