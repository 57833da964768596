"""The MoE sublayer on one device (counterpart of
``repro/core/moe_layer.py``): parameters, capacity, and
``moe_core`` = gate + build + execute. On one device it is also the
whole of the reference's ``models/transformer.py::_moe_apply_dist``."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

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


def moe_core(params, x, sideband: Dict[str, torch.Tensor], cfg: ModelConfig,
             luffy: LuffyConfig, *, mode: str, capacity: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], None, MoEAux]:
    """One MoE sublayer: gate on the RMS-normed tokens, build the plan,
    execute it. x: [n_seq, S, d] pre-norm hidden. Returns the
    reference's 4-tuple ``(x + moe_delta, sideband, s_next, aux)``; on
    one device without migration or condensation the sideband is
    unchanged and there is no similarity history (``s_next`` is None)."""
    from repro_torch.models.blocks import _dtype
    n_seq, S, d = x.shape
    xn = _rms(x.reshape(n_seq * S, d), params["norm"]["scale"]) \
        .to(_dtype(cfg.compute_dtype))
    gate = gate_apply(params["router"], xn, cfg.moe.top_k)
    plan = build_exchange_plan(gate, xn, cfg, luffy, mode=mode,
                               capacity=capacity, sideband=sideband)
    y, aux = execute_plan(params, x, plan, cfg)
    return y, dict(sideband), None, aux
