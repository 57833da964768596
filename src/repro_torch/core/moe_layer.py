"""The MoE sublayer (counterpart of ``repro/core/moe_layer.py``):
parameters, capacity, and ``moe_core_planned`` = gate + build + execute
for every expert-parallel rank at once (rank-major tensors,
:mod:`repro_torch.comm.hierarchical`; one device is one rank). The
build and the execution are the ``plan_build`` and ``exchange`` phases
of :mod:`repro_torch.obs.trace`."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.comm.hierarchical import CommContext
from repro_torch.condense.plan import CondenseCarry
from repro_torch.config import LuffyConfig, MoEConfig, ModelConfig
from repro_torch.core.gating import gate_apply, gate_init
from repro_torch.obs import trace as obs_trace
from repro_torch.plan import exchange as pex
from repro_torch.plan.exchange import MoEAux, _rms


def moe_init(generator, cfg: ModelConfig, *, device):
    """Expert stack [E, ...], router, the MoE RMS-norm scale and, with
    ``num_shared_experts`` > 0, the shared expert (``w_up``, ``w_gate``
    [d, f * n_shared], ``w_down`` [f * n_shared, d]) at the reference's
    scales. An f32 stack is one draw of the whole stack; a bf16 one is
    drawn one expert at a time into the preallocated stack, so the f32
    temporary is one expert's matrix (llama4's whole f32 stack would be
    21.5e9 bytes)."""
    from repro_torch.models.blocks import _dtype
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    pdt = _dtype(cfg.param_dtype)
    scale_down = 1.0 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std):
        if pdt == torch.float32 or len(shape) == 2:
            return (torch.randn(shape, generator=generator, device=device)
                    * std).to(pdt)
        out = torch.empty(shape, dtype=pdt, device=device)
        for e in range(shape[0]):
            out[e].copy_(torch.randn(shape[1:], generator=generator,
                                     device=device).mul_(std))
        return out

    p = {
        "router": gate_init(generator, d, E, device=device),
        "experts": {
            "w_up": normal((E, d, f), 1.0 / math.sqrt(d)),
            "w_gate": normal((E, d, f), 1.0 / math.sqrt(d)),
            "w_down": normal((E, f, d), scale_down / math.sqrt(f)),
        },
        "norm": {"scale": torch.ones((d,), dtype=pdt, device=device)},
    }
    if m.num_shared_experts > 0:
        fs = f * m.num_shared_experts
        p["shared"] = {
            "w_up": normal((d, fs), 1.0 / math.sqrt(d)),
            "w_gate": normal((d, fs), 1.0 / math.sqrt(d)),
            "w_down": normal((fs, d), scale_down / math.sqrt(fs)),
        }
    return p


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
                     condense_carry: Optional[CondenseCarry] = None,
                     comm: Optional[CommContext] = None, reuse_from=None,
                     wire_ef: Optional[torch.Tensor] = None,
                     plan_template=None):
    """One MoE sublayer for the ``M`` ranks of ``comm`` (None: one
    device, M = 1): gate on the RMS-normed tokens, build the plan
    (condensing when ``luffy.enable_condensation`` and the mode is not
    ``decode``), execute it. x: [M, n_seq, S, d] pre-norm hidden and a
    rank-major sideband (seq_len [M, n_seq]); ``threshold`` an f32
    scalar tensor, ``s_prev`` the similarity carried from the previous
    MoE sublayer, ``condense_carry`` and ``reuse_from`` (a plan or its
    signature) the condense and plan reuse carries, ``wire_ef`` [M,
    n_seq, S, d] f32 the wire error-feedback residual carried from the
    previous step (None: not threaded). Returns ``(y, sideband, s_next,
    aux, plan, cond_carry, wire_ef)``, rank-major, aux per rank [M]:
    ``y = x + moe_delta`` with the sideband unchanged, or in migrate mode
    across ranks ``y``, the sideband and ``s_next`` at the sequences' new
    homes. ``s_next`` / ``cond_carry`` are None without condensation,
    ``wire_ef`` (this step's residual) without a carried one.
    ``plan_template``: a cached serving template
    (:mod:`repro_torch.plan.cache`); the routing is bound onto it
    (``instantiate_plan``) and no plan is built."""
    from repro_torch.models.blocks import _dtype
    M, n_seq, S, d = x.shape
    xn = _rms(x.reshape(M, n_seq * S, d), params["norm"]["scale"]) \
        .to(_dtype(cfg.compute_dtype))
    gate = gate_apply(params["router"], xn, cfg.moe.top_k)
    with obs_trace.phase("plan_build") as sp:
        if plan_template is not None:
            plan = pex.instantiate_plan(plan_template, gate, xn, cfg,
                                        capacity=capacity,
                                        sideband=sideband, comm=comm)
        else:
            plan = pex.build_exchange_plan(
                gate, xn, cfg, luffy, mode=mode, capacity=capacity,
                sideband=sideband, threshold=threshold, s_prev=s_prev,
                condense_carry=condense_carry, comm=comm,
                reuse_from=reuse_from)
        plan = sp.fence(plan)
    with obs_trace.phase("exchange") as sp:
        y, aux, cond_carry, sb, s_next, ef = pex.execute_plan(
            params, x, plan, cfg, sideband, wire_ef=wire_ef)
        y = sp.fence(y)
    return y, sb, s_next, aux, plan, cond_carry, ef


def moe_core(params, x, sideband: Dict[str, torch.Tensor], cfg: ModelConfig,
             luffy: LuffyConfig, *, mode: str, capacity: int, threshold=None,
             s_prev: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                        Optional[torch.Tensor], MoEAux]:
    """The reference's one-device ``moe_core``: x [n_seq, S, d] and the
    sideband [n_seq, ...] in, the 4-tuple ``(y, sideband, s_next, aux)``
    out in the same layout (aux scalars). It is :func:`moe_core_planned`
    with one rank."""
    y, sb, s_next, aux, _, _, _ = moe_core_planned(
        params, x[None], {key: v[None] for key, v in sideband.items()},
        cfg, luffy, mode=mode, capacity=capacity, threshold=threshold,
        s_prev=s_prev)
    return (y[0], {key: v[0] for key, v in sb.items()}, s_next,
            MoEAux(*(a[0] for a in aux)))
