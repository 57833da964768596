"""The train step (counterpart of ``repro/train_lib.py``): loss,
backward, the optimizer update (AdamW, Adafactor or SGD), and the LUFFY
state that carries the adaptive threshold (paper Eq. 2) and the wire
error-feedback residuals from step to step, on one device or over
virtual expert-parallel ranks (``dist``).

The threshold is an f32 tensor computed on the device from the running
loss, as the reference computes it inside its jitted step (a Python
float64 would move decisions at the margin). The condensation-rate
bucket, which fixes the static dispatch capacity, is chosen on the host
between steps (:func:`pick_bucket_host`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.condense.plan import adaptive_threshold
from repro_torch.config import LuffyConfig, ModelConfig, OptimConfig, \
    ShapeConfig
from repro_torch.core import moe_layer
from repro_torch.dist import DistContext
from repro_torch.models import transformer as tf
from repro_torch.obs import metrics as obs_metrics


class LuffyState(NamedTuple):
    l_ini: torch.Tensor      # [] f32 loss at the first step (Eq. 2)
    l_prev: torch.Tensor     # [] f32 loss at t-1
    step: torch.Tensor       # [] int32
    # the previous step's per-layer wire quantization residuals,
    # tf.wire_ef_shape(cfg, B, S) f32; None unless wire error feedback
    # is on under a lossy wire
    wire_ef: Optional[torch.Tensor] = None


def init_luffy_state(device, wire_ef_shape: Optional[Tuple[int, ...]] = None
                     ) -> LuffyState:
    neg = torch.full((), -1.0, dtype=torch.float32, device=device)
    ef = (None if wire_ef_shape is None else
          torch.zeros(wire_ef_shape, dtype=torch.float32, device=device))
    return LuffyState(neg, neg.clone(),
                      torch.zeros((), dtype=torch.int32, device=device), ef)


def tokens_per_device(shape: ShapeConfig,
                      dist: Optional[DistContext] = None) -> int:
    """Tokens each rank holds (``DistContext.token_divisor``)."""
    div = 1 if dist is None else dist.token_divisor
    return max(1, shape.global_batch * shape.seq_len // max(1, div))


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for an arch the port's train path does not take yet: the
    hybrid hymba-1.5b, whose attention (K5) and selective scan (K6) have
    no backward (item 8.6), and every arch with bf16 parameters (yi-34b,
    stablelm-12b, starcoder2-15b, gemma3-12b, llama4-maverick), whose
    optimizer arithmetic on bf16 leaves is not yet held to the
    reference's (item 8.7b). The MoE archs with f32 parameters, the dense
    f32 decoder internvl2-2b with its prefix, the encoder-decoder
    seamless-m4t-large-v2 and rwkv6-3b (K7 and its backward) train; a
    dense step has no MoE sublayer, so no condensation, migration or
    capacity bucket."""
    if cfg.attn is not None and cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: training a hybrid needs backwards of K5 and K6, "
            f"not ported yet (ROADMAP Queue 1 item 8.6); it serves through "
            f"repro_torch.launch.serve")
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: training {cfg.param_dtype} parameters is not "
            f"ported yet (ROADMAP Queue 1 item 8.7b); it serves through "
            f"repro_torch.launch.serve")


def capacity_for_bucket(cfg: ModelConfig, shape: ShapeConfig,
                        luffy: LuffyConfig, bucket: int,
                        dist: Optional[DistContext] = None) -> int:
    rate = luffy.rate_buckets[bucket] if luffy.enable_condensation else 0.0
    return moe_layer.capacity_for(cfg.moe, tokens_per_device(shape, dist),
                                  cfg.moe.num_experts, rate=rate)


def threshold_for(lstate: LuffyState, luffy: LuffyConfig):
    """Eq. 2 from the running loss once there is one (0.999 before)."""
    if not luffy.adaptive_threshold:
        return torch.full((), luffy.static_threshold, dtype=torch.float32,
                          device=lstate.l_ini.device)
    return torch.where(lstate.l_ini > 0,
                       adaptive_threshold(lstate.l_ini, lstate.l_prev),
                       torch.full_like(lstate.l_ini, 0.999))


def loss_and_metrics(params, batch, lstate: LuffyState, cfg: ModelConfig,
                     luffy: LuffyConfig, capacity: int,
                     dist: Optional[DistContext] = None):
    return tf.forward_train(params, cfg, luffy, batch,
                            threshold_for(lstate, luffy), capacity,
                            dist=dist, wire_ef=lstate.wire_ef)


def make_train_step(cfg: ModelConfig, luffy: LuffyConfig,
                    ocfg: OptimConfig, capacity: int,
                    dist: Optional[DistContext] = None):
    """Returns step(params, opt_state, lstate, batch) -> (params,
    opt_state, lstate, metrics). ``params`` is a nested dict of leaf
    tensors that require grad (``Model.params``); they and the
    optimizer state are updated in place. The refreshed wire residuals
    ride into the next step on ``lstate.wire_ef``."""

    def step(params, opt_state, lstate: LuffyState, batch):
        leaves = [p for _, p in optim.leaves_with_path(params)]
        for p in leaves:
            p.grad = None
        loss, metrics = loss_and_metrics(params, batch, lstate, cfg, luffy,
                                         capacity, dist)
        loss.backward()
        grads = optim.tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        params, opt_state, om = optim.update(params, grads, opt_state, ocfg)
        for p in leaves:
            p.grad = None
        metrics = dict(metrics)
        ef_next = metrics.pop("_wire_ef", None)
        metrics = dict(metrics, **om, total_loss=loss.detach())
        new_l = metrics["loss"]
        lstate = LuffyState(torch.where(lstate.l_ini > 0, lstate.l_ini,
                                        new_l),
                            new_l, lstate.step + 1,
                            lstate.wire_ef if ef_next is None else ef_next)
        return params, opt_state, lstate, metrics

    return step


def finalize_metrics(metrics, luffy: LuffyConfig
                     ) -> Dict[str, Optional[float]]:
    """Host-side view of one step's metrics: device scalars as floats,
    config-inapplicable keys masked to ``None`` (an
    ``inter_bytes_shipped`` of 0.0 from a dense-wire run means "nothing
    measured", not "zero bytes"; see :mod:`repro_torch.obs.metrics`)."""
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return obs_metrics.mask_inapplicable(out, luffy)


def pick_bucket_host(luffy: LuffyConfig, observed_rate: float) -> int:
    """The largest capacity-reduction bucket the observed condensation
    rate supports, with a hysteresis of 0.05 against switching back and
    forth (the reference's, whose threshold argument it never reads)."""
    best = 0
    for i, r in enumerate(luffy.rate_buckets):
        if r <= max(0.0, observed_rate - 0.05):
            best = i
    return best
