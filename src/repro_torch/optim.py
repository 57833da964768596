"""AdamW on nested dicts of tensors (counterpart of ``repro/optim.py``):
warmup-cosine schedule, global-norm clipping, the decay mask and the
update, in the reference's f32 formulas (bias correction on the moments,
eps added to the corrected root), not ``torch.optim.AdamW``'s. The port
updates parameters and moments in place, which saves a copy of each;
Adafactor and SGD come with a later slice and raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.config import OptimConfig


class OptState(NamedTuple):
    step: torch.Tensor       # [] int32
    mu: Any                  # first moments, a tree like params, f32
    nu: Any                  # second moments, f32


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict/list, dict keys in sorted order (the
    order of ``jax.tree.leaves``); paths read ``layers/0/attn_norm/scale``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_opt_state(params, cfg: OptimConfig) -> OptState:
    """AdamW: f32 mu and nu, zeros like the parameters."""
    _check_name(cfg)
    dev = next(leaves_with_path(params))[1].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(cfg: OptimConfig, step):
    """Linear warmup to ``cfg.lr``, then cosine down to 0.1 of it."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm). Returns
    (clipped tree, global norm)."""
    leaves = [g for _, g in leaves_with_path(grads)]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _decay_mask(path: str) -> bool:
    """No weight decay for norms / biases / 1-d params."""
    return not any(s in path for s in ("norm", "scale", "bias", "mix_",
                                       "dt_bias", "a_log", "d_skip",
                                       "w_bias", "u_bonus"))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: OptimConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; params, mu and nu are updated in place and
    returned. Metrics: the pre-clip gradient norm and the lr."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    g_of = dict(leaves_with_path(grads))
    mu_of = dict(leaves_with_path(state.mu))
    nu_of = dict(leaves_with_path(state.nu))
    for path, p in leaves_with_path(params):
        gf, m, v = g_of[path].float(), mu_of[path], nu_of[path]
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def _check_name(cfg: OptimConfig):
    if cfg.name != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.name!r}: only AdamW is ported; Adafactor and "
            f"SGD come with a later slice of the port")


def update(params, grads, state: OptState, cfg: OptimConfig):
    _check_name(cfg)
    return adamw_update(params, grads, state, cfg)
