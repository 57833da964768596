"""AdamW, Adafactor and SGD on nested dicts of tensors (counterpart of
``repro/optim.py``): warmup-cosine schedule, global-norm clipping, the
decay mask and the updates, in the reference's f32 formulas (AdamW: bias
correction on the moments, eps added to the corrected root, not
``torch.optim.AdamW``'s; Adafactor: bf16 momentum of the normalised
gradient and a factored f32 second moment). The port updates parameters
and optimizer state in place, which saves a copy of each.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.config import OptimConfig


OPTIMIZERS = ("adamw", "adafactor", "sgd")


class OptState(NamedTuple):
    step: torch.Tensor       # [] int32
    mu: Any                  # first moments, a tree like params (f32;
    #                          bf16 under Adafactor)
    nu: Any                  # second moments, f32 (Adafactor: {"r", "c"}
    #                          row and column means on factored leaves)


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


def zip_with_path(tree, *others, prefix: str = ""):
    """(path, leaf, others' entries at that path), walking ``tree``'s
    structure only, in :func:`leaves_with_path`'s order: an entry of
    ``others`` that is itself a dict where ``tree`` has a leaf (a
    factored second moment's ``{"r", "c"}``) comes whole, as the
    reference's tree map flattens its extra trees up to the params'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from zip_with_path(tree[k], *(o[k] for o in others),
                                     prefix=f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from zip_with_path(v, *(o[i] for o in others),
                                     prefix=f"{prefix}{i}/")
    else:
        yield (prefix.rstrip("/"), tree, *others)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _factored(p) -> bool:
    """Adafactor keeps a row and a column mean of g^2 on leaves whose
    last two dimensions are both at least 128."""
    return p.dim() >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def init_opt_state(params, cfg: OptimConfig) -> OptState:
    """AdamW and SGD: f32 mu and nu, zeros like the parameters (SGD
    reads only mu, as in the reference). Adafactor: bf16 mu, and f32 nu
    ``{"r": [..., rows], "c": [..., cols]}`` on factored leaves, else
    like the parameter."""
    _check_name(cfg)
    dev = next(leaves_with_path(params))[1].device

    def zeros(p, dtype=torch.float32):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "adafactor":
        def nu_init(p):
            if _factored(p):
                f32 = dict(dtype=torch.float32, device=p.device)
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         **f32)}
            return zeros(p)

        return OptState(step, tree_map(lambda p: zeros(p, torch.bfloat16),
                                       params), tree_map(nu_init, params))
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(cfg: OptimConfig, step):
    """Linear warmup to ``cfg.lr``, then cosine down to 0.1 of it."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _clip_scale(grads, max_norm: float):
    """(min(1, max_norm / global norm), global norm) of a gradient tree."""
    leaves = [g for _, g in leaves_with_path(grads)]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm). Returns
    (clipped tree, global norm). The updates below scale each leaf as
    they reach it instead, which keeps no clipped copy of the whole tree
    (at moe-bert-large's width that copy alone is 20 GB)."""
    scale, gn = _clip_scale(grads, max_norm)
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
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    for path, p, g, m, v in zip_with_path(params, grads, state.mu,
                                          state.nu):
        gf = (g * scale.to(g.dtype)).float()
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adafactor_update(params, grads, state: OptState, cfg: OptimConfig
                     ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One Adafactor step with momentum and weight decay (the
    reference's): the update is g over the root of the second-moment
    estimate (on factored leaves ``r c^T / mean(r)``), its momentum is
    kept in bf16 but applied in f32. Parameters and state are updated in
    place and returned."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    for path, p, g, m, v in zip_with_path(params, grads, state.mu,
                                          state.nu):
        gf = (g * scale.to(g.dtype)).float()
        g2 = gf * gf + 1e-30
        if isinstance(v, dict):
            r, c = v["r"], v["c"]
            r.copy_(b2 * r + (1 - b2) * torch.mean(g2, dim=-1))
            c.copy_(b2 * c + (1 - b2) * torch.mean(g2, dim=-2))
            denom = (r[..., None] * c[..., None, :]) / torch.clamp(
                torch.mean(r, dim=-1)[..., None, None], min=1e-30)
        else:
            denom = b2 * v + (1 - b2) * g2
            v.copy_(denom)
        del g2
        u = gf / (torch.sqrt(denom) + cfg.eps)
        del denom, gf
        m2 = b1 * m.float() + (1 - b1) * u
        del u
        m.copy_(m2.to(m.dtype))
        pf = p.float()
        delta = m2 + cfg.weight_decay * pf if _decay_mask(path) else m2
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def sgd_update(params, grads, state: OptState, cfg: OptimConfig
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One SGD step with momentum 0.9 (no weight decay, as the
    reference's); params and mu are updated in place and returned."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    for _, p, g, m in zip_with_path(params, grads, state.mu):
        m.copy_(0.9 * m + (g * scale.to(g.dtype)).float())
        p.copy_((p.float() - lr * m).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def _check_name(cfg: OptimConfig):
    if cfg.name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.name!r}: one of "
                         f"{OPTIMIZERS}")


def update(params, grads, state: OptState, cfg: OptimConfig):
    _check_name(cfg)
    if cfg.name == "sgd":
        return sgd_update(params, grads, state, cfg)
    if cfg.name == "adafactor":
        return adafactor_update(params, grads, state, cfg)
    return adamw_update(params, grads, state, cfg)
