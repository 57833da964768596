"""Carry parameters between the reference's pytree and the port.

The reference keeps its decoder layers stacked by pattern position:
``params["layers"][j]`` is a pytree whose leaves have a leading
``n_groups`` axis, and layer ``i`` is group ``i // period`` at position
``i % period``. The port keeps one dict per layer. Both sides are given
as numpy arrays (``jax.tree.map(np.asarray, params)`` on the reference
side), so nothing here needs JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import pattern_period


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind != "f" or a.dtype.itemsize not in (2, 4, 8):
        raise TypeError(f"cannot carry a {a.dtype} array (numpy float16/32/"
                        f"64 only; cast bfloat16 leaves to float32 first)")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_to_torch(tree: Any, device="cpu"):
    """A nested dict/list of numpy float arrays -> the same of tensors."""
    return _map(lambda a: _tensor(a, device), tree)


def tree_to_numpy(tree: Any):
    """A nested dict/list of tensors -> the same of numpy arrays."""
    return _map(lambda t: t.detach().cpu().numpy(), tree)


def from_reference(np_params: Any, cfg: ModelConfig, *,
                   device="cpu") -> dict:
    """The reference's parameter pytree, as numpy arrays, -> the port's
    nested dict of tensors on ``device``."""
    period = pattern_period(cfg)
    out = {k: tree_to_torch(v, device)
           for k, v in np_params.items() if k != "layers"}
    layers = []
    for i in range(cfg.num_layers):
        g, j = divmod(i, period)
        layers.append(_map(lambda a, g=g: _tensor(np.asarray(a)[g], device),
                           np_params["layers"][j]))
    out["layers"] = layers
    return out


def to_reference(params: Any, cfg: ModelConfig) -> dict:
    """The port's parameters -> the reference's pytree layout, as numpy
    arrays (the inverse of :func:`from_reference`)."""
    period = pattern_period(cfg)
    out = {k: tree_to_numpy(v) for k, v in params.items() if k != "layers"}
    n_groups = cfg.num_layers // period

    def stack(*leaves):
        return np.stack([t.detach().cpu().numpy() for t in leaves])

    def zip_map(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_map([t[k] for t in trees]) for k in first}
        return stack(*trees)

    out["layers"] = [zip_map([params["layers"][g * period + j]
                              for g in range(n_groups)])
                     for j in range(period)]
    return out
