"""Carry parameters between the reference's pytree and the port.

The reference keeps its decoder layers stacked by pattern position:
``params["layers"][j]`` is a pytree whose leaves have a leading
``n_groups`` axis, and layer ``i`` is group ``i // period`` at position
``i % period``; an encoder-decoder's ``params["encoder"]["layers"]``
likewise. The port keeps one dict per layer in each. Both sides are given
as numpy arrays (``jax.tree.map(np.asarray, params)`` on the reference
side), so nothing here needs JAX.

A bfloat16 leaf crosses as its 16-bit pattern, bit for bit, without
``ml_dtypes``: an array whose dtype is named ``bfloat16`` (the
reference's own leaves) or is raw 2-byte ``|V2`` (how ``np.savez`` stores
one, and how :func:`tensor_to_numpy` gives one back) becomes a torch
bfloat16 tensor of the same bits, and back.
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


# numpy's raw 2-byte dtype: a bfloat16 leaf's bits outside ml_dtypes
BF16_RAW = np.dtype("V2")


def is_bf16(a: np.ndarray) -> bool:
    """Whether numpy array ``a`` holds bfloat16 bits (ml_dtypes' type, or
    raw ``|V2``)."""
    return a.dtype.name == "bfloat16" or a.dtype == BF16_RAW


def numpy_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if is_bf16(a):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if a.dtype.kind != "f" or a.dtype.itemsize not in (2, 4, 8):
        raise TypeError(f"cannot carry a {a.dtype} array (numpy float16/32/"
                        f"64, and bfloat16 as ml_dtypes' type or raw |V2)")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; a bfloat16 one as raw
    ``|V2`` of the same bits (numpy has no bfloat16 without ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RAW)
    return t.numpy()


def tree_to_torch(tree: Any, device="cpu"):
    """A nested dict/list of numpy float arrays -> the same of tensors."""
    return _map(lambda a: numpy_to_tensor(a, device), tree)


def tree_to_numpy(tree: Any):
    """A nested dict/list of tensors -> the same of numpy arrays."""
    return _map(tensor_to_numpy, tree)


def _unstack(stacked, n_layers: int, period: int, device):
    """Layers stacked by pattern position -> one dict per layer."""
    return [_map(lambda a, g=i // period: numpy_to_tensor(np.asarray(a)[g],
                                                         device),
                 stacked[i % period]) for i in range(n_layers)]


def _stack(layers, period: int):
    """One dict per layer -> stacked by pattern position, numpy."""
    def zip_map(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_map([t[k] for t in trees]) for k in first}
        return np.stack([tensor_to_numpy(t) for t in trees])

    return [zip_map(layers[j::period]) for j in range(period)]


def from_reference(np_params: Any, cfg: ModelConfig, *,
                   device="cpu") -> dict:
    """The reference's parameter pytree, as numpy arrays, -> the port's
    nested dict of tensors on ``device``."""
    period = pattern_period(cfg)
    out = {k: tree_to_torch(v, device) for k, v in np_params.items()
           if k not in ("layers", "encoder")}
    out["layers"] = _unstack(np_params["layers"], cfg.num_layers, period,
                             device)
    if "encoder" in np_params:
        enc = np_params["encoder"]
        out["encoder"] = {
            "layers": _unstack(enc["layers"], cfg.num_encoder_layers, period,
                               device),
            "final_norm": tree_to_torch(enc["final_norm"], device)}
    return out


def to_reference(params: Any, cfg: ModelConfig) -> dict:
    """The port's parameters -> the reference's pytree layout, as numpy
    arrays (the inverse of :func:`from_reference`)."""
    period = pattern_period(cfg)
    out = {k: tree_to_numpy(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out["layers"] = _stack(params["layers"], period)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"layers": _stack(enc["layers"], period),
                          "final_norm": tree_to_numpy(enc["final_norm"])}
    return out
