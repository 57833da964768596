"""Pytree checkpoints: leaves to ``.npz`` shards plus a JSON spec
(counterpart of ``repro/checkpoint.py``, in its format).

``save`` writes ``shard_{i}.npz`` files, each holding keys ``t{j}`` (the
j-th leaf in flattening order) up to about ``shard_mb`` MiB, and
``spec.json`` with ``step`` and ``leaves: [{name, key, shard, dtype,
shape, pspec}]``. A leaf's name is its ``/``-joined path (dict keys,
list indices), and leaves are flattened as the reference flattens a
pytree: dict keys sorted, lists in order. ``pspec`` is null: the port's
tensors carry no PartitionSpec. The train launcher saves
``convert.to_reference(params, cfg)``, the reference's stacked-layer
tree, so either package restores either package's checkpoint;
``restore`` then ``convert.from_reference`` gives the port's
parameters. A bfloat16 leaf is stored as the reference's npz holds it:
raw ``|V2`` bits, with ``"bfloat16"`` in the spec; it restores from
those bits (:mod:`repro_torch.convert`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import is_bf16, numpy_to_tensor


def _flatten(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (i,))
        return out
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flattening
    order, by the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, leaves) for v in tree]
    return next(leaves)


def _as_dtype(a: np.ndarray, want: np.dtype) -> np.ndarray:
    """Stored leaf ``a`` as the like leaf's dtype ``want``; a bfloat16
    leaf as its bits."""
    if is_bf16(a) != is_bf16(np.empty(0, want)):
        raise TypeError(f"a stored {a.dtype} leaf cannot restore into "
                        f"{want} (bfloat16 restores only as bfloat16)")
    return np.ascontiguousarray(a).view(want) if is_bf16(a) \
        else np.asarray(a, dtype=want)


def _leaf_tensor(a: np.ndarray, device) -> torch.Tensor:
    return numpy_to_tensor(a, device) if is_bf16(a) \
        else torch.from_numpy(a).to(device)


def save(path: str, tree, *, step: int = 0, shard_mb: int = 512) -> None:
    """Write ``tree`` (nested dicts / lists of numpy arrays) under the
    directory ``path``."""
    os.makedirs(path, exist_ok=True)
    spec: Dict[str, Any] = {"step": step, "leaves": []}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes, shard_id = 0, 0
    limit = shard_mb * (1 << 20)

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if shard:
            np.savez(os.path.join(path, f"shard_{shard_id}.npz"), **shard)
            shard, shard_bytes, shard_id = {}, 0, shard_id + 1

    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = np.asarray(leaf)
        key = f"t{i}"
        spec["leaves"].append({
            "name": name, "key": key, "shard": shard_id,
            "dtype": "bfloat16" if is_bf16(arr) else str(arr.dtype),
            "shape": list(arr.shape),
            "pspec": None})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= limit:
            flush()
    flush()
    with open(os.path.join(path, "spec.json"), "w") as f:
        json.dump(spec, f, indent=1)


def restore(path: str, like, *, device: Optional[Any] = None):
    """Read the checkpoint at ``path`` into the structure of ``like`` (a
    tree of numpy arrays; leaves matched by name, each cast to its
    ``like`` leaf's dtype). Returns ``(tree, step)``: numpy arrays, or
    with ``device`` tensors there."""
    with open(os.path.join(path, "spec.json")) as f:
        spec = json.load(f)
    by_name = {e["name"]: e for e in spec["leaves"]}
    shards: Dict[int, Any] = {}
    out = []
    for name, leaf in _flatten(like):
        e = by_name[name]
        sid = e["shard"]
        if sid not in shards:
            shards[sid] = np.load(os.path.join(path, f"shard_{sid}.npz"))
        a = _as_dtype(shards[sid][e["key"]], np.asarray(leaf).dtype)
        out.append(a if device is None else _leaf_tensor(a, device))
    for z in shards.values():
        z.close()
    return _unflatten(like, iter(out)), spec["step"]
