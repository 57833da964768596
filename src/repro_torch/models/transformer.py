"""The decoder stack's pieces (counterpart of
``repro/models/transformer.py``): parameter init, embedding and the
tied LM head. The single-device branch of the reference's
``_moe_apply_dist`` is :func:`repro_torch.core.moe_layer.moe_core`.

Where the reference stacks layers by pattern position for ``lax.scan``,
the port keeps ``params["layers"]`` as a plain list, one dict per layer,
walked by a Python loop.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import moe_layer as moe
from repro_torch.models import blocks as bk


def pattern_period(cfg: ModelConfig) -> int:
    a = len(cfg.attn.window_pattern) if cfg.attn is not None else 1
    return math.lcm(a, len(cfg.layer_ffn_pattern))


def _check_arch(cfg: ModelConfig):
    if cfg.kind != "decoder" or cfg.attn is None:
        raise NotImplementedError(
            f"{cfg.name}: only attention decoders are ported; other "
            f"kinds come with the 'other architectures' slice")


def _init_layer(generator, cfg: ModelConfig, layer: int, *, device):
    pdt = bk._dtype(cfg.param_dtype)
    p: Dict[str, Any] = {
        "attn_norm": bk.norm_init(cfg.d_model, cfg.norm, pdt, device=device),
        "attn": bk.attn_init(generator, cfg, device=device),
    }
    if cfg.ffn_kind(layer) == "moe":
        p["moe"] = moe.moe_init(generator, cfg, device=device)
    else:
        p["ffn_norm"] = bk.norm_init(cfg.d_model, cfg.norm, pdt, device=device)
        p["ffn"] = bk.ffn_init(generator, cfg.d_model, cfg.d_ff, cfg,
                               device=device)
    return p


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device):
    """Random parameters from ``generator`` (which must live on
    ``device``), laid out like the reference's pytree with the layer
    stack unrolled into a list."""
    _check_arch(cfg)
    pdt = bk._dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": {"table": bk.embed_init(generator, cfg.vocab_size,
                                         cfg.d_model, pdt, device=device)},
        "final_norm": bk.norm_init(cfg.d_model, cfg.norm, pdt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": bk.dense_init(
            generator, cfg.d_model, cfg.vocab_size, pdt, device=device)}
    params["layers"] = [_init_layer(generator, cfg, i, device=device)
                        for i in range(cfg.num_layers)]
    return params


def embed_tokens(params, cfg: ModelConfig, tokens):
    """Token embedding scaled by sqrt(d_model); the scale is rounded to
    the compute dtype before the multiply, as in the reference."""
    cdt = bk._dtype(cfg.compute_dtype)
    x = params["embed"]["table"][tokens.long()].to(cdt)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    return x * scale.to(cdt).to(x.device)


def logits_fn(params, cfg: ModelConfig, x):
    cdt = bk._dtype(cfg.compute_dtype)
    h = bk.norm_apply(params["final_norm"], x, cfg.norm).to(cdt)
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(cdt).T
    else:
        w = params["unembed"]["w"].to(cdt)
    return h @ w
