"""The Mamba selective SSM token mixer, hymba's parallel branch
(counterpart of the Mamba part of ``repro/models/ssm.py``; RWKV-6 is not
ported yet).

A full sequence (:func:`mamba_apply`) scans from the zero state through
``ops.mamba_scan_fused``: on the card kernel K6 with the f32 passes
around the scan (softplus, skip, gate, rounding) taken in, on the CPU its
plain version, the same ops one by one; any S and d_inner. A decode step (:func:`mamba_step`) advances the
carried state by one token in plain PyTorch, as the reference's
``lax.scan`` path does. The rounding points are the reference's: ``xc``
is rounded to the compute dtype before ``x_proj``; ``dt``, B, C, the
scan, the skip and the gate are f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.blocks import _dtype, dense_init


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def mamba_init(generator, cfg: ModelConfig, *, device):
    s = cfg.ssm
    d = cfg.d_model
    di = d_inner(cfg)
    dt_rank = s.dt_rank or max(1, math.ceil(d / 16))
    pdt = _dtype(cfg.param_dtype)
    a_init = torch.arange(1, s.state_dim + 1, dtype=torch.float32,
                          device=device)[None].repeat(di, 1)
    return {
        "in_proj": dense_init(generator, d, 2 * di, pdt, device=device),
        "conv_w": (torch.randn((s.conv_dim, di), generator=generator,
                               device=device) * 0.1).to(pdt),
        "x_proj": dense_init(generator, di, dt_rank + 2 * s.state_dim, pdt,
                             device=device),
        "dt_proj": dense_init(generator, dt_rank, di, pdt, device=device),
        "dt_bias": torch.zeros((di,), dtype=pdt, device=device),
        # f32 whatever the parameter dtype, as in the reference
        "a_log": torch.log(a_init),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, di, d, pdt, device=device,
                               scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def _mamba_inner(p, cfg: ModelConfig, x_conv, z, h0=None):
    """x_conv, z: [B,S,di] in the compute dtype (post-conv, pre-activation).
    h0 None: scan the whole sequence from the zero state (K6); else one
    decode step (S = 1) from the state h0 [B,di,N] f32. Returns (y
    [B,S,di], the final state)."""
    n = cfg.ssm.state_dim
    dt_rank = p["dt_proj"].shape[0]
    cdt = _dtype(cfg.compute_dtype)
    xc = F.silu(x_conv).to(cdt)
    proj = (xc @ p["x_proj"].to(cdt)).float()
    dt, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt_lin = dt @ p["dt_proj"].float()
    a = -torch.exp(p["a_log"])                                     # [di,N]
    if h0 is None:
        return ops.mamba_scan_fused(dt_lin, p["dt_bias"], xc, z,
                                    p["d_skip"], bmat, cmat, a)
    dt = ref.softplus(dt_lin + p["dt_bias"].float())
    xf = xc.float()
    da = torch.exp(dt[:, 0, :, None] * a)                          # [B,di,N]
    dbx = (dt[:, 0] * xf[:, 0])[..., None] * bmat[:, 0, None, :]
    h = da * h0 + dbx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None]
    y = y + p["d_skip"] * xf
    y = y * F.silu(z.float())
    return y.to(cdt), h


def mamba_apply(p, cfg: ModelConfig, x):
    """Full-sequence Mamba from the zero state. x: [B,S,d] -> [B,S,d]."""
    cdt = _dtype(cfg.compute_dtype)
    K = cfg.ssm.conv_dim
    xz = x.to(cdt) @ p["in_proj"].to(cdt)
    xin, z = torch.chunk(xz, 2, dim=-1)
    # causal depthwise conv: the reference's K-term shifted sum, in order
    w = p["conv_w"].to(cdt)                                      # [K,di]
    S = xin.shape[1]
    pad = F.pad(xin, (0, 0, K - 1, 0))
    xconv = sum(pad[:, i:i + S] * w[i] for i in range(K))
    y, _ = _mamba_inner(p, cfg, xconv, z)
    return (y @ p["out_proj"].to(cdt)).to(x.dtype)


def mamba_init_state(cfg: ModelConfig, batch: int, *, device):
    s = cfg.ssm
    di = d_inner(cfg)
    return {"h": torch.zeros((batch, di, s.state_dim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, s.conv_dim - 1, di),
                                dtype=torch.float32, device=device)}


def mamba_step(p, cfg: ModelConfig, x, state):
    """Single-token decode. x: [B,1,d]; state {"h": [B,di,N] f32, "conv":
    [B,K-1,di] f32}. Returns (out [B,1,d], the new state)."""
    cdt = _dtype(cfg.compute_dtype)
    xz = x.to(cdt) @ p["in_proj"].to(cdt)
    xin, z = torch.chunk(xz, 2, dim=-1)                          # [B,1,di]
    hist = torch.cat([state["conv"].to(cdt), xin], dim=1)        # [B,K,di]
    w = p["conv_w"].to(cdt)
    xconv = torch.einsum("bkd,kd->bd", hist, w)[:, None]
    y, h = _mamba_inner(p, cfg, xconv, z, state["h"])
    new_state = {"h": h, "conv": hist[:, 1:].float()}
    return (y @ p["out_proj"].to(cdt)).to(x.dtype), new_state
