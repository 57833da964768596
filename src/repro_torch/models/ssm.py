"""The state-space token mixers (counterpart of ``repro/models/ssm.py``):
the Mamba selective SSM, hymba's parallel branch, and RWKV-6's time-mix
and channel-mix, the layers of rwkv6-3b.

A full sequence (:func:`mamba_apply`) scans from the zero state through
``ops.mamba_scan_fused``: on the card kernel K6 with the f32 passes
around the scan (softplus, skip, gate, rounding) taken in, on the CPU its
plain version, the same ops one by one; any S and d_inner. A decode step (:func:`mamba_step`) advances the
carried state by one token in plain PyTorch, as the reference's
``lax.scan`` path does. The rounding points are the reference's: ``xc``
is rounded to the compute dtype before ``x_proj``; ``dt``, B, C, the
scan, the skip and the gate are f32.

RWKV-6 (:func:`rwkv6_apply` over a sequence from the zero state,
:func:`rwkv6_step` one token from a carried state) runs its WKV6
recurrence through ``ops.wkv6_scan``: on the card kernel K7, whole
sequence or one step, on the CPU its plain version. The reference's
rounding points are kept: r, k, v and g are products in the compute
dtype, r, k and v then cast to f32; the decay LoRA is f32 and has no
tanh, ``w = exp(-exp(mix_w A B + w_bias))``; ``u_bonus`` and ``w_bias``
are f32 whatever the parameter dtype; the output is normalised by the
RMS over the whole d (not per head), scaled by ``ln_scale``, multiplied
by g in the compute dtype, then projected by ``wo``. The channel-mix's
``r = sigmoid(xc wr)`` takes the unshifted input and only k is
token-shifted; a full sequence's shift is zero-padded.
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


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) time-mix with data-dependent decay
# ---------------------------------------------------------------------------

def rwkv6_init(generator, cfg: ModelConfig, *, device):
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    n_heads = d // hd
    pdt = _dtype(cfg.param_dtype)
    lora = max(32, d // 32)

    def half():
        return torch.full((d,), 0.5, dtype=pdt, device=device)

    return {
        "mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_w": half(),
        "wr": dense_init(generator, d, d, pdt, device=device),
        "wk": dense_init(generator, d, d, pdt, device=device),
        "wv": dense_init(generator, d, d, pdt, device=device),
        "wg": dense_init(generator, d, d, pdt, device=device),
        "wo": dense_init(generator, d, d, pdt, device=device,
                         scale=1.0 / math.sqrt(2 * cfg.num_layers)),
        # the data-dependent decay's LoRA (the Finch contribution)
        "w_lora_a": dense_init(generator, d, lora, pdt, device=device),
        "w_lora_b": dense_init(generator, lora, d, pdt, device=device,
                               scale=0.1),
        # f32 whatever the parameter dtype, as in the reference
        "w_bias": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "u_bonus": torch.randn((n_heads, hd), generator=generator,
                               device=device) * 0.1,
        "ln_scale": torch.ones((d,), dtype=pdt, device=device),
    }


def _rwkv6_core(p, cfg: ModelConfig, r, k, v, w, state=None):
    """The WKV6 recurrence (K7 on the card): r, k, v, w [B,S,H,hd] f32;
    state [B,H,hd,hd] f32 (None: zeros). Returns (y [B,S,H,hd] f32, the
    final state)."""
    return ops.wkv6_scan(r, k, v, w, p["u_bonus"], state)


def _rwkv6_project(p, cfg: ModelConfig, x, x_prev):
    """The token-shift mixes and projections. x, x_prev: [B,S,d] (x_prev
    the shifted input). Returns (r, k, v, w [B,S,H,hd] f32, g [B,S,d] in
    the compute dtype)."""
    cdt = _dtype(cfg.compute_dtype)
    hd = cfg.ssm.head_dim
    B, S, d = x.shape
    n_heads = d // hd
    xc, xp = x.to(cdt), x_prev.to(cdt)

    def mix(m):
        mm = p[m].to(cdt)
        return xc * mm + xp * (1 - mm)

    r = (mix("mix_r") @ p["wr"].to(cdt)).reshape(B, S, n_heads, hd)
    k = (mix("mix_k") @ p["wk"].to(cdt)).reshape(B, S, n_heads, hd)
    v = (mix("mix_v") @ p["wv"].to(cdt)).reshape(B, S, n_heads, hd)
    g = F.silu(xc @ p["wg"].to(cdt))
    ww = mix("mix_w").float()
    ww = (ww @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    w = torch.exp(-torch.exp(ww + p["w_bias"].float()))           # (0,1)
    return (r.float(), k.float(), v.float(),
            w.reshape(B, S, n_heads, hd), g)


def _rwkv6_out(p, cfg: ModelConfig, y, g, out_dtype):
    """The time-mix output: y [B,S,H,hd] f32 normalised by its RMS over
    the whole d (the reference's approximation of a per-head group norm),
    scaled by ``ln_scale``, gated by g in the compute dtype, projected by
    ``wo``."""
    cdt = _dtype(cfg.compute_dtype)
    B, S = y.shape[0], y.shape[1]
    yf = y.reshape(B, S, p["wo"].shape[0])
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    yf = yf * p["ln_scale"].float()
    return ((yf.to(cdt) * g) @ p["wo"].to(cdt)).to(out_dtype)


def _shift(x):
    """The full sequence's token shift: position t sees t - 1, position 0
    zeros."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv6_apply(p, cfg: ModelConfig, x):
    """The full-sequence RWKV-6 time-mix from the zero state (one K7
    launch on the card). x: [B,S,d] -> [B,S,d]."""
    r, k, v, w, g = _rwkv6_project(p, cfg, x, _shift(x))
    y, _ = _rwkv6_core(p, cfg, r, k, v, w)
    return _rwkv6_out(p, cfg, y, g, x.dtype)


def rwkv6_init_state(cfg: ModelConfig, batch: int, *, device):
    hd = cfg.ssm.head_dim
    n_heads = cfg.d_model // hd
    return {"S": torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, 1, cfg.d_model),
                                  dtype=torch.float32, device=device)}


def rwkv6_step(p, cfg: ModelConfig, x, state):
    """Single-token decode. x: [B,1,d]; state {"S": [B,H,hd,hd] f32,
    "x_prev": [B,1,d] f32, the previous token's input}. Returns (out
    [B,1,d], the new state: S advanced by one step, and x as f32 for
    x_prev)."""
    r, k, v, w, g = _rwkv6_project(p, cfg, x, state["x_prev"].to(x.dtype))
    y, st = _rwkv6_core(p, cfg, r, k, v, w, state["S"])
    return (_rwkv6_out(p, cfg, y, g, x.dtype),
            {"S": st, "x_prev": x.float()})


# ---------------------------------------------------------------------------
# RWKV channel-mix (the FFN of rwkv archs)
# ---------------------------------------------------------------------------

def rwkv_cmix_init(generator, cfg: ModelConfig, *, device):
    d, dff = cfg.d_model, cfg.d_ff
    pdt = _dtype(cfg.param_dtype)
    return {"mix_k": torch.full((d,), 0.5, dtype=pdt, device=device),
            "wk": dense_init(generator, d, dff, pdt, device=device),
            "wv": dense_init(generator, dff, d, pdt, device=device,
                             scale=1.0 / math.sqrt(2 * cfg.num_layers)),
            "wr": dense_init(generator, d, d, pdt, device=device)}


def rwkv_cmix_apply(p, cfg: ModelConfig, x, x_prev=None):
    """The channel-mix: ``sigmoid(xc wr) * (relu(xk wk)^2 wv)`` with xk
    the token-shifted mix of x and x_prev (None: the full sequence's
    zero-padded shift; a decode step passes the previous token's input,
    [B,1,d])."""
    cdt = _dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    xp = _shift(xc) if x_prev is None else x_prev.to(cdt)
    m = p["mix_k"].to(cdt)
    xk = xc * m + xp * (1 - m)
    k = torch.square(F.relu(xk @ p["wk"].to(cdt)))
    r = torch.sigmoid(xc @ p["wr"].to(cdt))
    return (r * (k @ p["wv"].to(cdt))).to(x.dtype)
