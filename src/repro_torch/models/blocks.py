"""Transformer building blocks (counterpart of ``repro/models/blocks.py``).

Parameters are nested dicts of tensors; every ``*_init`` takes an
explicit ``torch.Generator`` and device. Compute runs in
``cfg.compute_dtype``; norm and softmax statistics in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ACTS

NEG_INF = -1e30
# the streaming path's chunks of queries and keys, and the longest
# sequence the direct path takes (the reference's constants)
ATTN_CHUNK_Q = 512
ATTN_CHUNK_K = 1024
ATTN_DIRECT_MAX = 2048

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(generator, d_in: int, d_out: int, dtype, *, device,
               scale: float = 1.0):
    # one f32 matrix at a time (scaled in place), then cast: a bf16
    # model never holds more than one f32 temporary
    std = scale / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=generator,
                       device=device).mul_(std).to(dtype)


def embed_init(generator, vocab: int, d: int, dtype, *, device):
    return torch.randn((vocab, d), generator=generator,
                       device=device).mul_(0.02).to(dtype)


def norm_init(d: int, kind: str, dtype, *, device):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind != "rms":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_apply(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm or LayerNorm (population variance) in f32, cast back."""
    xf = x.float()
    if kind == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, *, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding in f32, cast back. x: [..., S, H, hd];
    positions: [..., S] integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # [hd/2]
    ang = positions[..., None].float() * freqs                 # [.., S, hd/2]
    cos = torch.cos(ang)[..., None, :]            # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(generator, cfg: ModelConfig, *, device):
    """A self-attention's projections, or a cross-attention's: the
    reference's ``cross=True`` draws the same four matrices."""
    a = cfg.attn
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    return {
        "wq": dense_init(generator, d, a.q_dim, dt, device=device),
        "wk": dense_init(generator, d, a.kv_dim, dt, device=device),
        "wv": dense_init(generator, d, a.kv_dim, dt, device=device),
        "wo": dense_init(generator, a.q_dim, d, dt, device=device,
                         scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def _split_heads(x, n_heads: int, head_dim: int):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _repeat_kv(k, n_rep: int):
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=-2)


def make_attn_mask(q_pos, k_pos, *, causal: bool, window: Optional[int],
                   chunked: bool = False):
    """Boolean [.., Sq, Sk] mask; True = attend."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k <= q
    if window is not None:
        if chunked:
            mask &= (q // window) == (k // window)
        else:
            mask &= (q - k) < window
    return mask


def attend(q, k, v, mask, scale: float, logit_cap=None):
    """q: [B,Sq,H,hd]; k, v: [B,Sk,Hkv,hd]; mask broadcastable to
    [B,1,Sq,Sk]. Logits in f32, softmax weights cast to v's dtype."""
    n_rep = q.shape[-2] // k.shape[-2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if mask.dim() == 2:
        mask = mask[None, None]
    elif mask.dim() == 3:
        mask = mask[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attend_chunked(q, k, v, q_pos, k_pos, scale: float, *, causal: bool,
                   window: Optional[int], chunked_window: bool,
                   logit_cap=None, kv_valid=None, chunk_q: int = ATTN_CHUNK_Q,
                   chunk_k: int = ATTN_CHUNK_K):
    """Streaming-softmax attention (the reference's ``attend_chunked``):
    query chunks of ``chunk_q`` against key chunks of ``chunk_k`` with a
    running (m, l, acc) in f32, never the whole [B,H,Sq,Sk] logits.
    q: [B,Sq,H,hd]; k, v: [B,Sk,Hkv,hd]; q_pos / k_pos: [Sq] / [Sk]
    integer positions shared across the batch; kv_valid: [B,Sk] bool or
    None. Sq and Sk must be multiples of their chunks (or shorter). A
    causal sliding window with Sq == Sk visits only the band of key
    chunks a query chunk can see (the reference's default; its
    ``REPRO_ATTN_BAND`` switch is not ported). Returns [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n_rep = H // k.shape[2]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    nq, nk = Sq // cq, Sk // ck
    if Sq % cq or Sk % ck:
        raise ValueError(f"the streaming path takes Sq, Sk multiples of "
                         f"their chunks, got Sq={Sq} (chunk {cq}), Sk={Sk} "
                         f"(chunk {ck})")
    n_need = nk
    # only a causal window looks strictly backward: a non-causal one
    # also attends forward, so the band does not apply
    if window is not None and Sq == Sk and causal:
        if chunked_window:
            n_need = min(nk, (window + ck - 1) // ck + (cq + ck - 1) // ck)
        else:
            n_need = min(nk, (window + cq + ck - 1) // ck + 1)
    # the chunk bounds on the host, one copy of the query positions
    q_first = q_pos.reshape(nq, cq)[:, 0].tolist()
    outs = []
    for i in range(nq):
        qb = q[:, i * cq:(i + 1) * cq].float()
        qp = q_pos[i * cq:(i + 1) * cq][:, None]
        m = torch.full((B, H, cq), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32,
                          device=q.device)
        lo = 0
        if n_need < nk:
            q0 = q_first[i]
            if chunked_window:
                lo = ((q0 // window) * (window // ck) if window >= ck
                      else q0 // ck)
            else:
                lo = max(q0 - window + 1, 0) // ck
            lo = min(max(lo, 0), nk - n_need)
        for j in range(lo, lo + n_need):
            ks = slice(j * ck, (j + 1) * ck)
            kk = _repeat_kv(k[:, ks], n_rep)
            vv = _repeat_kv(v[:, ks], n_rep)
            lg = torch.einsum("bqhd,bkhd->bhqk", qb, kk.float()) * scale
            if logit_cap is not None:
                lg = logit_cap * torch.tanh(lg / logit_cap)
            kp = k_pos[ks][None, :]
            msk = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                msk &= kp <= qp
            if window is not None:
                if chunked_window:
                    msk &= (qp // window) == (kp // window)
                else:
                    msk &= (qp - kp) < window
            msk4 = msk[None, None]
            if kv_valid is not None:
                msk4 = msk4 & kv_valid[:, ks][:, None, None, :]
            lg = torch.where(msk4, lg, NEG_INF)
            m2 = torch.maximum(m, torch.amax(lg, dim=-1))
            m2 = torch.clamp(m2, min=-0.5e30)
            a = torch.exp(m - m2)
            p = torch.exp(lg - m2[..., None])
            p = torch.where(msk4, p, 0.0)
            l = l * a + torch.sum(p, dim=-1)
            acc = acc * a[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vv.dtype), vv).float()
            m = m2
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))     # [B,cq,H,hd]
    return torch.cat(outs, dim=1)


def flash_takes(cfg: ModelConfig) -> bool:
    """Whether K5 computes ``cfg``'s self-attention masks: every layer
    kind is one it takes (a global layer causal, a sliding window, a
    chunked-local window by :func:`flash_chunked`), so only a logit cap
    rules an arch out (a key-padding mask is the caller's to rule
    out). An arch without attention (RWKV-6) has nothing for K5."""
    return cfg.attn is not None and cfg.attn.logit_cap is None


def flash_chunked(q, k, v, chunk: int, *, causal: bool, scale: float):
    """A chunked-local layer (``q // W == k // W``, W = ``chunk``) through
    the unchanged K5, positions 0..S-1 in every row: blocks of W positions
    attend only within themselves, so the ``n = S // W`` whole blocks fold
    into the batch, [B * n, W, ...], for one launch at K5's own mask
    (``causal``, no window), and the ragged tail of ``S mod W`` positions
    (a block of its own, starting at a multiple of W) takes a second; at
    S <= W the layer is one launch. q: [B,S,H,hd]; k, v: [B,S,KV,hd].
    The fold is a view when S is a multiple of W; otherwise (B > 1) the
    leading positions are copied once. Returns [B,S,H,hd]."""
    B, S = q.shape[:2]
    if S <= chunk:
        return ops.flash_attention(q, k, v, causal=causal, scale=scale)
    n = S // chunk
    L = n * chunk

    def fold(t):
        return t[:, :L].reshape((B * n, chunk) + t.shape[2:])

    out = ops.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                              scale=scale).reshape((B, L) + q.shape[2:])
    if L == S:
        return out
    tail = ops.flash_attention(q[:, L:], k[:, L:], v[:, L:], causal=causal,
                               scale=scale)
    return torch.cat([out, tail], dim=1)


def attn_apply(p, cfg: ModelConfig, x, positions, *, layer: int,
               kv=None, causal: bool = True, flash: bool = False,
               kv_valid=None):
    """Full-sequence attention (train / prefill / encoder / cross).
    x: [B,S,d]; positions: [B,S]; kv_valid: [B,Sk] bool, the keys that
    may be attended (a non-causal arch must not attend to padding), ANDed
    into the mask. ``kv = (src [B,Sk,d], src_positions [B,Sk])`` makes it
    cross-attention, as the reference's: keys and values projected from
    ``src`` (an encoder's output) in the compute dtype, no RoPE on them,
    no window and no causal mask, whatever ``causal`` says. With
    ``flash`` the core runs through ``ops.flash_attention`` (K5) at any
    S, a chunked-local layer folded (:func:`flash_chunked`), a cross one
    non-causal at Sq != Sk; K5 masks by index, so positions must be
    0..S-1 in every row, and takes no key mask; else through ``attend``
    up to ``ATTN_DIRECT_MAX`` positions (of queries and keys) and
    ``attend_chunked`` (positions shared across the batch) above, as the
    reference routes. Returns (out [B,S,d], (k, v)), k after RoPE: a
    cross layer's (k, v) is its decode cache's static ``ck`` / ``cv``."""
    a = cfg.attn
    cdt = _dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    q = _split_heads(xq @ p["wq"].to(cdt), a.num_heads, a.head_dim)
    src, kv_positions = (xq, positions) if kv is None else \
        (kv[0].to(cdt), kv[1])
    k = _split_heads(src @ p["wk"].to(cdt), a.num_kv_heads, a.head_dim)
    v = _split_heads(src @ p["wv"].to(cdt), a.num_kv_heads, a.head_dim)
    if a.use_rope:
        q = apply_rope(q, positions, a.rope_theta)
        if kv is None:
            k = apply_rope(k, positions, a.rope_theta)
    scale = a.softmax_scale or 1.0 / math.sqrt(a.head_dim)
    window = a.window_for_layer(layer) if kv is None else None
    causal = causal and kv is None
    if flash:
        if not flash_takes(cfg) or kv_valid is not None:
            raise NotImplementedError(
                "K5 masks causal, sliding and chunked windows only (no "
                "logit cap, no key-padding mask)")
        if window is not None and a.chunked_local:
            out = flash_chunked(q, k, v, window, causal=causal, scale=scale)
        else:
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    elif max(q.shape[1], k.shape[1]) > ATTN_DIRECT_MAX:
        def first(t):
            return t[0] if t.dim() == 2 else t
        out = attend_chunked(q, k, v, first(positions), first(kv_positions),
                             scale, causal=causal, window=window,
                             chunked_window=a.chunked_local,
                             logit_cap=a.logit_cap, kv_valid=kv_valid)
    else:
        mask = make_attn_mask(positions, kv_positions, causal=causal,
                              window=window, chunked=a.chunked_local)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        out = attend(q, k, v, mask, scale, a.logit_cap)
    out = out.reshape(out.shape[:-2] + (a.q_dim,))
    return (out @ p["wo"].to(cdt)).to(x.dtype), (k, v)


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def ffn_init(generator, d_model: int, d_ff: int, cfg: ModelConfig, *,
             device):
    dt = _dtype(cfg.param_dtype)
    p = {"w_up": dense_init(generator, d_model, d_ff, dt, device=device),
         "w_down": dense_init(generator, d_ff, d_model, dt, device=device,
                              scale=1.0 / math.sqrt(2 * cfg.num_layers))}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dt, device=device)
    return p


def _act(name: str):
    return ACTS[name]


def ffn_apply(p, cfg: ModelConfig, x):
    cdt = _dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    h = xc @ p["w_up"].to(cdt)
    if cfg.gated_mlp:
        h = _act(cfg.act)(xc @ p["w_gate"].to(cdt)) * h
    else:
        h = _act(cfg.act)(h)
    return (h @ p["w_down"].to(cdt)).to(x.dtype)
