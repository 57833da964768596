"""Serving engine: prefill and single-token decode with per-layer KV
caches (counterpart of ``repro/serve/engine.py``), on one device or
over virtual expert-parallel ranks (``dist``, :mod:`repro_torch.dist`):
the prefill's MoE sublayers sequence-sharded over the ranks. The decode
step is the one-device one at any number of ranks: the reference's
all-reduce decode gives its values on virtual ranks (see
:mod:`repro_torch.dist`), and attention and the cache are the
one-device ones in both.

Cache layout, one entry per layer: ``{"k", "v": [B, W, kv, hd],
"cpos": [B, W]}`` with ``W = min(window, s_max)``; a window layer keeps a
ring buffer (slot = rpos % W), a global layer a full buffer. ``cpos``
holds each slot's relative position, -1 when empty. A hybrid layer
(hymba) also carries its Mamba state, ``"ssm_h": [B, di, N]`` and
``"ssm_conv": [B, K-1, di]``, both f32; an RWKV-6 layer (rwkv6-3b) has
no K/V and carries its WKV6 state ``"ssm_S": [B, H, hd, hd]`` and its two
token-shift states, the time-mix's ``"ssm_xprev": [B, 1, d]`` and the
channel-mix's ``"cmix_xprev": [B, 1, d]`` (the previous token's normed
inputs), all f32; a decoder layer of an
encoder-decoder (seamless) its static cross K/V, ``"ck", "cv": [B,
S_enc, kv, hd]`` in the compute dtype, which the prefill's per-layer
``ckv`` fills (:func:`write_cross_kv`) and no step writes. ``offset`` [B] is
each slot's frame origin (rpos = pos - offset) and ``pos`` the step
count. :func:`decode_step` updates the cache tensors in place, which
saves a copy of every layer's cache per token, and returns the cache.

Slot recycling (continuous batching, :mod:`repro_torch.serve.scheduler`):
:func:`admit_slot` restarts a slot at relative position 0 by setting
``offset[slot] = pos`` and zeroing its Mamba or RWKV state, and clears no
attention entry. Every ``cpos`` entry at ring index ``i`` is either -1
or a value ``v >= i`` with ``v = i (mod W)`` (writes store ``rpos`` at
index ``rpos % W``). For a fresh occupant at ``rpos_new`` every stale
index ``i > rpos_new`` therefore holds ``v >= i > rpos_new`` or -1,
masked by ``kp <= rpos`` exactly where a fresh cache's -1 entries are;
the -1e30 logits give exactly-0 softmax weights, and ``0 * stale_v = 0``,
so the recycled slot's logits are a fresh cache's bit for bit. The
Mamba and RWKV states carry across tokens unmasked, so they are zeroed
(RWKV-6's decode is row-independent: K7 runs a block per (slot, head),
so a zeroed slot decodes as a fresh one bit for bit). ``ck`` and
``cv`` are left as they are, as the reference's ``admit_slot`` leaves
them: a recycled slot attends the old request's encoder memory until
its own is written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.core import moe_layer as moe
from repro_torch.dist import DistContext
from repro_torch.models import blocks as bk
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import (cross_sublayer, embed_tokens,
                                            encode, hybrid_mixer, logits_fn,
                                            moe_apply_vanilla, rwkv_block)

NEG_INF = -1e30
# the cache's recurrent state, which admit_slot zeroes
RECURRENT_KEYS = ("ssm_h", "ssm_conv", "ssm_S", "ssm_xprev", "cmix_xprev")


def _win(cfg: ModelConfig, layer: int, s_max: int) -> int:
    w = cfg.attn.window_for_layer(layer)
    return s_max if w is None else min(w, s_max)


def cache_struct(cfg: ModelConfig, batch: int, s_max: int, *, device,
                 enc_len: int = 0):
    """An empty cache for ``batch`` slots of up to ``s_max`` positions;
    an encoder-decoder's also holds each layer's cross K/V over
    ``enc_len`` encoder positions, zeros (``enc_len`` 0: the reference's
    empty memory)."""
    a = cfg.attn
    cdt = bk._dtype(cfg.compute_dtype)
    layers = []
    for i in range(cfg.num_layers):
        g = {}
        if a is not None:
            W = _win(cfg, i, s_max)
            shape = (batch, W, a.num_kv_heads, a.head_dim)
            g["k"] = torch.zeros(shape, dtype=cdt, device=device)
            g["v"] = torch.zeros(shape, dtype=cdt, device=device)
            g["cpos"] = torch.full((batch, W), -1, dtype=torch.int32,
                                   device=device)
        if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
            st = ssm_mod.rwkv6_init_state(cfg, batch, device=device)
            g["ssm_S"], g["ssm_xprev"] = st["S"], st["x_prev"]
            # the channel-mix's own token shift (its input is normed by
            # another norm than the time-mix's)
            g["cmix_xprev"] = torch.zeros_like(st["x_prev"])
        elif cfg.ssm is not None:
            st = ssm_mod.mamba_init_state(cfg, batch, device=device)
            g["ssm_h"], g["ssm_conv"] = st["h"], st["conv"]
        if cfg.kind == "encdec":
            cshape = (batch, enc_len, a.num_kv_heads, a.head_dim)
            g["ck"] = torch.zeros(cshape, dtype=cdt, device=device)
            g["cv"] = torch.zeros(cshape, dtype=cdt, device=device)
        layers.append(g)
    return {"layers": layers,
            "offset": torch.zeros((batch,), dtype=torch.int32, device=device),
            "pos": 0}


def admit_slot(cache, slot: int, position: int):
    """Recycle cache slot ``slot`` for a new request whose first token is
    fed at absolute decode position ``position`` (normally
    ``cache["pos"]``): ``offset[slot] = position``, and the slot's
    recurrent state rows zeroed in place: the Mamba state (``ssm_h``,
    ``ssm_conv``) of every hybrid layer, the RWKV-6 state and token
    shifts (``ssm_S``, ``ssm_xprev``, ``cmix_xprev``) of every RWKV
    layer. ``k``, ``v`` and ``cpos`` are left as they are: the
    recycling invariant (module docstring) masks every stale entry; so
    are an encoder-decoder's ``ck`` and ``cv``, as in the reference.
    Returns the cache. The writes are fills, so nothing is copied from
    the host (no device sync), and run in inference mode: the decode
    step's states are inference tensors."""
    with torch.inference_mode():
        cache["offset"][slot].fill_(int(position))
        for g in cache["layers"]:
            for key in RECURRENT_KEYS:
                if key in g:
                    g[key][slot].zero_()
    return cache


def attn_decode(p, cfg: ModelConfig, x, pos: int, offset, ck, cv, cpos, *,
                window: Optional[int]):
    """x: [B,1,d]; ck/cv: [B,W,kv,hd]; cpos: [B,W]. Writes the new
    token's k/v at its slot's ring index (in place), then attends.
    Returns (out, ck, cv, cpos)."""
    a = cfg.attn
    cdt = bk._dtype(cfg.compute_dtype)
    B = x.shape[0]
    xq = x.to(cdt)
    q = (xq @ p["wq"].to(cdt)).reshape(B, 1, a.num_heads, a.head_dim)
    k_new = (xq @ p["wk"].to(cdt)).reshape(B, 1, a.num_kv_heads, a.head_dim)
    v_new = (xq @ p["wv"].to(cdt)).reshape(B, 1, a.num_kv_heads, a.head_dim)
    rpos = pos - offset                            # [B] relative positions
    if a.use_rope:
        q = bk.apply_rope(q, rpos[:, None], a.rope_theta)
        k_new = bk.apply_rope(k_new, rpos[:, None], a.rope_theta)
    W = ck.shape[1]
    rslot = (rpos % W).long()
    b_idx = torch.arange(B, device=x.device)
    ck[b_idx, rslot] = k_new[:, 0]
    cv[b_idx, rslot] = v_new[:, 0]
    cpos[b_idx, rslot] = rpos.to(cpos.dtype)

    n_rep = a.num_heads // a.num_kv_heads
    kk = bk._repeat_kv(ck, n_rep)
    vv = bk._repeat_kv(cv, n_rep)
    scale = a.softmax_scale or 1.0 / math.sqrt(a.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    kp = cpos[:, None, None, :]
    rq = rpos[:, None, None, None]
    valid = (kp >= 0) & (kp <= rq)
    if window is not None:
        if a.chunked_local:
            valid &= (rq // window) == (kp // window)
        else:
            valid &= (rq - kp) < window
    if a.logit_cap is not None:
        logits = a.logit_cap * torch.tanh(logits / a.logit_cap)
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(vv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vv).reshape(B, 1, a.q_dim)
    return (o @ p["wo"].to(cdt)).to(x.dtype), ck, cv, cpos


def cross_attn_decode(p, cfg: ModelConfig, x, ck, cv):
    """One token's cross-attention against the static encoder K/V (the
    reference's ``cross_attn_decode``, outside any kernel there too): x
    [B,1,d]; ck / cv [B,S_enc,kv,hd]; every encoder position live, no
    RoPE. Returns [B,1,d]."""
    a = cfg.attn
    cdt = bk._dtype(cfg.compute_dtype)
    B = x.shape[0]
    q = (x.to(cdt) @ p["wq"].to(cdt)).reshape(B, 1, a.num_heads, a.head_dim)
    n_rep = a.num_heads // a.num_kv_heads
    kk = bk._repeat_kv(ck, n_rep)
    vv = bk._repeat_kv(cv, n_rep)
    scale = a.softmax_scale or 1.0 / math.sqrt(a.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    w = torch.softmax(logits, dim=-1).to(vv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vv).reshape(B, 1, a.q_dim)
    return (o @ p["wo"].to(cdt)).to(x.dtype)


def write_cross_kv(cache, ckvs):
    """Copy each decoder layer's prefill cross K/V, ``ckvs[i] = (ck,
    cv)`` [B, S_enc, kv, hd], into the cache's ``ck`` / ``cv`` (made with
    ``enc_len = S_enc``), in place. Returns the cache."""
    with torch.inference_mode():
        for g, (ck, cv) in zip(cache["layers"], ckvs):
            g["ck"].copy_(ck)
            g["cv"].copy_(cv)
    return cache


def decode_capacity(cfg: ModelConfig, batch: int) -> int:
    """The MoE dispatch capacity of one decode step of ``batch`` slots."""
    return moe.capacity_for(cfg.moe, max(1, batch), cfg.moe.num_experts,
                            slack=2.0)


def prefill_capacity(cfg: ModelConfig, batch: int, seq_len: int,
                     dist: Optional[DistContext] = None) -> int:
    """The MoE dispatch capacity of one (batch, seq_len) prefill, at one
    rank's tokens (``DistContext.token_divisor``)."""
    div = 1 if dist is None else dist.token_divisor
    return moe.capacity_for(cfg.moe, max(1, batch * seq_len // div),
                            cfg.moe.num_experts)


def rwkv_decode_layer(p, cfg: ModelConfig, x, g):
    """One RWKV-6 layer of a decode step: the time-mix from the cached
    state (K7 at S = 1 on the card) and the channel-mix shifted by
    ``cmix_xprev``; the cache entries of layer ``g`` take the new states.
    x: [B,1,d] -> [B,1,d]."""
    xn = bk.norm_apply(p["ssm_norm"], x, cfg.norm)
    y, st = ssm_mod.rwkv6_step(p["ssm"], cfg, xn, {"S": g["ssm_S"],
                                                   "x_prev": g["ssm_xprev"]})
    g["ssm_S"], g["ssm_xprev"] = st["S"], st["x_prev"]
    x = x + y
    xn = bk.norm_apply(p["ffn_norm"], x, cfg.norm)
    x = x + ssm_mod.rwkv_cmix_apply(p["ffn"], cfg, xn,
                                    x_prev=g["cmix_xprev"])
    g["cmix_xprev"] = xn.float()
    return x


def _ffn_sublayer(p, cfg, luffy, x, layer, mode, capacity, sideband,
                  plan_template=None):
    if cfg.ffn_kind(layer) == "moe":
        # one rank: the layer's rank-major form, its aux unread
        return moe.moe_core_planned(
            p["moe"], x[None], {k: v[None] for k, v in sideband.items()},
            cfg, luffy, mode=mode, capacity=capacity,
            plan_template=plan_template)[0][0]
    xn = bk.norm_apply(p["ffn_norm"], x, cfg.norm)
    return x + bk.ffn_apply(p["ffn"], cfg, xn)


def decode_step(params, cfg: ModelConfig, luffy: LuffyConfig, cache, tokens,
                plan_cache=None):
    """One decode step for the whole batch. tokens: [B,1] integer.
    Returns (logits [B,V] f32, cache). ``plan_cache``: a
    :class:`repro_torch.plan.cache.PlanCache`; when it holds the decode
    template of this batch shape (``--precompute-plans``), every MoE
    sublayer binds its routing onto it: no plan is built, and the logits
    are the uncached step's bit for bit."""
    pos, offset = cache["pos"], cache["offset"]
    x = embed_tokens(params, cfg, tokens)
    B = x.shape[0]
    sb = {"seq_len": torch.ones((B,), dtype=torch.int32, device=x.device)}
    cap = decode_capacity(cfg, B) if cfg.uses_moe else 0
    tmpl = None
    if plan_cache is not None and cfg.uses_moe:
        from repro_torch.plan.cache import decode_plan_key
        tmpl = plan_cache.get(decode_plan_key(cfg, luffy, B, cap))
    for i, p in enumerate(params["layers"]):
        g = cache["layers"][i]
        if cfg.attn is None:
            x = rwkv_decode_layer(p, cfg, x, g)
            continue
        xn = bk.norm_apply(p["attn_norm"], x, cfg.norm)
        att, g["k"], g["v"], g["cpos"] = attn_decode(
            p["attn"], cfg, xn, pos, offset, g["k"], g["v"], g["cpos"],
            window=cfg.attn.window_for_layer(i))
        if cfg.ssm is not None:       # hymba: the parallel Mamba branch
            sso, st = ssm_mod.mamba_step(
                p["ssm"], cfg, xn, {"h": g["ssm_h"], "conv": g["ssm_conv"]})
            g["ssm_h"], g["ssm_conv"] = st["h"], st["conv"]
            x = x + 0.5 * (att + sso)
        else:
            x = x + att
        if cfg.kind == "encdec":
            xn = bk.norm_apply(p["cross_norm"], x, cfg.norm)
            x = x + cross_attn_decode(p["cross_attn"], cfg, xn, g["ck"],
                                      g["cv"])
        x = _ffn_sublayer(p, cfg, luffy, x, i, "decode", cap, sb, tmpl)
    logits = logits_fn(params, cfg, x)[:, 0]
    cache["pos"] = pos + 1
    return logits.float(), cache


def prefill(params, cfg: ModelConfig, luffy: LuffyConfig, tokens,
            s_max: int, dist: Optional[DistContext] = None, plan_cache=None,
            *, prefix=None, enc_input=None):
    """Full forward over the prompt [B,S], after ``prefix`` [B,P,
    prefix_dim] when given (a prefix arch's frontend embeddings,
    projected before the tokens: positions run 0..P+S-1 and the returned
    K/V hold P+S entries); dist: the expert-parallel
    ranks (None or one rank: one device), whose MoE sublayers run the
    vanilla exchange in ``dist``'s layout (sequence-sharded for the
    prefill shape) at one rank's capacity. Returns (last-token logits
    [B,V] f32, per-layer (k, v)). An encoder-decoder takes ``enc_input``
    [B, S_enc, prefix_dim] (the frontend stub's frames): the encoder runs
    once (:func:`repro_torch.models.transformer.encode`), each decoder
    layer attends it after its self-attention, and the per-layer entry
    is the reference's pair ``((k, v), (ck, cv))``, the cross K/V over
    S_enc positions (:func:`write_cross_kv` puts them in a cache made
    with ``enc_len = S_enc``). Condensation and migration are forced
    off: serving prompts are neither condensed nor re-homed. On the card
    every decoder whose masks K5 takes (``bk.flash_takes``: causal, a
    sliding window, or a chunked-local window folded into the batch)
    attends through K5, at any prompt length (an encoder's layers and the
    cross layers non-causal, a cross layer at Sq != Sk); on the CPU
    through the reference's ``attend`` / ``attend_chunked``. An RWKV-6
    layer runs its recurrence over the whole prompt from the zero state
    (one K7 launch on the card) and its entry is None (no K/V). As in
    the reference, a Mamba branch's or an RWKV layer's final state is
    not returned: the launcher builds the decode cache by feeding the
    prompt step by step. ``plan_cache``: a
    :class:`repro_torch.plan.cache.PlanCache`; when it holds this (batch,
    prompt) shape's template (``--precompute-plans``), every MoE sublayer
    binds its routing onto it: no plan is built, and the logits are the
    uncached prefill's bit for bit."""
    x = embed_tokens(params, cfg, tokens, prefix)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    sb = {"seq_len": torch.full((B,), S, dtype=torch.int32,
                                device=x.device)}
    nl = dataclasses.replace(luffy, enable_condensation=False,
                             enable_migration=False)
    cap = prefill_capacity(cfg, B, S, dist) if cfg.uses_moe else 0
    ranks = dist is not None and dist.enabled
    tmpl = None
    if plan_cache is not None and cfg.uses_moe:
        from repro_torch.plan.cache import prefill_plan_key
        tmpl = plan_cache.get(prefill_plan_key(cfg, nl, dist, B, S, cap))
    # on the card the attention core runs on K5 wherever K5 takes the
    # mask; on the CPU it stays the reference's attend (attend_chunked
    # over ATTN_DIRECT_MAX positions), which the CPU parity rests on
    flash = x.device.type == "cuda" and bk.flash_takes(cfg)
    enc = None
    if cfg.kind == "encdec":
        if enc_input is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                             f"prefill takes enc_input")
        enc = encode(params, cfg, enc_input, flash=flash)
    kvs = []
    for i, p in enumerate(params["layers"]):
        if cfg.attn is None:          # RWKV-6: K7, no K/V
            x = rwkv_block(p, cfg, x)
            kvs.append(None)
            continue
        if cfg.ssm is not None:       # hymba: K5 and K6
            x, kv = hybrid_mixer(p, cfg, x, positions, i)
        else:
            xn = bk.norm_apply(p["attn_norm"], x, cfg.norm)
            # causal whatever cfg.causal says: the reference serves
            # every decoder so
            att, kv = bk.attn_apply(p["attn"], cfg, xn, positions, layer=i,
                                    causal=True, flash=flash)
            x = x + att
        if enc is not None:
            x, ckv = cross_sublayer(p, cfg, x, positions, enc, i,
                                    flash=flash)
            kv = (kv, ckv)
        if ranks and cfg.ffn_kind(i) == "moe":
            x = moe_apply_vanilla(p["moe"], x, sb, cfg, nl, dist, cap,
                                  plan_template=tmpl)[0]
        else:
            x = _ffn_sublayer(p, cfg, nl, x, i, "vanilla", cap, sb, tmpl)
        kvs.append(kv)
    logits = logits_fn(params, cfg, x[:, -1:])[:, 0]
    return logits.float(), kvs
