"""The decoder stack (counterpart of ``repro/models/transformer.py``):
parameter init, embedding, the LM head (tied or not), the chunked
cross-entropy, hymba's hybrid token mixer, an RWKV-6 layer
(:func:`rwkv_block`), an encoder-decoder's encoder
(:func:`encode`, :func:`run_encoder`) and its cross-attention sublayer
(:func:`cross_sublayer`), and the train forward, on one device or over
``M`` virtual expert-parallel ranks (:func:`_moe_apply_dist`,
batch-sharded; :func:`moe_apply_vanilla`, either layout).

Where the reference stacks layers by pattern position for ``lax.scan``,
the port keeps ``params["layers"]`` (and an encoder-decoder's
``params["encoder"]["layers"]``) as a plain list, one dict per layer,
walked by a Python loop; ``cfg.remat`` checkpoints each layer as the
reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.comm.hierarchical import CommContext
from repro_torch.condense.plan import CondenseCarry
from repro_torch.config import LuffyConfig, ModelConfig
from repro_torch.core import moe_layer as moe
from repro_torch.dist import DistContext
from repro_torch.models import blocks as bk
from repro_torch.models import ssm as ssm_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.plan.exchange import MoEAux, PlanSignature, \
    invalid_signature


def pattern_period(cfg: ModelConfig) -> int:
    a = len(cfg.attn.window_pattern) if cfg.attn is not None else 1
    return math.lcm(a, len(cfg.layer_ffn_pattern))


def _check_arch(cfg: ModelConfig):
    if cfg.kind not in ("decoder", "encdec") or (
            cfg.kind == "encdec" and cfg.ssm is not None):
        raise NotImplementedError(
            f"{cfg.name}: only decoders and attention encoder-decoders are "
            f"ported (an encoder-decoder with an SSM has no config)")
    if cfg.attn is None:
        if cfg.ssm is None or cfg.ssm.kind != "rwkv6" or cfg.uses_moe:
            raise NotImplementedError(
                f"{cfg.name}: of the attention-free stacks only RWKV-6 "
                f"with its channel-mix is ported (a pure Mamba stack has "
                f"no config)")
    elif cfg.ssm is not None and not (cfg.parallel_ssm
                                      and cfg.ssm.kind == "mamba"):
        raise NotImplementedError(
            f"{cfg.name}: of the hybrids only hymba's parallel Mamba "
            f"branch is ported (a stacked SSM beside attention has no "
            f"config)")


def hybrid_mixer(p, cfg: ModelConfig, x, positions, layer: int):
    """hymba's token mixer over a whole sequence: attention (its core on
    K5) and the Mamba branch (its scan on K6) on one shared norm,
    mean-fused, ``x + 0.5 * (att + sso)``. Returns (x, (k, v))."""
    xn = bk.norm_apply(p["attn_norm"], x, cfg.norm)
    att, kv = bk.attn_apply(p["attn"], cfg, xn, positions, layer=layer,
                            causal=True, flash=True)
    sso = ssm_mod.mamba_apply(p["ssm"], cfg, xn)
    return x + 0.5 * (att + sso), kv


def rwkv_block(p, cfg: ModelConfig, x):
    """An RWKV-6 layer over a whole sequence from the zero state: the
    time-mix on its own norm (its recurrence on K7), then the
    channel-mix on the FFN's norm, each token-shifted with zeros before
    position 0. x: [B,S,d] -> [B,S,d]."""
    xn = bk.norm_apply(p["ssm_norm"], x, cfg.norm)
    x = x + ssm_mod.rwkv6_apply(p["ssm"], cfg, xn)
    xn = bk.norm_apply(p["ffn_norm"], x, cfg.norm)
    return x + ssm_mod.rwkv_cmix_apply(p["ffn"], cfg, xn)


def _init_layer(generator, cfg: ModelConfig, layer: int, *, device,
                cross: bool = False):
    """One layer's parameters, with the reference's keys; ``cross``: a
    decoder layer of an encoder-decoder, with ``cross_norm`` and
    ``cross_attn``. An RWKV-6 layer has ``ssm`` and ``ssm_norm`` in place
    of the attention, and its ``ffn`` is the channel-mix."""
    pdt = bk._dtype(cfg.param_dtype)
    p: Dict[str, Any] = {}
    if cfg.attn is not None:
        p["attn_norm"] = bk.norm_init(cfg.d_model, cfg.norm, pdt,
                                      device=device)
        p["attn"] = bk.attn_init(generator, cfg, device=device)
    rwkv = cfg.ssm is not None and cfg.ssm.kind == "rwkv6"
    if rwkv:
        p["ssm"] = ssm_mod.rwkv6_init(generator, cfg, device=device)
        p["ssm_norm"] = bk.norm_init(cfg.d_model, cfg.norm, pdt,
                                     device=device)
    elif cfg.ssm is not None:         # parallel branch: no norm of its own
        p["ssm"] = ssm_mod.mamba_init(generator, cfg, device=device)
    if cross:
        p["cross_norm"] = bk.norm_init(cfg.d_model, cfg.norm, pdt,
                                       device=device)
        p["cross_attn"] = bk.attn_init(generator, cfg, device=device)
    if cfg.ffn_kind(layer) == "moe":
        p["moe"] = moe.moe_init(generator, cfg, device=device)
    else:
        p["ffn_norm"] = bk.norm_init(cfg.d_model, cfg.norm, pdt, device=device)
        p["ffn"] = (ssm_mod.rwkv_cmix_init(generator, cfg, device=device)
                    if rwkv else bk.ffn_init(generator, cfg.d_model,
                                             cfg.d_ff, cfg, device=device))
    return p


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device):
    """Random parameters from ``generator`` (which must live on
    ``device``), laid out like the reference's pytree with the layer
    stacks unrolled into lists (an encoder-decoder's encoder under
    ``params["encoder"]``: its ``layers`` and ``final_norm``)."""
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
    if cfg.prefix_slots > 0:
        params["prefix_proj"] = {"w": bk.dense_init(
            generator, cfg.prefix_dim or cfg.d_model, cfg.d_model, pdt,
            device=device)}
    encdec = cfg.kind == "encdec"
    params["layers"] = [_init_layer(generator, cfg, i, device=device,
                                    cross=encdec)
                        for i in range(cfg.num_layers)]
    if encdec:
        params["encoder"] = {
            "layers": [_init_layer(generator, cfg, i, device=device)
                       for i in range(cfg.num_encoder_layers)],
            "final_norm": bk.norm_init(cfg.d_model, cfg.norm, pdt,
                                       device=device)}
    return params


def _encoder_layer(p, cfg: ModelConfig, x, positions, i: int, flash: bool):
    xn = bk.norm_apply(p["attn_norm"], x, cfg.norm)
    att, _ = bk.attn_apply(p["attn"], cfg, xn, positions, layer=i,
                           causal=False, flash=flash)
    x = x + att
    xn = bk.norm_apply(p["ffn_norm"], x, cfg.norm)
    return x + bk.ffn_apply(p["ffn"], cfg, xn)


def run_encoder(enc_params, cfg: ModelConfig, enc_x, *, flash: bool = False,
                remat: bool = False):
    """The encoder stack (the reference's ``_run_encoder``) over ``enc_x``
    [B, S_enc, d]: each layer non-causal self-attention over every
    position (no key mask; on K5 with ``flash``) and the dense FFN, then
    the encoder's own ``final_norm``. With ``remat`` (the train forward
    under ``cfg.remat``) each layer keeps only its input and runs again
    in the backward, as the decoder's layers do: the same values, without
    each layer's [B, H, S_enc, S_enc] scores held to the backward.
    Returns [B, S_enc, d]."""
    B, S = enc_x.shape[0], enc_x.shape[1]
    positions = torch.arange(S, device=enc_x.device)[None].expand(B, S)
    x = enc_x
    for i, p in enumerate(enc_params["layers"]):
        if remat:
            x = ckpt.checkpoint(_encoder_layer, p, cfg, x, positions, i,
                                flash, use_reentrant=False)
        else:
            x = _encoder_layer(p, cfg, x, positions, i, flash)
    return bk.norm_apply(enc_params["final_norm"], x, cfg.norm)


def encode(params, cfg: ModelConfig, enc_input, *, flash: bool = False,
           remat: bool = False):
    """An encoder-decoder's encoder memory: ``enc_input`` [B, S_enc,
    prefix_dim] (the frontend stub's frame embeddings) projected by
    ``prefix_proj`` in the compute dtype (no embedding scale, no
    positions: the reference's rounding points), then
    :func:`run_encoder` (``remat`` as there). Returns (enc_out [B, S_enc,
    d], enc_pos [B, S_enc])."""
    cdt = bk._dtype(cfg.compute_dtype)
    w = params["prefix_proj"]["w"]
    enc_x = enc_input.to(w.device, cdt) @ w.to(cdt)
    enc_out = run_encoder(params["encoder"], cfg, enc_x, flash=flash,
                          remat=remat)
    B, S = enc_out.shape[0], enc_out.shape[1]
    return enc_out, torch.arange(S, device=enc_out.device)[None].expand(B, S)


def cross_sublayer(p, cfg: ModelConfig, x, positions, enc, layer: int, *,
                   flash: bool = False):
    """A decoder layer's cross-attention sublayer over the whole
    sequence: ``x + cross_attn(cross_norm(x), kv=enc)`` with ``enc =
    (enc_out, enc_pos)`` (every encoder position live; on K5, non-causal
    at Sq != Sk, with ``flash``). Returns (x, (ck, cv)), the layer's
    static cross K/V."""
    xn = bk.norm_apply(p["cross_norm"], x, cfg.norm)
    ca, ckv = bk.attn_apply(p["cross_attn"], cfg, xn, positions,
                            layer=layer, kv=enc, causal=False, flash=flash)
    return x + ca, ckv


def embed_tokens(params, cfg: ModelConfig, tokens, prefix=None):
    """Token embedding scaled by sqrt(d_model); the scale is rounded to
    the compute dtype before the multiply, as in the reference. A
    ``prefix`` [B, P, prefix_dim] (a modality frontend's embeddings) is
    projected by ``prefix_proj`` in the compute dtype and put before the
    tokens: [B, P + S, d]."""
    cdt = bk._dtype(cfg.compute_dtype)
    x = params["embed"]["table"][tokens.long()].to(cdt)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    x = x * scale.to(cdt).to(x.device)
    if prefix is not None:
        px = prefix.to(x.device, cdt) @ params["prefix_proj"]["w"].to(cdt)
        x = torch.cat([px, x], dim=1)
    return x


def logits_fn(params, cfg: ModelConfig, x):
    cdt = bk._dtype(cfg.compute_dtype)
    h = bk.norm_apply(params["final_norm"], x, cfg.norm).to(cdt)
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(cdt).T
    else:
        w = params["unembed"]["w"].to(cdt)
    return h @ w


def chunked_xent(params, cfg: ModelConfig, x, labels, *, chunk: int = 512):
    """Cross-entropy over S in chunks of ``chunk`` positions, summed in
    the reference's order. labels < 0 are ignored. Returns (sum_loss,
    count), f32 scalars."""
    B, S, _ = x.shape
    chunk = min(chunk, S)

    def one(xc, lc):
        lg = logits_fn(params, cfg, xc).float()
        valid = (lc >= 0).float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, lc.clamp(min=0).long()[..., None])[..., 0]
        return torch.sum((lse - gold) * valid), torch.sum(valid)

    sl = sc = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        dl, dc = one(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        sl, sc = sl + dl, sc + dc
    return sl, sc


def _zero_aux(device) -> MoEAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MoEAux(*([z] * len(MoEAux._fields)))


def moe_apply_vanilla(p_moe, x, sideband, cfg: ModelConfig,
                      luffy: LuffyConfig, dist: DistContext, capacity: int,
                      wire_ef=None, plan_template=None):
    """The MoE sublayer's vanilla exchange over ``dist``'s ranks in
    ``dist``'s layout, at one rank's ``capacity``: the sequence-sharded
    train forward and the expert-parallel prefill. x: [B, S, d];
    sideband: per-position entries [B, S] (labels) and per-sequence ones
    [B] (seq_len); wire_ef: the error-feedback residual [B, S, d] f32
    (None: off), laid out like x. Returns (y, aux, wire_ef), aux averaged
    over the ranks.

    Sequence-sharded, rank r holds positions [r*S/M, (r+1)*S/M) of every
    sequence (the reference's specs ``P(bax, sax, ...)``), its tokens
    row-major over (sequence, local position); a per-position sideband
    entry is split the same way and a per-sequence one replicated, as
    the reference's specs place them. Batch-sharded, it is
    :func:`_moe_apply_dist`'s layout. ``plan_template``: a cached serving
    template to bind the routing onto (no plan is built)."""
    comm = dist.comm(luffy.comm_mode)
    if not dist.seq_sharded:
        y, _, _, aux, _, _, ef = _moe_apply_dist(
            p_moe, x, sideband, None, None, cfg, luffy, comm, "vanilla",
            capacity, None, wire_ef=wire_ef, plan_template=plan_template)
        return y, aux, ef
    B, S, d = x.shape
    comm = CommContext.local() if comm is None else comm
    M = comm.size()
    if S % M:
        raise ValueError(f"a sequence of {S} positions does not split "
                         f"over a model axis of {M}")

    def split(t):
        return t.reshape(B, M, S // M, d).transpose(0, 1)

    sb = {key: (v.reshape(B, M, S // M).transpose(0, 1) if v.dim() == 2
                else v.expand(M, B)) for key, v in sideband.items()}
    y, _, _, aux, _, _, ef = moe.moe_core_planned(
        p_moe, split(x), sb, cfg, luffy, mode="vanilla", capacity=capacity,
        comm=comm, wire_ef=None if wire_ef is None else split(wire_ef),
        plan_template=plan_template)
    return (y.transpose(0, 1).reshape(B, S, d),
            MoEAux(*(comm.pmean(a) for a in aux)),
            None if ef is None else ef.transpose(0, 1).reshape(B, S, d))


def _moe_apply_dist(p_moe, x, sideband, s_prev, threshold, cfg, luffy,
                    comm: Optional[CommContext], mode: str, capacity: int,
                    cond_carry, plan_carry: Optional[PlanSignature] = None,
                    wire_ef=None, plan_template=None):
    """The MoE sublayer over the batch, split rank-major over the ``M``
    ranks of ``comm`` (None: one device, M = 1; the reference's train
    branch of ``_moe_apply_dist``). Each rank's tokens run the rank-local
    core; the sideband, the similarity history and the condense carry
    come back at the sequences' (new) homes, and the ledger is averaged
    over the ranks (the reference's pmean). ``plan_carry``: the plan
    reuse carry (None: not threaded); ``wire_ef``: the error-feedback
    residual [B, S, d] f32, keyed by (slot, position): it stays at its
    slot when sequences migrate (None: not threaded); ``plan_template``: a
    cached vanilla template (serving). Returns (y, sideband, s_next, aux,
    cond_carry, plan_carry, wire_ef)."""
    B, S, d = x.shape
    comm = CommContext.local() if comm is None else comm
    M = comm.size()
    n_seq = B // M
    carry = None
    if cond_carry is not None:
        carry = CondenseCarry(cond_carry["rep"].reshape(-1),
                              cond_carry["cexp"].reshape(-1),
                              cond_carry["age"], cond_carry["valid"])
    sb = {key: v.reshape(M, n_seq, *v.shape[1:])
          for key, v in sideband.items()}
    y, sb, s_next, aux, plan, cc, ef = moe.moe_core_planned(
        p_moe, x.reshape(M, n_seq, S, d), sb, cfg, luffy, mode=mode,
        capacity=capacity, threshold=threshold, s_prev=s_prev,
        condense_carry=carry, comm=comm, reuse_from=plan_carry,
        wire_ef=(None if wire_ef is None
                 else wire_ef.reshape(M, n_seq, S, d)),
        plan_template=plan_template)
    sb = {key: v.reshape(B, *v.shape[2:]) for key, v in sb.items()}
    aux = MoEAux(*(comm.pmean(a) for a in aux))
    if s_next is not None:
        G = luffy.condense_group
        s_next = s_next.reshape(B, S // G, G, G)
    return (y.reshape(B, S, d), sb, s_next, aux,
            cond_carry if cc is None else cc,
            None if plan_carry is None else plan.signature,
            None if ef is None else ef.reshape(B, S, d))


def _layer_full(p, cfg: ModelConfig, luffy: LuffyConfig, layer: int,
                moe_mode: str, capacity: int, dist, x, sideband, s_prev,
                threshold, cond_carry, plan_carry, wire_ef, enc=None):
    """One decoder layer of the train forward (an RWKV-6 layer:
    :func:`rwkv_block`): attention over the whole batch (causal, or for a
    non-causal arch masked to each sequence's ``seq_len`` keys, read from
    the sideband, which has moved with its sequence), an
    encoder-decoder's cross sublayer over ``enc`` = (enc_out, enc_pos),
    then the MoE sublayer (condensing, carrying the similarity history,
    the condense carry, the plan carry and the wire residual, and
    migrating sequences across ranks; or sequence-sharded) or the dense
    FFN. Returns (x, sideband, s_prev, aux, cond_carry, plan_carry,
    wire_ef)."""
    if cfg.attn is None:              # RWKV-6: no attention, no MoE
        return (rwkv_block(p, cfg, x), sideband, s_prev,
                _zero_aux(x.device), cond_carry, plan_carry, wire_ef)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    kv_valid = None
    if not cfg.causal:
        kv_valid = positions < sideband["seq_len"][:, None]
    xn = bk.norm_apply(p["attn_norm"], x, cfg.norm)
    # sequence-sharded, the reference attends each rank's queries against
    # all-gathered K/V (_attn_seqpar): on one device that is this
    # attention over the whole sequence with the same mask, so it has no
    # separate path
    att, _ = bk.attn_apply(p["attn"], cfg, xn, positions, layer=layer,
                           causal=cfg.causal, kv_valid=kv_valid)
    x = x + att
    if enc is not None:
        x, _ = cross_sublayer(p, cfg, x, positions, enc, layer)
    if cfg.ffn_kind(layer) != "moe":
        xn = bk.norm_apply(p["ffn_norm"], x, cfg.norm)
        return (x + bk.ffn_apply(p["ffn"], cfg, xn), sideband, s_prev,
                _zero_aux(x.device), cond_carry, plan_carry, wire_ef)
    if dist is not None and dist.seq_sharded:
        x, aux, ef = moe_apply_vanilla(p["moe"], x, sideband, cfg, luffy,
                                       dist, capacity, wire_ef)
        return x, sideband, s_prev, aux, cond_carry, plan_carry, ef
    comm = None if dist is None else dist.comm(luffy.comm_mode)
    x, sideband, s_next, aux, cond_carry, plan_carry, ef = _moe_apply_dist(
        p["moe"], x, sideband, s_prev, threshold, cfg, luffy, comm,
        moe_mode, capacity, cond_carry, plan_carry, wire_ef)
    return (x, sideband, s_prev if s_next is None else s_next, aux,
            cond_carry, plan_carry, ef)


def wire_ef_shape(cfg: ModelConfig, batch: int, seq_len: int):
    """Shape of the cross-step wire error-feedback buffer: one per-token
    residual slot per layer, ``(num_layers, B, S, d_model)``. The
    reference's (``wire_ef_shape``) is ``(n_groups, period, B, S, d)``
    for its layer scan; layer ``g * period + j`` is its ``[g, j]``, so
    the two have the same memory order."""
    return (cfg.num_layers, batch, seq_len, cfg.d_model)


def forward_train(params, cfg: ModelConfig, luffy: LuffyConfig,
                  batch: Dict[str, torch.Tensor], threshold,
                  capacity: int, dist: Optional[DistContext] = None,
                  wire_ef: Optional[torch.Tensor] = None):
    """The train forward (the reference's ``forward_train``). batch:
    tokens [B, S - P], labels [B, S] (< 0 ignored), seq_len [B], for a
    prefix arch prefix [B, P, prefix_dim] (put before the tokens by
    :func:`embed_tokens`; P = 0 without one), and for an encoder-decoder
    enc_input [B, S_enc, prefix_dim]; threshold:
    f32 scalar tensor (Eq. 2); capacity: the MoE dispatch capacity per
    (rank, expert); dist: the expert-parallel ranks (None: one device).
    The dense layers run on the whole batch in its current rank-major
    order, which is each rank's computation row for row; the loss is
    the global mean (a dense arch's metrics are the loss alone).
    wire_ef (:func:`wire_ef_shape`, f32): the previous step's per-layer
    wire quantization residuals; when given, each MoE
    layer adds its slot to the shipped payload, and the refreshed
    residuals come back under ``metrics["_wire_ef"]`` (a new tensor; the
    given one is not written, since the remat recompute replays each
    layer on its old slot). Returns (total loss, metrics): the total
    adds ``router_aux_coef`` times the mean router aux loss; the metrics
    are detached scalars."""
    _check_arch(cfg)
    if cfg.ssm is not None and cfg.attn is not None:
        raise NotImplementedError(
            f"{cfg.name}: training a hybrid needs backwards for K5 and K6, "
            f"which are not ported yet (ROADMAP Queue 2)")
    seq_sharded = dist is not None and dist.seq_sharded
    x = embed_tokens(params, cfg, batch["tokens"], batch.get("prefix"))
    enc = (encode(params, cfg, batch["enc_input"], remat=cfg.remat)
           if cfg.kind == "encdec" else None)
    B, S = x.shape[0], x.shape[1]
    sideband = {"labels": batch["labels"],
                "seq_len": batch["seq_len"].to(torch.int32)}
    G = luffy.condense_group
    use_cond = (luffy.enable_condensation and cfg.uses_moe and S % G == 0
                and not seq_sharded)
    s_prev = cond_carry = None
    if use_cond:
        # 0.5 = "uncertain": the first block measures every pair (§V-A
        # has no history yet); 0.0 would mark every pair dissimilar
        s_prev = torch.full((B, S // G, G, G), 0.5, dtype=torch.float32,
                            device=x.device)
        zi = torch.zeros((B, S), dtype=torch.int64, device=x.device)
        zf = torch.zeros((B,), dtype=torch.float32, device=x.device)
        cond_carry = {"rep": zi, "cexp": zi.clone(), "age": zf,
                      "valid": zf.clone()}
    eff_luffy = luffy if use_cond else dataclasses.replace(
        luffy, enable_condensation=False)
    moe_mode = ("migrate" if (luffy.enable_migration and cfg.uses_moe
                              and not seq_sharded) else "vanilla")
    # the plan reuse carry threads through every migrating stack (under
    # plan_reuse "off" its valid flag stays 0), a host signature of the
    # shape of the planner's inputs
    plan_carry = None
    if moe_mode == "migrate":
        M = 1 if dist is None else dist.model_size
        plan_carry = invalid_signature(B, M)
    aux_sum = _zero_aux(x.device)
    ef_out = None if wire_ef is None else torch.empty_like(wire_ef)
    # the recompute runs each layer to its end, so every kernel of the
    # layer launches again in the backward (counted by chip_smoke.py);
    # it gets the layer's carries as they were, so it takes the
    # forward's reuse decisions and rebuilds the forward's residual,
    # which it drops
    with ckpt.set_checkpoint_early_stop(False):
        for i, p in enumerate(params["layers"]):
            args = (p, cfg, eff_luffy, i, moe_mode, capacity, dist, x,
                    sideband, s_prev, threshold, cond_carry, plan_carry,
                    None if wire_ef is None else wire_ef[i], enc)
            if cfg.remat:
                # traced, the recompute records no phase (the reference's
                # spans fire once per forward of a sublayer)
                fn = (_layer_full if obs_trace.active() is None
                      else obs_trace.first_call_traced(_layer_full))
                out = ckpt.checkpoint(fn, *args, use_reentrant=False)
            else:
                out = _layer_full(*args)
            x, sideband, s_prev, aux, cond_carry, plan_carry, ef = out
            if ef_out is not None:
                ef_out[i].copy_(ef)
            aux_sum = MoEAux(*(a + b for a, b in zip(aux_sum, aux)))

    sl, sc = chunked_xent(params, cfg, x, sideband["labels"])
    loss = sl / torch.clamp(sc, min=1.0)
    n_moe = max(1, sum(cfg.ffn_kind(i) == "moe"
                       for i in range(cfg.num_layers)))
    aux_mean = MoEAux(*(a / n_moe for a in aux_sum))
    total = loss
    if cfg.uses_moe:
        total = loss + cfg.moe.router_aux_coef * aux_mean.aux_loss
    if not cfg.uses_moe:
        # a dense step has no MoE sublayer: no router, drop, condensation,
        # migration or wire ledger to report
        return total, {"loss": loss.detach()}
    metrics = {
        "loss": loss, "aux_loss": aux_mean.aux_loss,
        "dispatch_drop": aux_mean.dispatch_drop,
        "combine_drop": aux_mean.combine_drop,
        "condense_rate": aux_mean.condense_rate,
        "local_frac": aux_mean.local_frac,
        "traffic_before": aux_mean.traffic_before,
        "traffic_after": aux_mean.traffic_after,
        "inter_bytes_flat": aux_mean.inter_bytes_flat,
        "inter_bytes_dedup": aux_mean.inter_bytes_dedup,
        "inter_bytes_shipped": aux_mean.inter_bytes_shipped,
        # plan and condensation ledgers: per-forward sums over the MoE
        # sublayers
        "plans_built": aux_sum.plans_built,
        "plans_reused": aux_sum.plans_reused,
        "plan_reuse_mismatch": aux_sum.reuse_mismatch,
        "measured_pairs": aux_sum.measured_pairs,
        "condense_built": aux_sum.condense_built,
        "condense_reused": aux_sum.condense_reused,
    }
    metrics = {k: v.detach() for k, v in metrics.items()}
    if ef_out is not None:
        metrics["_wire_ef"] = ef_out
    return total, metrics
