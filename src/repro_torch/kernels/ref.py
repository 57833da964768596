"""Plain PyTorch versions of the hand-written kernels (counterpart of
``repro/kernels/ref.py``). The CPU path runs them; on the card they are
what each kernel is held against."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.comm import dtypes as wdt


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": _gelu_tanh}


def mapped_weights(w, w_idx):
    """The stack group e of a K1 launch reads under the group map
    ``w_idx`` (int [E], -1 idle): ``w[w_idx[e]]``, zero for an idle group.
    For the expert-parallel replica lanes this is the reference's
    concatenation ``[w; w[src] * live]`` laid out rank by rank
    (``repro/plan/exchange.py:867-871``); autograd adds each group's
    gradient into the weights it read."""
    live = (w_idx >= 0).to(w.dtype)[:, None, None]
    return w.index_select(0, w_idx.clamp(min=0).long()) * live


def expert_ffn_ref(h, w_up, w_gate, w_down, act_name: str = "silu",
                   w_idx=None):
    """h: [E, R, d]; w_up/w_gate: [E, d, f]; w_down: [E, f, d] (with the
    group map ``w_idx``, [Ew, ...] read through :func:`mapped_weights`).
    f32 math throughout, result cast to ``h.dtype``."""
    if w_idx is not None:
        w_up, w_gate, w_down = (mapped_weights(w, w_idx)
                                for w in (w_up, w_gate, w_down))
    act = ACTS[act_name]
    hf = h.float()
    up = torch.einsum("erd,edf->erf", hf, w_up.float())
    gt = torch.einsum("erd,edf->erf", hf, w_gate.float())
    out = torch.einsum("erf,efd->erd", act(gt) * up, w_down.float())
    return out.to(h.dtype)


def act_grad(x, act_name: str):
    """d act / dx by the kernels' formula (``csrc/common.cuh``)."""
    if act_name == "silu":
        s = torch.sigmoid(x)
        return s * (1.0 + x * (1.0 - s))
    k0, k1 = math.sqrt(2.0 / math.pi), 0.044715
    t = torch.tanh(k0 * (x + k1 * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * k0 * (
        1.0 + 3.0 * k1 * x * x)


def bf16_split(x):
    """x as two bf16 terms (hi, lo): hi = bf16(x), lo = bf16(x - hi).
    hi + lo holds x to 16 bits; a bf16 x has lo = 0."""
    hi = x.to(torch.bfloat16)
    return hi, (x.float() - hi.float()).to(torch.bfloat16)


def _pair(x):
    hi, lo = bf16_split(x)
    return hi.float() + lo.float()       # exact in f32


def expert_ffn_bwd_bf16_ref(h, w_up, w_gate, w_down, dy,
                            act_name: str = "silu"):
    """The tensor-core backward's rounding points
    (``csrc/expert_ffn_bwd.cu``, route 1), f32 sums: h, dy bf16; the
    weights as their bf16 hi + lo terms; gt, up, dhh, then P = act(gt) *
    up, DU = dhh * act(gt), DG = dhh * up * act'(gt) in f32; the weight
    gradients h^T (DU hi + lo), h^T (DG hi + lo), (P hi + lo)^T dy in f32;
    dh = bf16(DU) W_up^T + bf16(DG) W_gate^T, rounded to h's dtype.
    Returns (dh, dw_up, dw_gate, dw_down)."""
    hf, dyf = h.float(), dy.float()
    wu, wg, wd = (_pair(w.float()) for w in (w_up, w_gate, w_down))
    gt, up = hf @ wg, hf @ wu
    dhh = dyf @ wd.transpose(1, 2)
    a = ACTS[act_name](gt)
    p, du, dg = a * up, dhh * a, dhh * up * act_grad(gt, act_name)
    ht = hf.transpose(1, 2)
    dwu, dwg = ht @ _pair(du), ht @ _pair(dg)
    dwd = _pair(p).transpose(1, 2) @ dyf
    dh = (du.to(torch.bfloat16).float() @ wu.transpose(1, 2)
          + dg.to(torch.bfloat16).float() @ wg.transpose(1, 2))
    return dh.to(h.dtype), dwu, dwg, dwd


def masked_similarity_ref(x, mask):
    """x: [.., G, d]; mask: [.., G, G] bool. The Pallas kernel's formula
    (``repro/kernels/similarity.py::_sim_kernel``): the f32 Gram product
    normalised as ``rsqrt(xx * yy + 1e-8)``, mapped to [0, 1], zero where
    masked. Not ``pairwise_cosine``'s normalise-first formula, which
    decides differently at the margin."""
    xf = x.float()
    acc = xf @ xf.transpose(-1, -2)
    sq = torch.sum(xf * xf, dim=-1)
    inv = torch.rsqrt(sq[..., :, None] * sq[..., None, :] + 1e-8)
    sim = (acc * inv + 1.0) * 0.5
    return torch.where(mask, sim, torch.zeros((), dtype=sim.dtype))


def masked_similarity_fused_ref(x, expert, s_prev, s1: float, s2: float,
                                code=None):
    """§V-A fast similarity over every group: x [NG, G, d]; expert [NG, G]
    primary expert ids; s_prev [NG, G, G] carried similarity or None;
    code [NG, G] LSH bucket codes or None. Cross-expert pairs are 0,
    pairs with s_prev > s1 are 1, pairs with s_prev < s2 are 0, the rest
    are measured by :func:`masked_similarity_ref` where the codes of row
    and column are equal (every one without codes) and 0 elsewhere.
    Returns (sim [NG, G, G] f32, measured_frac [NG], the measured share).
    The op sequence of the reference's
    ``repro/condense/backends.py::fast_similarity``, the exact backend
    without codes, the lsh backend with them."""
    same_expert = expert[:, :, None] == expert[:, None, :]
    if s_prev is not None:
        known_hi = s_prev > s1
        uncertain = same_expert & ~known_hi & ~(s_prev < s2)
    else:
        known_hi = torch.zeros_like(same_expert)
        uncertain = same_expert
    measured = uncertain
    if code is not None:
        measured = uncertain & (code[:, :, None] == code[:, None, :])
    cos = masked_similarity_ref(x, measured)
    zero = torch.zeros((), dtype=torch.float32, device=cos.device)
    sim = torch.where(measured, cos, zero)
    sim = torch.where(known_hi & same_expert, torch.ones_like(zero), sim)
    sim = torch.where(same_expert, sim, zero)
    measured_frac = measured.float().mean(dim=(1, 2))
    return sim, measured_frac


def gather_rows_ref(y, rep_idx):
    """y: [T_src, d]; rep_idx: [T] -> y[rep_idx] (differentiable)."""
    return torch.index_select(y, 0, rep_idx.to(torch.int64))


def gather_rows_bwd_ref(dy, rep_idx, n_src: int):
    """The gradient of ``gather_rows_ref``: row j of the [n_src, d] result
    is the f32 sum of the rows dy[i] with rep_idx[i] = j, cast to dy's
    dtype. On the CPU ``index_add_`` adds in index order, as the kernel
    does; on the card it adds with atomics, in no fixed order."""
    dx = torch.zeros((n_src, dy.shape[1]), dtype=torch.float32,
                     device=dy.device)
    dx.index_add_(0, rep_idx.to(torch.int64), dy.float())
    return dx.to(dy.dtype)


def pack_rows_ref(x, tok):
    """The dedup pack alone: rows x[tok] with -1 giving a zero row."""
    tok = tok.to(torch.int64)
    rows = torch.index_select(x, 0, tok.clamp(min=0))
    return torch.where((tok >= 0)[:, None], rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def pack_quantize_ref(x, tok, wire_dtype: str = "f32"):
    """x: [T, d]; tok: [R] slot -> token map (-1 = empty, a zero row).
    The packed rows through the wire codec: ``(q, scales)`` exactly as
    the kernel returns them (``repro/kernels/ref.py::pack_quantize_ref``)."""
    return wdt.quantize_rows(pack_rows_ref(x, tok), wire_dtype)


def pack_quant_bwd_ref(x, tok, g):
    """The reference's gradient of the f8 wire at one rank's rows: g [R,
    d], the cotangent of the dequantized rows x[tok] (tok None: x's own
    rows), -> the cotangent of the packed rows [R, d] in x's type."""
    src = x if tok is None else pack_rows_ref(x, tok)
    q, sc = wdt.quantize_rows(src, "f8e4m3")
    ct_q, ct_sc = wdt.dequantize_t(g, q, sc)
    return wdt.quantize_t(src, ct_q, ct_sc).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None):
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KV,hd] (KV heads expanded here). Plain
    masked softmax attention by position, f32 math, result in q's dtype
    (``repro/kernels/ref.py::flash_attention_ref``, which takes Sq == Sk).
    Sk may differ from Sq without a causal mask or a window (cross-
    attention: every key live), the kernel's rule."""
    Sq, H, hd = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[1]
    if Sq != Sk and (causal or window is not None):
        raise ValueError(f"a causal or windowed call takes Sq == Sk, got "
                         f"Sq={Sq}, Sk={Sk}")
    scale = scale or 1.0 / math.sqrt(hd)
    n_rep = H // k.shape[2]
    k = torch.repeat_interleave(k, n_rep, dim=2) if n_rep > 1 else k
    v = torch.repeat_interleave(v, n_rep, dim=2) if n_rep > 1 else v
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    lg = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lg = torch.where(mask, lg, torch.full((), -1e30, device=q.device))
    w = torch.softmax(lg, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def mamba_scan_ref(dt, x, bmat, cmat, a):
    """The per-step recurrence (``repro/kernels/ref.py::mamba_scan_ref``)
    from the zero state, f32: dt/x [B,S,di]; bmat/cmat [B,S,N]; a [di,N].
    Returns (y [B,S,di] in dt's dtype, the final state h [B,di,N] f32).
    Materialises the [B,S,di,N] decay and input terms."""
    da = torch.exp(dt.float()[..., None] * a.float())           # [B,S,di,N]
    dbx = (dt * x).float()[..., None] * bmat.float()[..., None, :]
    cf = cmat.float()
    B, S, di = dt.shape
    h = torch.zeros((B, di, a.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(S):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, 1).to(dt.dtype), h


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) for every x (``F.softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_scan_fused_ref(dt_lin, dt_bias, x, z, d_skip, bmat, cmat, a):
    """The tail of hymba's Mamba branch around the scan
    (``models/ssm.py::_mamba_inner`` from the zero state), op for op:
    dt = softplus(dt_lin + dt_bias) in f32, the scan, then ``(y + d_skip *
    x) * silu(z)`` in f32, rounded to x's type. Returns (y, the final
    state h [B,di,N] f32)."""
    dt = softplus(dt_lin + dt_bias.float())
    xf = x.float()
    y, h = mamba_scan_ref(dt, xf, bmat, cmat, a)
    y = y + d_skip * xf
    y = y * F.silu(z.float())
    return y.to(x.dtype), h


def wkv6_scan_ref(r, k, v, w, u, state=None):
    """The WKV6 recurrence step by step, in the reference's op order
    (``repro/models/ssm.py::_rwkv6_core``), f32: r, k, v, w [B,S,H,hd]
    (w the decay in (0, 1)), u [H,hd] the bonus, state [B,H,hd,hd] laid
    out [k][v] (None: zeros). Per step ``kv = k v^T``, ``y = r^T (S +
    u kv)``, ``S = w S + kv``. Returns (y [B,S,H,hd] f32, the final state
    [B,H,hd,hd] f32); f64 throughout where r is f64 (a yardstick)."""
    B, S_, H, hd = r.shape
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    st = (torch.zeros((B, H, hd, hd), dtype=dt, device=r.device)
          if state is None else state.to(dt))
    rf, kf, vf, wf = (t.to(dt) for t in (r, k, v, w))
    uf = u.to(dt)[..., None]
    ys = []
    for t in range(S_):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(ys, 1), st


def wkv6_scan_bwd_ref(r, k, v, w, u, state, dy, d_state=None):
    """The backward of :func:`wkv6_scan_ref` as the explicit reverse-time
    recurrence K7's backward computes, f32, step by step: the states S_t
    recomputed forward (``S_t = w_t S_{t-1} + k_t v_t^T``, laid out
    [k][v], from ``state`` or zeros), then from dS_T = ``d_state`` (None:
    zeros), with a_t = sum_i r_i u_i k_i and vdy_t = v_t . dy_t,
    t = S .. 1:

        dv_t = dS_t^T k_t + a_t dy_t
        dk_t = dS_t v_t + r_t u vdy_t
        dr_t = S_{t-1} dy_t + u k_t vdy_t
        dw_t = rowsum(dS_t * S_{t-1})
        du  += r_t k_t vdy_t (summed over the batch)
        dS_{t-1} = w_t dS_t + r_t dy_t^T

    r, k, v, w, dy [B,S,H,hd]; u [H,hd]; state, d_state [B,H,hd,hd].
    Returns (dr, dk, dv, dw [B,S,H,hd], du [H,hd], dS_0 [B,H,hd,hd]), f32.
    Holds every state: [B,S,H,hd,hd] f32 in all."""
    B, S_, H, hd = r.shape
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    st = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    states = []
    for t in range(S_):
        states.append(st)
        st = wf[:, t, :, :, None] * st + kf[:, t, :, :, None] * vf[:, t, :,
                                                                  None, :]
    ds = (torch.zeros_like(st) if d_state is None
          else d_state.float().clone())
    a = (rf * uf * kf).sum(-1)                                   # [B,S,H]
    vdy = (vf * dyf).sum(-1)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(S_)):
        sp, rt, kt, vt, wt, dyt = (states[t], rf[:, t], kf[:, t], vf[:, t],
                                   wf[:, t], dyf[:, t])
        vd = vdy[:, t, :, None]
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", ds, kt)
                    + a[:, t, :, None] * dyt)
        dk[:, t] = torch.einsum("bhij,bhj->bhi", ds, vt) + rt * uf * vd
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + uf * kt * vd
        dw[:, t] = (ds * sp).sum(-1)
        du += (rt * kt * vd).sum(0)
        ds = wt[..., None] * ds + rt[..., None] * dyt[:, :, None, :]
    return dr, dk, dv, dw, du, ds
