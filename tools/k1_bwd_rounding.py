#!/usr/bin/env python3
"""Why K1's tensor-core backward carries two bf16 terms, on the CPU.

    PYTHONPATH=src python3 tools/k1_bwd_rounding.py [--E 1] [--R 2048]
        [--d 768] [--F 3072] [--scale init|0.05] [--act gelu]

Holds two rounding models of the backward against autograd through the
f32 plain version (``ref.expert_ffn_ref``) at one shape, and counts the
entries of each gradient outside the elementwise bf16 tolerance that
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold K1 to
(``|err| <= 5e-2 + 5e-2 |want|``):

* ``bf16``: every operand rounded once to bf16 (the weights, P, DU, DG),
  f32 sums;
* ``split``: the weights and P, DU, DG as bf16 hi + lo terms
  (``ref.expert_ffn_bwd_bf16_ref``, the kernel's arithmetic).

h and dy are bf16 from a numpy seed; the weights are N(0, 1) times
moe_init's scales (``init``: 1/sqrt(d) for w_up and w_gate,
1/sqrt(2 L F) for w_down with L = 12) or a flat 0.05 (the gpu tests').
Prints one line per model and gradient, then ``RESULT {json}``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

TOL = 5e-2


def bf16_once(h, w_up, w_gate, w_down, dy, act_name):
    """Every operand rounded once to bf16, f32 sums."""
    def bf(x):
        return x.to(torch.bfloat16).float()

    hf, dyf = h.float(), dy.float()
    wu, wg, wd = bf(w_up), bf(w_gate), bf(w_down)
    gt, up, dhh = hf @ wg, hf @ wu, dyf @ wd.transpose(1, 2)
    a = ref.ACTS[act_name](gt)
    p, du, dg = a * up, dhh * a, dhh * up * ref.act_grad(gt, act_name)
    p, du, dg = bf(p), bf(du), bf(dg)
    ht = hf.transpose(1, 2)
    dh = du @ wu.transpose(1, 2) + dg @ wg.transpose(1, 2)
    return (dh.to(h.dtype), ht @ du, ht @ dg, p.transpose(1, 2) @ dyf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--E", type=int, default=1)
    ap.add_argument("--R", type=int, default=2048)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--F", type=int, default=3072)
    ap.add_argument("--scale", default="init")
    ap.add_argument("--act", default="gelu", choices=("gelu", "silu"))
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    E, R, d, F = args.E, args.R, args.d, args.F
    r = np.random.default_rng(args.seed)
    h = torch.as_tensor(r.standard_normal((E, R, d)).astype(np.float32))
    dy = torch.as_tensor(r.standard_normal((E, R, d)).astype(np.float32))
    h, dy = h.to(torch.bfloat16), dy.to(torch.bfloat16)
    if args.scale == "init":
        scales = (d ** -0.5, d ** -0.5, 1.0 / math.sqrt(2 * 12 * F))
    else:
        scales = (float(args.scale),) * 3
    ws = [torch.as_tensor(r.standard_normal(s).astype(np.float32)) * sc
          for s, sc in zip(((E, d, F), (E, d, F), (E, F, d)), scales)]
    leaves = [t.float().requires_grad_() for t in (h, *ws)]
    ref.expert_ffn_ref(*leaves, args.act).backward(dy.float())
    want = [t.grad for t in leaves]
    out = {"shape": [E, R, d, F], "scale": args.scale, "act": args.act,
           "tol": TOL}
    for name, fn in (("bf16", bf16_once),
                     ("split", ref.expert_ffn_bwd_bf16_ref)):
        got = fn(h, *ws, dy, args.act)
        rows = {}
        for g_name, g, w in zip(("dh", "dw_up", "dw_gate", "dw_down"), got,
                                want):
            err = (g.float() - w).abs()
            bad = int((err > TOL + TOL * w.abs()).sum())
            rows[g_name] = dict(max_abs_err=err.max().item(),
                                max_abs=w.abs().max().item(),
                                outside_tol=bad, entries=w.numel())
            print(f"{name:5s} {g_name:7s} max|err| {err.max().item():.3e} "
                  f"(max|grad| {w.abs().max().item():.3e}); outside the "
                  f"tolerance: {bad} of {w.numel()}")
        out[name] = rows
    print("RESULT " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
