#!/usr/bin/env python3
"""hymba-1.5b's batched prefill, K6 and K4's backward from one checkout of
the port on the card, for comparing two commits in one call (run them in
turns: parent, change, change, parent, ...).

    python3 tools/hymba_compare.py [ROOT] [--prefills N]

ROOT (default: the checkout holding this script) is the root of the
checkout whose ``src/repro_torch`` runs:

- full-width hymba-1.5b (32 layers, random weights from seed 0, bf16
  compute), batched prefill of B=4 prompts of 2048 tokens, as
  ``chip_smoke.py`` phase 18 runs it: after a warm-up, N prefills on the
  host clock to a synchronise (tokens/s), then one under torch.profiler
  (device time, device-busy share, K6's share, the top-10 device ops);
- K6 at that prefill's shape, [4,2048,3200]x16: the f32 contract entry
  ``mamba_scan``, and the fused entry ``mamba_scan_fused`` at bf16 where
  the checkout has it, each by CUDA events and by profiler device time;
- K4's backward at the expert-parallel train shape (16384 bf16 cotangent
  rows of 768 from 8192 source rows, a third of the slots filled), both
  times.

Prints the card's name and power limit, then one line ``RESULT {json}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

B, S = 4, 2048
K6 = (4, 2048, 3200, 16)
K4_T, K4_D, K4_R, K4_FILL = 8192, 768, 16384, 0.35


def _events_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _rows(prof):
    """(device us, name, count) of every kernel, copy and memset on the
    card, largest first."""
    from torch.autograd import DeviceType
    return sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)


def _device_ms(fn, n: int = 20) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # each kernel's mean duration times its launches per call: the profiler
    # can record fewer launches than were made
    return sum(d / c * max(1, round(c / n)) for d, _, c in _rows(prof)) / 1e3


def prefill(n_timed: int):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("hymba-1.5b")
    model = build_model(cfg, device="cuda", seed=0)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, S)), dtype=torch.int32, device="cuda")
    model.prefill(toks, S + 32, luffy=luffy)
    torch.cuda.synchronize()
    wall = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        model.prefill(toks, S + 32, luffy=luffy)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(toks, S + 32, luffy=luffy)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    rows = _rows(prof)
    busy = sum(r[0] for r in rows)
    k6 = sum(d for d, key, _ in rows if "mamba_scan_kernel" in key)
    del model
    torch.cuda.empty_cache()
    return dict(wall_ms=wall, tokens_per_s=[B * S / w * 1e3 for w in wall],
                profiled_wall_ms=prof_wall_us / 1e3, device_ms=busy / 1e3,
                device_busy_share=busy / prof_wall_us if rows else None,
                k6_share=k6 / busy if busy else None, k6_ms=k6 / 1e3,
                top=[{"op": k[:70], "ms": d / 1e3, "count": c}
                     for d, k, c in rows[:10]])


def k6():
    import torch
    from repro_torch.kernels import mamba_scan as kms
    b, s, di, n = K6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(56)
    dt = torch.rand((b, s, di), generator=gen, device="cuda") * 0.1
    x = torch.randn((b, s, di), generator=gen, device="cuda")
    bm = torch.randn((b, s, n), generator=gen, device="cuda")
    cm = torch.randn((b, s, n), generator=gen, device="cuda")
    a = -torch.exp(torch.randn((di, n), generator=gen, device="cuda"))
    out = {"mamba_scan": dict(
        ms=_events_ms(lambda: kms.mamba_scan(dt, x, bm, cm, a)),
        device_ms=_device_ms(lambda: kms.mamba_scan(dt, x, bm, cm, a)))}
    if hasattr(kms, "mamba_scan_fused"):
        xz = torch.randn((b, s, 2 * di), generator=gen,
                         device="cuda").to(torch.bfloat16)
        xb, z = torch.chunk(xz, 2, dim=-1)
        xb = xb.contiguous()
        dt_lin = torch.randn((b, s, di), generator=gen, device="cuda")
        bias = torch.randn((di,), generator=gen, device="cuda") * 0.1
        dskip = torch.ones((di,), device="cuda")

        def fused():
            return kms.mamba_scan_fused(dt_lin, bias, xb, z, dskip, bm, cm, a)

        out["mamba_scan_fused"] = dict(ms=_events_ms(fused),
                                       device_ms=_device_ms(fused))
    return out


def k4_bwd():
    import numpy as np
    import torch
    from repro_torch.kernels import pack as kpack
    r = np.random.default_rng(4)
    x = torch.as_tensor(r.standard_normal((K4_T, K4_D)),
                        dtype=torch.float32).to(torch.bfloat16).cuda()
    tok = np.full(K4_R, -1, np.int32)
    filled = r.random(K4_R) < K4_FILL
    tok[filled] = r.integers(0, K4_T, int(filled.sum()))
    tok = torch.as_tensor(tok).cuda()
    g = torch.as_tensor(r.standard_normal((K4_R, K4_D)),
                        dtype=torch.float32).to(torch.bfloat16).cuda()

    def fn():
        return kpack.pack_quant_bwd(x, tok, g)

    return dict(ms=_events_ms(fn, 50), device_ms=_device_ms(fn, 50),
                filled_rows=int(filled.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--prefills", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("hymba_compare: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build(["flash_attn", "mamba_scan", "pack"])
    out = {"root": str(root), "prefill": prefill(args.prefills),
           "k6": k6(), "k4_bwd": k4_bwd()}
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
