#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. device: the card's name, count, and name / power limit from nvidia-smi;
2. build: every hand-written kernel from ``src/repro_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, all at once), with the compiler's
   register / shared-memory / spill report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, then timed (CUDA events) beside
   the plain version, a one-call PyTorch yardstick and its bound;
4. slice: full-width moe-gpt2 (16 experts, random weights from a seed)
   served through the port's launcher, ``repro_torch.launch.serve``:
   batched prefill (warm-up + timed), step-wise prompt feed into the KV
   cache, greedy decode. Every kernel of the path must have launched
   during this run, as many times as the path calls it;
5. parity: the same full-width weights at 2 layers, batched prefill on
   the card (kernels) against the CPU (plain versions);
6. profile: where a full-width prefill's and decode step's time goes
   (torch.profiler: device-busy share and the top device ops).

Then one JSON line with every kernel's record, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

# K1 at the shapes of the slice run below: B=8 x S=128 prefill gives
# C=256 rows per expert, a decode step of B=8 gives C=8; R=160 is ragged.
E, D, F_ = 16, 768, 3072
K1_SHAPES = {"prefill": 256, "decode": 8, "ragged": 160}
K1_TOL = {"float32": 1e-4, "bfloat16": 5e-2}

SERVE_ARGS = ["--arch", "moe-gpt2", "--batch", "8", "--prompt-len", "128",
              "--gen", "32", "--prefill", "batch", "--device", "cuda",
              "--seed", "0"]
PARITY_TOL = 3e-2


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
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


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"device: {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul off, cudnn off (plain versions run in full f32)")
    return name, count, smi[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"build: {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f}s")
    for name, path in paths.items():
        log(f"  {name}: {path.relative_to(ROOT)}")
        for line in _build.BUILD_LOG.get(name, "(cached)").splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling", "(cached)")):
                log(f"    {line.strip()}")
    return paths


def _k1_inputs(R: int, h_dtype, gen):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import moe_init
    cfg = get_config("moe-gpt2")
    ew = moe_init(gen, cfg, device="cuda")["experts"]
    h = torch.randn((E, R, D), generator=gen, device="cuda").to(h_dtype)
    return h, ew["w_up"], ew["w_gate"], ew["w_down"]


def _k1_library(h, wu, wg, wd, act):
    """One-call-per-product PyTorch yardstick (torch.bmm), never used by
    the port."""
    import torch
    import torch.nn.functional as F
    hf = h.float()
    gt = torch.bmm(hf, wg)
    a = F.gelu(gt, approximate="tanh") if act == "gelu" else F.silu(gt)
    return torch.bmm(a * torch.bmm(hf, wu), wd).to(h.dtype)


def phase_kernels():
    """K1 against its plain version at every shape, both h types and
    both activations; then timed at the path's own setting."""
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    checks = []
    for shape, R in K1_SHAPES.items():
        for h_name in ("bfloat16", "float32"):
            for act in ("gelu", "silu"):
                args = _k1_inputs(R, getattr(torch, h_name), gen)
                got = kexp.expert_ffn(*args, act)
                torch.cuda.synchronize()
                want = ref.expert_ffn_ref(*args, act)
                err = (got.float() - want.float()).abs().max().item()
                tol = K1_TOL[h_name]
                ok = torch.allclose(got.float(), want.float(), atol=tol,
                                    rtol=tol)
                checks.append(dict(shape=shape, R=R, h=h_name, act=act,
                                   max_abs_err=err, tol=tol, ok=ok))
                log(f"  K1 {shape:8s} R={R:3d} h={h_name:8s} {act}: "
                    f"max|err|={err:.3e} tol={tol:g} "
                    f"{'ok' if ok else 'FAIL'}")
                del args, got, want
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"K1 disagrees with its plain version: {bad}")

    timed = {}
    for shape, R in K1_SHAPES.items():
        # the path's setting: bf16 rows, f32 weights, tanh-gelu
        args = _k1_inputs(R, torch.bfloat16, gen)
        iters = 50 if R <= 8 else 20
        ms = time_ms(lambda: kexp.expert_ffn(*args, "gelu"), iters)
        plain_ms = time_ms(lambda: ref.expert_ffn_ref(*args, "gelu"), iters)
        lib_ms = time_ms(lambda: _k1_library(*args, "gelu"), iters)
        h, wu, wg, wd = args
        nbytes = (2 * h.numel() * h.element_size()
                  + sum(w.numel() * w.element_size() for w in (wu, wg, wd)))
        flops = 2.0 * E * R * D * F_ * 3
        t_bytes = nbytes / HBM_BPS * 1e3
        t_f32 = flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_f32)
        err = max(c["max_abs_err"] for c in checks if c["shape"] == shape
                  and c["h"] == "bfloat16" and c["act"] == "gelu")
        timed[shape] = dict(
            R=R, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by="bytes" if t_bytes >= t_f32
            else "operations", bytes=nbytes, flops=flops,
            bound_bf16_tc_ms=max(t_bytes, flops / BF16_TC_FLOPS * 1e3),
            max_abs_err=err)
        log(f"  K1 {shape:8s} [{E},{R},{D}]x{F_} bf16 h, f32 w, gelu: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm "
            f"{lib_ms:.4f} ms; bound {bound:.4f} ms by "
            f"{timed[shape]['bound_by']} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP at f32 {F32_FLOPS / 1e12:g} TFLOP/s); "
            f"bound at bf16 tensor-core rate "
            f"{timed[shape]['bound_bf16_tc_ms']:.4f} ms")
        del args
    torch.cuda.empty_cache()
    return checks, timed


def phase_slice():
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import serve
    from repro_torch.configs import get_config
    n_layers = get_config("moe-gpt2").num_layers
    kexp.expert_ffn.launches = 0
    res = serve.main(SERVE_ARGS)
    launches = kexp.expert_ffn.launches
    B, S, G = res["batch"], res["prompt_len"], res["gen"]
    want = n_layers * (serve.N_BATCHED_PREFILLS + S + G)
    logits = ([res["prefill_logits"]] + res["step_logits"]
              + res["gen_logits"])
    finite = all(bool(torch.isfinite(t).all()) for t in logits)
    shapes_ok = all(tuple(t.shape) == (B, 50257) for t in logits)
    feed_vs_batch = (res["step_logits"][-1]
                     - res["prefill_logits"]).abs().max().item()
    info = dict(arch=res["arch"], batch=B, prompt_len=S, gen=G,
                prefill_s=res["prefill_s"],
                prefill_tok_s=res["prefill_tok_s"],
                prompt_feed_s=res["prompt_feed_s"],
                decode_ms_per_step=res["decode_ms_per_step"],
                peak_mem_gib=res["peak_mem_bytes"] / 2 ** 30,
                k1_launches=launches, k1_launches_expected=want,
                feed_vs_batch_max_abs=feed_vs_batch,
                sample_tokens=res["tokens"][0, :10].tolist())
    log("slice: " + json.dumps(info))
    if not finite or not shapes_ok:
        raise SystemExit(f"slice logits: finite={finite} shapes={shapes_ok}")
    if launches != want:
        raise SystemExit(f"K1 launched {launches} times in the slice run, "
                         f"the path calls it {want} times")
    del res, logits
    torch.cuda.empty_cache()
    return info


def phase_parity():
    """Batched prefill of full-width moe-gpt2 cut to 2 layers: card
    (kernels) against CPU (plain versions), same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=2)
    model = build_model(cfg, device="cuda", seed=0)
    toks = torch.as_tensor(
        np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 64)))
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    before = kexp.expert_ffn.launches
    lg = model.prefill(toks.cuda(), 64, luffy=luffy)[0].cpu()
    launched = kexp.expert_ffn.launches - before
    model.to("cpu")             # the same parameters, moved
    lc = model.prefill(toks, 64, luffy=luffy)[0]
    err = (lg - lc).abs().max().item()
    log(f"parity: 2-layer full-width prefill B=2 S=64, cuda vs cpu "
        f"max|dlogits|={err:.3e} (tol {PARITY_TOL:g}, |logits| max "
        f"{lc.abs().max().item():.3f}); K1 launches on cuda {launched}")
    if launched != cfg.num_layers:
        raise SystemExit(f"parity run launched K1 {launched} times")
    if not (err <= PARITY_TOL and math.isfinite(err)):
        raise SystemExit(f"cuda vs cpu prefill differ by {err}")
    return err


def _profile(fn, n: int):
    """Run ``fn`` n times under torch.profiler; returns the device-busy
    share of the wall time and the top device ops (ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    top = [{"op": k[:60], "ms_per_call": d / n / 1e3, "count_per_call":
            c / n} for d, k, c in rows[:6]]
    return dict(wall_ms_per_call=wall_us / n / 1e3,
                device_ms_per_call=busy / n / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                top=top)


def phase_profile():
    """Where the time goes at full width: one batched prefill (B=8,
    S=128) and 8 decode steps (B=8) under torch.profiler. Runs after the
    slice's launch counts were read."""
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("moe-gpt2")
    model = build_model(cfg, device="cuda", seed=0)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    import numpy as np
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(1, cfg.vocab_size, (8, 128)),
        dtype=torch.int32, device="cuda")
    model.prefill(toks, 160, luffy=luffy)
    pf = _profile(lambda: model.prefill(toks, 160, luffy=luffy), 2)
    state = {"cache": model.new_cache(8, 160)}

    def step():
        _, state["cache"] = model.decode_step(state["cache"], toks[:, :1],
                                              luffy=luffy)

    for _ in range(4):
        step()
    dec = _profile(step, 8)
    info = {"prefill": pf, "decode_step": dec}
    log("profile: " + json.dumps(info))
    if not pf["top"] or not dec["top"]:
        log("profile: the profiler saw no device time (not measured)")
    del model, state
    torch.cuda.empty_cache()
    return info


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    log("kernels:")
    checks, timed = phase_kernels()
    slice_info = phase_slice()
    phase_parity()
    phase_profile()
    k1 = timed["decode"]
    record = {
        "name": "expert_ffn", "route": "cuda",
        "source": "src/repro_torch/csrc/expert_ffn.cu",
        "replaces": "src/repro/kernels/expert_ffn.py:52",
        "jax": "repro/kernels/expert_ffn.py::expert_ffn",
        "launches": slice_info["k1_launches"],
        "max_abs_err": k1["max_abs_err"],
        "max_abs_err_all_checks": max(c["max_abs_err"] for c in checks),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "timed_at": "decode shape [16,8,768]x3072, bf16 h, f32 weights, "
                    "gelu (1920 of the run's 1944 launches)",
        "shapes": timed,
    }
    log(f"total {time.perf_counter() - t_start:.1f}s on {smi}")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
