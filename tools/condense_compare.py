#!/usr/bin/env python3
"""K2, K4 and the condensation's similarity step from one checkout of the
port on the card, for comparing two commits in one call (run them in
turns: parent, change, change, parent).

    python3 tools/condense_compare.py [ROOT] [--no-train]

ROOT (default: the checkout holding this script) is the root of the
checkout whose ``src/repro_torch`` runs. At the train path's shapes
(moe-gpt2, B=8 x S=1024, 64 condensation groups of 128 tokens, d 768,
16 experts) it measures, each by CUDA events of back-to-back calls and
by profiler device time:

- K2 ``masked_similarity`` on bf16 and f32 rows, the mask the first
  block's same-expert mask with every fourth group empty (as
  ``chip_smoke.py`` phase 3 gives it);
- ``condense.backends.fast_similarity`` (the skip rules around K2) with
  the first block's ``s_prev`` (0.5 everywhere) and with a carried one,
  its kernel launches per call, and K2's fused entry
  ``masked_similarity_fused`` where the checkout has it;
- K4's f8 and cast forward and its backward at the expert-parallel train
  shape (8192 bf16 rows of 768 into 16384 wire slots, ~4300 filled, the
  map built as ``condense/wire.py`` builds it), with the wrapper's host
  time per call (host clock over calls that are not synchronised);
- one full-width train step under torch.profiler: its device time, and
  the device time inside ``fast_similarity`` and ``condense_tokens``
  (both wrapped in ``record_function`` ranges for this run).

``--no-train`` leaves out the train step. Prints the card's name and
power limit, then one line ``RESULT {json}``; each call's record carries a
digest of its output bits (``digest``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

NG, G, D, E = 64, 128, 768, 16
K4_M, K4_N, K4_T, K4_KEEP = 4, 2, 2048, 0.35
S1, S2 = 0.8, 0.2


def _events_ms(fn, iters: int = 50) -> float:
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


def _host_us(fn, iters: int = 200) -> float:
    """Host time per call of calls that are not synchronised (the queue
    of this many small launches does not fill)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _rows(prof):
    """(device us, name, count) of every kernel, copy and memset on the
    card, largest first."""
    from torch.autograd import DeviceType
    return sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)


def _device(fn, n: int = 50) -> dict:
    """Device ms per call (each kernel's mean duration times its launches
    per call) and the kernels launched per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = _rows(prof)
    return dict(device_ms=sum(d / c * max(1, round(c / n))
                              for d, _, c in rows) / 1e3,
                launches_per_call=sum(max(1, round(c / n))
                                      for _, _, c in rows),
                kernels=[k[:60] for _, k, _ in rows])


def _digest(out) -> str:
    """A digest of a call's output bits, for holding two checkouts' f32
    routes and K4 outputs equal bit for bit."""
    import hashlib
    import torch
    ts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _timed(fn, iters: int = 50, host: bool = False) -> dict:
    out = dict(ms=_events_ms(fn, iters), **_device(fn, iters),
               digest=_digest(fn()))
    if host:
        out["host_us"] = _host_us(fn)
    return out


def k2():
    import numpy as np
    import torch
    from repro_torch.condense import backends
    from repro_torch.kernels import similarity as ksim
    r = np.random.default_rng(11)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    # the path's expert ids: the first column of an [T, 2] int64 top-2
    # map, a strided view
    top2 = torch.as_tensor(r.integers(0, E, (NG * G, 2)), device="cuda")
    expert = top2[:, 0].reshape(NG, G)
    mask = expert[:, :, None] == expert[:, None, :]
    mask[::4] = False
    out = {}
    for name in ("float32", "bfloat16"):
        x = torch.randn((NG, G, D), generator=gen,
                        device="cuda").to(getattr(torch, name))
        out[f"k2_{name}"] = _timed(lambda: ksim.masked_similarity(x, mask),
                                   host=True)
    # rows near 16 centres, so that a carried s_prev has pairs above s1
    # and below s2
    centres = torch.randn((E, D), generator=gen, device="cuda")
    cid = torch.as_tensor(r.integers(0, E, (NG, G)), device="cuda")
    xc = (centres[cid] + 0.6 * torch.randn((NG, G, D), generator=gen,
                                           device="cuda")).to(torch.bfloat16)
    first = torch.full((NG, G, G), 0.5, device="cuda")
    carried, _ = backends.fast_similarity(xc, expert, first, S1, S2)
    carried = carried.contiguous()
    x = torch.randn((NG, G, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    share = {}
    for name, sp in (("first", first), ("carried", carried)):
        same = expert[:, :, None] == expert[:, None, :]
        unc = same & ~(sp > S1) & ~(sp < S2)
        share[name] = dict(uncertain=unc.float().mean().item(),
                           tiles_live=unc.reshape(NG, 2, 64, 2, 64).any(
                               dim=(2, 4)).float().mean().item())
        out[f"fast_similarity_{name}"] = _timed(
            lambda: backends.fast_similarity(x, expert, sp, S1, S2),
            host=True)
        if hasattr(ksim, "masked_similarity_fused"):
            out[f"k2_fused_{name}"] = _timed(
                lambda: ksim.masked_similarity_fused(x, expert, sp, S1, S2),
                host=True)
    out["s_prev_shares"] = share
    if hasattr(ksim, "route"):
        out["route_bf16"] = ksim.route(torch.bfloat16, D)
    return out


def _k4_tok(gen):
    """The dedup wire's slot -> token map at the EP train shape, built as
    ``condense/wire.py::dedup_dispatch`` builds it (as chip_smoke.py's
    phase 10 does)."""
    import torch
    from repro_torch.condense.wire import dedup_capacity
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import capacity_for
    cfg = get_config("moe-gpt2")
    M, N, T = K4_M, K4_N, K4_T
    L = M // N
    e_local = E // M
    C_u = dedup_capacity(T, e_local, L, capacity_for(cfg.moe, T, E))
    first = torch.randint(0, E, (M, T), generator=gen, device="cuda")
    second = (first + torch.randint(1, E, (M, T), generator=gen,
                                    device="cuda")) % E
    keep = torch.rand((M, T), generator=gen, device="cuda") < K4_KEEP
    node = torch.stack([first, second], -1) // e_local // L
    headed = (node[..., None] == torch.arange(N, device="cuda")).any(2) \
        & keep[..., None]
    h = headed.long()
    urank = torch.cumsum(h, 1) - h
    ranks = torch.arange(M, device="cuda")
    slot = (ranks[:, None, None] * N + torch.arange(N, device="cuda")) \
        * C_u + urank
    R = M * N * C_u
    tok = torch.full((R + 1,), -1, dtype=torch.int32, device="cuda")
    gid = (ranks[:, None, None] * T
           + torch.arange(T, device="cuda")[None, :, None]).expand(M, T, N)
    tok[torch.where(headed, slot, torch.full_like(slot, R)).reshape(-1)] = \
        gid.reshape(-1).to(torch.int32)
    return tok[:R]


def k4():
    import torch
    from repro_torch.kernels import pack as kpack
    gen = torch.Generator(device="cuda")
    gen.manual_seed(777)
    tok = _k4_tok(gen)
    x = torch.randn((K4_M * K4_T, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    g = torch.randn((tok.numel(), D), generator=gen, device="cuda").to(
        torch.bfloat16)
    return {"rows": tok.numel(), "filled_rows": int((tok >= 0).sum()),
            "k4_f8": _timed(lambda: kpack.pack_quantize(x, tok, "f8e4m3"),
                            host=True),
            "k4_cast": _timed(lambda: kpack.pack_quantize(x, tok, "bf16"),
                              host=True),
            "k4_bwd": _timed(lambda: kpack.pack_quant_bwd(x, tok, g),
                             host=True)}


def train_step():
    """One full-width train step (after a warm-up step) under
    torch.profiler, with the similarity step and the whole token
    condensation in record_function ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import optim, train_lib
    from repro_torch.condense import backends, plan
    from repro_torch.config import LuffyConfig, OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import build_model
    cfg = get_config("moe-gpt2")
    shape = ShapeConfig("train", 1024, 8, "train")
    model = build_model(cfg, device="cuda", seed=0)
    params = model.params
    ocfg = OptimConfig(lr=1e-3, total_steps=6, warmup_steps=2)
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0)
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0)
    step = train_lib.make_train_step(cfg, luffy, ocfg, cap)
    state = [optim.init_opt_state(params, ocfg),
             train_lib.init_luffy_state("cuda")]
    data = SyntheticLM(cfg, shape)

    def one(i):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(i).items()}
        _, state[0], state[1], _ = step(params, state[0], state[1], b)

    def ranged(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    one(0)
    torch.cuda.synchronize()
    orig = backends.fast_similarity, plan.condense_tokens
    backends.fast_similarity = ranged("condense::fast_similarity", orig[0])
    plan.condense_tokens = ranged("condense::condense_tokens", orig[1])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one(1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        backends.fast_similarity, plan.condense_tokens = orig
    rows = _rows(prof)
    busy = sum(r[0] for r in rows)
    ranges = {}
    for ev in prof.key_averages():
        if ev.key.startswith("condense::"):
            ranges[ev.key] = dict(
                calls=ev.count,
                device_ms=getattr(ev, "device_time_total",
                                  getattr(ev, "cuda_time_total", 0.0)) / 1e3,
                host_ms=ev.cpu_time_total / 1e3)
    del model, params, state
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                ranges=ranges,
                top=[{"op": k[:60], "ms": d / 1e3, "count": c}
                     for d, k, c in rows[:12]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--no-train", action="store_true",
                    help="leave out the train-step profile")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("condense_compare: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    out = {"root": str(root), **k2(), **k4()}
    if not args.no_train:
        out["train_step"] = train_step()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
