#!/usr/bin/env python3
"""K6's design choices, measured on the card: variants of
``src/repro_torch/csrc/mamba_scan.cu`` built side by side and held
against the plain versions, then timed at hymba's prefill shape.

    python3 tools/k6_variants.py [--only NAME ...] [--rounds R]
                                 [--sass-dir DIR] [--widths DI ...]

Each variant is the source with a few lines replaced (``VARIANTS``):
the block size (NT threads, so 4 NT / N channels per block), the states
per lane, the decay's
exp (the accurate ``expf`` or ``__expf``, one ``ex2.approx.ftz``),
softplus and silu in PyTorch's own forms (``log1pf``, IEEE division)
and, for timing alone, the fused entry without them. A variant's copy of ``csrc/`` goes under
``build/k6_variants/<name>/`` and builds there, as ``_build`` builds the
source. For each: ptxas's registers and spills, the largest error of both
entries against their plain versions at the prefill shape [4,2048,3200]x16
and a ragged [2,100,200]x16 (f32: y and the final state; the fused entry
at bf16: the number of elements more than one bf16 ulp from the plain
version, and the largest distance in ulps), the occupancy calculator's
resident blocks per SM and the opcode counts of the fused bf16 instance's
SASS (``cuobjdump``); then, every variant in turns for R rounds after a
warm-up, profiler device times of both entries at the prefill shape
(the contract entry at f32, the fused one at bf16) and the host's enqueue
time per fused call.
Prints the card's name and power limit, then ``RESULT {json}``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from hymba_compare import _device_ms  # noqa: E402

NT_LINE = "constexpr int NT = 256;  // threads per block"
P_LINE = "constexpr int P = 4;     // states per lane"
EXP_LINE = "h[p] = fmaf(expf(d.x * a[p]), h[p], d.y * bb[p]);"
SOFTPLUS = "d = elive ? softplus(__fadd_rn(d, bias)) : 0.0f;"
SILU = "silu(to_f32(sm.z[slot][t][ec]))"
VARIANTS = {
    "base": [],
    "nt32": [(NT_LINE, NT_LINE.replace("256", "32"))],
    "nt64": [(NT_LINE, NT_LINE.replace("256", "64"))],
    "nt128": [(NT_LINE, NT_LINE.replace("256", "128"))],
    # 8 states a lane, 2 lanes a channel at N = 16
    "p8": [(P_LINE, P_LINE.replace("4", "8"))],
    "p8_nt128": [(P_LINE, P_LINE.replace("4", "8")),
                 (NT_LINE, NT_LINE.replace("256", "128"))],
    # softplus and silu as PyTorch's CUDA kernels write them: log1pf and
    # IEEE division, each with a slow path behind a branch
    "torch_forms": [
        (SOFTPLUS, "d = elive ? __fadd_rn(fmaxf(__fadd_rn(d, bias), 0.0f), "
                   "log1pf(expf(-fabsf(__fadd_rn(d, bias))))) : 0.0f;"),
        (SILU, "__fdiv_rn(to_f32(sm.z[slot][t][ec]), __fadd_rn(1.0f, "
               "expf(-to_f32(sm.z[slot][t][ec]))))")],
    # the decay by ex2.approx.ftz (CUDA's __expf: one special-function op)
    "ex2": [(EXP_LINE, EXP_LINE.replace("expf(", "__expf("))],
    # timing only: softplus and silu left out (its checks fail by design)
    "no_softplus_silu": [
        (SOFTPLUS, "d = elive ? __fadd_rn(d, bias) : 0.0f;"),
        (SILU, "to_f32(sm.z[slot][t][ec])")],
}
SHAPES = {"prefill": (4, 2048, 3200, 16), "ragged": (2, 100, 200, 16)}


def _inputs(b, s, di, n, dtype, seed):
    """hymba-like operands: z and x halves of one [B,S,2di] product, B
    and C column slices of one [B,S,R+2N] projection."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xz = rn(b, s, 2 * di).to(dtype)
    x, z = torch.chunk(xz, 2, dim=-1)
    proj = rn(b, s, 100 + 2 * n)
    _, bm, cm = torch.split(proj, [100, n, n], dim=-1)
    return dict(dt_lin=rn(b, s, di) - 1.0, dt_bias=rn(di) * 0.5,
                x=x.contiguous(), z=z, d_skip=torch.ones(di, device="cuda"),
                bmat=bm, cmat=cm, a=-torch.exp(rn(di, n)),
                dt=torch.rand((b, s, di), generator=gen, device="cuda") * 0.1)


def _ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude."""
    import torch
    g, w = got.float(), want.float()
    m = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(m)
    ulp = torch.ldexp(torch.ones_like(m), e - 8)
    return (g - w).abs() / ulp


def _host_us(fn, n: int = 50) -> float:
    """Host time per call to enqueue ``fn`` (no synchronise inside)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _sass(lib) -> str:
    """The SASS of the fused bf16 N = 16 instance with 16-byte staging,
    from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    want = "mamba_scan_kernelILi16ELb1ELb1E13__nv_bfloat16"
    out, on = [], False
    for line in text.splitlines():
        if "Function :" in line:
            on = want in line
        if on:
            out.append(line)
    return "\n".join(out)


def _sass_counts(text: str) -> dict:
    """Opcode counts (static) of a SASS listing."""
    import collections
    import re
    counts = collections.Counter()
    for line in text.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m:
            counts[m.group(2).split(".")[0]] += 1
    return dict(total=sum(counts.values()), by_opcode=dict(
        counts.most_common()))


def build_variant(name, subs):
    """Builds the variant's copy of csrc/; returns (library path, ptxas
    lines, SASS opcode counts)."""
    from repro_torch.kernels import _build
    src = ROOT / "build" / "k6_variants" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", src)
    text = (src / "mamba_scan.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    (src / "mamba_scan.cu").write_text(text)
    _build.CSRC = src
    _build.BUILD_LOG.pop("mamba_scan", None)
    path = _build.build(["mamba_scan"])["mamba_scan"]
    log = _build.BUILD_LOG.get("mamba_scan", "(built before, in this run)")
    return path, [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln
                  or "Compiling entry" in ln], _sass(path)


def use(path):
    """Route the wrappers to the variant's library."""
    import ctypes
    from repro_torch.kernels import _build
    _build._LIBS["mamba_scan"] = ctypes.CDLL(str(path))


def checks():
    """Both entries against their plain versions at SHAPES."""
    import torch
    from repro_torch.kernels import mamba_scan as kms
    from repro_torch.kernels import ref
    out = {}
    for shape_name, shp in SHAPES.items():
        b, s, di, n = shp
        for dtype in (torch.float32, torch.bfloat16):
            op = _inputs(b, s, di, n, dtype, seed=di)
            args = [op[k] for k in ("dt_lin", "dt_bias", "x", "z", "d_skip",
                                    "bmat", "cmat", "a")]
            y, h = kms.mamba_scan_fused(*args)
            wy, wh = ref.mamba_scan_fused_ref(*args)
            rec = dict(max_abs_err_h=(h - wh).abs().max().item(),
                       max_abs_err_y=(y.float() - wy.float()).abs().max()
                       .item())
            if dtype == torch.float32:
                rec["ok"] = bool(
                    torch.allclose(y, wy, atol=2e-5, rtol=2e-5)
                    and torch.allclose(h, wh, atol=2e-5, rtol=2e-5))
            else:
                u = _ulps(y, wy)
                rec.update(max_ulps=u.max().item(),
                           n_over_1ulp=int((u > 1).sum()))
            out[f"fused_{shape_name}_{str(dtype)[6:]}"] = rec
            del y, h, wy, wh
            if dtype == torch.float32:
                sargs = [op[k] for k in ("dt", "x", "bmat", "cmat", "a")]
                y, h = kms.mamba_scan(*sargs)
                wy, wh = ref.mamba_scan_ref(*sargs)
                out[f"scan_{shape_name}"] = dict(
                    max_abs_err_y=(y - wy).abs().max().item(),
                    max_abs_err_h=(h - wh).abs().max().item(),
                    ok=bool(torch.allclose(y, wy, atol=2e-5, rtol=2e-5)
                            and torch.allclose(h, wh, atol=2e-5,
                                               rtol=2e-5)))
                del y, h, wy, wh
            del op, args
            torch.cuda.empty_cache()
    return out


def timed(paths, rounds: int):
    """Device time (profiler) of the contract entry at f32 and the fused
    entry at bf16, prefill shape, every variant in turns for ``rounds``
    rounds (the order rotated each round), after a warm-up; and each
    variant's host time to enqueue the fused call."""
    import torch
    from repro_torch.kernels import mamba_scan as kms
    b, s, di, n = SHAPES["prefill"]
    op = _inputs(b, s, di, n, torch.bfloat16, seed=1)
    fargs = [op[k] for k in ("dt_lin", "dt_bias", "x", "z", "d_skip",
                             "bmat", "cmat", "a")]
    x32 = torch.randn((b, s, di), device="cuda")
    sargs = [op["dt"], x32, op["bmat"].contiguous(), op["cmat"].contiguous(),
             op["a"]]
    names = list(paths)
    use(paths[names[0]])
    for _ in range(200):                     # the card at its clocks
        kms.mamba_scan_fused(*fargs)
    torch.cuda.synchronize()
    out = {k: dict(scan_device_ms=[], fused_bf16_device_ms=[],
                   fused_bf16_host_us=[]) for k in names}
    for r in range(rounds):
        for k in names[r % len(names):] + names[:r % len(names)]:
            use(paths[k])
            out[k]["scan_device_ms"].append(
                _device_ms(lambda: kms.mamba_scan(*sargs), 10))
            out[k]["fused_bf16_device_ms"].append(
                _device_ms(lambda: kms.mamba_scan_fused(*fargs), 10))
            out[k]["fused_bf16_host_us"].append(
                _host_us(lambda: kms.mamba_scan_fused(*fargs)))
    return out


def by_width(path, widths):
    """The fused entry at bf16, [4, 2048, di] x 16 for each di in
    ``widths``: device ms, and ms per 1e9 state updates (flat if the card
    is filled evenly, higher where the grid's last wave is partial)."""
    import torch
    from repro_torch.kernels import mamba_scan as kms
    use(path)
    out = {}
    for di in widths:
        op = _inputs(4, 2048, di, 16, torch.bfloat16, seed=2)
        args = [op[k] for k in ("dt_lin", "dt_bias", "x", "z", "d_skip",
                                "bmat", "cmat", "a")]
        ms = _device_ms(lambda: kms.mamba_scan_fused(*args), 10)
        out[di] = dict(device_ms=ms,
                       ms_per_g_updates=ms / (4 * 2048 * di * 16 / 1e9))
        del op, args
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass-dir", help="write each variant's fused bf16 "
                    "N = 16 SASS here")
    ap.add_argument("--widths", nargs="*", type=int, help="also time the "
                    "first variant's fused entry at [4, 2048, di] x 16 for "
                    "these di")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    names = args.only or list(VARIANTS)
    built = {k: build_variant(k, VARIANTS[k]) for k in names}
    out = {}
    for k in names:
        use(built[k][0])
        from repro_torch.kernels import mamba_scan as kms
        if args.sass_dir:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"{k}.sass").write_text(built[k][2])
        out[k] = dict(ptxas=built[k][1],
                      sass_fused_bf16=_sass_counts(built[k][2]),
                      occupancy={c: kms.occupancy(*a) for c, a in (
                          ("fused_bf16", (True, torch.bfloat16)),
                          ("scan_f32", (False, torch.float32)))},
                      checks=checks())
        print(k, json.dumps(out[k]["checks"]), flush=True)
    for k, t in timed({k: built[k][0] for k in names}, args.rounds).items():
        out[k]["timed"] = t
        print(k, json.dumps(t), flush=True)
    if args.widths:
        out["by_width"] = by_width(built[names[0]][0], args.widths)
        print("by_width", json.dumps(out["by_width"]), flush=True)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
