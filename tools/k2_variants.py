#!/usr/bin/env python3
"""K2's design choices, measured on the card: variants of
``src/repro_torch/csrc/similarity.cu`` built side by side and held
against the plain versions, then timed at the train path's shape.

    python3 tools/k2_variants.py [--only NAME ...] [--rounds R]

Each variant is the source with a few lines replaced (``VARIANTS``): the
tensor-core kernel's tile (64 x 64 or 128 x 128 in place of 64 x 128),
the slabs a barrier (one, with a 3-slot ring, in place of two), the
ring's depth (6: a pair's products in flight across the next barrier),
the epilogue's IEEE ``1 / sqrtf`` in place of ``rsqrtf``, and, for timing
alone, the tensor-core kernel without its square sums, without its
products, without its row loads, without the proxy fence, without the
epilogue's arithmetic, without the skip rules' expert comparison, or
without all of loads, square sums and products (the skeleton). A line
to replace that is not in the source stops the run. A variant's copy of
``csrc/`` goes under ``build/k2_variants/<name>/`` and builds there with
``_build``'s flags, every variant's ``nvcc`` at once. For each: ptxas's
registers and spills and, for the variants that compute what K2
computes, both entries against their plain versions at the path's shape
(64 groups of [128, 768] bf16 rows). Then every variant in turns for R
rounds after a warm-up, profiler device times of the contract entry
(the mask of ``chip_smoke.py`` phase 3; every group live; every tile
skipped) and of the fused entry with a carried s_prev and with none.
Prints the card's name and power limit, then ``RESULT {json}``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from condense_compare import _device  # noqa: E402

NG, G, D, E = 64, 128, 768, 16
S1, S2 = 0.8, 0.2
TILE = "constexpr int TC_BM = 64, TC_BN = 128;  // the tensor-core kernel's tile"
STAGES = "constexpr int STAGES = 4;  // shared-memory slots of the slab ring"
PAIR = "constexpr int PAIR = 2;    // slabs stored between two barriers"
RSQRT = "const float m = (acc[4 * nt + 2 * h + c] * rsqrtf(w) + 1.0f) * 0.5f;"
SQ = ("      sq8(cb[u], sqb[u]);\n", "        sq8(ca[u], sqa[u]);\n")
MMA = ("        hopper::wgmma_m64n64k16_ss<0>(\n"
       "            acc, hopper::desc_sw128(ta + wr * 64 * 128 + ks * 32),\n"
       "            hopper::desc_sw128(tb + wc * 64 * 128 + ks * 32), 1);\n")
LOAD = "    const bool in_k = s < n_slabs && k0 + 8 * cc < d;\n"
FENCE = "    fence_proxy_async();\n"
EPI = "        v[c] = code == MEASURE ? m : (code == ONE ? 1.0f : 0.0f);\n"
SAME = "        const bool same = !RULES || rid[u] == cid[k];\n"
VARIANTS = {
    "base": [],
    "tile64x64": [(TILE, TILE.replace("TC_BN = 128", "TC_BN = 64"))],
    "tile128x128": [(TILE, TILE.replace("TC_BM = 64", "TC_BM = 128"))],
    # one slab a barrier (3 slots), and a pair's products in flight (6)
    "single": [(PAIR, PAIR.replace("2;", "1;")),
               (STAGES, STAGES.replace("4;", "3;"))],
    "stages6": [(STAGES, STAGES.replace("4;", "6;"))],
    "ieee": [(RSQRT, RSQRT.replace("rsqrtf(w)", "(1.0f / sqrtf(w))"))],
    # timing alone: what each part of the main loop costs
    "no_sq": [(SQ[0], ""), (SQ[1], "")],
    "no_mma": [(MMA, "        ;\n")],
    "no_load": [(LOAD, "    const bool in_k = false;\n")],
    "no_fence": [(FENCE, "")],
    "no_epilogue": [(EPI, "        v[c] = code == ONE ? 1.0f : 0.0f;\n")],
    "no_ids": [(SAME, "        const bool same = true;\n")],
    "skeleton": [(LOAD, "    const bool in_k = false;\n"), (SQ[0], ""),
                 (SQ[1], ""), (MMA, "        ;\n")],
}
TIMING_ONLY = ("no_sq", "no_mma", "no_load", "no_fence", "no_epilogue",
               "no_ids", "skeleton")


def build_all(names):
    """Every variant's copy of csrc/ and its library, all nvcc processes
    at once. Returns {name: (library path, ptxas lines)}."""
    from repro_torch.kernels import _build
    base = (ROOT / "src" / "repro_torch" / "csrc" / "similarity.cu").read_text()
    texts = {}
    for name in names:                    # every substitution, then nvcc
        text = base
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    nvcc, procs = _build._nvcc(), {}
    for name in names:
        src = ROOT / "build" / "k2_variants" / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", src)
        (src / "similarity.cu").write_text(texts[name])
        lib = src / "libsimilarity.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
             str(src / "similarity.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln])
    return out


def use(lib):
    """Route K2's wrappers to a variant's library."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import similarity as ksim
    _build._LIBS["similarity"] = ctypes.CDLL(str(lib))
    ksim._ENTRIES.clear()


def inputs():
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    r = np.random.default_rng(11)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    top2 = torch.as_tensor(r.integers(0, E, (NG * G, 2)), device="cuda")
    expert = top2[:, 0].reshape(NG, G)
    same = expert[:, :, None] == expert[:, None, :]
    path = same.clone()
    path[::4] = False
    x = torch.randn((NG, G, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    centres = torch.randn((E, D), generator=gen, device="cuda")
    cid = torch.as_tensor(r.integers(0, E, (NG, G)), device="cuda")
    x0 = centres[cid] + 0.6 * torch.randn((NG, G, D), generator=gen,
                                          device="cuda")
    first = torch.full((NG, G, G), 0.5, device="cuda")
    carried = ref.masked_similarity_fused_ref(x0, expert, first, S1,
                                              S2)[0].contiguous()
    return dict(x=x, expert=expert, masks={
        "path": path, "live": same, "skip_all": torch.zeros_like(same)},
        carried=carried)


def checks(inp):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import similarity as ksim
    x, expert, sp = inp["x"], inp["expert"], inp["carried"]
    mask = inp["masks"]["path"]
    err = (ksim.masked_similarity(x, mask)
           - ref.masked_similarity_ref(x, mask)).abs().max().item()
    sim, frac = ksim.masked_similarity_fused(x, expert, sp, S1, S2)
    want, wfrac = ref.masked_similarity_fused_ref(x, expert, sp, S1, S2)
    measured = (expert[:, :, None] == expert[:, None, :]) \
        & ~(sp > S1) & ~(sp < S2)
    rec = dict(contract_max_abs_err=err,
               fused_max_abs_err=(sim - want)[measured].abs().max().item(),
               fused_rest_bitwise=bool(torch.equal(sim[~measured],
                                                   want[~measured])),
               frac_bitwise=bool(torch.equal(frac, wfrac)))
    rec["ok"] = (err <= 1e-5 and rec["fused_max_abs_err"] <= 1e-5
                 and rec["fused_rest_bitwise"] and rec["frac_bitwise"])
    return rec


def timed(libs, inp, rounds: int):
    """Device ms of each case, every variant in turns."""
    import torch
    from repro_torch.kernels import similarity as ksim
    x, expert, sp = inp["x"], inp["expert"], inp["carried"]
    cases = {f"contract_{k}": (lambda m=m: ksim.masked_similarity(x, m))
             for k, m in inp["masks"].items()}
    cases["fused_carried"] = lambda: ksim.masked_similarity_fused(
        x, expert, sp, S1, S2)
    cases["fused_no_s_prev"] = lambda: ksim.masked_similarity_fused(
        x, expert, None, S1, S2)
    runs = list(libs)
    use(libs[runs[0]])
    for _ in range(200):                     # the card at its clocks
        cases["contract_path"]()
    torch.cuda.synchronize()
    out = {n: {c: [] for c in cases} for n in runs}
    for r in range(rounds):
        for n in runs[r % len(runs):] + runs[:r % len(runs)]:
            use(libs[n])
            for c, fn in cases.items():
                out[n][c].append(_device(fn, 20)["device_ms"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = args.only or list(VARIANTS)
    built = build_all(names)
    inp = inputs()
    out = {"ptxas": {n: b[1] for n, b in built.items()}, "checks": {}}
    for n in names:
        if n not in TIMING_ONLY:
            use(built[n][0])
            out["checks"][n] = checks(inp)
    out["device_ms"] = timed({n: b[0] for n, b in built.items()}, inp,
                             args.rounds)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
