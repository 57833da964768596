#!/usr/bin/env python3
"""K7's backward's design choices, measured on the card: variants of
``src/repro_torch/csrc/wkv6_bwd.cu`` built side by side and held against
the plain version, an f64 autograd and the first design it replaced, then
timed in turns at rwkv6-3b's train shapes.

    python3 tools/k7_bwd_variants.py [--only NAME ...] [--rounds R]
                                     [--out FILE] [--no-time]
                                     [--extra NAME=PATH ...]

Each variant is the source with its constants replaced (``VARIANTS``): G
(row blocks a (batch, head), one cluster; G = 1 sums dv inside one block
of 512 threads, with no cluster), D (steps a sub-chunk, its states in
registers), NSUB (sub-chunks between checkpoints, so the checkpoint
interval C = NSUB D), DR (steps a round of sums) and the threads an SM
the registers are held to (which sets the registers a thread).
``baseline`` is the first design (``tools/k7_baseline_wkv6_bwd.cu``: a
checkpoint every 64 steps, a butterfly a step for the row sums, dv's
block partials through device memory and a launch of their own). Every
variant's copy of ``csrc/`` goes under ``build/k7_bwd_variants/<name>/``,
all ``nvcc`` at once. For each: ptxas's registers and spills of each
kernel, the design and the occupancy calculator's resident blocks an SM
and clusters; at the train shape [4,2048,40,64] from the zero state, at
[1,2048,40,64] from a random state with a cotangent on the final state,
at a ragged [2,1000,4,64] and at S = D - 1, D, D + 1, C + 1 and 2 C + 3
([2,S,4,64]): each gradient within 1e-4 of its norm of
``ref.wkv6_scan_bwd_ref``, a second call bit for bit, each checkpoint
K7's state over the same prefix bit for bit (K7 launched over C steps at
a time, chained through the state), and each gradient compared bit for
bit with the baseline's; at [1,2048,40,64] each gradient against an f64
autograd through the plain forward (the plain version's own error
beside it). Then every variant in turns for R rounds (the order rotated
each round) after a warm-up: profiler device time of each kernel and of
the call at the train, state and ragged shapes. Prints the card's name
and power limit, then ``RESULT {json}`` (also written to ``--out``).
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
sys.path.insert(0, str(ROOT))

from chip_smoke import _device_rows, _k7_inputs  # noqa: E402

BASELINE = ROOT / "tools" / "k7_baseline_wkv6_bwd.cu"
LINES = {"G": "constexpr int G = 4;               // row blocks a (batch, "
              "head): a cluster",
         "D": "constexpr int D = 6;               // steps a sub-chunk, "
              "states in registers",
         "NSUB": "constexpr int NSUB = 2;            // sub-chunks between "
                 "checkpoints",
         "DR": "constexpr int DR = 3;              // steps a round of sums",
         "SMT": "constexpr int SM_THREADS = 384;    // threads an SM the "
                "registers allow",
         "CKR": "constexpr int CK_RING = 2;         // its chunks staged, "
                "CK_RING - 1 ahead"}
GRADS = ("dr", "dk", "dv", "dw", "du", "dS0")
NEW_KERNELS = ("ckpt_kernel", "bwd_kernel", "du_kernel")
OLD_KERNELS = ("ckpt_kernel", "bwd_kernel", "dv_kernel", "du_kernel")
DESIGN = ("threads_per_block", "smem_per_block", "registers", "local_bytes",
          "blocks_per_sm", "clusters", "G", "D", "C", "DR", "ckpt_registers",
          "ckpt_local_bytes")


def _p(**kw):
    """The substitutions that set the source's constants to ``kw``."""
    out = []
    for key, value in kw.items():
        line = LINES[key]
        head, tail = line.split("=", 1)
        out.append((line, f"{head}= {value};" + tail.split(";", 1)[1]))
    return out


VARIANTS = {
    "baseline": None,                     # the first design, whole
    "base": [],
    "dr6": _p(DR=6),                      # a round a sub-chunk
    "dr2": _p(DR=2),
    "c18": _p(NSUB=3),                    # a checkpoint every 18 steps
    "c18_dr6": _p(NSUB=3, DR=6),
    "d8c8": _p(D=8, NSUB=1, DR=4),        # 8 states, no passing steps
    "d4": _p(D=4, NSUB=4, DR=4),          # C = 16, 4 states a sub-chunk
    "g2": _p(G=2, SMT=256),               # 128 threads, a pair of blocks
    "g1": _p(G=1, SMT=256),               # no cluster: one block of 256
    "ckr4": _p(CKR=4),                    # the checkpoint pass's ring
    # timing only (their checks fail by design): one part of the work
    # left out, to see what it costs
    "x_no_rwait": [("      cluster_wait();\n      round_dv(sm, a, w.pend",
                    "      round_dv(sm, a, w.pend"),
                   ("    cluster_arrive();\n    w.pend", "    w.pend"),
                   ("  cluster_wait();  // the last round's pushes have "
                    "landed", "  cluster_arrive();\n  cluster_wait();")],
    "x_no_rounds": [("j < 3 * DR * NP; j += NT)", "j < 0; j += NT)"),
                    ("j < DR * NGR * (HD / 4); j += NT)", "j < 0; j += NT)"),
                    ("j < DR * (CO / 4); j += NT)", "j < 0; j += NT)"),
                    ("  if (x < RB) {\n#pragma unroll\n    for (int dd",
                     "  if (x < 0) {\n#pragma unroll\n    for (int dd")],
    "x_no_pass": [("pass < s; ++pass)", "pass < 0; ++pass)")],
    "x_ck_nodots": [("t0 < a.S; t0 += CK_G * DT)", "t0 < 0; t0 += CK_G * DT)")],
}
SHAPES = {"train": (4, 2048, 40, False), "state": (1, 2048, 40, True),
          "ragged": (2, 1000, 4, True)}
TIMED = ("train", "state", "ragged")
TOL = 1e-4


def _source(name) -> str:
    subs = VARIANTS[name]
    if isinstance(subs, Path):
        return subs.read_text()
    if subs is None:
        return BASELINE.read_text()
    text = (ROOT / "src" / "repro_torch" / "csrc" / "wkv6_bwd.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def _const(text, key) -> int:
    head = LINES[key].split("=")[0]
    line = next(ln for ln in text.splitlines() if ln.startswith(head))
    return int(line.split("=", 1)[1].split(";")[0])


def build_all(names):
    """Every variant's copy of csrc/ compiled at once; returns name ->
    (library path, ptxas lines, source text)."""
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        src = ROOT / "build" / "k7_bwd_variants" / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", src)
        text = _source(name)
        (src / "wkv6_bwd.cu").write_text(text)
        lib = src / "libwkv6_bwd.so"
        procs[name] = (lib, text, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src / "wkv6_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (lib, text, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln], text)
    if failed:
        raise SystemExit("nvcc failed for " + "\n".join(failed))
    return out


def sass_sizes(lib) -> dict:
    """Instructions of each kernel in the library's SASS (``cuobjdump``):
    the code a kernel's warps fetch."""
    import re
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((k for k in NEW_KERNELS + ("dv_kernel",)
                        if k in m.group(1)), m.group(1))
            out[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 1
    return out


class Lib:
    """A built variant: its entry, its checkpoint interval and kernels."""

    def __init__(self, name, path, text):
        self.name = name
        self.old = "wkv6_bwd_design" not in text  # the first design
        self.C = 64 if self.old else _const(text, "D") * _const(text,
                                                                 "NSUB")
        self.kernels = OLD_KERNELS if self.old else NEW_KERNELS
        self.lib = ctypes.CDLL(str(path))
        self.fn = self.lib.wkv6_bwd_launch
        self.fn.argtypes = ([ctypes.c_void_p] * (19 if self.old else 18)
                            + [ctypes.c_int] * (4 if self.old else 5)
                            + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int

    def design(self) -> dict:
        import torch
        n = 5 if self.old else len(DESIGN)
        out = torch.zeros(n, dtype=torch.int32)
        fn = getattr(self.lib, "wkv6_bwd_occupancy" if self.old
                     else "wkv6_bwd_design")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if fn(out.data_ptr(), None) != 0:
            raise RuntimeError(f"{self.name}: design query failed")
        return dict(zip(DESIGN, out.tolist()))

    def __call__(self, r, k, v, w, u, s0, dy, ds):
        """(dr, dk, dv, dw, du, dS0, checkpoints), as the wrapper
        allocates them."""
        import torch
        B, S, H, hd = r.shape

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device="cuda")

        ckpt, at, vdy = (f32(B, H, -(-S // self.C), hd, hd), f32(B, S, H),
                         f32(B, S, H))
        dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
        du, ds0, du_part = f32(H, hd), f32(B, H, hd, hd), f32(B, H, hd)
        ws = [ckpt, at, vdy] + ([f32(4, B, S, H, hd)] if self.old else [])
        ptrs = [r, k, v, w, u, s0, dy, ds, *ws, du_part, dr, dk, dv, dw, du,
                ds0]
        ints = (B, S, H, hd) + (() if self.old else (-(-S // self.C),))
        rc = self.fn(*(None if t is None else t.data_ptr() for t in ptrs),
                     *ints, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {rc}")
        return dr, dk, dv, dw, du, ds0, ckpt


def _rel(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-300)).item()


def _args(B, S, H, state, seed):
    import torch
    r, k, v, w, u, s0 = _k7_inputs(B, S, H, seed, state)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    dy = torch.randn((B, S, H, 64), generator=gen, device="cuda")
    ds = (torch.randn((B, H, 64, 64), generator=gen, device="cuda")
          if state else None)
    return r, k, v, w, u, s0, dy, ds


def _ckpt_ok(lib, args, ckpt) -> bool:
    """Each checkpoint K7's state over the same prefix, bit for bit."""
    import torch
    from repro_torch.kernels import wkv6 as kwkv
    r, k, v, w, u, s0 = args[:6]
    st = s0
    ok = bool(torch.equal(ckpt[:, :, 0], torch.zeros_like(ckpt[:, :, 0])
                          if s0 is None else s0))
    with torch.no_grad():
        for c in range(1, ckpt.shape[2]):
            sl = slice(lib.C * (c - 1), lib.C * c)
            _, st = kwkv.wkv6_scan(r[:, sl], k[:, sl], v[:, sl], w[:, sl],
                                   u, st)
            ok = ok and bool(torch.equal(st, ckpt[:, :, c]))
    return ok


def checks(libs):
    """Every variant at SHAPES and its own edges: the plain version's
    gate, a repeat, the checkpoints, bits against the baseline; f64 at
    ``state``."""
    import torch
    from repro_torch.kernels import ref
    cases = {}                  # the small edges first
    for lib in libs.values():
        if not lib.old:
            D = lib.C // _const(_source(lib.name), "NSUB")
            for S in (D - 1, D, D + 1, lib.C + 1, 2 * lib.C + 3):
                cases[f"S{S}"] = (2, S, 4, True)
    cases.update(SHAPES)
    out = {n: dict(cases={}) for n in libs}
    for ci, (case, (B, S, H, state)) in enumerate(cases.items()):
        args = _args(B, S, H, state, 330 + ci)
        want = ref.wkv6_scan_bwd_ref(*args)
        f64 = None
        if case == "state":
            ins = [t.double().requires_grad_() for t in args[:6]]
            y64, st64 = ref.wkv6_scan_ref(*ins)
            ((y64 * args[6].double()).sum()
             + (st64 * args[7].double()).sum()).backward()
            f64 = [t.grad for t in ins]
            plain64 = {g: _rel(a, b) for g, a, b in zip(GRADS, want, f64)}
            for n in libs:
                out[n]["plain_rel_err_f64"] = plain64
            del ins, y64, st64
        base = None
        for name, lib in libs.items():
            if case.startswith("S") and (lib.old or S not in {
                    lib.C // _const(_source(name), "NSUB") + d
                    for d in (-1, 0, 1)} | {lib.C + 1, 2 * lib.C + 3}):
                continue
            try:
                got = lib(*args)
                again = lib(*args)
                torch.cuda.synchronize()
            except RuntimeError as e:     # a launch the card refused
                out[name]["cases"][case] = dict(ok=False, error=str(e))
                continue
            rec = dict(rel_err={g: _rel(a, b) for g, a, b in
                                zip(GRADS, got, want)},
                       repeat_bitwise=all(torch.equal(a, b)
                                          for a, b in zip(got, again)),
                       checkpoints_bitwise=_ckpt_ok(lib, args, got[6]))
            del again
            if f64 is not None:
                rec["rel_err_f64"] = {g: _rel(a, b) for g, a, b in
                                      zip(GRADS, got, f64)}
            if name == "baseline":
                base = [t.clone() for t in got[:6]]
            elif base is not None:
                rec["bitwise_baseline"] = {g: bool(torch.equal(a, b)) for
                                           g, a, b in zip(GRADS, got, base)}
            rec["ok"] = (max(rec["rel_err"].values()) <= TOL
                         and rec["repeat_bitwise"]
                         and rec["checkpoints_bitwise"]
                         and (f64 is None
                              or max(rec["rel_err_f64"].values()) <= TOL))
            out[name]["cases"][case] = rec
            del got
        del args, want, f64, base
        torch.cuda.empty_cache()
    for name in libs:
        out[name]["ok"] = all(c["ok"] for c in out[name]["cases"].values())
    return out


def _split(lib, args, n):
    """Device ms a call of each of the library's kernels and their sum,
    ``n`` calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lib(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            lib(*args)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    out = {x: sum(d / c * max(1, round(c / n)) for d, k, c in rows
                  if f"::{x}(" in k) / 1e3
           for x in lib.kernels}
    out["sum"] = sum(out.values())
    return out


def timed(libs, rounds: int):
    """Each kernel's profiler device ms at TIMED, every variant in turns
    for ``rounds`` rounds, the order rotated each round, after a
    warm-up."""
    import torch
    names = list(libs)
    ops = {c: _args(*SHAPES[c][:3], SHAPES[c][3], 900 + i)
           for i, c in enumerate(TIMED)}
    for _ in range(20):                      # the card at its clocks
        libs[names[-1]](*ops["train"])
    torch.cuda.synchronize()
    out = {n: {c: [] for c in TIMED} for n in names}
    for rd in range(rounds):
        for name in names[rd % len(names):] + names[:rd % len(names)]:
            for c in TIMED:
                out[name][c].append(_split(libs[name], ops[c],
                                           10 if c != "ragged" else 20))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="also write the result here")
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    ap.add_argument("--extra", nargs="*", default=[], metavar="NAME=PATH",
                    help="also a whole other wkv6_bwd.cu, e.g. a parent "
                         "commit's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k7_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for spec in args.extra:
        name, path = spec.split("=", 1)
        VARIANTS[name] = Path(path).resolve()
    names = (args.only or list(VARIANTS)) + [
        e.split("=", 1)[0] for e in args.extra if args.only]
    if "baseline" in names:     # first: the others' bits are held to it
        names = ["baseline"] + [n for n in names if n != "baseline"]
    built = build_all(names)
    libs = {n: Lib(n, built[n][0], built[n][2]) for n in names}
    out = {}
    for name, lib in libs.items():
        out[name] = dict(ptxas=built[name][1], design=lib.design(), C=lib.C,
                         sass_instructions=sass_sizes(built[name][0]))
        print(name, json.dumps(out[name]), flush=True)
    for name, rec in checks(libs).items():
        out[name].update(rec)
        print(name, "ok" if rec["ok"] else "FAIL",
              json.dumps(rec["cases"]), flush=True)
    runs = {n: lib for n, lib in libs.items()
            if not any("error" in c for c in out[n]["cases"].values())}
    for name, t in ({} if args.no_time else timed(runs, args.rounds)).items():
        out[name]["device_ms"] = t
        best = {c: min(v, key=lambda x: x["sum"]) for c, v in t.items()}
        print(name, json.dumps(best), flush=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print("RESULT " + text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
