#!/usr/bin/env python3
"""K7's design choices, measured on the card: variants of
``src/repro_torch/csrc/wkv6.cu`` built side by side and held against the
plain version and against the one-thread-a-column kernel it replaced,
then timed in turns at rwkv6-3b's shapes.

    python3 tools/k7_variants.py [--only NAME ...] [--rounds R]
                                 [--out FILE] [--sass-dir DIR] [--no-time]
                                 [--extra NAME=PATH ...]

Each variant is the source with a few lines replaced (``VARIANTS``): G
(blocks a head), T (steps a staged chunk), columns a lane, lanes a
column, the steps a group (whose reductions interleave), the type a_t
is summed in, and the rank-one bonus in
the state loop (``y += r_i (S_ij + u_i k_i v_j)``, five instructions an
element) against out of it (``v_j a_t``, three). ``column`` is the
former kernel (``tools/k7_baseline_wkv6.cu``: a block of 64 threads a
(batch, head), a state column a thread). Every variant's copy of
``csrc/`` goes under ``build/k7_variants/<name>/``, all ``nvcc`` at once.
For each: ptxas's registers and spills, the occupancy calculator's
resident blocks an SM, y within 2e-5 of each row's norm and the final
state within 2e-5 of each head's state norm against
``ref.wkv6_scan_ref`` at three draws of the prefill [4,2048,40,64] from
the zero state and one from a random state, the decode step [4,1,40,64]
and a ragged [2,1000,4,64] from a random state, and S = T - 1, T, T + 1
and 2T + 3 at 40 heads; at the prefills also y against an f64
recurrence, beside the f32 plain version's own error against it, and the
step of the worst row against the plain version; whether the final state
is bit for bit the ``column`` kernel's at the prefill (its state update
rounds alike); a repeat bit for bit; 4T + 3 launches at S = 1, chained
through the state, bit for bit one launch over 4T + 3. Then every
variant in turns for R rounds (the order rotated each round) after a
warm-up: profiler device time at the prefill, decode and ragged shapes.
Prints the card's name and power limit, then ``RESULT {json}``
(also written to ``--out``).
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
sys.path.insert(0, str(ROOT))

from chip_smoke import _k7_inputs, _k7_scan64  # noqa: E402
from chip_smoke import _rel_norm_err as _rel  # noqa: E402
from hymba_compare import _device_ms  # noqa: E402

BASELINE = ROOT / "tools" / "k7_baseline_wkv6.cu"
LINES = {"G": "constexpr int G = 4;     // blocks a (batch, head)",
         "T": "constexpr int T = 16;    // steps a staged chunk",
         "RING": "constexpr int RING = 3;  // staged chunks; RING - 2 copied "
                 "ahead",
         "CPL": "constexpr int CPL = 4;   // state columns a lane",
         "LPC": "constexpr int LPC = 16;  // lanes a column group",
         "U": "constexpr int U = 8;     // steps a group, their "
              "reductions interleaved",
         "BonusT": "using BonusT = double;   // the type a_t is summed in"}
ACC_LINE = "acc[s][cc] = __fmaf_rn(rr[e], x, acc[s][cc]);"
Y_LINE = "const float yj = __fmaf_rn(vj[s][0], a0[s], acc[s][0]);"
R4_LINE = "const float4 r4 = r0[i4];"
KW_LINE = "const float4 k4 = k0[i4], w4 = w0[i4];"
V_LINE = "vj[s][cc] = v0[s * CB + (cc ^ mine)];"
GROUP_SIG = "int mine, uint64_t* summed,"
GROUP_CALL = "st, q, mine, summed, parity);"
STEPS_SIG = "const float* a0 = sm.a[slot];"
BONUS_HEAD = "const int sub = lane % AL;"
SHFL_LINE = "acc[s][i], __shfl_xor_sync(0xffffffffu, acc[s][h + i], o));"
YSTORE_LINE = "if (q < CPL) *y0 = yj;"
STEPS_LINE = "steps(sm, a.y + base + c * chunk"


def _p(**kw):
    """The substitutions that set the source's constants to ``kw``."""
    out = []
    for key, value in kw.items():
        line = LINES[key]
        head, tail = line.split("=", 1)
        out.append((line, f"{head}= {value};" + tail.split(";", 1)[1]))
    return out


def _value(name, key):
    """The constant ``key`` of variant ``name``."""
    if isinstance(VARIANTS[name], Path):
        text = VARIANTS[name].read_text()
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(LINES[key].split("=")[0]))
        return line.split("=", 1)[1].split(";")[0].strip()
    for old, new in VARIANTS[name] or []:
        if old == LINES[key]:
            return new.split("=", 1)[1].split(";")[0].strip()
    return LINES[key].split("=", 1)[1].split(";")[0].strip()


VARIANTS = {
    "column": None,                       # the former kernel, whole
    "base": [],
    # rows a lane (64 / LPC) x columns a lane (CPL), and G
    **{f"l{lpc}c{cpl}_g{g}": _p(LPC=lpc, CPL=cpl, G=g)
       for lpc, cpl, gs in ((4, 1, (4,)), (4, 4, (1,)), (8, 4, (2, 4)),
                            (8, 8, (1,)), (16, 4, (1, 2)), (16, 8, (2, 4)))
       for g in gs},
    # steps a chunk and chunks staged
    **{f"t{t}_r{ring}": _p(T=t, RING=ring)
       for t, ring in ((8, 3), (8, 4), (8, 6), (16, 4), (32, 3))},
    "u1": _p(U=1),
    "u2": _p(U=2),
    "u4": _p(U=4),
    "a32": _p(BonusT="float"),            # a_t summed in f32
    # timing only (their checks fail by design): one part of the work
    # left out, to see what it costs
    "x_no_shuffle": [(SHFL_LINE, "acc[s][i], acc[s][h + i]);")],
    "x_no_bonus": [(BONUS_HEAD, "return; " + BONUS_HEAD)],
    "x_no_ystore": [(YSTORE_LINE, YSTORE_LINE.replace(
        "q < CPL", "q < CPL && yj == 1.25f"))],
    "x_no_steps": [(STEPS_LINE, "if (false) " + STEPS_LINE)],
    "x_lds_quarter": [(R4_LINE, R4_LINE.replace("[i4]", "[p * LPC]")),
                      (KW_LINE, KW_LINE.replace("[i4]", "[p * LPC]")),
                      (V_LINE, V_LINE.replace("s * CB + ", ""))],
    "x_no_acc": [(ACC_LINE, "")],
    # the bonus in the state loop, u_i from shared memory; the a_t pass
    # returns at once
    "bonus_in": [
        (GROUP_SIG, GROUP_SIG.replace("int mine,",
                                      "int mine, const BonusT* uq,")),
        (GROUP_CALL, "st, q, mine, uq, summed, parity);"),
        (STEPS_SIG, STEPS_SIG + " const BonusT* uq = sm.u;"),
        (R4_LINE, R4_LINE + " const BonusT* ub = uq + 4 * (p * LPC + q);"
                  " const float uu[4] = {float(ub[0]), float(ub[1]),"
                  " float(ub[2]), float(ub[3])};"),
        (ACC_LINE, "acc[s][cc] = __fmaf_rn(rr[e], __fadd_rn(x, "
                   "__fmul_rn(uu[e], kv)), acc[s][cc]);"),
        (Y_LINE, "const float yj = acc[s][0];"),
        (BONUS_HEAD, "return; " + BONUS_HEAD)],
}
SHAPES = {"prefill": (4, 2048, 40, False), "prefill_b": (4, 2048, 40, False),
          "prefill_c": (4, 2048, 40, False),
          "prefill_state": (4, 2048, 40, True), "decode": (4, 1, 40, True),
          "ragged": (2, 1000, 4, True)}
TIMED = ("prefill", "decode", "ragged")
TOL = 2e-5


def _worst_t(got, want):
    """The step of the row with the largest error of its norm."""
    import torch
    d = torch.linalg.vector_norm(got - want, dim=-1)
    n = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
    e = torch.nan_to_num(d / n, nan=float("inf"))       # [B, S, H]
    return int(torch.argmax(e)) // e.shape[2] % e.shape[1]


def build_all(names):
    """Every variant's copy of csrc/ compiled at once; returns name ->
    (library path, ptxas lines)."""
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        src = ROOT / "build" / "k7_variants" / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", src)
        subs = VARIANTS[name]
        if isinstance(subs, Path):
            text = subs.read_text()
        elif subs is None:
            text = BASELINE.read_text()
        else:
            text = (src / "wkv6.cu").read_text()
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"variant {name}: {old!r} not in the "
                                     f"source")
                text = text.replace(old, new)
        (src / "wkv6.cu").write_text(text)
        lib = src / "libwkv6.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src / "wkv6.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    if failed:
        raise SystemExit("nvcc failed for " + "\n".join(failed))
    return out


def sass(lib) -> str:
    """The library's SASS (``cuobjdump``)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True).stdout


def sass_counts(text) -> dict:
    """Static opcode counts of a SASS listing."""
    import collections
    import re
    counts = collections.Counter()
    for line in text.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m:
            counts[m.group(2).split(".")[0]] += 1
    return dict(total=sum(counts.values()), by_opcode=dict(
        counts.most_common(16)))


def use(path):
    """Route ``wkv6_scan`` to the variant's library."""
    from repro_torch.kernels import _build
    _build._LIBS["wkv6"] = ctypes.CDLL(str(path))


def _t_of(name):
    return int(_value(name, "T"))


def checks(names, libs):
    """Every variant against the plain version at SHAPES and its own T's
    edges, the final prefill state against the column kernel's, a repeat
    and the chained launches bit for bit."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as kwkv
    cases = dict(SHAPES)
    for name in names:
        if VARIANTS[name] is not None:
            T = _t_of(name)
            for S in (T - 1, T, T + 1, 2 * T + 3):
                cases[f"S{S}"] = (2, S, 40, True)
    out = {n: dict(cases={}) for n in names}
    column_state = None
    for ci, (case, (B, S, H, state)) in enumerate(cases.items()):
        args = _k7_inputs(B, S, H, 700 + ci, state)
        wy, wst = ref.wkv6_scan_ref(*args)
        y64 = None
        if case.startswith("prefill"):
            y64 = _k7_scan64(*args)
            plain64 = dict(y_row_rel_err_f64=_rel(wy.double(), y64, (-1,)),
                           worst_t_f64=_worst_t(wy.double(), y64))
            for name in names:
                out[name].setdefault("plain_vs_f64", {})[case] = plain64
        for name in names:
            if case.startswith("S") and (VARIANTS[name] is None or S not in {
                    _t_of(name) + d for d in (-1, 0, 1)} | {
                    2 * _t_of(name) + 3}):
                continue
            use(libs[name])
            y, st = kwkv.wkv6_scan(*args)
            y2, st2 = kwkv.wkv6_scan(*args)
            torch.cuda.synchronize()
            rec = dict(y_row_rel_err=_rel(y, wy, (-1,)),
                       state_rel_err=_rel(st, wst, (-2, -1)),
                       repeat_bitwise=bool(torch.equal(y, y2)
                                           and torch.equal(st, st2)))
            if y64 is not None:
                rec.update(worst_t=_worst_t(y, wy),
                           y_row_rel_err_f64=_rel(y.double(), y64, (-1,)))
            rec["ok"] = (rec["y_row_rel_err"] <= TOL
                         and rec["state_rel_err"] <= TOL
                         and rec["repeat_bitwise"])
            if case == "prefill":
                if name == "column":
                    column_state = st.clone()
                elif column_state is not None:
                    rec["state_bitwise_column"] = bool(
                        torch.equal(st, column_state))
            out[name]["cases"][case] = rec
            del y, st, y2, st2
        del args, wy, wst, y64
        torch.cuda.empty_cache()
    for name in names:
        T = _t_of(name) if VARIANTS[name] is not None else 16
        r, k, v, w, u, s0 = _k7_inputs(1, 4 * T + 3, 40, 799, True)
        use(libs[name])
        y, st = kwkv.wkv6_scan(r, k, v, w, u, s0)
        state, ys = s0, []
        for t in range(r.shape[1]):
            yt, state = kwkv.wkv6_scan(r[:, t:t + 1], k[:, t:t + 1],
                                       v[:, t:t + 1], w[:, t:t + 1], u,
                                       state)
            ys.append(yt)
        torch.cuda.synchronize()
        out[name]["chain"] = dict(
            steps=4 * T + 3, bitwise=bool(torch.equal(torch.cat(ys, 1), y)
                                          and torch.equal(state, st)))
        c = out[name]["cases"]
        out[name]["ok"] = (all(x["ok"] for x in c.values())
                           and out[name]["chain"]["bitwise"])
    return out


def timed(names, libs, rounds: int):
    """Profiler device ms at TIMED, every variant in turns for ``rounds``
    rounds, the order rotated each round, after a warm-up."""
    import torch
    from repro_torch.kernels import wkv6 as kwkv
    ops = {c: _k7_inputs(*SHAPES[c][:3], 900 + i, SHAPES[c][3])
           for i, c in enumerate(TIMED)}
    use(libs[names[-1]])
    for _ in range(200):                     # the card at its clocks
        kwkv.wkv6_scan(*ops["prefill"])
    torch.cuda.synchronize()
    out = {n: {c: [] for c in TIMED} for n in names}
    for rd in range(rounds):
        for name in names[rd % len(names):] + names[:rd % len(names)]:
            use(libs[name])
            for c in TIMED:
                out[name][c].append(_device_ms(
                    lambda a=ops[c]: kwkv.wkv6_scan(*a),
                    10 if c != "decode" else 50))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="also write the result here")
    ap.add_argument("--sass-dir", help="write each variant's SASS here")
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    ap.add_argument("--extra", nargs="*", default=[], metavar="NAME=PATH",
                    help="also a whole other wkv6.cu, e.g. a parent "
                         "commit's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k7_variants: no CUDA device", file=sys.stderr)
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
    if "column" in names:       # the baseline first: its state is compared
        names = ["column"] + [n for n in names if n != "column"]
    built = build_all(names)
    libs = {n: built[n][0] for n in names}
    from repro_torch.kernels import wkv6 as kwkv
    out = {}
    for name in names:
        use(libs[name])
        try:
            occ = kwkv.occupancy()
        except AttributeError:               # the column kernel has none
            occ = None
        text = sass(libs[name])
        if args.sass_dir:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"{name}.sass").write_text(text)
        out[name] = dict(ptxas=built[name][1], occupancy=occ,
                         sass=sass_counts(text))
    for name, rec in checks(names, libs).items():
        out[name].update(rec)
        print(name, json.dumps({k: out[name][k] for k in (
            "ptxas", "occupancy", "sass", "ok", "chain")}), flush=True)
        print(name, json.dumps(out[name]["cases"]), flush=True)
    for name, t in ({} if args.no_time else timed(
            names, libs, args.rounds)).items():
        out[name]["device_ms"] = t
        print(name, json.dumps({c: min(v) for c, v in t.items()}),
              flush=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print("RESULT " + text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
