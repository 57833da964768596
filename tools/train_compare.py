#!/usr/bin/env python3
"""Train and expert-parallel train runs of one checkout of the port on
the card, for comparing two commits in one call (run them in turns:
parent, change, change, parent).

    python3 tools/train_compare.py [ROOT] [--check-k1] [--k1-route fma]

ROOT (default: the checkout holding this script) is the root of the
checkout whose ``src/repro_torch`` runs: full-width moe-gpt2, 6 steps,
B=8, S=1024, seed 0, as ``chip_smoke.py`` trains it, then the same over
4 virtual ranks (2 nodes, hier dedup, f8e4m3 wire). ``--check-k1``
holds every K1 forward launch of the train run against its plain
version (the error of each call, then a summary); ``--k1-route fma``
forces K1's forward onto its f32 FMA kernels (a checkout with
``kernels/expert_ffn.py::route``). Prints the card's name and power
limit, then one line ``RESULT {json}``: per run the losses, step times,
their median after step 0 and the buckets.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TRAIN = ["--arch", "moe-gpt2", "--steps", "6", "--global-batch", "8",
         "--seq-len", "1024", "--device", "cuda", "--seed", "0"]
EP = TRAIN + ["--model-axis", "4", "--comm-mode", "hier", "--nodes", "2",
              "--hier-dedup", "on", "--wire-dtype", "f8e4m3"]


def _k1_checked(kexp, ref, errs):
    """kexp.expert_ffn, with each launch's output held against the plain
    version: (shape, max |err|, max |err| / max |plain|)."""
    orig = kexp.expert_ffn

    def checked(h, w_up, w_gate, w_down, act_name="silu"):
        out = orig(h, w_up, w_gate, w_down, act_name)
        want = ref.expert_ffn_ref(h, w_up, w_gate, w_down, act_name).float()
        err = (out.float() - want).abs().max().item()
        errs.append((list(h.shape), err, err / want.abs().max().item()))
        return out

    checked.launches = 0
    return checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--check-k1", action="store_true")
    ap.add_argument("--k1-route", choices=("fma",))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_compare: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import train
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    errs = []
    if args.check_k1:
        kexp.expert_ffn = _k1_checked(kexp, ref, errs)
    if args.k1_route:
        kexp.route = lambda *a: args.k1_route
    out = {"root": str(root), "check_k1": args.check_k1,
           "k1_route": args.k1_route}
    for name, run_args in (("train", TRAIN), ("ep", EP)):
        steps = train.main(run_args)["steps"]
        out[name] = dict(
            losses=[s["loss"] for s in steps],
            step_ms=[s["step_ms"] for s in steps],
            median_ms=statistics.median(s["step_ms"] for s in steps[1:]),
            buckets=[s["bucket"] for s in steps])
        torch.cuda.empty_cache()
    if errs:
        out["k1_calls"] = len(errs)
        out["k1_max_abs_err"] = max(e[1] for e in errs)
        out["k1_max_rel_to_largest"] = max(e[2] for e in errs)
        out["k1_shapes"] = sorted({tuple(e[0]) for e in errs})
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
