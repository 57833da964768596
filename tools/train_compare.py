#!/usr/bin/env python3
"""Train and expert-parallel train runs of one checkout of the port on
the card, for comparing two commits in one call (run them in turns:
parent, change, change, parent).

    python3 tools/train_compare.py [ROOT] [--check-k1] [--k1-route fma]
                                   [--k1-bwd-route fma]

ROOT (default: the checkout holding this script) is the root of the
checkout whose ``src/repro_torch`` runs: full-width moe-gpt2, 6 steps,
B=8, S=1024, seed 0, as ``chip_smoke.py`` trains it, then the same over
4 virtual ranks (2 nodes, hier dedup, f8e4m3 wire). ``--check-k1``
holds every K1 launch of the runs, forward and backward, against its
plain version (the error of each call relative to the call's largest
output, then a summary); ``--k1-route fma`` forces K1's forward and
backward onto their f32 FMA kernels (a checkout with
``kernels/expert_ffn.py::route``, and ``bwd_route`` where it has one);
``--k1-bwd-route fma`` forces the backward alone (a checkout with
``bwd_route``). Prints the card's name and power limit, then one line
``RESULT {json}``: per run the losses, step times, their median after
step 0 and the buckets.
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


def _k1_bwd_checked(kexp, ref, errs):
    """kexp.expert_ffn_bwd, with each launch's four gradients held against
    autograd through the plain version: (shape, max |err|, max over the
    gradients of max |err| / max |plain|)."""
    import torch
    orig = kexp.expert_ffn_bwd

    def checked(h, w_up, w_gate, w_down, dy, act_name="silu"):
        got = orig(h, w_up, w_gate, w_down, dy, act_name)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in (h, w_up, w_gate, w_down)]
            want = torch.autograd.grad(
                ref.expert_ffn_ref(*leaves, act_name), leaves, dy)
        err = [(g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want)]
        rel = [e / w.float().abs().max().item() for e, w in zip(err, want)]
        errs.append((list(h.shape), max(err), max(rel)))
        return got

    checked.launches = 0
    return checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--check-k1", action="store_true")
    ap.add_argument("--k1-route", choices=("fma",))
    ap.add_argument("--k1-bwd-route", choices=("fma",))
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
    errs, bwd_errs = [], []
    if args.check_k1:
        kexp.expert_ffn = _k1_checked(kexp, ref, errs)
        kexp.expert_ffn_bwd = _k1_bwd_checked(kexp, ref, bwd_errs)
    if args.k1_route:
        kexp.route = lambda *a: args.k1_route
        if hasattr(kexp, "bwd_route"):
            kexp.bwd_route = lambda *a: args.k1_route
    if args.k1_bwd_route:
        kexp.bwd_route = lambda *a: args.k1_bwd_route
    out = {"root": str(root), "check_k1": args.check_k1,
           "k1_route": args.k1_route, "k1_bwd_route": args.k1_bwd_route}
    for name, run_args in (("train", TRAIN), ("ep", EP)):
        steps = train.main(run_args)["steps"]
        out[name] = dict(
            losses=[s["loss"] for s in steps],
            step_ms=[s["step_ms"] for s in steps],
            median_ms=statistics.median(s["step_ms"] for s in steps[1:]),
            buckets=[s["bucket"] for s in steps])
        torch.cuda.empty_cache()
    for key, es in (("k1", errs), ("k1_bwd", bwd_errs)):
        if es:
            out[f"{key}_calls"] = len(es)
            out[f"{key}_max_abs_err"] = max(e[1] for e in es)
            out[f"{key}_max_rel_to_largest"] = max(e[2] for e in es)
            out[f"{key}_shapes"] = sorted({tuple(e[0]) for e in es})
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
