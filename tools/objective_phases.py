#!/usr/bin/env python3
"""The objectives' and the plan cache's phases of ``chip_smoke.py``,
alone, on the card:

    python3 tools/objective_phases.py [--only NAME ...]

Runs ``chip_smoke.py``'s phases 1 and 2 (the card, the kernels' build),
then 36-40: K1 and its backward with the replica lanes' group map against
their plain versions, timed beside a launch without a map and the
concatenated stack; the full-width EP train under ``--plan-objective
replicate`` with a biased router against "traffic" (live lanes, launches,
casts, a bit-equal repeat, pipelined step 0 bit for bit sync's, a
profiled step of each); a 2-layer f32 cut card against CPU; the EP train
under ``--plan-objective overlap`` pipelined at the estimate's chunk
count; serving through ``--plan-cache --precompute-plans`` on one device
and over 4 ranks against the uncached run. ``--only`` picks phases by
name (lanes, replicate, parity, overlap, cache). A phase that fails exits
non-zero as in ``chip_smoke.py``; the last line is ``DONE``.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402

PHASES = {"lanes": cs.phase_k1_lanes,
          "replicate": cs.phase_replicate_ep,
          "parity": cs.phase_replicate_parity,
          "overlap": cs.phase_overlap_ep,
          "cache": cs.phase_plan_cache_serve}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(PHASES),
                    default=list(PHASES))
    args = ap.parse_args()
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cs.phase_build()
    cs.log("objectives, K1's lane map, plan cache:")
    for name in args.only:
        t = time.perf_counter()
        PHASES[name]()
        cs.log(f"phase {name}: {time.perf_counter() - t:.1f}s")
    cs.log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
