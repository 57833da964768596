#!/usr/bin/env python3
"""The pipelined executor's phases of ``chip_smoke.py``, alone, on the
card:

    python3 tools/sched_phases.py [--only NAME ...]

Runs ``chip_smoke.py``'s phases 1 and 2 (the card, the kernels' build),
then 30-35: K1 at the dense wire's chunk shape against its plain version,
timed, and each chunk's rows bit for bit one launch's; the pipelined EP
train run on the dense wire (step 0 bit for bit a sync run's, exact
launches, a bit-equal repeat); the pipelined f8 dedup wire (step 0 bit
for bit a 1-step sync run's, the shipped-bytes law, sync's launches); the
pipelined EP serve prefill bit for bit a sync run's; a 2-layer f32 cut
card against CPU; a profiled sync and pipelined step (streams, overlap).
``--only`` picks phases by name (kernels, dense, dedup, serve, parity,
profile). A phase that fails exits non-zero as in ``chip_smoke.py``; the
last line is ``DONE``.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402

PHASES = {"kernels": cs.phase_sched_kernels,
          "dense": cs.phase_sched_ep_dense,
          "dedup": cs.phase_sched_ep_dedup,
          "serve": cs.phase_sched_serve,
          "parity": cs.phase_sched_parity,
          "profile": cs.phase_sched_profile}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(PHASES),
                    default=list(PHASES))
    args = ap.parse_args()
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cs.phase_build()
    cs.log("pipelined executor:")
    for name in args.only:
        t = time.perf_counter()
        PHASES[name]()
        cs.log(f"phase {name}: {time.perf_counter() - t:.1f}s")
    cs.log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
