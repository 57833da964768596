#!/usr/bin/env python3
"""The expert-parallel train phases of ``chip_smoke.py`` and its reuse
and lsh phase, alone, on the card:

    python3 tools/reuse_phases.py

Runs ``chip_smoke.py``'s phases 1 and 2 (the card, the kernels' build),
11 (the full-width EP train run, 6 steps twice) and 14 (its profile),
then 22 (K2's LSH instances against their plain version and timed in
turns with the exact entry; phase 11's run with plan reuse, condense
reuse and the lsh backend beside phase 11's, with phase 14's profile;
the reuse guarantee at full width; reduced EP card against CPU), each
with its gates. A phase that fails exits non-zero as in
``chip_smoke.py``; the last line is ``DONE``.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cs.phase_build()
    ep_info = cs.phase_ep_train()
    ep_prof = cs.phase_ep_profile()
    cs.log("reuse and lsh:")
    cs.phase_reuse_kernels()
    cs.phase_reuse_ep(ep_info, ep_prof)
    cs.phase_reuse_guarantee()
    cs.phase_reuse_parity()
    cs.log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
