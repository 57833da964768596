#!/usr/bin/env python3
"""The paper models' phases of ``chip_smoke.py``, alone, on the card:

    python3 tools/paper_phases.py [--only NAME ...]

Runs ``chip_smoke.py``'s phases 1 and 2 (the card, the kernels' build),
then 23-29: K1-K4 against their plain versions and timed at d 1024 /
F 4096; moe-transformerxl and moe-bert-large trained at full width and
depth (exact launch counts, peak memory, a bit-equal repeat);
moe-transformerxl served; moe-bert-large expert-parallel with wire error
feedback; card against CPU for 2-layer cuts and one Adafactor and one
SGD update; reduced expert-parallel error feedback card against CPU; a
profiled train step of each model. ``--only`` picks phases by name
(kernels, train, serve, ep, parity, ep_parity, profile). A phase that
fails exits non-zero as in ``chip_smoke.py``; the last line is
``DONE``.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402

PHASES = {"kernels": cs.phase_paper_kernels, "train": cs.phase_paper_train,
          "serve": cs.phase_paper_serve, "ep": cs.phase_paper_ep,
          "parity": cs.phase_paper_parity,
          "ep_parity": cs.phase_paper_ep_parity,
          "profile": cs.phase_paper_profile}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(PHASES),
                    default=list(PHASES))
    args = ap.parse_args()
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cs.phase_build()
    cs.log("paper models:")
    for name in args.only:
        t = time.perf_counter()
        PHASES[name]()
        cs.log(f"phase {name}: {time.perf_counter() - t:.1f}s")
    cs.log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
