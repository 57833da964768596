#!/usr/bin/env python3
"""The serve phases of ``chip_smoke.py`` and its expert-parallel serve
and sequence-sharded train phases, alone, on the card:

    python3 tools/ep_serve_phases.py

Runs ``chip_smoke.py``'s phases 1 and 2 (the card, the kernels' build),
4 and 6 (full-width moe-gpt2 served on one rank, and its profile) and 19
to 21 (the same served over 4 virtual ranks with its profile, the
2-layer expert-parallel serve cut card against CPU, the sequence-sharded
train run and its card-against-CPU f32 step), each with its gates, then
logs prefill tokens/s, decode ms/step and the device-busy shares of M =
1 beside M = 4. A phase that fails exits non-zero as in
``chip_smoke.py``; the last line is ``DONE``.
"""
import json
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
    info, out = cs.phase_slice()
    prof = cs.phase_profile()
    ep = cs.phase_ep_serve(out)
    cs.phase_ep_serve_parity()
    cs.phase_seq_train()
    cs.log("serve M=1 vs M=4: " + json.dumps({
        "prefill_tok_s": [info["prefill_tok_s"], ep["prefill_tok_s"]],
        "decode_ms_per_step": [info["decode_ms_per_step"],
                               ep["decode_ms_per_step"]],
        "prefill_device_busy_share": [
            prof["prefill"]["device_busy_share"],
            ep["profile"]["prefill"]["device_busy_share"]],
        "decode_device_busy_share": [
            prof["decode_step"]["device_busy_share"],
            ep["profile"]["decode_step"]["device_busy_share"]]}))
    cs.log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
