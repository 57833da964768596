#!/usr/bin/env python3
"""How far two correct attention cores move reduced llama4's logits, on
the CPU.

    PYTHONPATH=src python3 tools/chunked_rounding.py [--prompts 256 200]
        [--batch 2] [--seed 58]

Runs the serve prefill of reduced llama4-maverick (one full period: three
chunked-local layers of chunk 64 and a global one, random weights from
``--seed``, the prompts too) twice on the CPU, once with its attention
core on ``models/blocks.py::attend`` (the CPU's path) and once on K5's
plain version with the chunks folded into the batch
(``attn_apply(flash=True)``, the card's path), at bf16 and at f32
compute, and prints the largest difference of the last-token logits,
whether the greedy tokens agree, and the gap between each row's two
largest logits. ``chip_smoke.py`` phase 58 holds the card against the
CPU for this model at f32 compute, since at bf16 this spread alone is
over the serve gate. Prints one line per case, then ``RESULT {json}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, nargs="+", default=[256, 200])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=58)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as bk
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    base = reduced(get_config("llama4-maverick-400b-a17b"), seq_len_hint=128)
    attn_apply = bk.attn_apply
    out = {}
    for cdt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        model = build_model(cfg, device="cpu", seed=args.seed)
        for S in args.prompts:
            toks = torch.as_tensor(np.random.default_rng(args.seed).integers(
                1, cfg.vocab_size, (args.batch, S)), dtype=torch.int32)
            plain = model.prefill(toks, S, luffy=luffy)[0]
            bk.attn_apply = lambda *a, flash=False, **kw: attn_apply(
                *a, flash=True, **kw)
            try:
                folded = model.prefill(toks, S, luffy=luffy)[0]
            finally:
                bk.attn_apply = attn_apply
            top2 = torch.topk(plain, 2, dim=-1).values
            rec = dict(compute_dtype=cdt, prompt=S,
                       max_abs_diff=(plain - folded).abs().max().item(),
                       logits_max_abs=plain.abs().max().item(),
                       argmax_equal=bool(torch.equal(plain.argmax(-1),
                                                     folded.argmax(-1))),
                       top2_gap=(top2[:, 0] - top2[:, 1]).tolist())
            out[f"{cdt}@{S}"] = rec
            print(json.dumps(rec))
    print("RESULT " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
