"""Serving (counterpart of ``repro/serve``):

* :mod:`repro_torch.serve.engine`: prefill and single-token decode with
  per-layer caches; a per-slot ``offset`` frame lets :func:`admit_slot`
  recycle a slot with no attention-cache reset, bit for bit a fresh one;
* :mod:`repro_torch.serve.scheduler`: the continuous-batching request
  scheduler (FIFO admission into free slots between decode steps,
  evict-on-finish, per-request SLOs), driven by ``launch/serve.py
  --continuous``.

The reference's ``serve_lib`` re-export shim has no counterpart: the
port has no historical imports to keep.
"""
from repro_torch.serve.engine import (admit_slot, attn_decode, cache_struct,
                                      decode_capacity, decode_step, prefill,
                                      prefill_capacity)
from repro_torch.serve.scheduler import (DECODE, DONE, IDLE_TOKEN, PREFILL,
                                         QUEUED, ContinuousScheduler, Request)

__all__ = [
    "ContinuousScheduler", "DECODE", "DONE", "IDLE_TOKEN", "PREFILL",
    "QUEUED", "Request", "admit_slot", "attn_decode", "cache_struct",
    "decode_capacity", "decode_step", "prefill", "prefill_capacity",
]
