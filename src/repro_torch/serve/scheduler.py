"""Continuous-batching request scheduler (counterpart of
``repro/serve/scheduler.py``: the same admission order, feeds, state
machine and metrics).

The unit of work here is a *request*, not a step: sequences are admitted
into free decode cache slots between steps, decoded until their budget
is spent, then evicted so the slot can be recycled for the next queued
request; the batch never drains to refill. The scheduler is pure host
state (no torch); the launcher owns the cache and applies
:func:`repro_torch.serve.engine.admit_slot` for every admission the
scheduler reports, so the decisions are testable with a virtual clock.

State machine per request::

    QUEUED --admit--> PREFILL --last prompt token--> DECODE --budget--> DONE
                      (prompt fed token by token;     (greedy argmax
                       logits discarded)               feeds itself)

Step protocol (one decode step = one model call over all B slots)::

    sched.submit(prompt, max_new, now=t)        # any time
    for slot, req in sched.admit(now=t):        # fill free slots, FIFO
        engine.admit_slot(cache, slot, cache["pos"])
    toks = sched.next_feed()                    # [B,1] int32
    logits, cache = decode_step(params, cfg, luffy, cache, toks)
    sched.observe(logits.cpu().numpy(), now=t2) # records generated tokens,
                                                # finishes + evicts requests

``observe`` takes the step's logits as a host array: the one
device-to-host copy a greedy step needs. SLO accounting (per request,
published through :mod:`repro_torch.obs.metrics` by the launcher):
``queue_ms`` (arrival to admission), ``ttft_ms`` (arrival to first
generated token), ``tpot_ms`` (mean inter-token latency after the
first). All timestamps are the caller's, so tests can drive a virtual
clock.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"

# token fed to idle slots (their logits are discarded; any in-vocab id
# works — the slot's stale cache entries are masked per the recycling
# invariant, and admit_slot restarts the frame before real use)
IDLE_TOKEN = 0


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle timestamps (seconds; the
    caller picks the clock — wall for serving, virtual for tests)."""
    rid: int
    prompt: np.ndarray                   # [S] int32
    max_new: int
    arrival: float
    state: str = QUEUED
    slot: int = -1
    fed: int = 0                         # prompt tokens fed so far
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def queue_ms(self) -> Optional[float]:
        if self.admit_time is None:
            return None
        return (self.admit_time - self.arrival) * 1e3

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return (self.first_token_time - self.arrival) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean per-output-token latency after the first token."""
        if self.finish_time is None or self.first_token_time is None \
                or len(self.generated) < 2:
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.generated) - 1)) * 1e3


class ContinuousScheduler:
    """FIFO admission into ``n_slots`` decode cache slots."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.done: List[Request] = []
        self._next_rid = 0
        self._slot_used = [False] * n_slots   # ever occupied → churn
        # cumulative counters (step_metrics reports per-step deltas)
        self.admitted = 0
        self.finished = 0
        self.generated_tokens = 0
        self.slot_churn = 0                   # admissions into a used slot
        self._last_counts: Dict[str, int] = {}
        self._finished_this_step: List[Request] = []

    # ---- submission / admission -------------------------------------------

    def submit(self, prompt, max_new: int, *, now: float,
               rid: Optional[int] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert prompt.size >= 1 and max_new >= 1
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new, arrival=now)
        self.queue.append(req)
        return req

    def admit(self, *, now: float) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots (FIFO). Returns the
        (slot, request) admissions; the caller must apply
        ``engine.admit_slot(cache, slot, pos)`` for each."""
        out: List[Tuple[int, Request]] = []
        for slot in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[slot] is not None:
                continue
            req = self.queue.popleft()
            req.state = PREFILL
            req.slot = slot
            req.admit_time = now
            self.slots[slot] = req
            self.admitted += 1
            if self._slot_used[slot]:
                self.slot_churn += 1
            self._slot_used[slot] = True
            out.append((slot, req))
        return out

    # ---- per-step feed / observe ------------------------------------------

    def next_feed(self) -> np.ndarray:
        """The [B,1] int32 token vector to feed this step."""
        toks = np.full((self.n_slots, 1), IDLE_TOKEN, np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.fed < len(req.prompt):
                toks[slot, 0] = req.prompt[req.fed]
                req.fed += 1
            else:
                toks[slot, 0] = req.generated[-1]
        return toks

    def observe(self, logits: np.ndarray, *, now: float) -> None:
        """Consume the step's logits [B,V]: greedy-pick generated tokens,
        transition PREFILL→DECODE after the final prompt token, finish +
        evict requests whose budget is spent."""
        self._finished_this_step = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.state == PREFILL:
                if req.fed < len(req.prompt):
                    continue              # mid-prompt logits are discarded
                req.state = DECODE        # these logits predict token 1
            nxt = int(np.argmax(logits[slot]))
            req.generated.append(nxt)
            self.generated_tokens += 1
            if req.first_token_time is None:
                req.first_token_time = now
            if len(req.generated) >= req.max_new:
                req.state = DONE
                req.finish_time = now
                self.finished += 1
                self.done.append(req)
                self._finished_this_step.append(req)
                self.slots[slot] = None   # evict → slot is recyclable
        return None

    # ---- status / metrics --------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def all_done(self) -> bool:
        return not self.queue and self.active_slots == 0

    def step_metrics(self) -> Dict[str, float]:
        """Raw metric dict for ``MetricsRegistry.observe`` — counters as
        per-step increments, gauges as current values, SLO gauges as the
        mean over the requests that finished THIS step (omitted when
        none did, so the registry's applicability masking applies)."""
        cur = {"admitted": self.admitted, "finished": self.finished,
               "generated_tokens": self.generated_tokens,
               "slot_churn": self.slot_churn}
        out: Dict[str, float] = {
            k: float(v - self._last_counts.get(k, 0))
            for k, v in cur.items()}
        self._last_counts = cur
        out["active_slots"] = float(self.active_slots)
        out["queued_requests"] = float(len(self.queue))
        fin = self._finished_this_step
        self._finished_this_step = []     # each finish reported once
        for name in ("queue_ms", "ttft_ms", "tpot_ms"):
            vals = [getattr(r, name) for r in fin]
            vals = [v for v in vals if v is not None]
            if vals:
                out[name] = float(np.mean(vals))
        return out
