"""The continuous-batching scheduler of the port (repro_torch.serve.
scheduler) against the reference's (repro.serve.scheduler): both are
pure host state, so the same submits, virtual-clock steps and logits
arrays must give the same admissions, feeds, request states,
timestamps and per-step metrics, exactly."""
import numpy as np
import pytest

from _hyp import given, settings, st   # optional dep; skips when absent

from repro.serve import scheduler as jsched

from repro_torch import serve as tserve_pkg
from repro_torch.serve import scheduler as tsched

V = 11


def _req_state(req):
    return (req.rid, req.state, req.slot, req.fed, list(req.generated),
            req.arrival, req.admit_time, req.first_token_time,
            req.finish_time, req.queue_ms, req.ttft_ms, req.tpot_ms)


def _drive(n_slots, arrivals, prompt_lens, max_new, seed, steps=200):
    """Run both schedulers side by side on one scripted stream: request
    i (prompt of ``prompt_lens[i]`` tokens, ``max_new[i]`` new tokens)
    arrives before step ``arrivals[i]``; every step feeds the same
    random logits to both. Asserts equality after every call."""
    r = np.random.default_rng(seed)
    prompts = [r.integers(1, V, (n,)).astype(np.int32) for n in prompt_lens]
    ours, ref = tsched.ContinuousScheduler(n_slots), \
        jsched.ContinuousScheduler(n_slots)
    submitted = 0
    for step in range(steps):
        now = 0.25 * step
        while submitted < len(prompts) and arrivals[submitted] <= step:
            a = ours.submit(prompts[submitted], max_new[submitted], now=now)
            b = ref.submit(prompts[submitted], max_new[submitted], now=now)
            assert _req_state(a) == _req_state(b)
            submitted += 1
        if ours.all_done() and submitted == len(prompts):
            assert ref.all_done()
            break
        got = [(s, q.rid) for s, q in ours.admit(now=now + 0.01)]
        want = [(s, q.rid) for s, q in ref.admit(now=now + 0.01)]
        assert got == want
        feed = ours.next_feed()
        np.testing.assert_array_equal(feed, ref.next_feed())
        assert feed.dtype == np.int32 and feed.shape == (n_slots, 1)
        logits = r.standard_normal((n_slots, V)).astype(np.float32)
        ours.observe(logits, now=now + 0.2)
        ref.observe(logits, now=now + 0.2)
        assert ours.step_metrics() == ref.step_metrics()
        assert [None if q is None else _req_state(q) for q in ours.slots] \
            == [None if q is None else _req_state(q) for q in ref.slots]
        assert ours.active_slots == ref.active_slots
    assert ours.all_done() and ref.all_done()
    assert [_req_state(q) for q in ours.done] == \
        [_req_state(q) for q in ref.done]
    for name in ("admitted", "finished", "generated_tokens", "slot_churn"):
        assert getattr(ours, name) == getattr(ref, name)
    return ours


def test_scripted_stream_matches_reference():
    """Bursts of 3 every 4 steps into 4 slots, uneven prompts and
    budgets, so slots recycle mid-stream while others decode."""
    n = 11
    arrivals = [(i // 3) * 4 for i in range(n)]
    lens = [3, 1, 5, 2, 4, 6, 1, 2, 3, 7, 2]
    new = [2, 4, 1, 3, 5, 2, 6, 1, 3, 2, 4]
    s = _drive(4, arrivals, lens, new, seed=0)
    assert s.finished == n and s.slot_churn >= n - 4
    assert s.generated_tokens == sum(new)


def test_constants_and_exports():
    assert (tsched.QUEUED, tsched.PREFILL, tsched.DECODE, tsched.DONE,
            tsched.IDLE_TOKEN) == (jsched.QUEUED, jsched.PREFILL,
                                   jsched.DECODE, jsched.DONE,
                                   jsched.IDLE_TOKEN)
    for name in ("ContinuousScheduler", "Request", "QUEUED", "PREFILL",
                 "DECODE", "DONE", "IDLE_TOKEN", "admit_slot"):
        assert name in tserve_pkg.__all__ and hasattr(tserve_pkg, name)


def test_submit_rejects_empty():
    with pytest.raises(AssertionError):
        tsched.ContinuousScheduler(2).submit([], 3, now=0.0)
    with pytest.raises(AssertionError):
        tsched.ContinuousScheduler(2).submit([1], 0, now=0.0)


@settings(max_examples=6, deadline=None)
@given(n_slots=st.integers(1, 4), burst=st.integers(1, 4),
       every=st.integers(1, 5), n=st.integers(1, 9),
       seed=st.integers(0, 2 ** 16))
def test_random_burst_patterns_match_reference(n_slots, burst, every, n,
                                               seed):
    r = np.random.default_rng(seed)
    arrivals = [(i // burst) * every for i in range(n)]
    _drive(n_slots, arrivals, list(r.integers(1, 6, n)),
           list(r.integers(1, 5, n)), seed)
