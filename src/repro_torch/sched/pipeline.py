"""Double-buffered software pipeline over capacity chunks (counterpart of
``repro/sched/pipeline.py``).

The schedule is the two-slot pipeline: issue the first chunk's
transfer, then chunk ``k+1``'s transfer before consuming chunk ``k``:

    dispatch[0]
    dispatch[1] ; compute[0] ; combine[0]
    dispatch[2] ; compute[1] ; combine[1]
    ...
                  compute[n-1] ; combine[n-1]

At most two dispatched payloads are live at any point.
:func:`pipeline_schedule` returns that issue order as data and
:func:`run_pipeline` follows it exactly.

The reference pins the order against XLA's scheduler with an
optimization barrier; eager PyTorch issues in program order, so there is
none here. On the card the collectives run on a side stream
(:func:`side_stream`) and the compute on the current one, ordered by
CUDA events: compute ``k`` waits for dispatch ``k``, combine ``k`` for
compute ``k``, and the current stream waits for the side stream before
:func:`run_pipeline` returns. A tensor made on one stream and read on
the other is marked for the caching allocator (``record_stream``), so
its memory is not handed out again while the other stream may still
read it; autograd runs each backward op on its forward op's stream and
orders the two by itself. On the CPU everything runs in program order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class Stage(NamedTuple):
    name: str                     # "dispatch" | "compute" | "combine"
    chunk: int


def pipeline_schedule(n_chunks: int, *, with_combine: bool = True
                      ) -> Tuple[Stage, ...]:
    """Issue order of the depth-2 pipeline over ``n_chunks``: each
    chunk's dispatch before its compute before its combine, chunk
    ``k+1``'s dispatch before chunk ``k``'s compute, at most two
    dispatched payloads outstanding."""
    assert n_chunks >= 1, n_chunks
    out: List[Stage] = [Stage("dispatch", 0)]
    for k in range(n_chunks):
        if k + 1 < n_chunks:
            out.append(Stage("dispatch", k + 1))
        out.append(Stage("compute", k))
        if with_combine:
            out.append(Stage("combine", k))
    return tuple(out)


def format_schedule(n_chunks: int, *, with_combine: bool = True) -> str:
    """Human-readable diagram of :func:`pipeline_schedule`."""
    sched = pipeline_schedule(n_chunks, with_combine=with_combine)
    lines, row = [], []
    for st in sched:
        if st.name == "dispatch" and row:
            lines.append(" ; ".join(row))
            row = []
        row.append(f"{st.name}[{st.chunk}]")
    if row:
        lines.append(" ; ".join(row))
    return "\n".join(f"t{i}: {ln}" for i, ln in enumerate(lines))


_SIDE: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device) -> Optional["torch.cuda.Stream"]:
    """The stream the pipeline's collectives run on for ``device``: one
    per CUDA device, made at first use (a failure to make it raises);
    None for the CPU, where the pipeline runs in program order."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    if idx not in _SIDE:
        _SIDE[idx] = torch.cuda.Stream(device=idx)
    return _SIDE[idx]


def share(stream, *objs):
    """Mark every tensor in ``objs`` (nested tuples and lists, None
    skipped) as used on ``stream``; nothing when ``stream`` is None."""
    if stream is None:
        return
    for o in objs:
        if isinstance(o, torch.Tensor):
            o.record_stream(stream)
        elif isinstance(o, (tuple, list)):
            share(stream, *o)


def run_pipeline(n_chunks: int, *,
                 dispatch: Callable[[int], object],
                 compute: Callable[[int, object], object],
                 combine: Optional[Callable[[int, object], object]] = None,
                 stream: Optional["torch.cuda.Stream"] = None):
    """Run ``n_chunks`` chunks in :func:`pipeline_schedule`'s order.

    ``dispatch(k)`` moves chunk ``k``'s payload and returns it (tensors
    in nested tuples); ``compute(k, payload)`` consumes it;
    ``combine(k, out)`` optionally moves the result back. Returns
    ``(computed, combined)`` in chunk order (``combined`` None without a
    combine stage).

    ``stream`` (a CUDA stream, :func:`side_stream`): dispatch and combine
    run on it, compute on the current stream, ordered by events; the
    side stream first waits for the work already issued on the current
    one (the inputs dispatch reads; the caller marks them with
    :func:`share`), and the current stream waits for the side stream
    before this returns. None: program order."""
    payloads = {}
    computed: List[object] = [None] * n_chunks
    combined: Optional[List[object]] = \
        [None] * n_chunks if combine is not None else None
    cur = None
    if stream is not None:
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
    ready, done = {}, {}
    for st in pipeline_schedule(n_chunks, with_combine=combine is not None):
        k = st.chunk
        if st.name == "dispatch":
            if stream is None:
                payloads[k] = dispatch(k)
            else:
                with torch.cuda.stream(stream):
                    payloads[k] = dispatch(k)
                    ready[k] = stream.record_event()
                share(cur, payloads[k])
        elif st.name == "compute":
            if stream is not None:
                cur.wait_event(ready.pop(k))
            computed[k] = compute(k, payloads.pop(k))
            if stream is not None and combine is not None:
                done[k] = cur.record_event()
        else:
            if stream is None:
                combined[k] = combine(k, computed[k])
            else:
                stream.wait_event(done.pop(k))
                share(stream, computed[k])
                with torch.cuda.stream(stream):
                    combined[k] = combine(k, computed[k])
                share(cur, combined[k])
        assert len(payloads) <= 2, "double-buffer invariant violated"
    if stream is not None:
        cur.wait_stream(stream)
    return computed, combined
