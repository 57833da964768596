"""Row gather on the card: the wrappers of ``csrc/condense.cu`` (the port
of Pallas kernel K3, ``repro/kernels/condense.py::gather_rows``), the
un-condense step ``y[rep_idx]``, and of its backward.

:class:`GatherRows` is its autograd function. The gradient of a row
gather sums ``dy`` into the representatives (the reference gets it from
XLA's transpose of ``jnp.take``, outside any Pallas kernel); the port's
backward kernels form those sums in f32, in ascending source order, with
no atomics, so a train step repeats bit for bit. Given ``group_size``
(the un-condense map keeps every token in its condensation group), the
backward is one group-local kernel with no global sort; without it, a
stable sort and a segmented sum. Both give the same bits. The plain
versions are :func:`repro_torch.kernels.ref.gather_rows_ref` and
:func:`repro_torch.kernels.ref.gather_rows_bwd_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _copy_width(row_bytes: int, *ptrs: int) -> int:
    """The widest copy word (16, 4 or 2 bytes) dividing ``row_bytes`` and
    every pointer."""
    a = row_bytes
    for p in ptrs:
        a |= p
    for w in (16, 4, 2):
        if a % w == 0:
            return w
    raise ValueError(f"rows of {row_bytes} bytes at {ptrs} are not 2-byte "
                     f"aligned")


# C entries of csrc/condense.cu by name, looked up at first use
_ENTRIES = {}


def _entry(fn_name: str, n_ptr: int, n_int: int):
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        fn = _ENTRIES[fn_name] = _build.entry("condense", fn_name, n_ptr,
                                              n_int)
    return fn


def gather_rows(y, rep_idx):
    """y: [T_src, d] (any 2- or 4-byte dtype); rep_idx: [T] int32 or
    int64, each in [0, T_src). Launches the kernel on the current stream;
    returns y[rep_idx]. Adds one to ``gather_rows.launches`` per launch."""
    if y.device.type != "cuda" or rep_idx.device != y.device:
        raise ValueError(f"y and rep_idx must lie on one CUDA device, got "
                         f"{y.device} and {rep_idx.device}")
    if y.dim() != 2 or rep_idx.dim() != 1:
        raise ValueError(f"y must be [T, d] and rep_idx [T], got "
                         f"{tuple(y.shape)} and {tuple(rep_idx.shape)}")
    idx_dtype = rep_idx.dtype
    if idx_dtype is not torch.int64 and idx_dtype is not torch.int32:
        raise TypeError(f"rep_idx must be int32 or int64, got {idx_dtype}")
    y = y.contiguous()
    idx = rep_idx.contiguous()
    n_src, d = y.shape
    T = idx.shape[0]
    dev = y.device
    # empty_like skips torch.empty's argument parsing: un-condense keeps T
    out = torch.empty_like(y) if T == n_src else y.new_empty((T, d))
    row_bytes = d * y.element_size()
    y_ptr, out_ptr = y.data_ptr(), out.data_ptr()
    fn = _entry("gather_rows_launch", 3, 5)
    args = (y_ptr, idx.data_ptr(), out_ptr, T, n_src, row_bytes,
            _copy_width(row_bytes, y_ptr, out_ptr),
            int(idx_dtype is torch.int64))
    if dev.index == _build.current_device():
        rc = fn(*args, _build.raw_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: cudaError {rc}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


MAX_GROUP = 1024   # the grouped kernel's shared memory holds G <= 1024


def gather_rows_bwd(dy, rep_idx, n_src: int, group_size=None):
    """dy: [T, d] f32 or bf16 on a CUDA device; rep_idx: [T] integer, each
    in [0, n_src). Launches a backward kernel on the current stream;
    returns dx [n_src, d] in dy's dtype, row j the f32 sum of the dy rows
    i with rep_idx[i] = j in ascending i. With ``group_size`` G the map
    must be group-local (rep_idx[i] // G == i // G, n_src == T, T % G ==
    0; the kernel traps on an index outside its group) and one kernel
    sorts within each group; without it a global stable sort comes first.
    Adds one to ``gather_rows_bwd.launches`` per launch."""
    if dy.device.type != "cuda" or rep_idx.device != dy.device:
        raise ValueError(f"dy and rep_idx must lie on one CUDA device, got "
                         f"{dy.device} and {rep_idx.device}")
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dy must be float32 or bfloat16, got {dy.dtype}")
    if dy.dim() != 2 or rep_idx.shape != dy.shape[:1]:
        raise ValueError(f"dy must be [T, d] and rep_idx [T], got "
                         f"{tuple(dy.shape)} and {tuple(rep_idx.shape)}")
    dy = dy.contiguous()
    T, d = dy.shape
    bf16 = int(dy.dtype == torch.bfloat16)
    dx = torch.empty((n_src, d), dtype=dy.dtype, device=dy.device)
    if group_size is not None:
        G = int(group_size)
        if not (1 <= G <= MAX_GROUP and T % G == 0 and n_src == T):
            raise ValueError(f"the group-local backward takes 1 <= G <= "
                             f"{MAX_GROUP}, T % G == 0 and n_src == T, got "
                             f"G={G}, T={T}, n_src={n_src}")
        idx = rep_idx.to(torch.int64).contiguous()
        row_bytes = d * dy.element_size()
        width = _copy_width(row_bytes, dy.data_ptr(), dx.data_ptr())
        fn = _entry("gather_rows_bwd_grouped_launch", 3, 5)
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(dy.data_ptr(), idx.data_ptr(), dx.data_ptr(), T // G, G,
                    row_bytes, width, bf16, stream)
    else:
        # the sources of each destination, in ascending order: a stable
        # sort and where each destination's run of them starts
        srt, order = torch.sort(rep_idx.to(torch.int64), stable=True)
        start = torch.searchsorted(
            srt, torch.arange(n_src + 1, dtype=torch.int64, device=dy.device))
        fn = _entry("gather_rows_bwd_launch", 4, 3)
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(dy.data_ptr(), order.data_ptr(), start.data_ptr(),
                    dx.data_ptr(), n_src, d, bf16, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows_bwd launch failed: cudaError {rc}")
    gather_rows_bwd.launches += 1
    return dx


gather_rows_bwd.launches = 0


class GatherRows(torch.autograd.Function):
    """K3 and its backward as a differentiable op (CUDA only); the index
    gets no gradient. ``group_size`` (None: any map) picks the backward."""

    @staticmethod
    def forward(ctx, y, rep_idx, group_size=None):
        ctx.save_for_backward(rep_idx)
        ctx.n_src = y.shape[0]
        ctx.group_size = group_size
        return gather_rows(y, rep_idx)

    @staticmethod
    def backward(ctx, dy):
        (rep_idx,) = ctx.saved_tensors
        return (gather_rows_bwd(dy, rep_idx, ctx.n_src, ctx.group_size),
                None, None)
