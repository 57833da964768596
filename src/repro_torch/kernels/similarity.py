"""Masked pairwise similarity on the card: the wrappers of
``csrc/similarity.cu`` (the port of Pallas kernel K2,
``repro/kernels/similarity.py::masked_similarity``).

``out[g] = where(mask[g], (x[g] @ x[g].T * rsqrt(xx * yy + 1e-8) + 1) / 2,
0)`` for x [NG, G, d] in f32 or bf16, one launch over every group.
:func:`masked_similarity` takes the mask; :func:`masked_similarity_fused`
forms it from §V-A's skip rules inside the kernel and applies them to the
result (``condense/backends.py::fast_similarity``), and with LSH bucket
codes measures only the pairs whose codes collide. :func:`route` picks the
kernel: bf16 rows at d a multiple of 16 go to the tensor cores. The source
says what bounds the kernels and how they are laid out; the plain versions
are :func:`repro_torch.kernels.ref.masked_similarity_ref` and
:func:`repro_torch.kernels.ref.masked_similarity_fused_ref`. The
similarity carries no gradient (it feeds only comparisons), so there is
no backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
TC_WIDTH = 16     # the tensor-core route's d is a multiple of this
# output tiles, rows x columns, of the tensor-core and the FMA kernel; the
# fused entry's tiles of one group form a cluster of at most 8 blocks
TILES = {"wgmma": (64, 128), "fma": (64, 64)}
MAX_CLUSTER = 8


def route(x_dtype, d: int) -> str:
    """The kernel for rows of ``x_dtype`` (f32 or bf16) at width d:
    ``"wgmma"`` (bf16 tensor cores, f32 sums) for bf16 rows at d a
    multiple of 16, else ``"fma"``. f32 rows keep f32 math: TF32 or bf16
    products would move the card-against-CPU decisions at f32 compute."""
    if x_dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x_dtype}")
    if x_dtype == torch.bfloat16 and d % TC_WIDTH == 0:
        return "wgmma"
    return "fma"


# C entries of csrc/similarity.cu by name, looked up at first use
_ENTRIES = {}


def _entry(fn_name: str, n_ptr: int, n_int: int, n_float: int = 0):
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        fn = _ENTRIES[fn_name] = _build.entry("similarity", fn_name, n_ptr,
                                              n_int, n_float)
    return fn


def _rows(x):
    """x as the kernels read it: [NG, G, d], contiguous, 16-byte aligned
    (the tensor-core kernel copies 16-byte chunks)."""
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [NG, G, d], got {tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"NG={x.shape[0]} exceeds the launch grid (65535)")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _aligned(t, nbytes: int):
    """t contiguous, its data at a multiple of nbytes (the kernels read
    s_prev in 16-byte and the mask in 4-byte words)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % nbytes else t


def _call(fn, dev, *args):
    if dev.index == _build.current_device():
        return fn(*args, _build.raw_stream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, _build.raw_stream(dev.index))


def masked_similarity(x, mask):
    """x: [NG, G, d]; mask: [NG, G, G] bool. Launches the kernel on the
    current stream; returns [NG, G, G] f32. Adds one to
    ``masked_similarity.launches`` per launch."""
    x = _rows(x)
    NG, G, d = x.shape
    if mask.device != x.device or mask.dtype != torch.bool \
            or tuple(mask.shape) != (NG, G, G):
        raise ValueError(f"mask must be a [NG, G, G] bool tensor on "
                         f"{x.device}, got {mask.dtype} {tuple(mask.shape)} "
                         f"on {mask.device}")
    mask = _aligned(mask, 4)
    out = torch.empty((NG, G, G), dtype=torch.float32, device=x.device)
    rc = _call(_entry("masked_similarity_launch", 3, 5), x.device,
               x.data_ptr(), mask.data_ptr(), out.data_ptr(), NG, G, d,
               int(x.dtype == torch.bfloat16),
               int(route(x.dtype, d) == "wgmma"))
    if rc != 0:
        raise RuntimeError(f"masked_similarity launch failed: cudaError {rc}")
    masked_similarity.launches += 1
    return out


masked_similarity.launches = 0


def masked_similarity_fused(x, expert, s_prev, s1: float, s2: float,
                            code=None):
    """§V-A fast similarity in one launch. x: [NG, G, d] f32 or bf16;
    expert: [NG, G] int32 or int64 primary expert ids (a strided view is
    read in place); s_prev: [NG, G, G] f32 carried similarity, or None;
    code: [NG, G] int32 LSH bucket codes, or None. Cross-expert pairs are
    0, pairs with s_prev > s1 are 1, pairs with s_prev < s2 are 0, the
    rest are measured, with codes only where the row's and the column's
    codes are equal (0 elsewhere). A group's tiles (``TILES``) must fit
    one cluster: G <= 256 on the tensor cores, G <= 128 on the FMA
    kernel. Returns (sim [NG, G, G] f32, measured_frac [NG] f32, each
    group's measured share of its G² pairs). Adds one to
    ``masked_similarity_fused.launches`` and to
    ``masked_similarity.launches`` per launch, and with codes to
    ``masked_similarity_fused.lsh_launches``."""
    x = _rows(x)
    NG, G, d = x.shape
    dev = x.device
    if expert.device != dev or expert.dtype not in (torch.int32,
                                                    torch.int64) \
            or tuple(expert.shape) != (NG, G):
        raise ValueError(f"expert must be [NG, G] int32 or int64 on {dev}, "
                         f"got {expert.dtype} {tuple(expert.shape)} on "
                         f"{expert.device}")
    if expert.stride(0) != G * expert.stride(1):
        expert = expert.contiguous()
    if s_prev is not None:
        if s_prev.device != dev or s_prev.dtype != torch.float32 \
                or tuple(s_prev.shape) != (NG, G, G):
            raise ValueError(f"s_prev must be [NG, G, G] float32 on {dev}, "
                             f"got {s_prev.dtype} {tuple(s_prev.shape)} on "
                             f"{s_prev.device}")
        s_prev = _aligned(s_prev, 16)
    if code is not None:
        if code.device != dev or code.dtype != torch.int32 \
                or tuple(code.shape) != (NG, G):
            raise ValueError(f"code must be [NG, G] int32 on {dev}, got "
                             f"{code.dtype} {tuple(code.shape)} on "
                             f"{code.device}")
        code = code.contiguous()
    rt = route(x.dtype, d)
    tm, tn = TILES[rt]
    if -(-G // tm) * -(-G // tn) > MAX_CLUSTER:
        raise ValueError(f"G={G} is more than {MAX_CLUSTER} tiles of "
                         f"{tm} x {tn} (route {rt!r}): a group must fit one "
                         f"cluster")
    out = torch.empty((NG, G, G), dtype=torch.float32, device=dev)
    frac = torch.empty((NG,), dtype=torch.float32, device=dev)
    rc = _call(_entry("masked_similarity_fused_launch", 6, 7, 2), dev,
               x.data_ptr(), expert.data_ptr(),
               None if s_prev is None else s_prev.data_ptr(),
               None if code is None else code.data_ptr(),
               out.data_ptr(), frac.data_ptr(), NG, G, d,
               int(x.dtype == torch.bfloat16), int(rt == "wgmma"),
               int(expert.dtype == torch.int64), expert.stride(1),
               float(s1), float(s2))
    if rc != 0:
        raise RuntimeError(f"masked_similarity_fused launch failed: "
                           f"cudaError {rc}")
    masked_similarity.launches += 1
    masked_similarity_fused.launches += 1
    if code is not None:
        masked_similarity_fused.lsh_launches += 1
    return out, frac


masked_similarity_fused.launches = 0
masked_similarity_fused.lsh_launches = 0
