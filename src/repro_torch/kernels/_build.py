"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/lib<name>-<digest>.so`` at the repository root
(``.gitignore`` lists ``build/``), then loaded with ``ctypes``. The
digest covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.
Sources are compiled in parallel, one ``nvcc`` each. Nothing here runs
at import: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("expert_ffn", "expert_ffn_bwd", "similarity", "condense",
           "pack", "flash_attn", "mamba_scan", "wkv6", "wkv6_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Process-wide like the dlopen behind them: loaded libraries by name, and
# the compiler's register / shared-memory / spill report of each build.
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every kernel in ``names`` (default: all) that has no
    up-to-date library yet, all ``nvcc`` processes at once. Raises with
    the compiler's output if one fails. Returns name -> library path."""
    names = tuple(KERNELS if names is None else names)
    paths = {n: lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def entry(name: str, fn_name: str, n_ptr: int, n_int: int,
          n_float: int = 0):
    """The C function ``fn_name`` of kernel library ``name``, typed as
    n_ptr pointers, n_int ints, n_float floats, then the stream; returns
    an int."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def raw_stream(device_index: int) -> int:
    """The current CUDA stream of device ``device_index`` as the integer
    handle a C entry takes, without building a ``torch.cuda.Stream``
    (the short host path of the small kernels' wrappers)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def current_device() -> int:
    """The current CUDA device's index (``torch.cuda.current_device``
    without its initialisation check: the caller holds a CUDA tensor)."""
    return torch._C._cuda_getDevice()
