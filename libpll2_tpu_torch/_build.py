"""Build and load the CUDA kernels of this package.

The kernels live in csrc/*.cu with a plain C interface.  On first use they
are compiled with nvcc for sm_90a into one shared library under
build/libpll2_tpu_torch/ (beside the package), named by a hash of the
sources and flags so that an edited source is rebuilt, and loaded with
ctypes.  Nothing is built at import time: the CPU tests import every module
of the package on machines with no nvcc.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent
SOURCES = (PACKAGE / "csrc" / "tree_sweep.cu",)
BUILD_DIR = PACKAGE.parent / "build" / "libpll2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # nvcc wall time; 0.0 when an existing build was used
    log: str            # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def build() -> BuildInfo:
    """Compile the sources (once per content hash) and return BuildInfo."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libpll2_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build().path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tree_sweep_launch.argtypes = [
        p, i,          # ops, n_ops
        p,             # pmat
        p, i,          # tip_blocked, tips
        p, i,          # export_slots, n_exp
        p, p,          # clv_out, scal_out
        i, i, i, i,    # nt, tb, rates, states
        i, i,          # pool_size, per_rate
        f, f,          # thresh, factor
        p,             # stream
    ]
    lib.tree_sweep_launch.restype = ctypes.c_int
    lib.tree_sweep_max_smem.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.tree_sweep_max_smem.restype = ctypes.c_int
    lib.tree_sweep_error_string.argtypes = [ctypes.c_int]
    lib.tree_sweep_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return library().tree_sweep_error_string(err).decode()


@functools.cache
def _max_shared_memory(index: int) -> int:
    value = ctypes.c_int(0)
    err = library().tree_sweep_max_smem(index, ctypes.byref(value))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: {err} "
                           f"({error_string(err)})")
    return value.value


def max_shared_memory(device: torch.device) -> int:
    """Dynamic shared memory one block may opt in to on `device`, bytes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _max_shared_memory(index)
