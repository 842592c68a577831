"""Build and load the CUDA kernels of this package.

The kernels live in csrc/*.cu with a plain C interface, and the code two
of them share in csrc/*.cuh.  On first use each source is compiled with
nvcc for sm_90a (one nvcc per source, all started together), the objects
are linked into one shared library under build/libpll2_tpu_torch/ (beside
the package), named by a hash of the sources, headers and flags so that
an edited source or header is rebuilt, and loaded with
ctypes.  Nothing is built at import time: the CPU tests import every module
of the package on machines with no nvcc.  `build` and `library` take the
build directory and the source directory as arguments (probes/cache.py
builds into a fresh directory and from an edited copy of csrc/).
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
SOURCE_DIR = PACKAGE / "csrc"
SOURCE_NAMES = ("tree_sweep.cu", "tree_sweep_generic.cu", "tree_sweep_mma.cu",
                "edge_score.cu", "mma_probe.cu", "cache_probe.cu",
                "construct_probe.cu", "message_sweep.cu", "newton_edges.cu",
                "tree_sweep_wide.cu")
SOURCES = tuple(SOURCE_DIR / name for name in SOURCE_NAMES)
# headers the sources include: hashed with them, compiled only through them
HEADER_NAMES = ("newton_passes.cuh",)
BUILD_DIR = PACKAGE.parent / "build" / "libpll2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # nvcc wall time; 0.0 when an existing build was used
    log: str            # nvcc's output (ptxas register / spill report)
    # seconds from the start of the build until each source's nvcc was
    # waited for (they run side by side and are waited for in turn, so an
    # upper bound of its end); empty when an existing build was used
    source_seconds: dict = dataclasses.field(default_factory=dict)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _directories(build_dir, source_dir):
    """The two directories as resolved paths, so that the caches below key
    on one spelling.  The defaults, BUILD_DIR and SOURCE_DIR, are resolved
    already (PACKAGE is) and are handed on as they are: a kernel wrapper
    asks for the default library on every launch, and resolving two paths
    costs more than the launch does."""
    return (BUILD_DIR if build_dir is None else Path(build_dir).resolve(),
            SOURCE_DIR if source_dir is None else Path(source_dir).resolve())


def library_path(build_dir=None, source_dir=None) -> Path:
    """Where the library of these sources goes: named by a hash of the
    flags and of every source's and header's bytes, inside the build
    directory."""
    build_dir, source_dir = _directories(build_dir, source_dir)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCE_NAMES + HEADER_NAMES:
        digest.update((source_dir / name).read_bytes())
    return build_dir / f"libpll2_kernels_{digest.hexdigest()[:16]}.so"


def build(build_dir=None, source_dir=None) -> BuildInfo:
    """Compile the sources of `source_dir` into `build_dir` (once per
    content hash and pair of resolved directories) and return BuildInfo."""
    return _build(*_directories(build_dir, source_dir))


@functools.cache
def _build(build_dir: Path, source_dir: Path) -> BuildInfo:
    out = library_path(build_dir, source_dir)
    sources = [source_dir / name for name in SOURCE_NAMES]
    if out.exists():
        return BuildInfo(out, 0.0, "")
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem[-16:]}.{os.getpid()}"
    objs = [build_dir / f"{src.stem}_{tag}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed, seconds = [], [], {}
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        seconds[src.name] = time.perf_counter() - t0
        logs.append(f"[{src.name}]\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                               + "\n".join(logs))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildInfo(out, time.perf_counter() - t0, "\n".join(logs),
                     seconds)


def library(build_dir=None, source_dir=None) -> ctypes.CDLL:
    """The kernel library with every entry point's C signature declared
    (loaded once per pair of resolved directories)."""
    return _library(*_directories(build_dir, source_dir))


@functools.cache
def _library(build_dir: Path, source_dir: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build(build_dir, source_dir).path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tree_sweep_launch.argtypes = [
        p, i,          # ops, n_ops
        p, p, i, p,    # pmat, p_base, n_pmat, pg
        p, i,          # tip_blocked, tips
        p, i, p,       # export_slots, n_exp, export_at
        p, p,          # clv_out, scal_out
        i, i, i, i,    # nt, tb, rates, states
        i, i, i, i,    # pool_size, per_rate, bf16, groups
        f, f,          # thresh, factor
        p,             # stream
    ]
    lib.tree_sweep_launch.restype = ctypes.c_int
    lib.tree_sweep_generic_matrix_floats.argtypes = [i, i, i]
    lib.tree_sweep_generic_matrix_floats.restype = ctypes.c_int
    lib.tree_sweep_generic_staged.argtypes = [i, i, i]
    lib.tree_sweep_generic_staged.restype = ctypes.c_int
    lib.tree_sweep_wide_launch.argtypes = [
        p, i,          # ops, n_ops
        p, i,          # items, n_items
        p, p, i, p,    # pmat, p_base, n_pmat, pt
        p, i,          # tip_blocked, tips
        p, p,          # clv_out, scal_out
        i, i, i, i,    # nt, tb, rates, states
        i, i,          # n_slots, per_rate
        f, f,          # thresh, factor
        p,             # stream
    ]
    lib.tree_sweep_wide_launch.restype = ctypes.c_int
    lib.tree_sweep_wide_smem.argtypes = [i, i, i, i, i]
    lib.tree_sweep_wide_smem.restype = ctypes.c_longlong
    lib.tree_sweep_mma_launch.argtypes = [
        p, i,          # ops, n_ops
        p, p,          # pfrag, p_base
        p, i,          # tip_blocked, tips
        p, i, p,       # export_slots, n_exp, export_at
        p, p,          # clv_out, scal_out
        i, i, i, i,    # nt, tb, rates, states
        i, i,          # pool_size, bf16
        f, f,          # thresh, factor
        p,             # stream
    ]
    lib.tree_sweep_mma_launch.restype = ctypes.c_int
    lib.tree_sweep_mma_fragments.argtypes = [
        p, p, p,       # pmat, idx, pfrag
        i, i, i, i,    # n_slots, words, run, pm_words
        i,             # bf16
        p,             # stream
    ]
    lib.tree_sweep_mma_fragments.restype = ctypes.c_int
    lib.mma_probe_launch.argtypes = [
        i, i,          # variant, unit
        p, p, p,       # a, b, out
        i, i, i,       # grid, tb, nrep
        p,             # stream
    ]
    lib.mma_probe_launch.restype = ctypes.c_int
    lib.mma_probe_smem.argtypes = [i, i, i]      # variant, unit, tb
    lib.mma_probe_smem.restype = ctypes.c_longlong
    lib.edge_score_launch.argtypes = [
        p, p,          # away, away_scal
        p, p,          # base, base_scal
        p, p, p, p,    # halves, score_ops, sub_rows, t0
        p, p, p, p,    # lbd, rbd, xw, pw
        p, p,          # score_out, t3_out
        i, i, i,       # n_cand, vg, slots
        i, i, i, i,    # rates, states, sites, newton_iters
        f,             # log_thresh
        i,             # cluster (0: the "reread" form)
        p,             # stream
    ]
    lib.edge_score_launch.restype = ctypes.c_int
    lib.edge_score_resident_smem.argtypes = [i, i, i, i]
    lib.edge_score_resident_smem.restype = ctypes.c_int
    lib.edge_score_reread_smem.argtypes = [i, i]         # rates, states
    lib.edge_score_reread_smem.restype = ctypes.c_int
    lib.cache_probe_launch.argtypes = [
        p, p, i,       # x, out, n
        p,             # stream
    ]
    lib.cache_probe_launch.restype = ctypes.c_int
    lib.construct_probe_launch.argtypes = [
        i,             # variant
        p, p,          # pfrag, pool
        p, p,          # out, scal_out
        i, i, i,       # grid, tb, n_ops
        f, f,          # thresh, factor
        p,             # stream
    ]
    lib.construct_probe_launch.restype = ctypes.c_int
    lib.static2_probe_launch.argtypes = [
        i,             # variant
        p, p, p,       # a_frag, b_cm, out
        i, i,          # sites, n_ops
        p,             # stream
    ]
    lib.static2_probe_launch.restype = ctypes.c_int
    lib.message_sweep_launch.argtypes = [
        p, i, i,       # ops, n_levels, width
        p, p, i,       # pmat, tipchars, tips
        p, p,          # clv, scal
        i, i, i,       # sites, tb, groups
        i, i,          # rates, states
        i, i, i,       # clv_scratch, scaler_zero, scaler_scratch
        i, f, f,       # per_rate, thresh, factor
        i, p,          # device, stream
    ]
    lib.message_sweep_launch.restype = ctypes.c_int
    lib.newton_edges_launch.argtypes = [
        p, p, p, i,    # clv, edge_rows, members, n
        p,             # bl
        p, p, p, p,    # lbd, rbd, xw, pw
        i, i, i, i,    # rates, states, sites, newton_iters
        f, f,          # lo, hi
        i, p,          # cluster, stream
    ]
    lib.newton_edges_launch.restype = ctypes.c_int
    lib.newton_edges_smem.argtypes = [i, i, i, i]
    lib.newton_edges_smem.restype = ctypes.c_int
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
