"""Does the kernel library build cold, reload warm and rebuild after an edit?

Counterpart of the JAX package's tools/cacheprobe.py, which ran a trivial
Pallas kernel under the persistent compilation cache, stage by stage and
each in a subprocess with a hard timeout, to find where a cold compile hung
and whether a warm load worked.  Here the cache is _build.py's directory of
nvcc-built libraries named by a content hash, and the trivial kernel is
csrc/cache_probe.cu (out = 2 x + 1 over [256, 256] f32, wrapper
`scale_shift`, plain version `scale_shift_reference`).

    python -m libpll2_tpu_torch.probes.cache

Stages, each a subprocess with a timeout so that a hang is reported and not
suffered:
  torch-only  a plain torch op on the card, no kernel library loaded;
  cold        _build.build into a fresh temporary directory: every source
              compiled, the kernel launched and compared;
  warm        a second process on the same directory with nvcc taken off
              its PATH and CUDA_HOME pointed at an empty directory: it must
              load the library without compiling (BuildInfo.seconds == 0.0),
              launch the kernel and get the same bytes;
  edited      one byte appended to cache_probe.cu in a copy of csrc/: a new
              hash and a rebuild, the old library left in place;
then, in this process, the cold library is loaded once more (no compile)
and the kernel launched through it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SHAPE = (256, 256)
STAGES = ("torch-only", "cold", "warm", "edited")

STAGE_SRC = r"""
import json, sys, time
import torch

stage, build_dir, source_dir = sys.argv[1:4]
t0 = time.perf_counter()
out = {"stage": stage}
if stage == "torch-only":
    x = torch.ones((256, 256), dtype=torch.float32, device="cuda")
    r = torch.sin(x) @ x.T
    torch.cuda.synchronize()
else:
    from libpll2_tpu_torch import _build
    from libpll2_tpu_torch.probes import cache
    info = _build.build(build_dir, source_dir)
    lib = _build.library(build_dir, source_dir)
    x = cache.probe_input(device="cuda")
    got = cache.scale_shift(x, lib)
    torch.cuda.synchronize()
    out.update(nvcc_seconds=info.seconds, library=info.path.name,
               equal=bool(torch.equal(got, cache.scale_shift_reference(x))),
               sha256=cache.digest(got), launches=cache.scale_shift.launches)
out["seconds"] = time.perf_counter() - t0
print(json.dumps(out), flush=True)
"""


def probe_input(seed: int = 0, device="cuda"):
    """x [256, 256] f32 standard normal from numpy's generator at `seed`."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(SHAPE).astype(np.float32),
                           device=device)


def scale_shift_reference(x):
    """Plain version: 2 x + 1."""
    return x * 2.0 + 1.0


def digest(x) -> str:
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()


# the C entry point and its library, looked up once per library (None: the
# package's own), so that a launch pays for no lookup
_ENTRIES: dict = {}


def _entry(lib):
    """(cache_probe_launch, the library it came from) for `lib`."""
    found = _ENTRIES.get(lib)
    if found is None:
        from .. import _build
        library = _build.library() if lib is None else lib
        found = _ENTRIES[lib] = (library.cache_probe_launch, library)
    return found


def scale_shift(x, lib=None):
    """2 x + 1 of an f32 tensor: the kernel on a CUDA tensor (from `lib`,
    a library of _build.library; default the package's own), the plain
    version on a CPU tensor.

    The launch path does only what the call needs: the entry point is
    looked up once per library, the device is switched only when `x` is
    not on the current one, and the output is allocated by torch.empty_like.
    The stream is torch.cuda.current_stream's (PyTorch's public API has no
    call that returns the handle without building a Stream)."""
    if x.dtype != torch.float32:
        raise TypeError(f"the probe takes f32, got {x.dtype}")
    device = x.device
    if device.type == "cpu":
        return scale_shift_reference(x)
    if device.type != "cuda":
        raise ValueError(f"the probe needs a CUDA or CPU tensor, got "
                         f"{device}")
    if not x.is_contiguous():
        raise ValueError("the probe takes a contiguous tensor")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"the probe takes fewer than 2^31 elements, got {n}")
    launch, library = _entry(lib)
    out = torch.empty_like(x)
    if n == 0:
        return out
    if device.index == torch.cuda.current_device():
        err = launch(x.data_ptr(), out.data_ptr(), n,
                     torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = launch(x.data_ptr(), out.data_ptr(), n,
                         torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        # asked of `library` itself, not through _build.error_string: that
        # one would load (and perhaps build) the default library, which a
        # stage of the probe must not touch
        raise RuntimeError(
            f"cache_probe kernel launch failed: CUDA error {err} "
            f"({library.tree_sweep_error_string(err).decode()})")
    scale_shift.launches += 1
    return out


scale_shift.launches = 0   # kernel launches by this wrapper


def host_costs(x, calls: int = 10000) -> dict:
    """Host microseconds a call of each piece of a kernel launch from
    Python, `calls` calls each (time.perf_counter_ns), on CUDA tensor `x`:
    the pieces scale_shift's launch path was built from and the ones it
    drops, the whole wrapper, and x * 2 + 1.  The launches enqueue kernels
    (a few microseconds of host time each, and 1-2 of device time)."""
    import time

    from .. import _build
    lib = _build.library()
    device = x.device
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(device).cuda_stream
    launch = lib.cache_probe_launch
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()

    def device_context():
        with torch.cuda.device(device):
            pass

    pieces = {
        "_build.library()": _build.library,
        "CDLL attribute lookup": lambda: lib.cache_probe_launch,
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.cuda.device enter and exit": device_context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "two data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call (the launch)": lambda: launch(xp, op, n, stream),
        "scale_shift (whole call)": lambda: scale_shift(x),
        "x * 2 + 1": lambda: x * 2 + 1,
    }
    costs = {}
    for label, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        costs[label] = (time.perf_counter_ns() - t0) / calls / 1e3
        torch.cuda.synchronize()
    return costs


def _without_nvcc(env: dict, empty_dir: str) -> dict:
    """`env` with every PATH entry that holds an nvcc dropped and CUDA_HOME
    pointed at an empty directory: _build cannot compile under it."""
    env = dict(env)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not (Path(d) / "nvcc").exists())
    env["CUDA_HOME"] = empty_dir
    return env


def run_stage(stage: str, build_dir, source_dir, timeout: float = 300.0,
              env=None) -> dict:
    """One stage in a subprocess: its JSON result with "rc" and "wall_s",
    or {"hang": True} when it ran into the timeout."""
    from .. import _build
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_build.PACKAGE.parent)] + ([env["PYTHONPATH"]]
                                        if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", STAGE_SRC, stage, str(build_dir),
             str(source_dir)], capture_output=True, text=True,
            timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"stage": stage, "hang": True, "timeout_s": timeout}
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1]) if lines else {"stage": stage}
    out.update(rc=proc.returncode, wall_s=time.perf_counter() - t0)
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-2000:]
    return out


def edited_copy(source_dir, dest) -> Path:
    """A copy of the sources with one byte appended to cache_probe.cu."""
    dest = Path(dest)
    shutil.copytree(source_dir, dest)
    with open(dest / "cache_probe.cu", "ab") as f:
        f.write(b"\n")
    return dest


def run_probe(timeout: float = 300.0, emit=print) -> dict:
    """Run every stage and the reload in this process.  Returns {stage:
    result}; raises RuntimeError if a stage hangs, fails, recompiles when
    it should not, or differs from the plain version.  Needs a CUDA
    device and nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    from .. import _build
    results = {}

    def fail(stage, why):
        raise RuntimeError(f"cache probe stage {stage}: {why}: "
                           f"{results[stage]}")

    with tempfile.TemporaryDirectory(prefix="libpll2_cacheprobe_") as tmp:
        build_dir = Path(tmp) / "build"
        empty = Path(tmp) / "no_cuda"
        empty.mkdir()
        emit(f"build dir: {build_dir}")
        for stage in STAGES:
            source_dir, env = _build.SOURCE_DIR, None
            if stage == "warm":
                env = _without_nvcc(os.environ, str(empty))
            elif stage == "edited":
                source_dir = edited_copy(_build.SOURCE_DIR,
                                         Path(tmp) / "csrc_edited")
            r = results[stage] = run_stage(stage, build_dir, source_dir,
                                           timeout, env)
            if r.get("hang"):
                emit(f"{stage:12s} HANG (> {timeout:.0f} s)")
                fail(stage, "hang")
            emit(f"{stage:12s} rc={r['rc']} {r['wall_s']:6.1f} s  "
                 + (f"nvcc {r['nvcc_seconds']:.2f} s  {r['library']}  "
                    f"equal={r['equal']}" if "library" in r else ""))
            if r["rc"] != 0:
                fail(stage, "failed")
            if stage != "torch-only" and not (r["equal"]
                                              and r["launches"] == 1):
                fail(stage, "the kernel differs from its plain version")
        cold, warm, edited = (results[s] for s in STAGES[1:])
        if not cold["nvcc_seconds"] > 0.0:
            fail("cold", "a fresh directory did not compile")
        if warm["nvcc_seconds"] != 0.0 or warm["library"] != cold["library"]:
            fail("warm", "the second process compiled again")
        if warm["sha256"] != cold["sha256"]:
            fail("warm", "other bytes than the cold stage")
        if not edited["nvcc_seconds"] > 0.0 \
                or edited["library"] == cold["library"]:
            fail("edited", "an edited source was not rebuilt")
        if not (build_dir / cold["library"]).exists():
            fail("edited", "the old library is gone")

        # once more in this process: a cache hit, then a launch
        info = _build.build(build_dir)
        x = probe_input(device="cuda")
        got = scale_shift(x, _build.library(build_dir))
        torch.cuda.synchronize()
        results["reload"] = dict(
            stage="reload", nvcc_seconds=info.seconds,
            library=info.path.name, sha256=digest(got),
            equal=bool(torch.equal(got, scale_shift_reference(x))))
        emit(f"{'reload':12s} in this process: nvcc "
             f"{info.seconds:.2f} s  {info.path.name}  "
             f"equal={results['reload']['equal']}")
        if info.seconds != 0.0 or info.path.name != cold["library"]:
            fail("reload", "this process compiled again")
        if not results["reload"]["equal"] \
                or results["reload"]["sha256"] != cold["sha256"]:
            fail("reload", "other bytes than the cold stage")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("probes.cache: torch.cuda.is_available() is False; the probe "
              "needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else torch.cuda.get_device_name(0))
    run_probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
