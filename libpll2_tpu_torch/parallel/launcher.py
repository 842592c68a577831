"""Run one function on the n ranks of a new process group, one process a
rank, and collect what each rank returns.

    results = launch("package.module:function", n, kwargs, device="cuda")

Every rank runs `function(mesh, **kwargs)` after parallel.initialize has
joined it to the others through a FileStore in a fresh directory, with
`mesh` its parallel.make_mesh.  device "cuda" gives rank r the card r mod
the card count (several ranks on one card share it over gloo); "cpu"
hides the cards from the ranks, which then form a gloo group on the CPU.
A rank that fails makes launch kill the others and raise with every
rank's output; so does a rank that outlives `timeout` seconds.  The
results come back in rank order, tensors moved to the CPU.

The rank side is parallel/_rank.py.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

# A rank that has not finished this many seconds after its start is
# killed with the others.
RANK_TIMEOUT_S = 180.0
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


class RankError(RuntimeError):
    """A rank of a launch failed or timed out."""


def _log_tail(path: pathlib.Path, lines: int = 60) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return "\n".join(text.splitlines()[-lines:])


def launch(target: str, n: int, kwargs=None, device: str = "cuda",
           timeout: float = RANK_TIMEOUT_S, workdir=None) -> list:
    """Run `target` ("module:function") on n ranks; return each rank's
    result in rank order.  `kwargs` (picklable) go to every rank;
    `workdir`, if given, is an empty directory for the store, the
    arguments, the results and each rank's output (else a temporary one,
    removed afterwards)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    own = workdir is None
    work = pathlib.Path(tempfile.mkdtemp(prefix="pll_ranks_") if own
                        else workdir)
    try:
        with open(work / "args.pkl", "wb") as f:
            pickle.dump(kwargs or {}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(PACKAGE_ROOT), os.getcwd()]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        if device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        procs, logs = [], []
        try:
            for rank in range(n):
                logs.append(work / f"rank{rank}.log")
                with open(logs[-1], "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", f"{__package__}._rank",
                         str(work), str(rank), str(n), device, target],
                        stdout=out, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes)
                          if c is not None and c != 0]
                if failed:
                    raise RankError(_report(
                        f"rank {failed[0]} of {target} exited with "
                        f"{codes[failed[0]]}", logs))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RankError(_report(
                        f"{target} did not finish on {n} ranks within "
                        f"{timeout} s", logs))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, path in enumerate(logs):
            for line in path.read_text(errors="replace").splitlines():
                print(f"[rank {rank}] {line}", flush=True)
        results = []
        for rank in range(n):
            with open(work / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


def _report(what: str, logs) -> str:
    return what + "".join(f"\n--- rank {r} output (tail) ---\n"
                          f"{_log_tail(path)}"
                          for r, path in enumerate(logs))
