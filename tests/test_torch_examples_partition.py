"""The port's demos against libpll2_tpu's examples/, on the CPU: the eight
demos of the partition API (rooted, rooted_tacg, unrooted,
partial_traversal, newton, lg4, protein_list, heterotachy).

Each case runs the JAX demo (`python examples/<name>.py`, JAX on the CPU
at f64) and the port's demo (`python -m libpll2_tpu_torch.examples.<name>
--device cpu`, f64) as two subprocesses side by side, each with a
timeout, and compares their standard output: after the masks below, the
text between the numbers is equal and every number is within 1e-9
(relative), or within LOOSE_RTOL on the lines a demo lists in LOOSE (the
fitted lines of optimize_demo: 200 Adam steps of the same function
summed in another order).  The helpers here serve the other two files,
test_torch_examples_io.py and test_torch_examples_search.py.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from libpll2_tpu_torch.examples._common import split_numbers

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-9
LOOSE_RTOL = 1e-6
TIMEOUT = 420            # seconds a subprocess (the search demos: 25-60 s)

# (pattern, replacement, why): applied to both outputs before comparing
MASKS = [
    (re.compile(r"\b\d+\.\d+s\b"), "<seconds>s",
     "wall seconds of a phase: host clock, different in every run"),
    (re.compile(r"^(  round \d+:) .*$", re.M), r"\1 <phases>",
     "a search round's line: its phase seconds, and in the JAX demo its "
     "compile fields shapes=, lops=, cfg=, cache= (XLA programs the port "
     "does not have) where the port prints its scorer and edge-scorer "
     "launches"),
]
# lines (by pattern) compared at LOOSE_RTOL, per demo
LOOSE = {"optimize_demo": re.compile(r"model fit|fitted")}

def mask(text: str) -> str:
    for pattern, replacement, _ in MASKS:
        text = pattern.sub(replacement, text)
    return text


def compare(name: str, want: str, got: str) -> None:
    """Assert that the port's output `got` matches the JAX demo's `want`:
    equal text between the numbers, numbers within RTOL (LOOSE_RTOL on
    the demo's LOOSE lines)."""
    want_lines, got_lines = mask(want).splitlines(), mask(got).splitlines()
    assert len(got_lines) == len(want_lines), (want, got)
    loose = LOOSE.get(name)
    for w, g in zip(want_lines, got_lines):
        (wt, wn), (gt, gn) = split_numbers(w), split_numbers(g)
        assert gt == wt, f"text differs:\n  JAX:  {w}\n  port: {g}"
        rtol = LOOSE_RTOL if loose is not None and loose.search(w) \
            else RTOL
        for a, b in zip(gn, wn):
            assert abs(a - b) <= rtol * max(abs(a), abs(b)), \
                f"numbers differ beyond {rtol}:\n  JAX:  {w}\n  port: {g}"


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update(extra)
    return env


def _run(name: str, commands) -> list:
    """Run (who, argv, cwd, env) commands side by side; their stdouts."""
    procs = [(who, subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env=env))
             for who, argv, cwd, env in commands]
    outs = []
    try:
        for who, proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, \
                f"{who} demo {name} exited {proc.returncode}:\n{err}"
            outs.append(out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def port_command(name: str, args=(), port_code=None):
    """The port's demo on the CPU; port_code: Python source to run in
    place of `-m`, with the arguments in `ARGV`."""
    port_args = [*args, "--device", "cpu"]
    if port_code is None:
        argv = [sys.executable, "-m", f"libpll2_tpu_torch.examples.{name}",
                *port_args]
    else:
        argv = [sys.executable, "-c", f"ARGV = {port_args!r}\n{port_code}"]
    return ("port", argv, REPO, _env(OMP_NUM_THREADS="1"))


def run_port(name: str, args=(), port_code=None) -> str:
    """The port's demo alone; its stdout."""
    return _run(name, [port_command(name, args, port_code)])[0]


def run_pair(name: str, args=(), port_code=None):
    """Run the JAX demo and the port's demo as subprocesses side by side;
    return (JAX stdout, port stdout).  The JAX demo runs with
    LIBPLL2_TPU_NATIVE=0 (its numpy paths, equal to its native ones by
    tests/test_native.py): its native library is built in place, and a
    build started here could be read half-written by another pytest
    worker."""
    jax_cmd = ("JAX", [sys.executable, str(REPO / "examples" / f"{name}.py"),
                       *args], REPO / "examples",
               _env(JAX_PLATFORMS="cpu", LIBPLL2_TPU_NATIVE="0"))
    want, got = _run(name, [jax_cmd, port_command(name, args, port_code)])
    return want, got


PARTITION_DEMOS = ["rooted", "rooted_tacg", "unrooted", "partial_traversal",
                   "newton", "lg4", "protein_list", "heterotachy"]


@pytest.mark.parametrize("name", PARTITION_DEMOS)
def test_partition_demo_matches_jax(name):
    want, got = run_pair(name)
    assert "Log-L" in got or name == "protein_list"
    compare(name, want, got)


def test_compare_tells_outputs_apart():
    """The comparison fails on a changed number or text, and masks only
    what MASKS names."""
    base = "Log-L: -12.345678\nstepwise parsimony start: cost 826  (1.2s)\n"
    compare("x", base, base.replace("(1.2s)", "(0.3s)"))
    with pytest.raises(AssertionError):
        compare("x", base, base.replace("-12.345678", "-12.345679"))
    with pytest.raises(AssertionError):
        compare("x", base, base.replace("Log-L", "Log-l"))
    with pytest.raises(AssertionError):
        compare("x", base, base + "extra line\n")
    fit = "  fitted alpha = 37.730001\n"
    compare("optimize_demo", fit, fit.replace("37.730001", "37.730002"))
    with pytest.raises(AssertionError):
        compare("other", fit, fit.replace("37.730001", "37.730002"))
