"""The port's search demos against libpll2_tpu's examples/, on the CPU:
optimize_demo (smoothing, fit_model, legacy_search.ml_spr_round),
infer_demo at its defaults (16 taxa x 500 sites) and large_search at 16
taxa x 256 sites, radius 2, 2 rounds.  Comparison and masks:
test_torch_examples_partition.py; optimize_demo's fitted lines are held
at LOOSE_RTOL (1e-6).

large_search is compared with the port's search smoothing colour classes
0-3 only (the `four_classes` pin of tests/test_torch_search.py): the JAX
search builds no mask for a fifth class and never smooths its branches
(ROADMAP R5), and this tree's colouring needs five.  A second case runs
the port's demo as it is, smoothing every class: its trace must be
monotone (the demo asserts it) and finite."""
import math
import re

import pytest

from .test_torch_examples_partition import compare, run_pair, run_port

FOUR_CLASSES = """
import dataclasses
from libpll2_tpu_torch import search_fast
real = search_fast.compile_spr
def compile_spr(*args, **kw):
    prog = real(*args, **kw)
    return dataclasses.replace(prog, color_masks=prog.color_masks[:4])
search_fast.compile_spr = compile_spr
from libpll2_tpu_torch.examples import large_search
large_search.main(ARGV)
"""
LARGE = ("16", "256", "2", "2")


@pytest.mark.parametrize("name", ["optimize_demo", "infer_demo"])
def test_search_demo_matches_jax(name):
    want, got = run_pair(name)
    assert "logL" in got
    compare(name, want, got)


def test_large_search_matches_jax_on_four_classes():
    want, got = run_pair("large_search", LARGE, port_code=FOUR_CLASSES)
    assert "final logL" in got
    compare("large_search", want, got)


def test_large_search_every_class():
    got = run_port("large_search", LARGE)
    trace = [float(x) for x in re.search(r"logL trace: (.*)",
                                         got).group(1).split()]
    assert len(trace) >= 2 and all(math.isfinite(x) for x in trace)
    assert all(b >= a - 1e-3 for a, b in zip(trace, trace[1:]))
    final = float(re.search(r"final logL: (\S+)", got).group(1))
    assert final >= trace[0]
