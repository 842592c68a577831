"""The metrics' own arithmetic: the sweep's roofline count at both
configurations, the 95th percentile, the union of intervals, the reading
of a trace and the gaps by host op."""
import importlib.util
import json
from types import SimpleNamespace

import numpy as np
import pytest

from pllbench import tracing

from . import tiny

METRICS = tiny.ROOT / "pllbench" / "metrics"
PEAKS = json.loads((tiny.ROOT / "pllbench" / "peaks.json").read_text())
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config(workload):
    return tiny.run.load_cell(tiny.ROOT, workload)[1]


def test_roofline_count_dna():
    m = metric("sweep_roofline.eval")
    flop, nbytes = m.work(config("dna_eval"))
    assert flop == 4096 * 4 * (254 * 4 + 252 * 2 * 16)
    assert nbytes == 4 * (256 * 4096 + 509 * 4 * 16 + 2 * 4 * 4 * 4096)
    assert m.bound_s(config("dna_eval"), H100) == pytest.approx(1.4474e-6,
                                                                rel=1e-3)


def test_roofline_count_protein():
    m = metric("sweep_roofline.eval")
    flop, nbytes = m.work(config("protein_eval"))
    assert flop == 16384 * 4 * (126 * 20 + 124 * 2 * 400)
    assert m.bound_s(config("protein_eval"), H100) == pytest.approx(
        flop / 495e12)
    assert flop / 495e12 == pytest.approx(13.468e-6, rel=1e-3)


def run_with(trace, workload="dna_eval"):
    return SimpleNamespace(config=config(workload), trace=trace, peaks=H100,
                           window_s=None, units=trace.units, latencies_s=[])


def sweep_trace(sweep_ns, units=2, launches=None, extra=()):
    rows = [("void tree_sweep_kernel<4, 4, float>", 1000 * i,
             1000 * i + sweep_ns) for i in range(units)] + list(extra)
    prof = tracing.Profile(rows, [("pllbench.window", 0, 10 ** 6)], 0, 10 ** 6)
    return tracing.Trace(prof, 1e-3, units,
                         {"tree_sweep": units if launches is None
                          else launches}, {})


def test_roofline_reads_the_sweep_rows():
    m = metric("sweep_roofline.eval")
    bound = m.bound_s(config("dna_eval"), H100)
    ns = 120_000
    got = m.read(run_with(sweep_trace(ns, extra=[
        ("pmatrix_fragments_kernel", 0, 0), ("at::native::mul", 0, 5000)])))
    assert got == pytest.approx(100 * bound / (ns * 1e-9))
    # a trace that lost a sweep row gives no number, never 0
    assert m.read(run_with(sweep_trace(ns, launches=3))) is None


def test_eval_launches_and_idle():
    trace = sweep_trace(400_000, units=2, extra=[("Memcpy DtoH", 500_000,
                                                  600_000)])
    assert metric("eval_launches.eval").read(run_with(trace)) == 1.5
    idle = metric("device_idle.eval").read(run_with(trace))
    # rows at 0-400 us and 1-401 us overlap: U = 401 + 100 us of 1 ms
    assert idle == pytest.approx(100 * (1 - 501e-6 / 1e-3))


def test_percentile_and_rates():
    p95 = metric("eval_ms_p95")
    values = list(np.random.default_rng(0).random(1001))
    assert p95.percentile(values, 95) == pytest.approx(
        np.percentile(values, 95))
    run = SimpleNamespace(window_s=2.0, units=4, latencies_s=[0.001] * 4,
                          work_per_unit=10.0)
    assert metric("site_updates_per_s").read(run) == 20.0
    assert p95.read(run) == pytest.approx(1.0)
    assert metric("spr_round_s").read(run) == 0.5


def test_union_and_gaps():
    assert tracing.union_s([(0, 10), (5, 20), (30, 40)]) == 30e-9
    prof = tracing.Profile(
        [("k", 10, 20), ("k", 15, 30), ("m", 50, 60)],
        [("pllbench.window", 0, 100), ("a", 0, 40), ("b", 32, 45),
         ("pllbench.x", 46, 99), ("c", 61, 70)], 0, 100)
    assert tracing.idle_gaps(prof) == [["after c", 4e-08], ["b", 2e-08],
                                       ["a", 1e-08]]
    assert tracing.device_ops(prof) == [["k", 2.5e-08], ["m", 1e-08]]
