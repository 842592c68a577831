"""The codon cell (codon_eval): its configuration regenerated from the
stated kappa, omega and F3x4 table by the program's builder and by the
reference's, the two metrics it adds (wide_sweep_roofline.codon and
wide_kernel_share.codon) on a synthetic trace and the program's counters,
None without them, and planted faults at 61 states on a CPU test's size
turning `correct` false."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pllbench import faults, run, tracing
from pllbench.reference import codon as ref_codon

from . import tiny
from .test_pllbench_metrics import H100, metric

WORKLOAD = "codon_eval"
SIZE = (8, 48)                   # taxa, codons: a CPU test's size
TRAFFIC = {"warmup_calls": 2, "trace_calls": 3, "check_sample": 4}


def config():
    return run.load_cell(tiny.ROOT, WORKLOAD)[1]


def test_configuration_regenerates():
    """subst and freqs of the file are what both builders make of the
    stated parameters (exchangeabilities exactly, frequencies within
    1e-15: sums in another order)."""
    from libpll2_tpu_torch.models import codon
    m = config()["model"]
    spec = m["codon"]
    assert m["states"] == 61 and len(m["subst"]) == 61 * 60 // 2
    for build in (codon.gy94_exchangeabilities, ref_codon.gy94):
        assert np.array_equal(m["subst"], build(spec["kappa"],
                                                spec["omega"]))
    for build in (codon.f3x4_frequencies, ref_codon.f3x4):
        np.testing.assert_allclose(m["freqs"], build(spec["f3x4"]),
                                   rtol=1e-15, atol=0)
    assert config()["reduced"] == []


def test_roofline_count():
    m = metric("wide_sweep_roofline.codon")
    flop, nbytes = m.work(config())
    assert flop == 16384 * 4 * (126 * 61 + 124 * 2 * 61 * 61)
    assert flop == pytest.approx(6.098e10, rel=1e-3)
    assert nbytes == 8 * 128 * 16384 + 4 * (253 * 4 * 61 * 61
                                            + 2 * 4 * 61 * 16384)
    assert m.bound_s(config(), H100) == pytest.approx(flop / 495e12)


def wide_trace(sweep_ns, units=2, launches=None):
    rows = [("void (anonymous namespace)::tree_sweep_wide_kernel(...)",
             10 ** 4 * i, 10 ** 4 * i + sweep_ns) for i in range(units)]
    rows += [("void (anonymous namespace)::wide_pmatrix_kernel(...)",
              10 ** 4 * i + sweep_ns, 10 ** 4 * i + sweep_ns + 500)
             for i in range(units)]
    rows += [("at::native::mul", 0, 5000)]
    prof = tracing.Profile(rows, [("pllbench.window", 0, 10 ** 7)], 0,
                           10 ** 7)
    return tracing.Trace(prof, 1e-2, units,
                         {"tree_sweep": units if launches is None
                          else launches}, {})


def run_with(trace):
    return SimpleNamespace(config=config(), trace=trace, peaks=H100,
                           window_s=None, units=trace.units, latencies_s=[])


def test_roofline_reads_the_wide_rows():
    m = metric("wide_sweep_roofline.codon")
    bound = m.bound_s(config(), H100)
    ns = 2_500_000
    got = m.read(run_with(wide_trace(ns)))
    assert got == pytest.approx(100 * bound / ((ns + 500) * 1e-9))
    # a trace whose sweep rows do not match the launches gives no number
    assert m.read(run_with(wide_trace(ns, launches=3))) is None
    assert m.read(SimpleNamespace(config=config(), trace=None,
                                  peaks=H100)) is None
    # a trace of another sweep form (no wide rows) gives none either
    other = tracing.Trace(tracing.Profile(
        [("void tree_sweep_kernel<20, 4, float>", 0, 10)], [], 0, 10),
        1e-3, 1, {"tree_sweep": 1}, {})
    assert m.read(run_with(other)) is None


def test_share_arithmetic(monkeypatch):
    from libpll2_tpu_torch.ops import partials_tree
    read = metric("wide_kernel_share.codon").read
    monkeypatch.setitem(partials_tree.sweep.launches_by_mode, "wide", 30)
    monkeypatch.setattr(partials_tree.sweep, "wide_dense_calls", 10)
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(partials_tree.sweep, "wide_dense_calls", 0)
    assert read(None) == pytest.approx(100.0)
    monkeypatch.setitem(partials_tree.sweep.launches_by_mode, "wide", 0)
    assert read(None) is None            # nothing swept above 32 states


def test_readers_without_the_program_parts(monkeypatch):
    """A program from before the wide form (no counters on the sweep)
    reads None on both metrics, and raises nothing."""
    from libpll2_tpu_torch.ops import partials_tree
    share = metric("wide_kernel_share.codon").read
    roof = metric("wide_sweep_roofline.codon").read
    monkeypatch.delitem(partials_tree.sweep.launches_by_mode, "wide")
    monkeypatch.delattr(partials_tree.sweep, "wide_dense_calls")
    assert share(None) is None
    assert roof(run_with(wide_trace(2_500_000))) is None
    monkeypatch.setitem(sys.modules, "libpll2_tpu_torch.ops.partials_tree",
                        None)
    monkeypatch.delattr(sys.modules["libpll2_tpu_torch.ops"],
                        "partials_tree")
    assert share(None) is None
    assert roof(run_with(wide_trace(2_500_000))) is None


def execute(trace=False, seed=tiny.SEED):
    torch.set_num_threads(1)
    cell, cfg, traffic, limits, e2e, layer = run.load_cell(tiny.ROOT,
                                                           WORKLOAD)
    cfg = dict(cfg, tips=SIZE[0], sites=SIZE[1])
    traffic = dict(traffic, **TRAFFIC)
    return run.execute(cell, cfg, traffic, limits, e2e, layer, seed, 0.3,
                       trace, torch.device("cpu"))


def test_cell_runs_correct_on_the_cpu():
    """The cell at a CPU test's size, on the program's plain paths: correct,
    its end-to-end metrics, and in a traced run the share of the dense
    path (0 wide launches on the CPU)."""
    out = execute()
    assert out["correct"], out["checks"]
    assert {"site_updates_per_s", "eval_ms_p95", "setup_s"} <= set(
        out["metrics"])
    assert out["checks"]["logl_rel_gap"]["value"] < 1e-6
    traced = execute(trace=True)
    assert traced["correct"]
    assert traced["metrics"]["wide_kernel_share.codon"]["value"] == 0.0


def truncated_tips():
    """The masks cut to their low 32 bits, as an int32-only path would
    hold them: states 32-60 vanish from the tips."""
    from libpll2_tpu_torch import engine
    real = engine.pad_tipchars

    def pad(tipchars, cfg):
        out = real(tipchars, cfg)
        return out & np.int64(0xFFFFFFFF) if out.dtype == np.int64 else out
    return [(engine, "pad_tipchars", pad)]


@pytest.mark.parametrize("fault", ["altered", "truncated_tips"])
def test_planted_faults_fail_the_check(monkeypatch, fault):
    plants = truncated_tips() if fault == "truncated_tips" else \
        faults.plant(fault, "eval_loop")
    for owner, name, value in plants:
        monkeypatch.setattr(owner, name, value)
    out = execute()
    assert not out["correct"], out["checks"]
