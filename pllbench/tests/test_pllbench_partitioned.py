"""The partitioned evaluation loop (protein_partitioned_eval) and the
smoothing loop (dna_smooth) at sizes a CPU test can hold: runs through
run.execute that come out correct, and faults planted in the program's
timed path that turn `correct` false (two partitions' models swapped,
padding columns given weight, smoothing that returns its start lengths);
inputs fixed by the seed; the partitioned reference against the
single-partition one; the new metrics' arithmetic."""
import importlib.util
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pllbench import inputs, run, tracing
from pllbench.drivers import partitioned_eval_loop, smooth_loop
from pllbench.reference import likelihood, newick, partitioned

from . import tiny

SIZES = {"protein_partitioned_eval": dict(tips=10, partition_sites=[
             60, 45, 130, 51], sites=286),
         "dna_smooth": dict(tips=12, sites=128)}
TRAFFIC = {"protein_partitioned_eval": {"warmup_calls": 2, "trace_calls": 2},
           "dna_smooth": {"warmup_calls": 1, "trace_calls": 2,
                          "check_sample": 4, "check_batch": 4}}
CPU = torch.device("cpu")


def cell(workload):
    """(cell, config, traffic, limits, e2e, layer) at a test size."""
    torch.set_num_threads(1)
    cell_, config, traffic, limits, e2e, layer = run.load_cell(tiny.ROOT,
                                                               workload)
    return (cell_, dict(config, **SIZES[workload]),
            dict(traffic, **TRAFFIC[workload]), limits, e2e, layer)


def execute(workload, seconds=0.5, trace=False):
    torch.set_num_threads(1)
    return run.execute(*cell(workload), tiny.SEED, seconds, trace, CPU)


def swapped(real):
    """multipartition.loglikelihood with partitions 0 and 1's models
    swapped."""
    def call(mp, models, *args, **kw):
        models = list(models)
        models[0], models[1] = models[1], models[0]
        return real(mp, models, *args, **kw)
    return call


def padding_weighed(real):
    """multipartition.loglikelihood with every padding column weight 1."""
    def call(mp, models, bl, tips, weights, *args, **kw):
        weights = [torch.ones_like(w) for w in weights]
        return real(mp, models, bl, tips, weights, *args, **kw)
    return call


def start_lengths(real):
    """engine.optimize_branch_lengths that returns its start lengths (and
    the logL there)."""
    def call(*args, **kw):
        return real(*args, **dict(kw, rounds=0))
    return call


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("workload", list(SIZES))
def test_runs_are_correct(workload, trace):
    result = execute(workload, 0.5, trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    if not trace:
        assert {"site_updates_per_s", "eval_ms_p95", "setup_s"} <= \
            set(result["metrics"])
    elif workload == "protein_partitioned_eval":
        # the program counts its padding on the CPU too
        assert 0 < result["metrics"]["multi_pad_share.multi"]["value"] < 100


@pytest.mark.parametrize("fault", ["swapped", "padding"])
def test_partitioned_faults(monkeypatch, fault):
    from libpll2_tpu_torch import multipartition
    wrap = {"swapped": swapped, "padding": padding_weighed}[fault]
    monkeypatch.setattr(multipartition, "loglikelihood",
                        wrap(multipartition.loglikelihood))
    result = execute("protein_partitioned_eval", 0.3)
    assert result["correct"] is False, result["checks"]
    gap = result["checks"]["logl_rel_gap"]
    assert gap["value"] > 10 * gap["limit"], result["checks"]


def test_smoothing_that_returns_its_start_fails(monkeypatch):
    from libpll2_tpu_torch import engine
    monkeypatch.setattr(engine, "optimize_branch_lengths",
                        start_lengths(engine.optimize_branch_lengths))
    result = execute("dna_smooth", 0.3)
    checks = result["checks"]
    assert result["correct"] is False, checks
    # the logL it reports is right at the lengths it returns: only the
    # gain shows the fault
    assert checks["logl_rel_gap"]["value"] <= checks["logl_rel_gap"]["limit"]
    assert checks["logl_gain"]["value"] == 0.0


def test_partitioned_inputs_are_fixed_by_the_seed():
    _, config, traffic, *_ = cell("protein_partitioned_eval")
    a = partitioned_eval_loop.Driver(config, traffic, tiny.SEED, CPU)
    b = partitioned_eval_loop.Driver(config, traffic, tiny.SEED, CPU)
    c = partitioned_eval_loop.Driver(config, traffic, tiny.SEED + 1, CPU)
    assert torch.equal(a.bank, b.bank) and not torch.equal(a.bank, c.bank)
    assert all(np.array_equal(a.chars[k], b.chars[k]) for k in a.chars)
    assert any(not np.array_equal(a.chars[k], c.chars[k]) for k in a.chars)
    assert all(torch.equal(x, y) for x, y in zip(a.tipchars, b.tipchars))
    assert a.work_per_unit == (10 - 2) * 286
    # padding repeats the partition's first columns with weight 0
    cfg = a.program.cfgs[0]
    assert torch.equal(a.tipchars[0][:, cfg.sites:],
                       a.tipchars[0][:, :cfg.sites_padded - cfg.sites])
    assert float(a.pattern_weights[0][cfg.sites:].sum()) == 0.0


def test_models_follow_the_configuration():
    config = run.load_cell(tiny.ROOT, "protein_partitioned_eval")[1]
    models = partitioned_eval_loop.draw_models(config)
    assert models == partitioned_eval_loop.draw_models(config)
    assert len(models) == len(config["partition_sites"]) == 1478
    assert sum(config["partition_sites"]) == config["sites"] == 413459
    assert min(config["partition_sites"]) >= 50
    p = config["partition_model"]
    alphas = [m.alpha for m in models]
    scalers = [m.scaler for m in models]
    assert p["alpha"][0] <= min(alphas) and max(alphas) <= p["alpha"][1]
    assert p["scaler"][0] <= min(scalers) and max(scalers) <= p["scaler"][1]
    assert all(abs(sum(m.freqs) - 1) < 1e-12 and min(m.freqs) > 0
               for m in models)
    assert all(m.subst == config["model"]["subst"] for m in models)


def test_smooth_inputs_are_fixed_by_the_seed():
    _, config, traffic, *_ = cell("dna_smooth")
    a = smooth_loop.Driver(config, traffic, tiny.SEED, CPU)
    b = smooth_loop.Driver(config, traffic, tiny.SEED, CPU)
    assert torch.equal(a.bank, b.bank) and torch.equal(a.tipchars, b.tipchars)
    ratio = (a.bank.double() / torch.as_tensor(
        a.program.default_branch_lengths)).numpy()
    lo, hi = traffic["scale"]
    assert ratio.min() >= lo * (1 - 1e-6) and ratio.max() <= hi * (1 + 1e-6)
    full = a.program
    assert a.work_per_unit == (traffic["rounds"] * full.n_colors + 1) * \
        3 * (12 - 2) * 128


@pytest.mark.parametrize("precision", ["f64", "tf32"])
def test_partitioned_reference_sums_the_single_one(precision):
    """Partitions of mixed state counts and lengths in blocks of a few
    hundred sites against reference/likelihood.py on each partition alone
    at t * s_k: the same pruning, so equal up to the control's own
    rounding."""
    rng = np.random.default_rng(4)
    tree = newick.parse(inputs.random_newick(9, rng, 0.02, 0.35))
    specs = [(20, 37), (4, 120), (20, 64), (4, 80), (5, 50)]
    bounds = np.concatenate([[0], np.cumsum([n for _, n in specs])])
    models = [partitioned.PartitionModel(
        rng.uniform(0.3, 3, s * (s - 1) // 2).tolist(),
        rng.dirichlet(np.full(s, 5.0)).tolist(), rng.uniform(0.3, 1.5),
        rng.uniform(0.5, 2.0)) for s, _ in specs]
    chars = {}
    for (s, n), m in zip(specs, models):
        for tip in tree.tips:
            chars.setdefault(tip.label, []).append(
                np.uint64(1) << rng.integers(0, s, n).astype(np.uint64))
    chars = {k: np.concatenate(v) for k, v in chars.items()}
    lengths = np.asarray(tree.lengths)[None] * np.array([[1.0], [0.7]])
    got = partitioned.partition_loglikelihoods(
        tree, lengths, chars, bounds, models, 4, precision=precision,
        block_sites=130)
    want = np.stack([likelihood.loglikelihood(
        tree, lengths * m.scaler,
        {k: v[bounds[i]:bounds[i + 1]] for k, v in chars.items()},
        m.subst, m.freqs, m.alpha, 4, precision=precision)
        for i, m in enumerate(models)], axis=1)
    rtol = 0 if precision == "f64" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert [sorted(b.tolist()) for b in partitioned.blocks(
        [n for _, n in specs], [s for s, _ in specs], 130)] == \
        [[3], [1], [4], [0, 2]]


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        tiny.ROOT / "pllbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


H100 = json.loads((tiny.ROOT / "pllbench" / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


def test_multi_roofline_count():
    m = metric("multi_sweep_roofline.multi")
    config = run.load_cell(tiny.ROOT, "protein_partitioned_eval")[1]
    flop, nbytes = m.work(config)
    assert flop == 413459 * 4 * (142 * 20 + 140 * 2 * 400)
    assert nbytes == 4 * (144 * 413459 + 1478 * 285 * 4 * 400
                          + 2 * 4 * 20 * 413459)
    # the P-matrices' bytes set the bound
    assert m.bound_s(config, H100) == pytest.approx(nbytes / 3.35e12)
    rows = [("void tree_sweep_kernel<20, 4, float>", 0, 60_000_000),
            ("void tree_sweep_kernel<20, 4, float>", 10 ** 8, 10 ** 8 +
             60_000_000), ("elementwise", 0, 10)]
    prof = tracing.Profile(rows, [], 0, 2 * 10 ** 8)
    trace = tracing.Trace(prof, 0.2, 2, {"tree_sweep": 2}, {})
    runs = SimpleNamespace(config=config, trace=trace, peaks=H100)
    assert m.read(runs) == pytest.approx(100 * m.bound_s(config, H100)
                                         / 0.06)
    assert metric("eval_launches.eval").read(runs) == 1.5
    # a trace that lost a sweep row gives no number, never 0
    trace.launches["tree_sweep"] = 3
    assert m.read(runs) is None
    assert metric("eval_launches.eval").read(runs) is None


def test_multi_pad_share_reader(monkeypatch):
    from libpll2_tpu_torch import multipartition
    read = metric("multi_pad_share.multi").read
    fn = multipartition.loglikelihood
    monkeypatch.setattr(fn, "real_columns", 300)
    monkeypatch.setattr(fn, "pad_columns", 100)
    assert read(None) == pytest.approx(25.0)
    monkeypatch.setattr(fn, "real_columns", 0)
    monkeypatch.setattr(fn, "pad_columns", 0)
    assert read(None) is None
    monkeypatch.delattr(fn, "pad_columns")
    assert read(None) is None


def test_multi_graph_share_reader(monkeypatch):
    from libpll2_tpu_torch import multipartition
    read = metric("multi_graph_share.multi").read
    fn = multipartition.loglikelihood
    for name, n in (("graph_replays", 6), ("graph_captures", 1),
                    ("eager_calls", 1)):
        monkeypatch.setattr(fn, name, n)
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(fn, "graph_replays", 0)
    monkeypatch.setattr(fn, "graph_captures", 0)
    monkeypatch.setattr(fn, "eager_calls", 0)
    assert read(None) is None
    monkeypatch.delattr(fn, "graph_replays")
    assert read(None) is None


def test_smoothing_message_sweep_reader(monkeypatch):
    """message_sweep_ms.smooth reads the program's message-sweep spans as
    message_sweep_ms.search does, and nothing without a trace."""
    from pllbench import program_spans
    seen = []
    monkeypatch.setattr(program_spans, "stream_ms",
                        lambda run, name: seen.append(name) or 2.5)
    assert metric("message_sweep_ms.smooth").read(None) == 2.5
    assert seen == ["libpll2.message_sweep"]
    monkeypatch.undo()
    assert metric("message_sweep_ms.smooth").read(
        SimpleNamespace(trace=None)) is None
