"""The one-call inference journey of the port (infer.infer_ml_tree)
against libpll2_tpu's on the CPU at f64: the case of tests/test_infer.py
(24 taxa x 600 sites simulated down a random truth tree, rng 5, seed 7,
12 rounds, 3 of them warm-up, 120 fit steps) goes through both packages.

Tolerances: pattern count, parsimony cost, start-tree splits, search
rounds and moves, and the final topology exactly; logL and its traces at
rtol 1e-8 (f64, the same formulas summed in another order); the fitted
parameters at the bounds of
tests/test_torch_fit.py::test_fit_model_follows_jax (rtol 1e-5, atol
1e-7).  The JAX test's own assertions then hold the port's result."""
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import infer as jinfer
from libpll2_tpu import tree as JT
from libpll2_tpu.io import compress_site_patterns as j_compress
from libpll2_tpu.models.gamma import compute_gamma_cats
from libpll2_tpu.parsimony import fastparsimony_stepwise as j_stepwise
from libpll2_tpu.tree.generate import random_newick, simulate_alignment
from libpll2_tpu_torch import infer
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.io import MSA
from libpll2_tpu_torch.tree.compare import rf_distance_normalized

from .test_stepwise import canonical_splits

NT = {1: "A", 2: "C", 4: "G", 8: "T"}
KW = dict(max_rounds=12, warmup_rounds=3, fit_steps=120, radius=5, seed=7)


def infer_case():
    """tests/test_infer.py's alignment and truth tree."""
    tips, sites = 24, 600
    rng = np.random.default_rng(5)
    rates = compute_gamma_cats(0.7, 4)
    subst = [1.5, 3.0, 0.8, 1.2, 2.5, 1.0]
    freqs = [0.32, 0.18, 0.24, 0.26]
    newick = random_newick(tips, rng, min_bl=0.05, max_bl=0.4)
    codes = simulate_alignment(JT.parse_newick_string(newick), sites, rng,
                               subst, freqs, rates)
    seqs = {lab: "".join(NT[int(c)] for c in cs)
            for lab, cs in codes.items()}
    return newick, seqs


@pytest.fixture(scope="module")
def results():
    newick, seqs = infer_case()
    want = jinfer.infer_ml_tree(seqs, **KW)
    got = infer.infer_ml_tree(MSA(sorted(seqs), [seqs[k] for k in
                                                 sorted(seqs)]),
                              device="cpu", **KW)
    return newick, seqs, got, want


def test_infer_ml_tree_follows_jax(results):
    _, _, got, want = results
    s, w = got.stats, want.stats
    assert set(s) == set(w)
    for key in ("sites_raw", "sites_patterns", "parsimony_cost", "warmup",
                "search"):
        assert s[key] == w[key], key
    assert s["sites_patterns"] == 511 and s["parsimony_cost"] == 3133
    assert rf_distance_normalized(
        got.tree, T.parse_newick_string(want.newick)) == 0
    np.testing.assert_allclose(got.logl, want.logl, rtol=1e-8)
    for key in ("logl_trace", "fit_logl_trace"):
        np.testing.assert_allclose(s[key], w[key], rtol=1e-8, err_msg=key)
    np.testing.assert_allclose(s["warmup_logl"], w["warmup_logl"],
                               rtol=1e-8)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-5)
    np.testing.assert_allclose(got.frequencies, want.frequencies, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.subst_params, want.subst_params,
                               rtol=1e-5, atol=1e-7)


def test_infer_start_tree_follows_jax(results):
    """The stepwise start on the port's FastParsimony (unit pattern
    weights, as the JAX package's Partition gives it) has the JAX start's
    splits."""
    _, seqs, got, _ = results
    labels = sorted(seqs)
    patterns, _w = j_compress([seqs[k] for k in labels], pll.MAP_NT)
    part = pll.Partition(24, 22, 4, len(patterns[0]), 1, 45, 1, 22)
    for i, p in enumerate(patterns):
        part.set_tip_states(i, pll.MAP_NT, p)
    jstart, jcost = j_stepwise([pll.FastParsimony(part)], labels, KW["seed"])
    assert jcost == got.stats["parsimony_cost"]

    from libpll2_tpu_torch.parsimony import (FastParsimony,
                                             fastparsimony_stepwise)
    pstart, pcost = fastparsimony_stepwise([FastParsimony(
        tipchars=part.tipchars, weights=np.ones(len(patterns[0])), tips=24,
        states=4, sites=len(patterns[0]), device="cpu")], labels, KW["seed"])
    assert pcost == jcost
    assert canonical_splits(pstart) == canonical_splits(jstart)


def test_infer_recovers_truth(results):
    """tests/test_infer.py's assertions on the port's result."""
    newick, _, res, _ = results
    truth = T.parse_newick_string(newick)
    assert rf_distance_normalized(res.tree, truth) <= 0.15
    assert res.stats["sites_patterns"] <= res.stats["sites_raw"] == 600
    assert 0.3 < res.alpha < 2.5, res.alpha
    assert abs(res.frequencies[0] - 0.32) < 0.08
    assert int(np.argmax(res.subst_params[:5])) == 1
    tr = res.stats["logl_trace"]
    assert all(b >= a - 1e-6 for a, b in zip(tr, tr[1:]))
    assert np.isfinite(res.logl)
    assert rf_distance_normalized(T.parse_newick_string(res.newick),
                                  res.tree) == 0
    assert isinstance(res.logl, float) and isinstance(res.alpha, float)
    assert res.subst_params.dtype == res.frequencies.dtype == np.float64


def test_infer_dtype_follows_device(monkeypatch):
    """dtype=None is f64 on the CPU; the fit gets a FullTreeProgram."""
    seen = {}
    real = infer.fit.fit_model

    def fit_model(program, cfg, *args, **kw):
        seen["dtype"], seen["full"] = cfg.dtype, kw.get("full_program")
        return real(program, cfg, *args, **kw)

    monkeypatch.setattr(infer.fit, "fit_model", fit_model)
    rng = np.random.default_rng(2)
    seqs = {f"t{i}": "".join("ACGT"[b] for b in rng.integers(0, 4, 40))
            for i in range(6)}
    res = infer.infer_ml_tree(seqs, max_rounds=2, warmup_rounds=1,
                              fit_steps=2, device="cpu")
    assert seen["dtype"] == torch.float64 and seen["full"] is not None
    assert len(res.stats["fit_logl_trace"]) == 2
    with pytest.raises(ValueError):
        infer.infer_ml_tree(dict(list(seqs.items())[:3]), device="cpu")
    with pytest.raises(ValueError):
        infer.infer_ml_tree(seqs, states=3, device="cpu")
