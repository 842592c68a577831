"""The reference against definitions and against the program's dense
float64 path on the CPU."""
import math

import numpy as np
import pytest
import torch

from pllbench import inputs
from pllbench.reference import likelihood, model, newick

DNA = dict(subst=[1.2, 2.7, 0.8, 1.1, 3.0, 1.0],
           freqs=[0.28, 0.24, 0.22, 0.26], alpha=0.9)


@pytest.mark.parametrize("alpha", [0.3, 0.9, 1.0, 2.5])
@pytest.mark.parametrize("k", [4, 8])
def test_gamma_rates_against_scipy(alpha, k):
    special = pytest.importorskip("scipy.special")
    borders = [0.0] + [special.gammaincinv(alpha, i / k) for i in range(1, k)]
    upper = [special.gammainc(alpha + 1, x) for x in borders] + [1.0]
    want = [k * (upper[i + 1] - upper[i]) for i in range(k)]
    got = model.gamma_rates(alpha, k)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert math.isclose(got.mean(), 1.0, rel_tol=1e-12)


def test_pmatrices_are_stochastic_and_reversible():
    values, left, right = model.eigensystem(DNA["subst"], DNA["freqs"])
    p = model.pmatrices(values, left, right, [[0.0, 0.1, 2.0]], [0.5, 1.5])
    np.testing.assert_allclose(p[0, 0, 0], np.eye(4), atol=1e-14)
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-13)
    pi = np.asarray(DNA["freqs"])
    flow = pi[:, None] * p[0, 1, 1]
    np.testing.assert_allclose(flow, flow.T, atol=1e-15)
    q = left @ np.diag(values) @ right
    assert math.isclose(-(pi * np.diag(q)).sum(), 1.0, rel_tol=1e-13)


def test_tf32_round():
    x = torch.randn(10000, dtype=torch.float32) * 100
    y = likelihood.tf32_round(x)
    assert torch.equal(likelihood.tf32_round(y), y)
    assert bool(((y.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0 ** -11


def test_newick_roundtrip_and_splits():
    text = inputs.random_newick(9, inputs.rng(3, 0))
    tree = newick.parse(text)
    assert len(tree.lengths) == 2 * 9 - 3 and len(tree.tips) == 9
    again = newick.parse(newick.write(tree, tree.lengths))
    assert again.lengths == tree.lengths
    assert newick.splits(again) == newick.splits(tree)
    assert len(newick.splits(tree)) == 9 - 3


def port_logl(text, chars, config_model, lengths_rows):
    """The program's dense float64 logL for each row of lengths (newick
    edge order)."""
    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats

    ref_tree = newick.parse(text)
    tree = T.parse_newick_string(text)
    n, sites = tree.tip_count, len(next(iter(chars.values())))
    states = len(config_model["freqs"])
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=states, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=torch.float64, use_kernel=False)
    prog = engine.compile_tree(tree, cfg)
    probe = engine.compile_tree(T.parse_newick_string(newick.write(
        ref_tree, [float(k + 1) for k in range(len(ref_tree.lengths))])), cfg)
    perm = np.rint(probe.default_branch_lengths).astype(int) - 1
    m = engine.make_model([config_model["subst"]], [config_model["freqs"]],
                          compute_gamma_cats(config_model["alpha"], 4),
                          device="cpu")
    codes = np.zeros((n, sites), np.uint64)
    for node in tree.nodes[:n]:
        codes[node.clv_index] = chars[node.label]
    tip = torch.as_tensor(engine.pad_tipchars(codes, cfg))
    pw = torch.zeros(cfg.sites_padded, dtype=torch.float64)
    pw[:sites] = 1.0
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32)
    return np.array([float(engine.loglikelihood(
        prog, cfg, m, torch.as_tensor(np.asarray(row)[perm]), tip, pw, inv))
        for row in lengths_rows])


def lg():
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "lg_g4_protein_128x16384.json").read_text())
    return {k: cfg["model"][k] for k in ("subst", "freqs", "alpha")}


@pytest.mark.parametrize("case", ["dna_random", "dna_deep", "lg_balanced"])
def test_reference_against_port_dense_f64(case):
    gen = inputs.rng(11, 0)
    if case == "lg_balanced":
        params = lg()
        text = inputs.balanced_newick(10, 0.1)
        codes = inputs.random_tipchars(10, 96, gen, 20)
        chars = {f"t{i}": codes[i] for i in range(10)}
    else:
        params = DNA
        n, scale = (14, 1.0) if case == "dna_random" else (40, 4.0)
        text = inputs.random_newick(n, gen, 0.02 * scale, 0.35 * scale)
        tree = newick.parse(text)
        chars = inputs.simulate_alignment(
            tree, 160, gen, params["subst"], params["freqs"],
            model.gamma_rates(params["alpha"], 4))
    tree = newick.parse(text)
    rows = np.asarray(tree.lengths)[None] * np.array([[1.0], [0.8], [1.25]])
    want = port_logl(text, chars, params, rows)
    got = likelihood.loglikelihood(tree, rows, chars, params["subst"],
                                   params["freqs"], params["alpha"], 4)
    # the program's Gamma rates are libpll-2's approximations, within
    # about 1e-8 of the exact means the reference takes
    np.testing.assert_allclose(got, want, rtol=1e-8)
