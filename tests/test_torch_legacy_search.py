"""The port's legacy SPR round (legacy_search.ml_spr_round) against
libpll2_tpu.legacy_search on the CPU at f64: tests/test_search.py's case
(8 taxa, 300 sites simulated under GTR+Gamma(0.9), a scrambled start
tree) goes through both packages round by round.  Each round must return
the same topology (the same newick), the same `improved` flag and a logL
within 1e-9 (relative): the same formulas in f64, summed in another
order.  Three rounds, each applying a move, are compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import legacy_search as jsearch
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu_torch import engine, legacy_search
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig

from .test_parity_tree import random_newick
from .test_search import FREQS, SUBST, simulate

RTOL = 1e-9


def search_case():
    """tests/test_search.py::test_ml_spr_round_improves's inputs."""
    rng = np.random.default_rng(17)
    sites = 300
    rates = pll.compute_gamma_cats(0.9, 4)
    true_tree = jtree.parse_newick_string(random_newick(8, rng))
    seqs = simulate(true_tree, sites, rng, rates)
    chars = {lab: (1 << s.astype(np.uint64)) for lab, s in seqs.items()}
    labels = sorted(seqs)
    start = jtree.parse_newick_string(
        random_newick(8, np.random.default_rng(99)))
    relabel = dict(zip(sorted(n.label for n in start.nodes[:8]), labels))
    for n in start.nodes[:8]:
        n.label = relabel[n.label]
    return jtree.export_newick(start.vroot, precision=None), chars, rates, \
        sites


@pytest.fixture(scope="module")
def rounds():
    """Up to 3 rounds in each package from the same start: [(jax newick,
    jax logL, jax improved, port newick, port logL, port improved)].  (The
    JAX package compiles each remainder's program anew, about 12 s a round
    on the CPU.)"""
    newick, chars, rates, sites = search_case()
    jt = jtree.parse_newick_string(newick)
    pt = T.parse_newick_string(newick)
    common = dict(tips=8, clv_buffers=pt.inner_count, states=4, sites=sites,
                  rate_matrices=1, prob_matrices=13, rate_cats=4,
                  scale_buffers=pt.inner_count)
    jcfg = JConfig(**common, dtype=jnp.float64)
    pcfg = PartitionConfig(**common, dtype=torch.float64)
    jmodel = jengine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64)
    pmodel = engine.make_model([SUBST], [FREQS], rates, dtype=torch.float64,
                               device="cpu")
    out = []
    for _ in range(3):
        jt, jl, ji = jsearch.ml_spr_round(jt, jcfg, jmodel, chars)
        pt, pl, pi = legacy_search.ml_spr_round(pt, pcfg, pmodel, chars)
        out.append((jtree.export_newick(jt.vroot, precision=None), jl, ji,
                    T.export_newick(pt.vroot, precision=None), pl, pi))
        if not ji:
            break
    return out


def test_rounds_take_the_same_moves(rounds):
    assert len(rounds) >= 2
    for jn, _, ji, pn, _, pi in rounds:
        assert pi == ji
        assert T.rf_distance(T.parse_newick_string(pn),
                             T.parse_newick_string(jn)) == 0
    assert rounds[-1][2] == 0 or len(rounds) == 3


def test_rounds_logl_equal(rounds):
    for _, jl, _, _, pl, _ in rounds:
        assert pl == pytest.approx(jl, rel=RTOL)
    logls = [r[4] for r in rounds]
    for a, b in zip(logls, logls[1:]):
        assert b >= a - 1e-9


def test_same_topology_and_lengths(rounds):
    """The newick of every round, lengths included, within 1e-9."""
    for jn, _, _, pn, _, _ in rounds:
        jt, pt = jtree.parse_newick_string(jn), T.parse_newick_string(pn)
        assert T.rf_distance(pt, T.parse_newick_string(jn)) == 0
        jl = sorted(n.length for n in jt.nodes)
        pl = sorted(n.length for n in pt.nodes)
        np.testing.assert_allclose(pl, jl, rtol=RTOL)


def test_max_subtree_tips_and_tip_prunes():
    """max_subtree_tips=1 prunes tips only, in both packages alike."""
    newick, chars, rates, sites = search_case()
    common = dict(tips=8, clv_buffers=6, states=4, sites=sites,
                  rate_matrices=1, prob_matrices=13, rate_cats=4,
                  scale_buffers=6)
    jt, jl, ji = jsearch.ml_spr_round(
        jtree.parse_newick_string(newick), JConfig(**common,
                                                   dtype=jnp.float64),
        jengine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64),
        chars, max_subtree_tips=1)
    pt, pl, pi = legacy_search.ml_spr_round(
        T.parse_newick_string(newick),
        PartitionConfig(**common, dtype=torch.float64),
        engine.make_model([SUBST], [FREQS], rates, dtype=torch.float64,
                          device="cpu"),
        chars, max_subtree_tips=1)
    assert pi == ji
    assert pl == pytest.approx(jl, rel=RTOL)
    assert T.rf_distance(pt, T.parse_newick_string(
        jtree.export_newick(jt.vroot, precision=None))) == 0
