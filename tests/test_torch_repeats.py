"""Site repeats in the port: its Repeats tables against libpll2_tpu's after
the same operations, the gathers of levelize_operations_repeats, the
repeats path against the port's own dense path bit for bit (repeats.c:
repeats move where CLV entries are stored, never a computed value), and a
JAX partition carried across with convert.partition_from_jax."""
import functools

import numpy as np
import pytest

import libpll2_tpu as jpll
import libpll2_tpu_torch as ppll
from libpll2_tpu import partition as jpartition
from libpll2_tpu import repeats as jrepeats
from libpll2_tpu import tree as JT
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import partition as ppartition
from libpll2_tpu_torch import repeats as prepeats
from libpll2_tpu_torch import tree as PT

from .test_parity_tree import random_newick
from .test_repeats import repetitive_seqs

TABLES = ("pernode_site_id", "pernode_id_site", "pernode_ids",
          "perscale_ids")

# name -> (tips, sites, patterns (None: random columns), caterpillar,
#          asc_bias)
ALIGNMENTS = {
    "repetitive": (14, 64, 7, False, jpll.AB_NONE),
    "random": (10, 32, None, False, jpll.AB_NONE),
    "caterpillar": (40, 48, 5, True, jpll.AB_NONE),
    "asc_lewis": (12, 64, 9, False, jpll.AB_LEWIS),
}


def alignment(name):
    tips, sites, patterns, cat, _ = ALIGNMENTS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    newick = random_newick(tips, rng, caterpillar=cat)
    if patterns is None:
        seqs = ["".join("ACGT"[b] for b in rng.integers(0, 4, sites))
                for _ in range(tips)]
    else:
        seqs = repetitive_seqs(tips, sites, patterns, rng)
    return newick, seqs


def test_first_occurrence_classes():
    keys = np.random.default_rng(5).integers(0, 9, 200)
    for a, b in zip(prepeats.first_occurrence_classes(keys),
                    jrepeats.first_occurrence_classes(keys)):
        np.testing.assert_array_equal(a, b)
    assert prepeats.REPEATS_LOOKUP_SIZE == jrepeats.REPEATS_LOOKUP_SIZE
    assert prepeats.MIN_SITES == jrepeats.MIN_SITES


@pytest.mark.parametrize("name", sorted(ALIGNMENTS))
def test_tables_and_gathers_equal_the_jax_packages(name):
    """Tip classes, then levelize_operations_repeats over the tree's
    operations: every table, the scaler -> node map and the level
    operations and gathers equal the JAX package's."""
    newick, seqs = alignment(name)
    asc = ALIGNMENTS[name][4]
    out = {}
    for pkg, T, part in ((jpll, JT, jpartition), (ppll, PT, ppartition)):
        tree = T.parse_newick_string(newick)
        kw = {"device": "cpu"} if pkg is ppll else {}
        p = pkg.Partition(tree.tip_count, tree.inner_count, 4, len(seqs[0]),
                          1, 2 * tree.tip_count - 3, 4, tree.inner_count,
                          site_repeats=True, asc_bias=asc, **kw)
        for i, s in enumerate(seqs):
            p.set_tip_states(i, pkg.MAP_NT, s)
        ops, _, _ = T.create_operations(T.traverse(tree.vroot))
        levels = part.levelize_operations_repeats(ops, p.cfg, p.repeats)
        out[pkg] = (p.repeats, levels)
    (rj, lj), (rp, lp) = out[jpll], out[ppll]
    for table in TABLES:
        np.testing.assert_array_equal(getattr(rp, table), getattr(rj, table))
    assert rp.perscale_node == rj.perscale_node
    for a, b in zip(lp, lj):
        np.testing.assert_array_equal(a, b)
    if name != "random":
        assert np.count_nonzero(rp.pernode_ids[len(seqs):]) > 0


# name -> (alignment, per_rate_scalers, dtype, branch scale)
BIT_CASES = {
    "per_site_f64": ("repetitive", False, "float64", 1.0),
    "per_rate_f64": ("repetitive", True, "float64", 1.0),
    "asc_lewis_f64": ("asc_lewis", False, "float64", 1.0),
    # f32 rescues every ~15 levels: the scaler rows are class-indexed too
    "rescue_per_site_f32": ("caterpillar", False, "float32", 20.0),
    "rescue_per_rate_f32": ("caterpillar", True, "float32", 20.0),
}


@functools.cache
def port_run(case, repeats: bool):
    import torch
    name, per_rate, dt, scale = BIT_CASES[case]
    newick, seqs = alignment(name)
    tree = PT.parse_newick_string(newick)
    n = tree.tip_count
    p = ppll.Partition(n, tree.inner_count, 4, len(seqs[0]), 1, 2 * n - 3, 4,
                       tree.inner_count, per_rate_scalers=per_rate,
                       site_repeats=repeats, asc_bias=ALIGNMENTS[name][4],
                       dtype=getattr(torch, dt), device="cpu")
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, ppll.MAP_NT, s)
    ops, branches, pmat_idx = PT.create_operations(PT.traverse(tree.vroot))
    p.update_prob_matrices([0] * 4, pmat_idx, np.asarray(branches) * scale)
    p.update_partials(ops)
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index)
    logl = p.compute_edge_loglikelihood(*edge, r.pmatrix_index, [0] * 4,
                                        return_persite=True)
    sumtable = p.update_sumtable(edge[0], edge[2], edge[1], edge[3], [0] * 4)
    derivs = p.compute_likelihood_derivatives(sumtable, float(r.length),
                                              [0] * 4)
    tip = tree.nodes[0]
    anc = [p.compute_node_ancestral(*edge, r.pmatrix_index, [0] * 4),
           p.compute_node_ancestral(tip.back.clv_index,
                                    tip.back.scaler_index, tip.clv_index,
                                    ppll.SCALE_BUFFER_NONE,
                                    tip.pmatrix_index, [0] * 4)]
    # site-indexed scaler rows of the real and phantom sites (padding
    # columns of a class-indexed row hold no site)
    scalers = [p._scaler_row(i)[..., :p.cfg.sites_alloc].cpu().numpy()
               for i in range(p.cfg.scale_buffers)]
    return p, logl, derivs, anc, scalers


@pytest.mark.parametrize("case", sorted(BIT_CASES))
def test_repeats_bit_equal_to_dense(case):
    p, (logl, persite), derivs, anc, scalers = port_run(case, True)
    _, (logl_d, persite_d), derivs_d, anc_d, scalers_d = port_run(case,
                                                                  False)
    assert np.count_nonzero(p.repeats.pernode_ids[p.cfg.tips:]) > 0
    assert np.isfinite(logl)
    assert logl == logl_d
    np.testing.assert_array_equal(persite, persite_d)
    assert derivs == derivs_d
    for a, b in zip(anc, anc_d):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(scalers, scalers_d):
        np.testing.assert_array_equal(a, b)
    if case.startswith("rescue"):
        assert max(int(s.max()) for s in scalers) > 0


@pytest.mark.parametrize("per_rate", [False, True])
def test_partition_carried_across_from_jax(per_rate):
    """A JAX partition after update_partials with repeats on, carried
    across: edge logL, derivatives and ancestral rows from the carried
    CLVs (nothing recomputed) equal the JAX package's."""
    newick, seqs = alignment("repetitive")
    tree = JT.parse_newick_string(newick)
    n = tree.tip_count
    pj = jpll.Partition(n, tree.inner_count, 4, len(seqs[0]), 1, 2 * n - 3,
                        4, tree.inner_count, site_repeats=True,
                        per_rate_scalers=per_rate)
    pj.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    pj.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    pj.set_gamma_rates(0.8)
    for i, s in enumerate(seqs):
        pj.set_tip_states(i, jpll.MAP_NT, s)
    ops, branches, pmat_idx = JT.create_operations(JT.traverse(tree.vroot))
    pj.update_prob_matrices([0] * 4, pmat_idx, branches)
    pj.update_partials(ops)
    pp = convert.partition_from_jax(convert.partition_arrays(pj), pj.cfg,
                                    device="cpu")
    assert pp.repeats_enabled()
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index)
    got, want = [], []
    for p, out in ((pp, got), (pj, want)):
        out.append(p.compute_edge_loglikelihood(
            *edge, r.pmatrix_index, [0] * 4, return_persite=True))
        st = p.update_sumtable(edge[0], edge[2], edge[1], edge[3], [0] * 4)
        out.append(p.compute_likelihood_derivatives(st, 0.13, [0] * 4))
        out.append(p.compute_node_ancestral(*edge, r.pmatrix_index,
                                            [0] * 4))
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-10)
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-10)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-8, atol=1e-12)
    for i in range(pj.cfg.num_clvs):
        assert pp.get_sites_number(i) == pj.get_sites_number(i)
        assert pp.get_clv_size(i) == pj.get_clv_size(i)
        for a, b in ((pp.get_site_id(i), pj.get_site_id(i)),
                     (pp.get_id_site(i), pj.get_id_site(i))):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
