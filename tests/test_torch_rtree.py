"""Rooted trees and SVG export in the port against libpll2_tpu: parsing and
template indices, newick export, traversals and the operation lists,
ASCII and SVG output byte for byte, unrooting, and the pulley principle
(a rooted logL equals the unrooted one under a reversible model) through
the port's Partition."""
import numpy as np
import pytest

import libpll2_tpu as jpll
import libpll2_tpu_torch as ppll
from libpll2_tpu import tree as JT
from libpll2_tpu_torch import tree as PT

from .test_parity_tree import random_newick

NEWICK = "((t0:0.2,t1:0.3)i1:0.1,(t2:0.25,(t3:0.15,t4:0.35)i2:0.05)i3:0.4)r;"
SEQS = {"t0": "WAACAB", "t1": "CACACD", "t2": "AGGACA", "t3": "CGTAGT",
        "t4": "CATCCA"}


def random_rooted(n, seed):
    """A random rooted binary newick on n taxa with labels on inner nodes
    too, from a seed."""
    rng = np.random.default_rng(seed)
    items = [f"t{i}:{rng.uniform(0.01, 0.5):.6f}" for i in range(n)]
    k = 0
    while len(items) > 2:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        merged = f"({items[i]},{items[j]})n{k}:{rng.uniform(0.01, 0.5):.6f}"
        k += 1
        items = [x for m, x in enumerate(items) if m not in (i, j)]
        items.append(merged)
    return f"({items[0]},{items[1]})root;"


ROOTED = {"fixed": NEWICK, "random12": random_rooted(12, 1),
          "random40": random_rooted(40, 2)}

NODE_FIELDS = ("label", "length", "node_index", "clv_index", "scaler_index",
               "pmatrix_index")


def op_tuple(op):
    return tuple(vars(op).values())


@pytest.mark.parametrize("name", sorted(ROOTED))
def test_parse_indices_and_export(name):
    text = ROOTED[name]
    rj, rp = JT.parse_rtree_string(text), PT.parse_rtree_string(text)
    assert (rp.tip_count, rp.inner_count, rp.edge_count) == \
        (rj.tip_count, rj.inner_count, rj.edge_count)
    for a, b in zip(rp.nodes, rj.nodes):
        assert [getattr(a, f) for f in NODE_FIELDS] == \
            [getattr(b, f) for f in NODE_FIELDS]
    out = PT.export_rtree_newick(rp.root)
    assert out == JT.export_rtree_newick(rj.root)
    assert PT.export_rtree_newick(rp.root, with_lengths=False) == \
        JT.export_rtree_newick(rj.root, with_lengths=False)
    again = PT.parse_rtree_string(out)
    assert [n.label for n in again.nodes] == [n.label for n in rp.nodes]
    np.testing.assert_allclose([n.length for n in again.nodes[:-1]],
                               [n.length for n in rp.nodes[:-1]], rtol=1e-6)


@pytest.mark.parametrize("name", sorted(ROOTED))
def test_traversals_and_operations(name):
    rj, rp = (JT.parse_rtree_string(ROOTED[name]),
              PT.parse_rtree_string(ROOTED[name]))
    for order in (ppll.constants.TRAVERSE_POSTORDER,
                  ppll.constants.TRAVERSE_PREORDER):
        tj, tp = JT.rtree_traverse(rj.root, order), \
            PT.rtree_traverse(rp.root, order)
        assert [n.clv_index for n in tp] == [n.clv_index for n in tj]
    tj, tp = JT.rtree_traverse(rj.root), PT.rtree_traverse(rp.root)
    (oj, bj, mj), (op, bp, mp) = (JT.rtree_create_operations(tj),
                                  PT.rtree_create_operations(tp))
    assert [op_tuple(o) for o in op] == [op_tuple(o) for o in oj]
    assert (bp, mp) == (bj, mj)
    assert [op_tuple(o) for o in PT.rtree_create_pars_buildops(tp)] == \
        [op_tuple(o) for o in JT.rtree_create_pars_buildops(tj)]
    pre_j = JT.rtree_traverse(rj.root, ppll.constants.TRAVERSE_PREORDER)
    pre_p = PT.rtree_traverse(rp.root, ppll.constants.TRAVERSE_PREORDER)
    assert [op_tuple(o) for o in PT.rtree_create_pars_recops(pre_p)] == \
        [op_tuple(o) for o in JT.rtree_create_pars_recops(pre_j)]
    for options in (0b11, 0b11111):
        assert PT.show_ascii_rtree(rp.root, options) == \
            JT.show_ascii_rtree(rj.root, options)
    uj, up = JT.rtree_to_utree(rj), PT.rtree_to_utree(rp)
    assert PT.check_integrity(up)
    assert PT.export_newick(up.vroot) == JT.export_newick(uj.vroot)


def rooted_logl(pkg, T, text, seqs):
    rt = T.parse_rtree_string(text)
    ops, branches, pmat_idx = T.rtree_create_operations(
        T.rtree_traverse(rt.root))
    sites = len(next(iter(seqs.values())))
    kw = {"device": "cpu"} if pkg is ppll else {}
    p = pkg.Partition(rt.tip_count, rt.inner_count, 4, sites, 1,
                      max(pmat_idx) + 1, 4, rt.inner_count, **kw)
    p.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for n in rt.nodes[:rt.tip_count]:
        p.set_tip_states(n.clv_index, pkg.MAP_NT, seqs[n.label])
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    p.update_partials(ops)
    return p.compute_root_loglikelihood(rt.root.clv_index,
                                        rt.root.scaler_index, [0] * 4,
                                        return_persite=True)


def unrooted_logl(text, seqs):
    ut = PT.rtree_to_utree(PT.parse_rtree_string(text))
    ops, branches, pmat_idx = PT.create_operations(PT.traverse(ut.vroot))
    n = ut.tip_count
    p = ppll.Partition(n, ut.inner_count, 4, len(next(iter(seqs.values()))),
                       1, 2 * n - 3, 4, ut.inner_count, device="cpu")
    p.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.8)
    for node in ut.nodes[:n]:
        p.set_tip_states(node.clv_index, ppll.MAP_NT, seqs[node.label])
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    p.update_partials(ops)
    r = ut.vroot
    return p.compute_edge_loglikelihood(r.clv_index, r.scaler_index,
                                        r.back.clv_index,
                                        r.back.scaler_index,
                                        r.pmatrix_index, [0] * 4)


@pytest.mark.parametrize("name", ["fixed", "random40"])
def test_rooted_logl_and_pulley_principle(name):
    """The rooted logL equals the JAX package's, and equals the unrooted
    logL of the unrooted tree (GTR is time-reversible)."""
    text = ROOTED[name]
    if name == "fixed":
        seqs = SEQS
    else:
        rng = np.random.default_rng(40)
        seqs = {f"t{i}": "".join("ACGT"[b] for b in rng.integers(0, 4, 50))
                for i in range(40)}
    got, persite = rooted_logl(ppll, PT, text, seqs)
    want, persite_j = rooted_logl(jpll, JT, text, seqs)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(persite, persite_j, rtol=1e-10)
    np.testing.assert_allclose(unrooted_logl(text, seqs), got, rtol=1e-10)


SVG_ATTRIBS = {
    "default": {},
    "no_legend": {"legend_show": 0, "width": 800, "node_radius": 3},
    "precision": {"precision": 3, "font_size": 9, "tip_spacing": 14,
                  "legend_ratio": 0.25},
}


@pytest.mark.parametrize("attrib", sorted(SVG_ATTRIBS))
@pytest.mark.parametrize("tips", [5, 24])
def test_export_svg_byte_equal(attrib, tips, tmp_path):
    newick = random_newick(tips, np.random.default_rng(tips))
    tj, tp = JT.parse_newick_string(newick), PT.parse_newick_string(newick)
    aj = JT.SvgAttrib(**SVG_ATTRIBS[attrib])
    ap = PT.SvgAttrib(**SVG_ATTRIBS[attrib])
    got = PT.export_svg(tp, attr=ap)
    assert got == JT.export_svg(tj, attr=aj)
    assert got.startswith("<svg") and got.endswith("</svg>\n")
    path = tmp_path / "tree.svg"
    assert PT.export_svg(tp, attr=ap, filename=str(path)) is None
    assert path.read_text() == got
