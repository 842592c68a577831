"""Weighted (Sankoff) parsimony scoring + ancestral reconstruction.

Mirror of the reference's examples/parsimony/parsimony.c: arbitrary
score matrix, per-node scores, and ancestral state strings on a rooted
topology.
"""
import numpy as np

import libpll2_tpu_torch as pll
from libpll2_tpu_torch import tree as T

from . import _common

NEWICK = "((t0:0.1,t1:0.1):0.1,(t2:0.1,t3:0.1):0.1);"
SEQS = ["ACGTTACG", "ACGTTGCG", "TCGTTACA", "TCGATACG"]


def main(argv=None) -> None:
    _, device, _ = _common.setup(_common.parser(__doc__), argv)
    rt = T.parse_rtree_string(NEWICK)
    trav = T.rtree_traverse(rt.root)
    build_ops = T.rtree_create_pars_buildops(trav)
    pre = T.rtree_traverse(rt.root, order=pll.constants.TRAVERSE_PREORDER)
    rec_ops = T.rtree_create_pars_recops(pre)

    score_matrix = 1.0 - np.eye(4)          # unit-cost (Fitch-equivalent)
    pars = pll.Parsimony(tips=4, states=4, sites=8,
                         score_matrix=score_matrix, score_buffers=3,
                         ancestral_buffers=3, device=device)
    for i, s in enumerate(SEQS):
        pars.set_tip_states(i, pll.MAP_NT, s)

    score = pars.build(build_ops)
    print(f"Parsimony score: {score:.0f}")

    pars.reconstruct(pll.MAP_NT, rec_ops)
    for op in rec_ops:
        print(f"Ancestral node {op.node_ancestral_index}: "
              f"{pars.get_ancestral(op.node_ancestral_index)}")


if __name__ == "__main__":
    main()
