"""Partial traversals: recompute only invalidated CLVs between logL calls.

Mirror of the reference's examples/partial-traversal (partial.c:60-463):
each inner node carries a clv_valid flag per round-about direction; a
pruned traversal (T.traverse with a callback) descends only into
subtrees whose CLV toward the chosen virtual root is stale, so after the
first full sweep each logL evaluation recomputes a handful of CLVs
instead of all of them.  Ten random inner nodes are evaluated in turn;
every evaluation must produce the SAME log-likelihood (the tree and
model never change — only the direction of evaluation does).
"""
import numpy as np

import libpll2_tpu_torch as pll
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.tree.generate import balanced_newick, random_tipchars
from libpll2_tpu_torch.utils.random import GlibcRandom

from . import _common

TIPS = 8
SITES = 40
NT = "ACGT"


def cb_partial_traversal(node: T.UNode) -> bool:
    """partial.c:60-103 — descend iff this direction's CLV is stale.

    The per-direction clv_valid flag lives in each half-node's `data`
    slot (the pll_unode_t void* data analog)."""
    if node.next is None:
        return True                      # tips always enter the traversal
    if node.data is None:
        # first visit: allocate the flags on all three half-nodes, mark
        # this direction oriented, and descend
        for g in node.roundabout():
            g.data = {"clv_valid": 0}
        node.data["clv_valid"] = 1
        return True
    if node.data["clv_valid"]:
        return False                     # valid: do not re-enter subtree
    # orient on this direction, invalidate the other two
    node.data["clv_valid"] = 1
    node.next.data["clv_valid"] = 0
    node.next.next.data["clv_valid"] = 0
    return True


def main(argv=None) -> None:
    _, device, dtype = _common.setup(_common.parser(__doc__), argv)
    tree = T.parse_newick_string(balanced_newick(TIPS))
    tips = tree.tip_count
    inner = tree.inner_count
    print(f"Number of tip/leaf nodes in tree: {tips}")
    print(f"Number of inner nodes in tree: {inner}")
    print(f"Total number of nodes in tree: {tips + inner}")
    print(f"Number of branches in tree: {tips + inner - 1}")

    partition = pll.Partition(tips, inner, 4, SITES, 1, 2 * tips - 3, 4,
                              inner, dtype=dtype, device=device)
    partition.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
    partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))
    rng = np.random.default_rng(42)
    raw = random_tipchars(tips, SITES, rng)
    for node in tree.nodes[:tips]:
        seq = "".join(NT[int(np.log2(c))] for c in raw[node.clv_index])
        partition.set_tip_states(node.clv_index, pll.MAP_NT, seq)

    # random evaluation directions for each inner node
    grand = GlibcRandom(7)
    inner_list = []
    for node in tree.nodes[tips:]:
        g = node
        for _ in range(grand.next() % 3):
            g = g.next
        inner_list.append(g)

    for i in range(10):
        node = inner_list[grand.next() % inner]
        trav = T.traverse(node, cbtrav=cb_partial_traversal)
        ops, branches, pmat_idx = T.create_operations(trav)
        print(f"\nComputing logL between CLV {node.clv_index} and "
              f"{node.back.clv_index} - (pmatrix {node.pmatrix_index} "
              f"with branch length {node.length:f})")
        print(f"Traversal size: {len(trav)}")
        print(f"Operations: {len(ops)}")
        print(f"Matrices: {len(pmat_idx)}")
        partition.update_prob_matrices([0] * 4, pmat_idx, branches)
        partition.update_partials(ops)
        logl = partition.compute_edge_loglikelihood(
            node.clv_index, node.scaler_index, node.back.clv_index,
            node.back.scaler_index, node.pmatrix_index, [0] * 4)
        print(f"Log-L: {logl:f}")


if __name__ == "__main__":
    main()
