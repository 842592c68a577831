"""Full pipeline: newick + PHYLIP -> pattern compression -> logL.

Mirror of the reference's examples/newick-phylip-unrooted
(newick-phylip-unrooted.c): parse an unrooted tree and a PHYLIP
alignment, fix missing branch lengths to 0.000001, compress site
patterns, compile the full traversal to an operations array, and
evaluate the GTR+GAMMA4 log-likelihood across the virtual-root edge.
"""
import pathlib
import tempfile

import libpll2_tpu_torch as pll
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.io import compress_site_patterns, load_phylip

from . import _common

NEWICK = ("((t0:0.12,t1:0.34):0.11,(t2:0.23,t3)x:0.09,"
          "(t4:0.40,t5:0.05):0.17);")          # t3 and x: missing lengths
PHYLIP = """6 20
t0          ACGTACGTAC GTACGTAAAA
t1          ACGTACGAAC GTACGTAAAA
t2          ACCTACGTAC GAACGTAAAA
t3          TCGTACGTAC GTACGAAAAA
t4          ACGTACTTAC GTACGCAAAA
t5          GCGTACGTAC GTACGTAAAA
"""


def set_missing_branch_length(tree: T.UTree, length: float) -> None:
    """Zero-length branches get a default (newick-phylip-unrooted.c:62-81;
    the reference treats an absent length as 0.0 and patches it here)."""
    for node in tree.nodes[:tree.tip_count]:
        if not node.length:
            node.length = node.back.length = length
    for node in tree.nodes[tree.tip_count:]:
        for g in node.roundabout():
            if not g.length:
                g.length = g.back.length = length


def main(argv=None) -> None:
    _, device, dtype = _common.setup(_common.parser(__doc__), argv)
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "msa.phy"
        path.write_text(PHYLIP)
        msa = load_phylip(str(path), interleaved=True)
    headers, seqs = msa.labels, msa.sequences

    tree = T.parse_newick_string(NEWICK)
    set_missing_branch_length(tree, 0.000001)
    order = {lab: i for i, lab in enumerate(headers)}
    tips = tree.tip_count

    print(f"Number of tip/leaf nodes in tree: {tips}")
    print(f"Number of inner nodes in tree: {tree.inner_count}")
    print(f"Total number of nodes in tree: {tips + tree.inner_count}")
    print(f"Number of branches in tree: {tips + tree.inner_count - 1}")

    patterns, weights = compress_site_patterns(seqs, pll.MAP_NT)
    sites = len(patterns[0])
    print(f"Compressed {len(seqs[0])} sites -> {sites} patterns")

    partition = pll.Partition(tips, tree.inner_count, 4, sites, 1,
                              2 * tips - 3, 4, tree.inner_count,
                              dtype=dtype, device=device)
    partition.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
    partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))
    partition.set_pattern_weights(weights)
    for node in tree.nodes[:tips]:
        partition.set_tip_states(node.clv_index, pll.MAP_NT,
                                 patterns[order[node.label]])

    trav = T.traverse(tree.vroot)
    print(f"Traversal size: {len(trav)}")
    ops, branches, pmat_idx = T.create_operations(trav)
    print(f"Operations: {len(ops)}")
    print(f"Probability Matrices: {len(pmat_idx)}")
    partition.update_prob_matrices([0] * 4, pmat_idx, branches)
    partition.update_partials(ops)

    root = tree.vroot
    logl = partition.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4)
    print(f"Log-L: {logl:f}")


if __name__ == "__main__":
    main()
