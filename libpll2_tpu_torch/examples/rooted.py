"""Rooted-tree log-likelihood with manual operations.

Mirror of the reference's examples/rooted/rooted.c: 5 taxa, GTR+GAMMA4,
root logL at CLV 8, then +I at 0.5 / 0.75 — byte-identical output.
"""
import libpll2_tpu_torch as pll
from libpll2_tpu_torch.utils import show_clv, show_pmatrix

from . import _common


def main(argv=None) -> None:
    _, device, dtype = _common.setup(_common.parser(__doc__), argv)
    partition = pll.Partition(tips=5, clv_buffers=4, states=4, sites=6,
                              rate_matrices=1, prob_matrices=5, rate_cats=4,
                              scale_buffers=4, dtype=dtype, device=device)

    branch_lengths = [0.36, 0.722, 0.985, 0.718, 1.44]
    matrix_indices = [0, 1, 2, 3, 4]
    partition.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
    partition.set_category_rates([0.13695378267140107, 0.47675185617665189,
                                  0.99999999997958422, 2.38629436117236260])

    for i, seq in enumerate(["WAAAAB", "CACACD", "AGGACA", "CGTAGT",
                             "CGAATT"]):
        partition.set_tip_states(i, pll.MAP_NT, seq)

    params_indices = [0, 0, 0, 0]
    partition.update_prob_matrices(params_indices, matrix_indices,
                                   branch_lengths)
    for i in range(5):
        print(f"P-matrix for branch length {branch_lengths[i]:f}")
        show_pmatrix(partition, i, 7)
        print()

    NONE = pll.SCALE_BUFFER_NONE
    operations = [
        pll.Operation(5, 0, 1, 0, 0, 0, NONE, NONE),
        pll.Operation(6, 5, 2, 1, 2, 1, 0, NONE),
        pll.Operation(7, 3, 4, 0, 0, 2, NONE, NONE),
        pll.Operation(8, 6, 7, 3, 4, 3, 1, 2),
    ]
    partition.update_partials(operations)

    for i in range(5):
        print(f"Tip {i}: ", end="")
        show_clv(partition, i, NONE, 7)
    for i in range(5, 9):
        print(f"CLV {i}: ", end="")
        show_clv(partition, i, i - 5, 7)

    logl = partition.compute_root_loglikelihood(8, 3, params_indices)
    print(f"Log-L: {logl:f}")

    partition.update_invariant_sites()
    partition.update_invariant_sites_proportion(0, 0.5)
    partition.update_prob_matrices(params_indices, matrix_indices,
                                   branch_lengths)
    partition.update_partials(operations)
    logl = partition.compute_root_loglikelihood(8, 3, params_indices)
    print(f"Log-L (Inv+Gamma 0.5): {logl:f}")

    partition.update_invariant_sites_proportion(0, 0.75)
    partition.update_prob_matrices(params_indices, matrix_indices,
                                   branch_lengths)
    partition.update_partials(operations)
    logl = partition.compute_root_loglikelihood(8, 3, params_indices)
    print(f"Log-L (Inv+Gamma 0.75): {logl:f}")


if __name__ == "__main__":
    main()
