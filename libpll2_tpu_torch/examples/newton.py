"""Branch-length optimization by Newton's method.

Mirror of the reference's examples/newton/newton.c: sumtable once per
edge (branch-invariant sufficient statistics), then cheap per-iteration
(d1, d2) evaluations and the update  len -= d1/d2  (newton.c:31-100).
"""
import libpll2_tpu_torch as pll

from . import _common

MAX_ITER = 32
EPSILON = 1e-5


def newton(partition, parent_clv, parent_scaler, child_clv, child_scaler,
           params_indices, initial_length):
    sumtable = partition.update_sumtable(parent_clv, child_clv,
                                         parent_scaler, child_scaler,
                                         params_indices)
    length = initial_length
    for _ in range(MAX_ITER):
        d1, d2 = partition.compute_likelihood_derivatives(
            sumtable, length, params_indices)
        print(f"Branch length: {length:f} Derivative: {d1:f}")
        if abs(d1) < EPSILON:
            break
        length -= d1 / d2
    return length


def main(argv=None) -> None:
    _, device, dtype = _common.setup(_common.parser(__doc__), argv)
    partition = pll.Partition(tips=4, clv_buffers=2, states=4, sites=6,
                              rate_matrices=1, prob_matrices=5, rate_cats=4,
                              scale_buffers=2, dtype=dtype, device=device)

    branch_lengths = [0.2, 0.4, 0.3, 0.5, 0.6]
    matrix_indices = [0, 1, 2, 3, 4]
    partition.set_frequencies(0, [0.17, 0.19, 0.25, 0.39])
    partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
    partition.set_category_rates(pll.compute_gamma_cats(1.0, 4))
    for i, seq in enumerate(["WAAAAB", "CACACD", "AGGACA", "CGTAGT"]):
        partition.set_tip_states(i, pll.MAP_NT, seq)

    params_indices = [0, 0, 0, 0]
    partition.update_prob_matrices(params_indices, matrix_indices,
                                   branch_lengths)

    NONE = pll.SCALE_BUFFER_NONE
    operations = [
        pll.Operation(4, 0, 1, 0, 1, 0, NONE, NONE),
        pll.Operation(5, 2, 3, 2, 3, 1, NONE, NONE),
    ]
    partition.update_partials(operations)

    logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4,
                                                params_indices)
    print(f"Log-L before optimization: {logl:f}")

    new_length = newton(partition, 4, 0, 5, 1, params_indices,
                        branch_lengths[4])
    print(f"Optimized branch length: {new_length:f}")

    partition.update_prob_matrices(params_indices, [4], [new_length])
    logl = partition.compute_edge_loglikelihood(4, 0, 5, 1, 4,
                                                params_indices)
    print(f"Log-L after optimization: {logl:f}")


if __name__ == "__main__":
    main()
