"""Randomized stepwise-addition starting tree + parsimony SPR round.

Mirror of the reference's examples/stepwise/stepwise.c: build a
minimum-parsimony starting tree by stepwise addition (deterministic
seed-for-seed with the reference via the glibc-exact RNG), then
hill-climb with one SPR round.
"""
import numpy as np

import libpll2_tpu_torch as pll
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.parsimony import (fastparsimony_stepwise,
                                         fastparsimony_stepwise_spr_round)

from . import _common

N_TIPS, SITES, SEED = 12, 60, 42
BASES = "ACGT"


def main(argv=None) -> None:
    _, device, dtype = _common.setup(_common.parser(__doc__), argv)
    rng = np.random.default_rng(7)
    seqs = ["".join(BASES[b] for b in rng.integers(0, 4, SITES))
            for _ in range(N_TIPS)]
    labels = [f"t{i}" for i in range(N_TIPS)]

    partition = pll.Partition(N_TIPS, N_TIPS - 2, 4, SITES, 1,
                              2 * N_TIPS - 3, 1, N_TIPS - 2, dtype=dtype,
                              device=device)
    for i, s in enumerate(seqs):
        partition.set_tip_states(i, pll.MAP_NT, s)

    fp = pll.FastParsimony(partition)
    print(f"Informative sites: {fp.informative_count}  "
          f"constant cost: {fp.const_cost}")

    tree, cost = fastparsimony_stepwise([fp], labels, SEED)
    print(f"Stepwise-addition tree cost: {cost}")
    print(T.export_newick(tree.vroot, with_lengths=False))

    cost = fastparsimony_stepwise_spr_round(
        tree, [fp], seed=17, clv_index_map=np.zeros(2 * N_TIPS, dtype=int))
    print(f"After SPR round: {cost}")
    print(T.export_newick(tree.vroot, with_lengths=False))


if __name__ == "__main__":
    main()
