"""Topology comparison: bipartition sets and Robinson-Foulds distance.

A JAX-free copy of libpll2_tpu/tree/compare.py.

The reference library itself ships no tree-distance code (RAxML-NG layers
it on top); a search framework needs a recovery metric, so it is
first-class here.  Splits are computed by a post-order sweep from a fixed
tip-label ordering; each internal edge contributes the bitmask of tip
labels on one side, canonicalized to the side NOT containing label 0 so
orientation does not matter.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Sequence

from .utree import UNode, UTree


def tip_labels(tree: UTree) -> list:
    return sorted(n.label for n in tree.nodes[:tree.tip_count])


def splits(tree: UTree, order: Optional[Sequence[str]] = None
           ) -> FrozenSet[int]:
    """Non-trivial bipartitions as canonical tip-index bitmasks.

    order: tip-label ordering defining bit positions (defaults to sorted
    labels); pass the SAME ordering for both trees when comparing.
    """
    if order is None:
        order = tip_labels(tree)
    idx: Dict[str, int] = {lab: i for i, lab in enumerate(order)}
    n = tree.tip_count
    full = (1 << n) - 1
    out = set()

    # iterative post-order over the unrooted tree from the virtual root:
    # memo[h.node_index] = bitmask of tips behind half-node h (away from
    # h.back); each internal edge is reached from exactly one side, and
    # the canonicalization makes sides interchangeable
    root = tree.vroot
    memo: Dict[int, int] = {}
    stack = [(root.back, False), (root, False)]
    # compute below-masks for every half-node reachable downward from the
    # two root directions; collect splits at inner-inner edges
    while stack:
        g, ready = stack.pop()
        if g.next is None:
            memo[g.node_index] = 1 << idx[g.label]
            continue
        kids = [s.back for s in g.roundabout() if s is not g]
        if not ready:
            stack.append((g, True))
            stack.extend((k, False) for k in kids)
        else:
            m = 0
            for k in kids:
                m |= memo[k.node_index]
            memo[g.node_index] = m

    for node in tree.nodes[tree.tip_count:]:
        for g in node.roundabout():
            m = memo.get(g.node_index)
            if m is None:
                continue
            if m.bit_count() < 2 or (full & ~m).bit_count() < 2:
                continue                     # trivial split
            if m & 1:
                m = full & ~m                # canonical: side without tip 0
            out.add(m)
    return frozenset(out)


def rf_distance(t1: UTree, t2: UTree) -> int:
    """Absolute Robinson-Foulds distance (symmetric-difference count of
    non-trivial splits); max value is 2*(n-3) for binary trees."""
    order = tip_labels(t1)
    if order != tip_labels(t2):
        raise ValueError("trees have different tip label sets")
    s1, s2 = splits(t1, order), splits(t2, order)
    return len(s1 ^ s2)


def rf_distance_normalized(t1: UTree, t2: UTree) -> float:
    """RF distance scaled to [0, 1] by the 2*(n-3) maximum."""
    n = t1.tip_count
    denom = 2 * (n - 3)
    if denom <= 0:
        return 0.0
    return rf_distance(t1, t2) / denom
