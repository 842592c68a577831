"""Randomized stepwise-addition starting trees + parsimony SPR rounds.

A copy of libpll2_tpu/parsimony/stepwise.py over the port's FastParsimony;
host code.  Reference: libpll-2 src/stepwise.c.  Semantics mirrored:

  * deterministic Fisher-Yates shuffles via the glibc-exact RNG
    (create_shuffled, stepwise.c:56-106 → utils/random.py);
  * 3-taxon star start, then insert each remaining tip at the
    minimum-parsimony edge (pll_fastparsimony_stepwise, :883-1082);
  * directional parsimony vectors maintained lazily with per-half-node
    ``clv_valid`` flags and partial traversals (:178-200, 461-478);
  * SPR hill-climb over all subtrees in seed-shuffled order with optional
    topological constraint (pll_fastparsimony_stepwise_spr_round, :585-729);
  * extending an existing tree with new taxa
    (pll_fastparsimony_stepwise_extend, :731-881).

The reference splices the subtree into every candidate edge one at a time,
recomputing one Fitch vector and one edge score per candidate
(stepwise.c:486-525).  Here all candidate placements are scored in one
batched call per parsimony structure (FastParsimony.placement_scores), on
the structure's device, with identical scores.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..constants import TRAVERSE_POSTORDER
from ..tree.utree import UNode, UTree, create_pars_buildops, traverse
from ..utils.random import create_shuffled
from .fitch import FastParsimony
from .sankoff import ParsBuildOp


class _Info:
    __slots__ = ("clv_valid",)

    def __init__(self):
        self.clv_valid = False


# --------------------------------------------------------------------------
# graph surgery primitives (stepwise.c:236-350)
# --------------------------------------------------------------------------

def _link(a: UNode, b: UNode) -> None:
    a.back = b
    b.back = a
    b.pmatrix_index = a.pmatrix_index


def _edgesplit(a: UNode, b: UNode, c: UNode) -> None:
    """Split edge a<->d and graft the b/c fork in between
    (stepwise.c:314-336)."""
    _link(c, a.back)
    _link(a, b)


def _prune(p: UNode) -> UNode:
    a = p.next.back
    b = p.next.next.back
    _link(a, b)
    p.next.back = None
    p.next.next.back = None
    return a


def _inner_create(i: int, tip_count: int) -> UNode:
    """Roundabout inner node: clv = tips+i, node ids tips+3i..+2
    (stepwise.c:236-285)."""
    n1, n2, n3 = UNode(), UNode(), UNode()
    n1.next, n2.next, n3.next = n2, n3, n1
    for k, n in enumerate((n1, n2, n3)):
        n.clv_index = tip_count + i
        n.node_index = tip_count + i * 3 + k
        n.data = _Info()
    return n1


def _tip_create(i: int) -> UNode:
    n = UNode()
    n.clv_index = i
    n.node_index = i
    return n


def _invalidate_node(node: UNode) -> None:
    for h in node.roundabout():
        h.data.clv_valid = False


def _collect_edges(root: UNode) -> List[UNode]:
    """All edges as inner half-nodes; root edge once
    (utree_collect_edges, stepwise.c:352-375)."""
    trav = traverse(root, TRAVERSE_POSTORDER)
    edges = [n.back if n.next is None else n for n in trav]
    return edges[:-1]


# --------------------------------------------------------------------------
# directional vector maintenance (stepwise.c:377-433)
# --------------------------------------------------------------------------

def _cb_partial(node: UNode) -> bool:
    if node.next is None:
        return True
    if node.data.clv_valid:
        return False
    node.data.clv_valid = True
    return True


def _cb_full_subtree(node: UNode) -> bool:
    # skip "dead-end" subtrees with unlinked back pointers (pruned forks)
    return (node.next is None
            or (node.next.back is not None
                and node.next.next.back is not None))


def _update_vectors(pars_list: Sequence[FastParsimony],
                    ops: Sequence[ParsBuildOp]) -> None:
    if not ops:
        return
    for pars in pars_list:
        pars.update_vectors(ops)


def _fill_outer_directions(edge_list: Sequence[UNode]) -> List[ParsBuildOp]:
    """Partial traversals from every outer (tip-adjacent) branch: computes
    every directional vector exactly once (stepwise.c:458-473)."""
    ops: List[ParsBuildOp] = []
    for e in edge_list:
        root = e if e.next is not None else e.back
        if root.back.next is not None:
            continue
        trav = traverse(root, TRAVERSE_POSTORDER, _cb_partial)
        ops.extend(create_pars_buildops(trav))
    return ops


# --------------------------------------------------------------------------
# best-edge insertion (stepwise.c:436-583)
# --------------------------------------------------------------------------

def _insert_best(pars_list: Sequence[FastParsimony],
                 edge_list: List[UNode],
                 inner_node: UNode,
                 constraint: Optional[np.ndarray],
                 prune_edge: Optional[UNode]) -> int:
    assert inner_node.next.back is None and inner_node.next.next.back is None

    ops = _fill_outer_directions(edge_list)
    _update_vectors(pars_list, ops)

    # re-inserting a pruned subtree: recompute its CLVs toward the cut
    if inner_node.back.next is not None:
        trav = traverse(inner_node.back, TRAVERSE_POSTORDER, _cb_full_subtree)
        _update_vectors(pars_list, create_pars_buildops(trav))

    # batched placement scoring over all candidate edges
    pairs = np.array([[e.node_index, e.back.node_index] for e in edge_list],
                     dtype=np.int32)
    scores = np.zeros(len(edge_list), dtype=np.int64)
    for pars in pars_list:
        scores += pars.placement_scores(pairs, inner_node.back.node_index)

    if constraint is not None:
        s = constraint[inner_node.clv_index]
        assert s
        for i, e in enumerate(edge_list):
            if s != constraint[e.clv_index] and \
               s != constraint[e.back.clv_index]:
                scores[i] = np.iinfo(np.int64).max

    best_index = int(np.argmin(scores))
    valid = scores[best_index] != np.iinfo(np.int64).max

    if valid:
        min_cost = int(scores[best_index])
        _edgesplit(edge_list[best_index], inner_node.next,
                   inner_node.next.next)
        _update_vectors(pars_list, [ParsBuildOp(
            parent_score_index=inner_node.node_index,
            child1_score_index=inner_node.next.back.node_index,
            child2_score_index=inner_node.next.next.back.node_index)])
    else:
        # no placement satisfied the constraint: restore original edge
        assert constraint is not None and prune_edge is not None
        _edgesplit(prune_edge, inner_node.next, inner_node.next.next)
        _update_vectors(pars_list, [ParsBuildOp(
            parent_score_index=inner_node.node_index,
            child1_score_index=inner_node.next.back.node_index,
            child2_score_index=inner_node.next.next.back.node_index)])
        min_cost = sum(
            pars.edge_score(inner_node.node_index,
                            inner_node.back.node_index)
            for pars in pars_list)

    if prune_edge is None:
        edge_list.append(inner_node)
        edge_list.append(inner_node.next.next)

    # invalidate all directions, re-validate those still correct
    for n in traverse(edge_list[0], TRAVERSE_POSTORDER):
        _invalidate_node(n.back if n.next is None else n)
    if prune_edge is None:
        for n in traverse(inner_node, TRAVERSE_POSTORDER):
            if n.data is not None:
                n.data.clv_valid = True
    _invalidate_node(inner_node)
    if inner_node.back.next is not None:
        _invalidate_node(inner_node.back)

    return min_cost


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def fastparsimony_stepwise(pars_list: Sequence[FastParsimony],
                           labels: Sequence[str], seed: int):
    """Build a randomized stepwise-addition tree
    (pll_fastparsimony_stepwise, stepwise.c:883-1082).

    Returns (UTree, cost)."""
    tips_count = pars_list[0].tips
    inner_nodes = pars_list[0].inner_nodes
    if tips_count < 3:
        raise ValueError("stepwise parsimony requires at least three tips")
    if inner_nodes < tips_count - 2:
        raise ValueError("stepwise parsimony supports only unrooted trees")
    for pars in pars_list[1:]:
        if pars.tips != tips_count or pars.inner_nodes != inner_nodes:
            raise ValueError("parsimony structures tips/inner not equal")

    root = _inner_create(tips_count - 3, tips_count)
    inner_node_list = [_inner_create(i, tips_count)
                       for i in range(tips_count - 3)]

    order = create_shuffled(tips_count, seed)
    tip_node_list = []
    for i in range(tips_count):
        index = int(order[i])
        tip = _tip_create(index)
        tip.label = labels[index]
        tip_node_list.append(tip)
        if i > 2:
            _link(inner_node_list[i - 3], tip)

    _link(root, tip_node_list[0])
    _link(root.next, tip_node_list[1])
    _link(root.next.next, tip_node_list[2])

    edge_list: List[UNode] = [root, root.next, root.next.next]

    if tips_count > 3:
        cost = 0
        for i in range(3, tips_count):
            cost = _insert_best(pars_list, edge_list,
                                inner_node_list[i - 3], None, None)
    else:
        cost = sum(pars.const_cost for pars in pars_list)

    for node in traverse(root, TRAVERSE_POSTORDER):
        for h in ((node,) if node.next is None else tuple(node.roundabout())):
            h.data = None

    from ..tree.utree import wrap_tree
    return wrap_tree(root), cost


def fastparsimony_stepwise_spr_round(tree: UTree,
                                     pars_list: Sequence[FastParsimony],
                                     seed: int,
                                     clv_index_map=None,
                                     tip_msa_idmap=None) -> int:
    """One SPR hill-climb round over all subtrees in seed-shuffled order
    (pll_fastparsimony_stepwise_spr_round, stepwise.c:585-729).

    ``clv_index_map`` enables the topological constraint check; None means
    unconstrained.  Returns the final cost."""
    tip_count = tree.tip_count
    inner_count = tree.inner_count
    node_count = tip_count + inner_count
    subtree_count = inner_count * 3
    new_tip_count = pars_list[0].tips
    ext_tip_count = new_tip_count - tip_count

    constraint = None
    if clv_index_map is not None:
        constraint = np.zeros(2 * node_count, dtype=np.int64)
        for i in range(node_count):
            clv_id = tree.nodes[i].clv_index
            constraint[clv_id] = (clv_index_map[clv_id] + 1
                                  if tree.nodes[i].next is not None else 0)

    orig_idmap = {}
    if tip_msa_idmap is not None:
        # remap to parsimony-struct numbering for incomplete trees
        # (stepwise.c:622-644)
        for i in range(tip_count):
            old_idx = tree.nodes[i].node_index
            new_idx = int(tip_msa_idmap[old_idx])
            tree.nodes[i].node_index = new_idx
            orig_idmap[new_idx] = old_idx
        for i in range(tip_count, node_count):
            for h in tree.nodes[i].roundabout():
                h.node_index += ext_tip_count

    order = create_shuffled(subtree_count, seed)

    all_nodes: List[UNode] = []
    for i in range(inner_count):
        node = tree.nodes[tip_count + i]
        all_nodes.extend([node, node.next, node.next.next])
    for h in all_nodes:
        h.data = _Info()

    cost = 0
    for i in range(subtree_count):
        new_inner = all_nodes[int(order[i])]
        if (new_inner.next.back.next is None
                and new_inner.next.next.back.next is None):
            continue
        prune_edge = _prune(new_inner)
        new_root = prune_edge if prune_edge.next is not None \
            else prune_edge.back
        edge_list = _collect_edges(new_root)
        cost = _insert_best(pars_list, edge_list, new_inner, constraint,
                            prune_edge)

    if tip_msa_idmap is not None:
        for i in range(tip_count):
            tree.nodes[i].node_index = orig_idmap[tree.nodes[i].node_index]
        for i in range(tip_count, node_count):
            for h in tree.nodes[i].roundabout():
                h.node_index -= ext_tip_count

    for h in all_nodes:
        h.data = None
    return cost


def fastparsimony_stepwise_extend(tree: UTree,
                                  pars_list: Sequence[FastParsimony],
                                  labels: Sequence[str], seed: int,
                                  tip_msa_idmap=None) -> int:
    """Extend an existing tree with new taxa by stepwise addition
    (pll_fastparsimony_stepwise_extend, stepwise.c:731-881).

    ``labels[i]`` names new tip old_tip_count+i; mutates ``tree`` in
    place.  Returns the final cost."""
    new_tip_count = pars_list[0].tips
    new_inner_count = new_tip_count - 2
    old_tip_count = tree.tip_count
    old_inner_count = tree.inner_count
    old_node_count = old_tip_count + old_inner_count
    ext_tip_count = new_tip_count - old_tip_count

    old_nodes = tree.nodes
    new_nodes: List[Optional[UNode]] = [None] * (new_tip_count
                                                 + new_inner_count)
    for i in range(old_tip_count):
        new_nodes[i] = old_nodes[i]
    for i in range(old_tip_count, old_node_count):
        new_idx = i + ext_tip_count
        new_nodes[new_idx] = old_nodes[i]
        for h in old_nodes[i].roundabout():
            h.clv_index += ext_tip_count
            h.node_index += ext_tip_count
            h.data = _Info()

    order = create_shuffled(ext_tip_count, seed)
    for i in range(ext_tip_count):
        index = int(order[i]) + old_tip_count
        tip = _tip_create(index)
        tip.label = labels[index - old_tip_count]
        inner = _inner_create(old_inner_count + i, new_tip_count)
        new_nodes[old_tip_count + i] = tip
        new_nodes[new_tip_count + old_inner_count + i] = inner
        _link(inner, tip)

    if tip_msa_idmap is not None:
        for i in range(new_tip_count):
            new_nodes[i].node_index = int(
                tip_msa_idmap[new_nodes[i].node_index])

    edge_list = _collect_edges(tree.vroot)
    assert len(edge_list) == tree.edge_count

    cost = 0
    new_inner_nodes = new_nodes[new_tip_count + old_inner_count:]
    for i in range(ext_tip_count):
        cost = _insert_best(pars_list, edge_list, new_inner_nodes[i],
                            None, None)

    tree.nodes = new_nodes
    tree.tip_count = new_tip_count
    tree.inner_count = new_inner_count
    tree.vroot = (tree.vroot if tree.vroot.next is not None
                  else tree.vroot.back)

    for node in new_nodes:
        for h in ((node,) if node.next is None else tuple(node.roundabout())):
            h.data = None
    return cost
