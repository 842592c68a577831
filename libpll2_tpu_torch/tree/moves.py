"""Topological moves on unrooted trees: SPR, NNI, and rollback.

A JAX-free copy of libpll2_tpu/tree/moves.py (host-only graph surgery).

Reference semantics (libpll-2 src/utree_moves.c):

  * SPR (pll_utree_spr, :119-254): prune the subtree at the far end of
    inner half-node p, merge the two vacated edges (lengths summed, pmatrix
    index of p->next->back's edge kept), then split the regraft edge r<->r'
    in half (each half r.length/2; r' side keeps p->next->next's pmatrix
    index, r side keeps its own); the changed (length, pmatrix) pairs are
    reported so the caller can update exactly three P-matrices.
  * NNI (pll_utree_nni, :72-109): swap p->next's subtree with one of the
    two subtrees across the edge (left/right); swapped subtrees keep their
    branch lengths and pmatrix indices (no P-matrix updates needed).
  * rollback (pll_utree_rollback, :356-375) restores from a recorded
    rollback object; an NNI rolls back by re-applying itself.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .utree import UNode

MOVE_SPR = 1
MOVE_NNI = 2
NNI_LEFT = 1
NNI_RIGHT = 2


@dataclasses.dataclass
class Rollback:
    """Mirror of pll_utree_rb_t (pll.h:442-464)."""
    move_type: int
    # NNI
    p: Optional[UNode] = None
    nni_type: int = 0
    # SPR
    r: Optional[UNode] = None
    r_back: Optional[UNode] = None
    r_len: float = 0.0
    pnb: Optional[UNode] = None
    pnb_len: float = 0.0
    pnnb: Optional[UNode] = None
    pnnb_len: float = 0.0


def _link(a: UNode, b: UNode, length: float, pmatrix_index: int) -> None:
    a.back = b
    b.back = a
    a.length = b.length = length
    a.pmatrix_index = b.pmatrix_index = pmatrix_index


def _swap(t1: UNode, t2: UNode) -> None:
    """Swap subtree positions; subtrees keep lengths/pmatrix indices
    (utree_moves.c:60-70)."""
    temp = t1.back
    _link(t1, t2.back, t2.back.length, t2.back.pmatrix_index)
    _link(t2, temp, temp.length, temp.pmatrix_index)


def subtree_contains(start: UNode, target: UNode) -> bool:
    """Does the subtree rooted at `start` (away from start->back) contain
    target? (utree_find, utree_moves.c:24-45)."""
    if start is None:
        return False
    if start is target:
        return True
    if start.next is None:
        return False
    h = start.next
    while h is not start:
        if h is target or subtree_contains(h.back, target):
            return True
        h = h.next
    return False


def nni(p: UNode, move_type: int) -> Rollback:
    """Nearest-neighbor interchange across the edge p<->p.back."""
    if move_type not in (NNI_LEFT, NNI_RIGHT):
        raise ValueError("invalid NNI move type")
    if p.next is None or p.back.next is None:
        raise ValueError("specified terminal branch")
    rb = Rollback(MOVE_NNI, p=p, nni_type=move_type)
    subtree1 = p.next
    subtree2 = p.back.next if move_type == NNI_LEFT else p.back.next.next
    _swap(subtree1, subtree2)
    return rb


def spr(p: UNode, r: UNode, safe: bool = False
        ) -> Tuple[Rollback, List[float], List[int]]:
    """Prune the subtree at p's far side and regraft on edge r<->r.back.

    Returns (rollback, changed_branch_lengths, changed_pmatrix_indices) —
    the three edges whose P-matrices must be recomputed.
    """
    if p.next is None:
        raise ValueError("prune edge must be defined by an inner node")
    if r in (p, p.back, p.next, p.next.back, p.next.next, p.next.next.back):
        raise ValueError("proposed move yields the same tree")
    if safe and subtree_contains(p.back, r):
        raise ValueError("node r is part of the subtree to be pruned")

    rb = Rollback(MOVE_SPR, p=p, r=r, r_back=r.back, r_len=r.length,
                  pnb=p.next.back, pnb_len=p.next.length,
                  pnnb=p.next.next.back, pnnb_len=p.next.next.length)

    branch_lengths: List[float] = []
    matrix_indices: List[int] = []

    # (b) connect u and v (merged edge)
    u = p.next.back
    v = p.next.next.back
    _link(u, v, u.length + v.length, u.pmatrix_index)
    branch_lengths.append(u.length)
    matrix_indices.append(u.pmatrix_index)

    # (a) prune
    p.next.back = p.next.next.back = None

    # (c) regraft: split edge r<->r' in half
    length = r.length / 2
    _link(r.back, p.next.next, length, p.next.next.pmatrix_index)
    branch_lengths.append(length)
    matrix_indices.append(p.next.next.pmatrix_index)
    _link(r, p.next, length, r.pmatrix_index)
    branch_lengths.append(length)
    matrix_indices.append(r.pmatrix_index)

    return rb, branch_lengths, matrix_indices


def prune_subtree(p: UNode) -> UNode:
    """The prune half of an SPR (utree_moves.c:140-169): detach p's node
    (and the subtree behind p->back) from the tree, reconnecting the two
    vacated neighbors with summed branch lengths.

    Returns a half-node inside the remainder tree.  The pruned component
    stays rooted at p (p->back and the subtree behind it are untouched);
    p->next / p->next->next dangle."""
    if p.next is None:
        raise ValueError("prune edge must be defined by an inner node")
    u = p.next.back
    v = p.next.next.back
    _link(u, v, u.length + v.length, u.pmatrix_index)
    p.next.back = p.next.next.back = None
    return u


def rollback(rb: Rollback) -> Tuple[List[float], List[int]]:
    """Undo a recorded move (pll_utree_rollback, utree_moves.c:356-375).
    Returns the (branch_lengths, pmatrix_indices) restored by an SPR
    rollback (empty for NNI)."""
    if rb.move_type == MOVE_NNI:
        nni(rb.p, rb.nni_type)
        return [], []
    if rb.move_type != MOVE_SPR:
        raise ValueError("invalid move type")
    branch_lengths: List[float] = []
    matrix_indices: List[int] = []
    _link(rb.pnb, rb.p.next, rb.pnb_len, rb.pnb.pmatrix_index)
    branch_lengths.append(rb.pnb_len)
    matrix_indices.append(rb.pnb.pmatrix_index)
    _link(rb.pnnb, rb.p.next.next, rb.pnnb_len,
          rb.p.next.next.pmatrix_index)
    branch_lengths.append(rb.pnnb_len)
    matrix_indices.append(rb.p.next.next.pmatrix_index)
    _link(rb.r, rb.r_back, rb.r_len, rb.r.pmatrix_index)
    branch_lengths.append(rb.r_len)
    matrix_indices.append(rb.r.pmatrix_index)
    return branch_lengths, matrix_indices
