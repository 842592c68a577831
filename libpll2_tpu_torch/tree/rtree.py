"""Rooted tree objects: left/right/parent nodes, traversals, operations
compilation, newick parse/export, and conversion to unrooted form.
Counterpart of libpll2_tpu/tree/rtree.py.

Mirrors the reference's pll_rnode_t / pll_rtree_t semantics
(libpll-2 src/pll.h:413-438, src/rtree.c, src/parse_rtree.y):

  * template indices (parse_rtree.y:164-227): tips get node_index =
    clv_index = pmatrix_index = 0..tips-1, scaler_index = NONE; inner
    nodes get clv_index = pmatrix_index = tips+i, scaler_index = i, in
    post-order; the root's pmatrix has no edge (ignored);
  * operations compilation (pll_rtree_create_operations, rtree.c:262-305)
    skips the root's branch;
  * unrooting (pll_rtree_unroot / pll_unroot_inplace analog, utree
    semantics) merges the two root edges.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

from ..constants import (SCALE_BUFFER_NONE, TRAVERSE_POSTORDER,
                         TRAVERSE_PREORDER)
from ..partition import Operation
from .newick import _Tokenizer
from .utree import UNode, UTree, reset_template_indices, wrap_tree


class RNode:
    """Rooted node (pll_rnode_t, pll.h:413-438)."""
    __slots__ = ("label", "length", "node_index", "clv_index", "scaler_index",
                 "pmatrix_index", "left", "right", "parent", "data")

    def __init__(self, label: Optional[str] = None, length: float = 0.0):
        self.label = label
        self.length = length
        self.node_index = 0
        self.clv_index = 0
        self.scaler_index = SCALE_BUFFER_NONE
        self.pmatrix_index = 0
        self.left: Optional[RNode] = None
        self.right: Optional[RNode] = None
        self.parent: Optional[RNode] = None
        self.data = None

    def is_tip(self) -> bool:
        return self.left is None and self.right is None

    def __repr__(self):
        return f"RNode({self.label!r}, clv={self.clv_index})"


@dataclasses.dataclass
class RTree:
    """Wrapper with node array and root (pll_rtree_t, pll.h:432-438)."""
    nodes: List[RNode]     # tips first, then inner, post-order
    root: RNode
    tip_count: int

    @property
    def inner_count(self) -> int:
        return len(self.nodes) - self.tip_count

    @property
    def edge_count(self) -> int:
        return len(self.nodes) - 1


def reset_rtree_template_indices(root: RNode, tip_count: int) -> None:
    """parse_rtree.y:164-227 semantics."""
    counters = {"tip": 0, "clv": tip_count, "node": tip_count, "scaler": 0}

    def rec(node: RNode) -> None:
        if node.is_tip():
            node.node_index = node.clv_index = node.pmatrix_index = \
                counters["tip"]
            node.scaler_index = SCALE_BUFFER_NONE
            counters["tip"] += 1
            return
        rec(node.left)
        rec(node.right)
        node.node_index = counters["node"]
        node.clv_index = node.pmatrix_index = counters["clv"]
        node.scaler_index = counters["scaler"]
        counters["node"] += 1
        counters["clv"] += 1
        counters["scaler"] += 1

    rec(root)


def rtree_traverse(root: RNode, order: int = TRAVERSE_POSTORDER,
                   cbtrav: Optional[Callable[[RNode], bool]] = None
                   ) -> List[RNode]:
    """Pre/post-order traversal with pruning callback (rtree.c:306-387)."""
    if root.is_tip():
        raise ValueError("traversal root must be an inner node")
    if cbtrav is None:
        cbtrav = lambda n: True  # noqa: E731
    out: List[RNode] = []

    def rec(node: RNode) -> None:
        if not cbtrav(node):
            return
        if order == TRAVERSE_PREORDER:
            out.append(node)
        if not node.is_tip():
            rec(node.left)
            rec(node.right)
        if order == TRAVERSE_POSTORDER:
            out.append(node)

    rec(root)
    return out


def rtree_create_operations(trav_buffer: Sequence[RNode]
                            ) -> Tuple[List[Operation], List[float],
                                       List[int]]:
    """pll_rtree_create_operations (rtree.c:262-305): the root (last node
    of a full post-order) contributes no branch."""
    ops: List[Operation] = []
    branches: List[float] = []
    pmatrix_indices: List[int] = []
    for i, node in enumerate(trav_buffer):
        if i < len(trav_buffer) - 1:
            branches.append(node.length)
            pmatrix_indices.append(node.pmatrix_index)
        if node.left is not None:
            ops.append(Operation(
                parent_clv_index=node.clv_index,
                child1_clv_index=node.left.clv_index,
                child2_clv_index=node.right.clv_index,
                child1_matrix_index=node.left.pmatrix_index,
                child2_matrix_index=node.right.pmatrix_index,
                parent_scaler_index=node.scaler_index,
                child1_scaler_index=node.left.scaler_index,
                child2_scaler_index=node.right.scaler_index,
            ))
    return ops, branches, pmatrix_indices


def rtree_create_pars_buildops(trav_buffer: Sequence[RNode]):
    """pll_rtree_create_pars_buildops (rtree.c:458-481): clv_index-based
    score indices (rooted trees need only one vector per node)."""
    from ..parsimony.sankoff import ParsBuildOp
    return [ParsBuildOp(parent_score_index=n.clv_index,
                        child1_score_index=n.left.clv_index,
                        child2_score_index=n.right.clv_index)
            for n in trav_buffer if n.left is not None]


def rtree_create_pars_recops(trav_buffer: Sequence[RNode]):
    """pll_rtree_create_pars_recops (rtree.c:483-517): preorder ancestral
    reconstruction ops; the root's parent entries are unused zeros."""
    from ..parsimony.sankoff import ParsRecOp
    ops = []
    for n in trav_buffer:
        if n.left is not None:
            p = n.parent
            ops.append(ParsRecOp(
                node_score_index=n.clv_index,
                node_ancestral_index=n.clv_index,
                parent_score_index=p.clv_index if p is not None else 0,
                parent_ancestral_index=p.clv_index if p is not None else 0))
    return ops


# --------------------------------------------------------------------------
# newick parse / export
# --------------------------------------------------------------------------

def _parse_rsubtree(tk: _Tokenizer) -> RNode:
    if tk.peek() == "(":
        tk.expect("(")
        left = _parse_rsubtree(tk)
        tk.expect(",")
        right = _parse_rsubtree(tk)
        tk.expect(")")
        node = RNode(tk.read_label(), tk.read_length() or 0.0)
        node.left, node.right = left, right
        left.parent = right.parent = node
        return node
    label = tk.read_label()
    if label is None:
        raise ValueError(f"expected label at position {tk.pos}")
    return RNode(label, tk.read_length() or 0.0)


def parse_rtree_string(text: str) -> RTree:
    """Parse a strictly-binary ROOTED newick (parse_rtree.y semantics)."""
    tk = _Tokenizer(text)
    root = _parse_rsubtree(tk)
    tk.expect(";")
    if root.is_tip():
        raise ValueError("input is a single taxon, not a tree")

    tips: List[RNode] = []
    inner: List[RNode] = []

    def collect(n: RNode) -> None:
        if n.is_tip():
            tips.append(n)
            return
        collect(n.left)
        collect(n.right)
        inner.append(n)

    collect(root)
    reset_rtree_template_indices(root, len(tips))
    return RTree(nodes=tips + inner, root=root, tip_count=len(tips))


def parse_rtree(path: str | Path) -> RTree:
    return parse_rtree_string(Path(path).read_text())


def export_rtree_newick(root: RNode, with_lengths: bool = True) -> str:
    """pll_rtree_export_newick (rtree.c:127-260)."""
    def sub(n: RNode) -> str:
        if n.is_tip():
            s = n.label or ""
        else:
            s = f"({sub(n.left)},{sub(n.right)}){n.label or ''}"
        if with_lengths and n.parent is not None:
            s += f":{n.length:f}"
        return s

    return sub(root) + ";"


def show_ascii_rtree(root: RNode, options: int = 0b11) -> str:
    """ASCII render, byte-identical to pll_rtree_show_ascii
    (rtree.c:25-125; prints to stdout there, returned as text here)."""
    from .utree import _INDENT_SPACE

    def node_info(n: RNode) -> str:
        from ..constants import (SHOW_BRANCH_LENGTH, SHOW_CLV_INDEX,
                                 SHOW_LABEL, SHOW_PMATRIX_INDEX,
                                 SHOW_SCALER_INDEX)
        s = ""
        if options & SHOW_LABEL:
            s += " " + (n.label if n.label is not None else "(null)")
        if options & SHOW_BRANCH_LENGTH:
            s += f" {n.length:f}"
        if options & SHOW_CLV_INDEX:
            s += f" {n.clv_index}"
        if options & SHOW_SCALER_INDEX:
            s += f" {n.scaler_index}"
        if options & SHOW_PMATRIX_INDEX:
            s += f" {n.pmatrix_index}"
        return s

    def indent_level(n: Optional[RNode], indent: int) -> int:
        if n is None:
            return indent
        return max(indent_level(n.left, indent + 1),
                   indent_level(n.right, indent + 1))

    max_indent = indent_level(root, 0)
    active = [0] * max(max_indent + 1, 2)
    active[0] = active[1] = 1
    out: List[str] = []
    pad = " " * (_INDENT_SPACE - 1)

    def rec(n: Optional[RNode], indent: int) -> None:
        if n is None:
            return
        out.append("".join(("|" if active[i] else " ") + pad
                           for i in range(indent)))
        line = "".join(("|" if active[i] else " ") + pad
                       for i in range(indent - 1))
        line += "+" + "-" * (_INDENT_SPACE - 1)
        if n.left is not None or n.right is not None:
            line += "+"
        out.append(line + node_info(n))
        if active[indent - 1] == 2:
            active[indent - 1] = 0
        active[indent] = 1
        rec(n.left, indent + 1)
        active[indent] = 2
        rec(n.right, indent + 1)

    out.append(node_info(root))
    rec(root.left, 1)
    rec(root.right, 1)
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# rooted -> unrooted conversion (utree.c:684-760 pll_utree_create)
# --------------------------------------------------------------------------

def rtree_to_utree(rtree: RTree) -> UTree:
    """Unroot: merge the two root edges into one (lengths summed), build
    the roundabout graph, and re-assign canonical unrooted indices."""
    root = rtree.root
    if root.left.is_tip() and root.right.is_tip():
        raise ValueError("cannot unroot a 2-taxon tree")

    def build(n: RNode) -> UNode:
        """Return the up-facing half-node for subtree n."""
        up = UNode(n.label, n.length)
        if not n.is_tip():
            h1 = UNode(n.label)
            h2 = UNode(n.label)
            up.next, h1.next, h2.next = h1, h2, up
            for h, child in ((h1, n.left), (h2, n.right)):
                c = build(child)
                h.back = c
                c.back = h
                h.length = c.length
        return up

    # pick the non-tip side as the new (virtual) root roundabout
    a, b = root.left, root.right
    if a.is_tip():
        a, b = b, a
    ua = build(a)
    ub = build(b)
    ua.back = ub
    ub.back = ua
    ua.length = ub.length = a.length + b.length
    reset_template_indices(ua, rtree.tip_count)
    return wrap_tree(ua, binary_required=False)
