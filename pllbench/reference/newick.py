"""A plain newick reader for the reference: labels, branch lengths and the
tree's shape, nothing else.

Edges are numbered in the order their lengths appear in the string, which
is the post-order of the non-root nodes.  The benchmark defines its branch
lengths in that order and hands the same string to the program.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

_SPECIAL = set("(),:;")


@dataclasses.dataclass
class Node:
    label: Optional[str]
    children: List["Node"]
    edge: int = -1          # index of the edge above the node; -1 at the root


@dataclasses.dataclass
class Tree:
    root: Node
    lengths: List[float]    # by edge index
    postorder: List[Node]   # every node, children before parents

    @property
    def tips(self) -> List[Node]:
        return [n for n in self.postorder if not n.children]


def parse(text: str) -> Tree:
    """Parse one newick string with a length on every edge."""
    text = "".join(text.split())
    pos = 0
    lengths: List[float] = []
    postorder: List[Node] = []

    def read_name() -> str:
        nonlocal pos
        start = pos
        while pos < len(text) and text[pos] not in _SPECIAL:
            pos += 1
        return text[start:pos]

    def read_node() -> Node:
        nonlocal pos
        children = []
        if text[pos] == "(":
            pos += 1
            while True:
                child = read_node()
                if text[pos] != ":":
                    raise ValueError(f"newick: no length at {pos}")
                pos += 1
                child.edge = len(lengths)
                lengths.append(float(read_name()))
                children.append(child)
                if text[pos] == ",":
                    pos += 1
                    continue
                if text[pos] != ")":
                    raise ValueError(f"newick: expected ')' at {pos}")
                pos += 1
                break
        node = Node(read_name() or None, children)
        postorder.append(node)
        return node

    root = read_node()
    if pos < len(text) and text[pos] == ":":      # a root length is ignored
        pos += 1
        read_name()
    if text[pos:] != ";":
        raise ValueError("newick: expected ';' at the end")
    return Tree(root, lengths, postorder)


def splits(tree: Tree) -> set:
    """The tree's nontrivial bipartitions, each as the frozenset of tip
    labels on the side without the first label in sorted order."""
    labels = sorted(n.label for n in tree.tips)
    anchor = labels[0]
    below = {}
    out = set()
    for node in tree.postorder:
        if not node.children:
            below[id(node)] = frozenset([node.label])
            continue
        side = frozenset().union(*(below[id(c)] for c in node.children))
        below[id(node)] = side
        if node is tree.root or len(side) < 2 or len(side) > len(labels) - 2:
            continue
        out.add(side if anchor not in side
                else frozenset(labels).difference(side))
    return out


def write(tree: Tree, lengths) -> str:
    """The tree as newick with `lengths` by edge index (repr of floats, so
    that they read back exactly)."""
    def text(node: Node) -> str:
        inner = ("(" + ",".join(f"{text(c)}:{lengths[c.edge]!r}"
                                for c in node.children) + ")"
                 if node.children else "")
        return inner + (node.label or "")
    return text(tree.root) + ";"
