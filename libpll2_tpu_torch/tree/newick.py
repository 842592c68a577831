"""Newick parser for unrooted trees (pure Python; replaces the reference's
bison/flex grammars parse_utree.y / lex_utree.l with identical semantics):

  * parse_newick_string        — requires an unrooted (>=3-furcation) input;
  * parse_newick_string_rooted — also accepts rooted / multifurcating;
  * parse_newick_string_unroot — unroots a rooted input in place, merging the
    two root branches (length sum, min pmatrix index;
    parse_utree.y:537-567);
  * template indices are assigned exactly as the reference
    (tree/utree.py reset_template_indices).

Labels may be quoted ('...') or unquoted; branch lengths follow ':'.
A root branch length is ignored (an unrooted structure is created).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

from .utree import UNode, UTree, reset_template_indices, wrap_tree

_SPECIAL = set("();,:[]")


class _Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip_ws_and_comments(self) -> None:
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c.isspace():
                self.pos += 1
            elif c == "[":  # newick comment
                end = self.text.find("]", self.pos)
                if end < 0:
                    raise ValueError("unterminated comment in newick string")
                self.pos = end + 1
            else:
                return

    def peek(self) -> Optional[str]:
        self._skip_ws_and_comments()
        if self.pos >= len(self.text):
            return None
        return self.text[self.pos]

    def expect(self, c: str) -> None:
        got = self.peek()
        if got != c:
            raise ValueError(
                f"newick syntax error at position {self.pos}: expected "
                f"{c!r}, found {got!r}")
        self.pos += 1

    def accept(self, c: str) -> bool:
        if self.peek() == c:
            self.pos += 1
            return True
        return False

    def read_label(self) -> Optional[str]:
        c = self.peek()
        if c is None or c in _SPECIAL:
            return None
        if c == "'":
            self.pos += 1
            end = self.text.find("'", self.pos)
            if end < 0:
                raise ValueError("unterminated quoted label")
            label = self.text[self.pos:end]
            self.pos = end + 1
            return label
        start = self.pos
        while (self.pos < len(self.text)
               and not self.text[self.pos].isspace()
               and self.text[self.pos] not in _SPECIAL):
            self.pos += 1
        return self.text[start:self.pos]

    def read_length(self) -> Optional[float]:
        if not self.accept(":"):
            return None
        self._skip_ws_and_comments()
        start = self.pos
        while (self.pos < len(self.text)
               and (self.text[self.pos] in "+-eE." or
                    self.text[self.pos].isdigit())):
            self.pos += 1
        if start == self.pos:
            raise ValueError(f"expected branch length at position {start}")
        return float(self.text[start:self.pos])


def _close_roundabout(first: UNode) -> None:
    """Close the circular half-node list and share the label
    (parse_utree.y:56-66)."""
    last = first
    while last.next is not None and last.next is not first:
        if last.next.label is None:
            last.next.label = first.label
        last = last.next
    last.next = first


def _parse_subtree(tk: _Tokenizer) -> UNode:
    """Parse one subtree; return its up-facing half-node."""
    if tk.peek() == "(":
        tk.expect("(")
        children: List[UNode] = [_parse_subtree(tk)]
        while tk.accept(","):
            children.append(_parse_subtree(tk))
        tk.expect(")")
        label = tk.read_label()
        length = tk.read_length() or 0.0

        up = UNode(label, length)
        prev = up
        for child in children:
            half = UNode(None, child.length)
            half.back = child
            child.back = half
            prev.next = half
            prev = half
        _close_roundabout(up)
        return up

    label = tk.read_label()
    if label is None:
        raise ValueError(f"expected label at position {tk.pos}")
    length = tk.read_length() or 0.0
    return UNode(label, length)


def _parse_graph(text: str) -> Tuple[UNode, int]:
    """Parse a full newick string into a node graph; return (root roundabout
    entry half-node, tip count)."""
    tk = _Tokenizer(text)
    tk.expect("(")
    children = [_parse_subtree(tk)]
    while tk.accept(","):
        children.append(_parse_subtree(tk))
    tk.expect(")")
    label = tk.read_label()
    tk.read_length()  # root length ignored (unrooted structure)
    tk.expect(";")

    # toplevel roundabout: entry half's back = first child
    # (parse_utree.y:188-201 'input' action)
    root = UNode(label, children[0].length)
    root.back = children[0]
    children[0].back = root
    prev = root
    for child in children[1:]:
        half = UNode(None, child.length)
        half.back = child
        child.back = half
        prev.next = half
        prev = half
    _close_roundabout(root)

    tips = _count_tips(root)
    return root, tips


def _count_tips(root: UNode) -> int:
    count = 0
    stack = [root]
    seen = set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if n.next is None and n.back is not None:
            count += 1
        if n.next is not None:
            stack.append(n.next)
        if n.back is not None:
            stack.append(n.back)
    return count


def _is_rooted(root: UNode) -> bool:
    return root.next is not None and root.next.next is root


def unroot_inplace(root: UNode) -> UNode:
    """Collapse a degree-2 root into an edge (parse_utree.y:537-567)."""
    if not _is_rooted(root):
        return root
    if root.next is root:
        raise ValueError("unifurcation detected at root")
    left = root.back
    right = root.next.back
    new_length = left.length + right.length
    left.back = right
    right.back = left
    left.length = right.length = new_length
    left.pmatrix_index = right.pmatrix_index = min(left.pmatrix_index,
                                                   right.pmatrix_index)
    return left if left.next is not None else right


def parse_newick_string(text: str) -> UTree:
    """Parse a strictly-unrooted, binary newick string.

    Multifurcating input is REJECTED: the operations compiler
    (tree/utree.py create_operations) assumes binary nodes, so silently
    accepting a polytomy would drop children and produce a wrong
    likelihood.  (The reference exposes the equivalent strict check via
    pll_utree_wraptree's binary flag, parse_utree.y:462-479.)
    """
    root, tips = _parse_graph(text)
    if _is_rooted(root):
        raise ValueError("rooted tree parsed but unrooted tree is expected")
    reset_template_indices(root, tips)
    return wrap_tree(root, binary_required=True)


def parse_newick_string_rooted(text: str) -> UTree:
    """Parse accepting rooted and multifurcating inputs."""
    root, tips = _parse_graph(text)
    reset_template_indices(root, tips)
    return wrap_tree(root, binary_required=False)


def parse_newick_string_unroot(text: str) -> UTree:
    """Parse, unrooting a rooted input in place; the unrooted result must
    be binary (same rationale as parse_newick_string)."""
    root, tips = _parse_graph(text)
    root = unroot_inplace(root)
    reset_template_indices(root, tips)
    return wrap_tree(root, binary_required=True)


def parse_newick(path: str | Path) -> UTree:
    return parse_newick_string(Path(path).read_text())


def parse_newick_rooted(path: str | Path) -> UTree:
    return parse_newick_string_rooted(Path(path).read_text())


def parse_newick_unroot(path: str | Path) -> UTree:
    return parse_newick_string_unroot(Path(path).read_text())
