"""SVG export of unrooted trees (reference: libpll-2 src/utree_svg.c).
Counterpart of libpll2_tpu/tree/svg.py.

Byte-compatible with the reference's output: same element order, same
"%f" coordinate formatting, same legend — so parity can be checked by
string diff.  The layout algorithm (utree_svg.c):

  * heights per roundabout via post-order (utree_set_height, :53-95);
  * horizontal scale = min over tips of
    (canvas_width - label_len) / tip_to_root_len (utree_scaler_init,
    :238-288);
  * x offsets pre-order: child x = parent x + scaled branch
    (utree_set_offset, :117-149); root x = left margin;
  * plot post-order: tips stacked at tip_spacing, inner nodes centered
    between children with a vertical connector (utree_plot, :151-236).
"""
from __future__ import annotations

import dataclasses
import io
from typing import Optional

from .utree import UNode, UTree


@dataclasses.dataclass
class SvgAttrib:
    """Mirror of pll_svg_attrib_t defaults (utree_svg.c:374-396)."""
    precision: int = 7
    width: int = 1920
    font_size: int = 12
    tip_spacing: int = 20
    stroke_width: int = 3
    legend_show: int = 1
    legend_spacing: int = 10
    margin_left: int = 20
    margin_right: int = 20
    margin_bottom: int = 20
    margin_top: int = 20
    node_radius: int = 0
    legend_ratio: float = 0.1


class _Data:
    __slots__ = ("height", "x", "y")

    def __init__(self):
        self.height = 0
        self.x = 0.0
        self.y = 0.0


class _Aux:
    __slots__ = ("tip_occ", "scaler", "canvas_width", "max_font_len",
                 "max_tree_len")

    def __init__(self):
        self.tip_occ = 0
        self.scaler = 0.0
        self.canvas_width = 0.0
        self.max_font_len = 0.0
        self.max_tree_len = 0.0


def _height_rec(node: UNode, data: dict) -> None:
    if node.next is None:
        data[id(node)] = _Data()
        return
    _height_rec(node.next.back, data)
    _height_rec(node.next.next.back, data)
    d1 = data[id(node.next.back)]
    d2 = data[id(node.next.next.back)]
    d = _Data()
    d.height = max(d1.height, d2.height) + 1
    for h in node.roundabout():
        data[id(h)] = d


def _set_height(root: UNode, data: dict) -> None:
    _height_rec(root.back, data)
    _height_rec(root, data)
    db = data[id(root.back)]
    d = data[id(root)]
    if db.height >= d.height:
        d.height = db.height + 1


def _line(fp, x1, y1, x2, y2, w):
    fp.write(f'<line x1="{x1:f}" y1="{y1:f}" x2="{x2:f}" y2="{y2:f}" '
             f'stroke="#31a354" stroke-width="{w:f}" />\n')


def _circle(fp, cx, cy, r):
    fp.write(f'<circle cx="{cx:f}" cy="{cy:f}" r="{r:f}" fill="#31a354" '
             f'stroke="#31a354" />\n')


def _set_offset(node: UNode, attr: SvgAttrib, aux: _Aux, data: dict) -> None:
    d = data[id(node)]
    d.x = node.length * aux.scaler
    pd = data[id(node.back)]
    parent = node.back if pd.height > d.height else None
    if parent is not None:
        d.x += pd.x
    else:
        d.x = attr.margin_left
    if node.next is None:
        return
    _set_offset(node.next.back, attr, aux, data)
    _set_offset(node.next.next.back, attr, aux, data)
    if parent is None:
        _set_offset(node.back, attr, aux, data)


def _plot(fp, node: UNode, attr: SvgAttrib, aux: _Aux, data: dict) -> None:
    d = data[id(node)]
    pd = data[id(node.back)]
    parent = node.back if pd.height > d.height else None

    if node.next is not None:
        _plot(fp, node.next.back, attr, aux, data)
        _plot(fp, node.next.next.back, attr, aux, data)
        if parent is None:
            _plot(fp, node.back, attr, aux, data)

    if parent is not None:
        x, px = d.x, pd.x
        if node.next is None:
            y = (aux.tip_occ * attr.tip_spacing + attr.margin_top
                 + attr.legend_spacing)
            aux.tip_occ += 1
        else:
            ly = data[id(node.next.back)].y
            ry = data[id(node.next.next.back)].y
            y = (ly + ry) / 2.0
            _line(fp, x, ly, x, ry, attr.stroke_width)
            _circle(fp, x, y, attr.node_radius)
        _line(fp, px, y, x, y, attr.stroke_width)
        d.y = y
        if node.next is None:
            fp.write(f'<text x="{x + 5:f}" y="{y + attr.font_size / 3.0:f}" '
                     f'font-size="{attr.font_size}" '
                     f'font-family="Arial;">{node.label}</text>\n')
        else:
            fp.write("\n")
    else:
        ly = data[id(node.next.back)].y
        ry = pd.y
        y = (ly + ry) / 2.0
        x = attr.margin_left
        _line(fp, x, ly, x, ry, attr.stroke_width)
        _circle(fp, x, y, attr.node_radius)


def _scaler_init(attr: SvgAttrib, aux: _Aux, tree: UTree, data: dict) -> None:
    for i in range(tree.tip_count):
        node = tree.nodes[i]
        length = node.length
        n = node.back
        while True:
            d = data[id(n)]
            if data[id(n.next.back)].height > d.height:
                n = n.next.back
            elif data[id(n.next.next.back)].height > d.height:
                n = n.next.next.back
            else:
                break
            length += n.length
        if length > aux.max_tree_len:
            aux.max_tree_len = length
        label_len = (attr.font_size / 1.5) * \
            (len(tree.nodes[i].label) if tree.nodes[i].label else 0)
        scale = (aux.canvas_width - label_len) / length
        if i == 0 or scale < aux.scaler:
            aux.scaler = scale
            aux.max_font_len = label_len


def _header(fp, tree: UTree, attr: SvgAttrib, aux: _Aux, data: dict) -> None:
    aux.canvas_width = attr.width - attr.margin_left - attr.margin_right
    _scaler_init(attr, aux, tree, data)
    svg_height = (attr.margin_top + attr.legend_spacing + attr.margin_bottom
                  + attr.tip_spacing * tree.tip_count)
    fp.write(f'<svg xmlns="http://www.w3.org/2000/svg" width="{attr.width}" '
             f'height="{svg_height}" '
             f'style="border: 1px solid #cccccc;">\n')
    if attr.legend_show:
        _line(fp, attr.margin_left, 10,
              (aux.canvas_width - aux.max_font_len) * attr.legend_ratio
              + attr.margin_left, 10, 3)
        fp.write('<text x="{:f}" y="{:f}" font-size="{}" '
                 'font-family="Arial;">{:.{}f}</text>\n'.format(
                     (aux.canvas_width - aux.max_font_len)
                     * attr.legend_ratio + attr.margin_left + 5,
                     20 - attr.font_size / 3.0,
                     attr.font_size,
                     aux.max_tree_len * attr.legend_ratio,
                     attr.precision))


def export_svg(tree: UTree, root: Optional[UNode] = None,
               attr: Optional[SvgAttrib] = None,
               filename: Optional[str] = None) -> Optional[str]:
    """pll_utree_export_svg (utree_svg.c:404-465).

    Returns the SVG text when filename is None, else writes the file."""
    if root is None:
        root = tree.vroot
    if root is None or root.next is None:
        raise ValueError("svg root must be an inner node")
    if attr is None:
        attr = SvgAttrib()

    data: dict = {}
    _set_height(root, data)

    fp = io.StringIO()
    aux = _Aux()
    _header(fp, tree, attr, aux, data)
    _set_offset(root, attr, aux, data)
    _plot(fp, root, attr, aux, data)
    fp.write("</svg>\n")
    text = fp.getvalue()
    if filename is not None:
        with open(filename, "w") as f:
            f.write(text)
        return None
    return text
