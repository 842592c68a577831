from .compare import rf_distance, rf_distance_normalized, splits
from .newick import (parse_newick, parse_newick_rooted, parse_newick_string,
                     parse_newick_string_rooted, parse_newick_string_unroot,
                     parse_newick_unroot, unroot_inplace)
from .rtree import (RNode, RTree, export_rtree_newick, parse_rtree,
                    parse_rtree_string, reset_rtree_template_indices,
                    rtree_create_operations, rtree_create_pars_buildops,
                    rtree_create_pars_recops, rtree_to_utree, rtree_traverse,
                    show_ascii_rtree)
from .svg import SvgAttrib, export_svg
from .utree import (UNode, UTree, check_integrity, clone_graph,
                    create_operations, create_pars_buildops, export_newick,
                    reset_template_indices, show_ascii, traverse, wrap_tree)

__all__ = [
    "UNode", "UTree", "traverse", "create_operations", "export_newick",
    "show_ascii", "reset_template_indices", "wrap_tree", "clone_graph",
    "check_integrity", "create_pars_buildops",
    "parse_newick", "parse_newick_rooted", "parse_newick_unroot",
    "parse_newick_string", "parse_newick_string_rooted",
    "parse_newick_string_unroot", "unroot_inplace",
    "RNode", "RTree", "parse_rtree", "parse_rtree_string",
    "export_rtree_newick", "reset_rtree_template_indices",
    "rtree_create_operations", "rtree_create_pars_buildops",
    "show_ascii_rtree",
    "rtree_create_pars_recops", "rtree_to_utree", "rtree_traverse",
    "SvgAttrib", "export_svg",
    "rf_distance", "rf_distance_normalized", "splits",
]
