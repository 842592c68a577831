from .compare import rf_distance, rf_distance_normalized, splits
from .newick import (parse_newick, parse_newick_rooted, parse_newick_string,
                     parse_newick_string_rooted, parse_newick_string_unroot,
                     parse_newick_unroot, unroot_inplace)
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
    "rf_distance", "rf_distance_normalized", "splits",
]
