"""sweep_roofline.eval (%, higher is better, device trace): the least time
the card could take for one evaluation's CLV sweep over the time the
sweep's rows took per evaluation in the trace.

The work is counted from the cell's shape, whatever form ran, as the
least any form must do.  Each of the tips - 2 operations multiplies its
two children's messages, S FLOP per (operation, site, rate).  A child
that is an inner node sends a dense S x S product, 2 * S^2 FLOP per (site,
rate); a tip child's message is a column of P, picked with no product.
Tips - 4 children are inner nodes wherever the tree is rooted between two
inner nodes, and tips - 3 where one end of the root edge is a tip, so the
count takes tips - 4.  The bytes are the tips read once (the
program's int32 state codes), every branch's P-matrices read once (f32)
and the two root rows written once (f32).  The compute roof is the card's
dense TF32 tensor-core rate, the fastest unit on which an f32-accurate
form can do the products, so no form reads over 100 %; the memory roof is
its HBM bandwidth (peaks.json).

The rows counted are the program's sweep kernels (names holding
"tree_sweep") and the P-matrix layout kernels a sweep launches beside them
("pmatrix_fragments", "pmatrix_gather", "group_pmatrix"); the count of
sweep rows is held to the launches partials_tree.sweep counted."""

SWEEP = "tree_sweep"
LAYOUT = ("pmatrix_fragments", "pmatrix_gather", "group_pmatrix")


def work(config):
    """(FLOP, bytes) of one evaluation's sweep at the config's shape."""
    tips, sites = config["tips"], config["sites"]
    s, r = config["model"]["states"], config["model"]["rate_cats"]
    ops, inner_children = tips - 2, tips - 4
    branches = 2 * tips - 3
    flop = sites * r * (ops * s + inner_children * 2 * s * s)
    nbytes = 4 * (tips * sites + branches * r * s * s + 2 * r * s * sites)
    return flop, nbytes


def bound_s(config, peaks):
    flop, nbytes = work(config)
    return max(flop / peaks["tf32_flop_per_s"],
               nbytes / peaks["hbm_byte_per_s"])


def read(run):
    trace = run.trace
    if trace is None or run.peaks is None or trace.lost_rows():
        return None
    sweeps = trace.rows(SWEEP)
    if not sweeps or len(sweeps) != trace.launches.get(SWEEP):
        return None
    seconds = sum(e - s for _, s, e in trace.rows(SWEEP, *LAYOUT)) / 1e9
    return 100.0 * bound_s(run.config, run.peaks) * trace.units / seconds
