"""multi_sweep_roofline.multi (%, higher is better, device trace): the
least time the card could take for one evaluation's CLV sweeps over all
partitions of a partitioned supermatrix over the time the sweep's rows
took per evaluation in the trace.

The work is counted as sweep_roofline.eval counts it, summed over the
partitions at their real sites (padding not counted): each of the
tips - 2 operations multiplies its two children's messages, S FLOP per
(operation, site, rate), and tips - 4 inner children each send a dense
S x S product, 2 * S^2 FLOP per (site, rate).  The bytes: the tips read
once (int32 state codes), every partition's P-matrices of every branch
read once, K * branches * R * S^2 floats, and the two root rows of every
site written once (f32).  The roofs: the card's dense TF32 tensor-core
rate and its HBM bandwidth (peaks.json).

The rows counted are the program's sweep kernels (names holding
"tree_sweep") and the P-matrix layout kernels a sweep launches beside them
("pmatrix_fragments", "pmatrix_gather", "group_pmatrix"); the count of
sweep rows is held to the launches partials_tree.sweep counted.  A trace
that lost rows, or shows none, gives None."""

SWEEP = "tree_sweep"
LAYOUT = ("pmatrix_fragments", "pmatrix_gather", "group_pmatrix")


def work(config):
    """(FLOP, bytes) of one evaluation's sweeps at the config's shape."""
    tips, sites = config["tips"], sum(config["partition_sites"])
    s, r = config["model"]["states"], config["model"]["rate_cats"]
    parts = len(config["partition_sites"])
    ops, inner_children = tips - 2, tips - 4
    branches = 2 * tips - 3
    flop = sites * r * (ops * s + inner_children * 2 * s * s)
    nbytes = 4 * (tips * sites + parts * branches * r * s * s
                  + 2 * r * s * sites)
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
