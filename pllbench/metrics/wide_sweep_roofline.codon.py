"""wide_sweep_roofline.codon (%, higher is better, device trace): the least
time the card could take for one evaluation's CLV sweep at the cell's
shape over the time the wide sweep's rows took per evaluation in the
trace.

The work is sweep_roofline.eval's: each of the tips - 2 operations
multiplies its two children's messages, S FLOP per (operation, site,
rate); each of tips - 4 inner children sends a dense S x S product, 2 *
S^2 FLOP per (site, rate); a tip child's message is a column of P, picked
with no product.  The bytes are the tips read once as the int64 state
codes that states above 32 take (8 bytes a code), every branch's
P-matrices read once (f32) and the two root rows written once (f32).  The
compute roof is the card's dense TF32 tensor-core rate, the fastest unit
on which an f32-accurate form can do the products, so no form reads over
100 %; the memory roof is its HBM bandwidth (peaks.json).

The rows counted are those of the wide form's sweep kernel (names holding
"tree_sweep_wide") and of the P-matrix layout kernel it launches beside
it ("wide_pmatrix").  The count of sweep rows is held to the sweep
launches the driver counted in the traced pass, and the program's
sweep.launches_by_mode["wide"] has to be there: a program without the
wide form (one from before it) gives None, and so does a trace in which
another form ran."""

SWEEP = "tree_sweep_wide"
LAYOUT = ("wide_pmatrix",)
LAUNCHES = "tree_sweep"       # the driver's count of the traced pass


def work(config):
    """(FLOP, bytes) of one evaluation's sweep at the config's shape."""
    tips, sites = config["tips"], config["sites"]
    s, r = config["model"]["states"], config["model"]["rate_cats"]
    ops, inner_children = tips - 2, tips - 4
    branches = 2 * tips - 3
    flop = sites * r * (ops * s + inner_children * 2 * s * s)
    nbytes = 8 * tips * sites + 4 * (branches * r * s * s
                                     + 2 * r * s * sites)
    return flop, nbytes


def bound_s(config, peaks):
    flop, nbytes = work(config)
    return max(flop / peaks["tf32_flop_per_s"],
               nbytes / peaks["hbm_byte_per_s"])


def _program_counts():
    try:
        from libpll2_tpu_torch.ops import partials_tree
    except ImportError:
        return None
    return getattr(partials_tree.sweep, "launches_by_mode", {}).get("wide")


def read(run):
    trace = run.trace
    if trace is None or run.peaks is None or trace.lost_rows():
        return None
    if not isinstance(_program_counts(), int):
        return None
    sweeps = trace.rows(SWEEP)
    if not sweeps or len(sweeps) != trace.launches.get(LAUNCHES):
        return None
    seconds = sum(e - s for _, s, e in trace.rows(SWEEP, *LAYOUT)) / 1e9
    return 100.0 * bound_s(run.config, run.peaks) * trace.units / seconds
