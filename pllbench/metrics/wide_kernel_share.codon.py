"""wide_kernel_share.codon (%, higher is better, program counter): the
share of the process's CLV sweeps above 32 states that ran the wide
kernel, 100 * wide / (wide + wide_dense_calls), from the counters the
program keeps on ops/partials_tree.sweep: wide is launches_by_mode["wide"]
(a graph replay counts the launch its capture made), wide_dense_calls the
sweeps above 32 states that engine._tree_rows ran on the dense path.  The counters run from the process's start,
so they hold the warm-up, the unprofiled and the profiled pass of a traced
run.  A program without the counters (one from before the wide form), or
one that swept nothing above 32 states, gives None."""


def read(run):
    try:
        from libpll2_tpu_torch.ops import partials_tree
    except ImportError:
        return None
    by_mode = getattr(partials_tree.sweep, "launches_by_mode", {})
    counts = [by_mode.get("wide"),
              getattr(partials_tree.sweep, "wide_dense_calls", None)]
    if any(not isinstance(n, int) for n in counts) or not sum(counts):
        return None
    return 100.0 * counts[0] / sum(counts)
