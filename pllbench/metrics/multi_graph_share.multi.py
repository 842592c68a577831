"""multi_graph_share.multi (%, higher is better, program counter): the
share of the process's multipartition.loglikelihood calls that replayed
CUDA graphs, 100 * graph_replays / (graph_replays + graph_captures +
eager_calls), from the counters the program keeps on the function since
the process started (the warm-up, the unprofiled and the profiled pass of
a traced run).  A program without the counters (one whose partitioned
forward has no graph path), or one that counted no call, gives None."""


def read(run):
    try:
        from libpll2_tpu_torch import multipartition
    except ImportError:
        return None
    fn = multipartition.loglikelihood
    counts = [getattr(fn, name, None) for name in
              ("graph_replays", "graph_captures", "eager_calls")]
    if any(not isinstance(n, int) for n in counts) or not sum(counts):
        return None
    return 100.0 * counts[0] / sum(counts)
