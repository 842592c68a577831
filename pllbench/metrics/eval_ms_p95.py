"""eval_ms_p95 (ms, lower is better, host clock): the 95th percentile of
the latencies of all evaluations of the window, each from the call of
engine.loglikelihood until its logL is a float on the host.  Linear
interpolation between order statistics (numpy's default, and
statistics.quantiles' "inclusive" method)."""


def percentile(values, q):
    """The q-th percentile (0-100) of values, interpolated linearly."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def read(run):
    if run.window_s is None or not run.latencies_s:
        return None
    return percentile(run.latencies_s, 95.0) * 1e3
