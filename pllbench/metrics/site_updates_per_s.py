"""site_updates_per_s (site-updates/s, higher is better, host clock): the
work of every evaluation completed in the window, (tips - 2) * sites each
(one CLV operation on one alignment column over all rate categories, the
JAX bench's unit), over the window's seconds."""


def read(run):
    if run.window_s is None or not run.latencies_s:
        return None
    return run.units * run.work_per_unit / run.window_s
