"""eval_launches.eval (launches/eval, lower is better, device trace):
device rows (kernels, memcpy, memset) per evaluation in the trace, where
the trace lost no row of the program's counted kernels."""


def read(run):
    trace = run.trace
    if trace is None or trace.lost_rows():
        return None
    return len(trace.profile.device) / trace.units
