"""device_idle.eval (%, lower is better, device trace): 1 - U / W over the
traced evaluations: U the union of the device rows' intervals in the
trace, W the host wall time of the same evaluations run without the
profiler between two synchronizes."""
from pllbench import tracing


def read(run):
    return tracing.idle_pct(run.trace)
