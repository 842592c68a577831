"""message_kernel_share.smooth (%, higher is better, program counter): the
share of the process's message sweeps (engine.message_sweep: each colour
class's sweep of a smoothing call and the final one) that ran the
message-sweep kernel, 100 * kernel_sweeps / (kernel_sweeps +
dense_sweeps), from the counters the program keeps on the function.  The
counters run from the process's start, so they hold the warm-up, the
unprofiled and the profiled pass of a traced run.  A program without the
counters (one from before the kernel), or one that counted no sweep,
gives None."""
from pllbench import program_counters


def read(run):
    return program_counters.message_kernel_share()
