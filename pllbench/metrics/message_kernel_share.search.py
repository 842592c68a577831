"""message_kernel_share.search (%, higher is better, program counter): the
share of the process's message sweeps (engine.message_sweep: a round's
base sweep and the verification's exact logL) that ran the message-sweep
kernel, 100 * kernel_sweeps / (kernel_sweeps + dense_sweeps), from the
counters the program keeps on the function, from the process's start.  A
program without the counters (one from before the kernel), or one that
counted no sweep, gives None."""
from pllbench import program_counters


def read(run):
    return program_counters.message_kernel_share()
