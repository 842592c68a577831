"""newton_ms.smooth (ms/call, lower is better, program span): the summed
stream ms of the program's `libpll2.newton` spans (the all-edge body's
Newton work of each colour class: its sumtables, its Newton steps and the
f32 keep, on the Newton kernel or on the plain path) per traced smoothing
call.  Read in the profiled pass, so where the host sets the pace it is
mostly the host's time under the profiler (program_spans.py): compare it
with other traced readings of the same cell only.  A program without the
span gives None."""
from pllbench import program_spans


def read(run):
    return program_spans.stream_ms(run, "libpll2.newton")
