"""message_sweep_ms.smooth (ms/call, lower is better, program span): the
summed stream ms of the program's `libpll2.message_sweep` spans
(engine.message_sweep: the dense all-directions sweep before each colour
class's Newton steps and the final one) per traced smoothing call.  Its
launches set the pace at this size: read in the profiled pass, it is
mostly the host's time under the profiler, and it spreads from seed to
seed (program_spans.py).  Compare it with other traced readings of the
same cell only."""
from pllbench import program_spans


def read(run):
    return program_spans.stream_ms(run, "libpll2.message_sweep")
