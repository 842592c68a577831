"""message_sweep_ms.search (ms/round, lower is better, program span): the
summed stream ms of the program's `libpll2.message_sweep` spans
(engine.message_sweep: the dense all-directions sweep of a round's score
phase and of the verification's exact logL) per traced round.  Its
launches set the pace at this size: read in the profiled pass, it is
mostly the host's time under the profiler, and it spreads from seed to
seed (program_spans.py).  Compare it with other traced readings of the
same cell only."""
from pllbench import program_spans


def read(run):
    return program_spans.stream_ms(run, "libpll2.message_sweep")
