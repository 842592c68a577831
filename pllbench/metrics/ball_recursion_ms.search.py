"""ball_recursion_ms.search (ms/round, lower is better, program span):
the summed stream ms of the program's `libpll2.ball_recursion` spans
(search_fast._recurse: every candidate batch's recursion over its ball,
with the merged edges' P-matrices, whose spans' own event pairs fall
inside it) per traced round.  The device sets the pace here, so the
profiler's host overhead moves it little (program_spans.py)."""
from pllbench import program_spans


def read(run):
    return program_spans.stream_ms(run, "libpll2.ball_recursion")
