"""pmatrix_ms.eval (ms/eval, lower is better, program span): the summed
stream ms of the program's `libpll2.pmatrix` spans
(ops/pmatrix.compute_pmatrices) per traced evaluation.  Small kernels
whose launches set the pace: read in the profiled pass, it is mostly the
host's time under the profiler, several times the unprofiled layer's, and
it spreads from seed to seed (program_spans.py).  Compare it with other
traced readings of the same cell only."""
from pllbench import program_spans


def read(run):
    return program_spans.stream_ms(run, "libpll2.pmatrix")
