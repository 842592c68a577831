"""search_host_ms.search (ms/round, lower is better, program span): the
host ms of the program's `libpll2.search.select` and
`libpll2.search.apply` spans (greedy move selection; the surgery on the
tree and compile_spr of the new topology) per traced round.  Both phases
launch no device work, so their host clock is their whole cost; the
profiler's host overhead is small there (numpy and Python only)."""
from pllbench import program_spans


def read(run):
    return program_spans.host_ms(run, "libpll2.search.select",
                                 "libpll2.search.apply")
