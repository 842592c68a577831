"""setup_s (s, lower is better, host clock): from the start of the run's
process to the first measured call: imports, the card, loading (or, in a
fresh checkout, building) the kernels, the inputs, the program's set-up
and the warm-up."""


def read(run):
    return run.setup_s
