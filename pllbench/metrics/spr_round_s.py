"""spr_round_s (s, lower is better, host clock): the window's seconds over
the SPR rounds completed in it.  The window holds whole climbs one after
another, so it counts the host's surgery, each round's compile_spr and
the compile_spr of every new start tree."""


def read(run):
    if run.window_s is None or not run.units:
        return None
    return run.window_s / run.units
