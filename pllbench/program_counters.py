"""Counters the program keeps on its functions, read by the metrics of
metrics/ whose source is `program_counter`; a program without a counter
gives None."""


def message_kernel_share():
    """100 * kernel_sweeps / (kernel_sweeps + dense_sweeps) of
    engine.message_sweep since the process started, or None."""
    try:
        from libpll2_tpu_torch import engine
    except ImportError:
        return None
    fn = engine.message_sweep
    counts = [getattr(fn, name, None)
              for name in ("kernel_sweeps", "dense_sweeps")]
    if any(not isinstance(n, int) for n in counts) or not sum(counts):
        return None
    return 100.0 * counts[0] / sum(counts)
