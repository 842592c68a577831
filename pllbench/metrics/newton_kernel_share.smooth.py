"""newton_kernel_share.smooth (%, higher is better, program counter): the
share of the process's colour classes smoothed by the Newton kernel, 100 *
kernel_classes / (kernel_classes + plain_classes), from the counters
engine.newton_choice keeps on itself.  The counters run from the
process's start, so they hold the warm-up, the unprofiled and the profiled
pass of a traced run.  A program without the counters (one from before
the kernel), or one that smoothed no class, gives None."""


def read(run):
    try:
        from libpll2_tpu_torch import engine
    except ImportError:
        return None
    fn = getattr(engine, "newton_choice", None)
    counts = [getattr(fn, name, None)
              for name in ("kernel_classes", "plain_classes")]
    if any(not isinstance(n, int) for n in counts) or not sum(counts):
        return None
    return 100.0 * counts[0] / sum(counts)
