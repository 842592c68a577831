"""multi_pad_share.multi (%, lower is better, program counter): the share
of padding in the site columns the partitioned forward swept,
100 * pad_columns / (real_columns + pad_columns), from the counters the
program keeps on multipartition.loglikelihood since the process started
(each partition's columns padded to its sites_padded, so that no site
block of the batched sweep spans two partitions).  A program without the
counters, or one that counted no column, gives None."""


def read(run):
    try:
        from libpll2_tpu_torch import multipartition
    except ImportError:
        return None
    fn = multipartition.loglikelihood
    real = getattr(fn, "real_columns", None)
    pad = getattr(fn, "pad_columns", None)
    if not isinstance(real, int) or not isinstance(pad, int) or \
            not real + pad:
        return None
    return 100.0 * pad / (real + pad)
