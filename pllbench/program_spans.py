"""The program's own spans in a traced run, for the per-layer metrics of
source `program_span` that read them.

libpll2_tpu_torch.spans records a span while torch.profiler records, so
in a driver's profiled pass, and opens a host range of the span's name
there.  The records of a name read here are the last n the program holds,
n the count of that name's ranges in the run's trace: those of the traced
pass, whatever the process profiled before it.

A span's `stream_ms` is the time between CUDA events recorded on the
current stream at its entry and exit: its kernels plus the device's waits
for the host inside it.  It is read in the profiled pass, so where the
host sets the pace (the evaluation cells' P-matrices and root reduction,
the search's message sweep) it is mostly the host's time under the
profiler, which costs more a launch than the unprofiled work does, and it
spreads from seed to seed; the event pair of a span nested inside another
(the P-matrices inside the ball recursion, the sweep, P-matrices and root
inside a forward) falls inside its parent's interval.  Compare a reading
with readings of the same cell, not with the unprofiled call.

Without a trace, without the spans module (a program from before it),
without a range of the name in the trace, or with fewer records than
ranges, the readers return None and the metric is left out of the line.
"""
from __future__ import annotations

from typing import List, Optional


def found(run, name: str) -> Optional[List[object]]:
    """The program's records of the span `name` in the traced pass, or
    None."""
    if run.trace is None:
        return None
    n = sum(1 for row in run.trace.profile.host if row[0] == name)
    if not n:
        return None
    try:
        from libpll2_tpu_torch import spans
    except ImportError:
        return None
    recs = [r for r in spans.records() if r.name == name]
    return recs[-n:] if len(recs) >= n else None


def stream_ms(run, name: str) -> Optional[float]:
    """The summed stream ms of the spans named `name` per traced unit;
    None where one has no CUDA events (the CPU)."""
    recs = found(run, name)
    if recs is None or any(r.stream_ms is None for r in recs):
        return None
    return sum(r.stream_ms for r in recs) / run.trace.units


def host_ms(run, *names: str) -> Optional[float]:
    """The summed host ms of the spans of the given names per unit; None
    where no name has records."""
    found_ = [found(run, name) for name in names]
    if all(recs is None for recs in found_):
        return None
    return sum(r.host_ms for recs in found_ if recs
               for r in recs) / run.trace.units
