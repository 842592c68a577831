"""Spans: the port's own ranges at the boundaries of its layers.

    with spans.span("pmatrix"):
        ...

Off, the default, a span reads one flag and hands back a shared object
that does nothing: no profiler range, no CUDA event, no allocation.  It is
on while torch.profiler records (the profiler's own enabled flag), or
inside a `recording()` block (profiling.py round reads the ball
recursion's spans so, without the profiler's host cost).  On, a span

1. opens a `torch.profiler.record_function` range named "libpll2.<name>",
   so that a trace shows the span on the profiler's clock beside the
   device rows it holds;
2. appends a `Record` to an in-memory list: its name, its id, the id of
   the span it opened inside, the id of the request (the outermost span
   open when it started: one `libpll2.forward` or `libpll2.search.round`),
   and its host start and end by `time.perf_counter_ns()`;
3. where CUDA is initialised, records a CUDA event on the current stream
   at entry and at exit.  The record's `stream_ms` is the time between the
   two: from the end of the work enqueued before the span to the end of
   its own, so the span's kernels plus the device's waits for the host
   inside it.  Recording adds no synchronize; `records()` synchronizes
   once, where an event is still unread, before it reads them.

The list keeps the last MAX_RECORDS records: the oldest go first, so a
process that profiles again and again holds a bounded number of events.
profiling.profile_kernels clears it before each profile.

A span given a `timings` dict adds its host seconds to
timings[<the last part of its name>] on or off: the phases of
search_fast.spr_round ("setup", "score", "select", "apply", "verify").

Inside a `suppressed()` block every span is off, recording or not:
engine.loglikelihood captures its CUDA graphs so, since an event recorded
into a graph would be replayed outside its span.

Spans nest by the order they open in, on one thread: the port drives a
device from one host thread.  The profiler's trace carries the ranges, so
nothing here exports them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "libpll2."
MAX_RECORDS = 1 << 16

_forced = 0                       # depth of open recording() blocks
_suppressed = 0                   # depth of open suppressed() blocks
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_open: List["Record"] = []        # the spans open now, innermost last
_ids = itertools.count(1)


@dataclasses.dataclass
class Record:
    """One span as it ran (times in ns on time.perf_counter_ns)."""
    name: str                     # "libpll2.<name>", the range's name
    id: int
    parent: Optional[int]         # the span it opened inside, or None
    request: int                  # the outermost span open at its start
    start_ns: int
    end_ns: Optional[int] = None  # None while it is open
    stream_ms: Optional[float] = None   # CUDA events; None without CUDA
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """The span of an off recorder: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _key(name: str) -> str:
    return name.rsplit(".", 1)[-1]


class _Timed:
    """An off span with a timings dict: its host seconds only."""
    __slots__ = ("timings", "key", "t0")

    def __init__(self, name: str, timings: dict):
        self.timings, self.key = timings, _key(name)

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t = self.timings
        t[self.key] = t.get(self.key, 0.0) + \
            (time.perf_counter_ns() - self.t0) / 1e9
        return False


class _Span:
    """A recording span."""
    __slots__ = ("name", "timings", "range", "record")

    def __init__(self, name: str, timings: Optional[dict]):
        self.name, self.timings = name, timings

    def __enter__(self):
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        parent = _open[-1] if _open else None
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        rid = next(_ids)
        rec = Record(PREFIX + self.name, rid,
                     None if parent is None else parent.id,
                     rid if parent is None else parent.request,
                     time.perf_counter_ns(), events=events)
        self.record = rec
        _open.append(rec)
        _records.append(rec)

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        _open.pop()
        if self.timings is not None:
            t, key = self.timings, _key(self.name)
            t[key] = t.get(key, 0.0) + (rec.end_ns - rec.start_ns) / 1e9
        self.range.__exit__(*exc)
        return False


def span(name: str, timings: Optional[dict] = None):
    """A context manager around one layer's work (module docstring)."""
    if _suppressed or not (_forced or _profiler._is_profiler_enabled):
        return _OFF if timings is None else _Timed(name, timings)
    return _Span(name, timings)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block whether or not a profiler runs."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


@contextlib.contextmanager
def suppressed() -> Iterator[None]:
    """Record no span inside this block, whatever else asks for them."""
    global _suppressed
    _suppressed += 1
    try:
        yield
    finally:
        _suppressed -= 1


def records() -> List[Record]:
    """Every closed span recorded since the last clear() (the last
    MAX_RECORDS of them), oldest first, with `stream_ms` read; the list is
    left as it is."""
    done = [r for r in _records if r.end_ns is not None]
    pending = [r for r in done if r.events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.stream_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return done


def clear() -> None:
    """Forget every span recorded so far."""
    _records.clear()
