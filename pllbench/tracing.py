"""Reading the profiler's trace: device rows, host ops, their union and the
check for lost rows.

A frozen copy of the program's profiling.py (`_union_ms`, the raw-event
walk of `profile_kernels`, the lost-row check of `card_fields`), kept
here so that the yardstick does not move with the program.  The idle
share is 1 - U / W: U the union of the device rows' intervals in the
trace of some work, W the host wall time of the same work between two
synchronizes, run without the profiler.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

# host ranges the drivers open with torch.profiler.record_function
SPAN_PREFIX = "pllbench."


@dataclasses.dataclass
class Profile:
    """The rows of one traced piece of work; times in ns on one clock."""
    device: List[Tuple[str, int, int]]      # (name, start, end)
    host: List[Tuple[str, int, int]]        # (name, start, end)
    start: int                               # the traced window
    end: int


@dataclasses.dataclass
class Trace:
    """What a driver hands the per-layer metrics from a traced run."""
    profile: Profile
    wall_s: float           # W: the same work, unprofiled, between syncs
    units: int              # evaluations or rounds in the traced work
    launches: Dict[str, int]  # launches the program's wrappers counted
    spans: Dict[str, List[float]]  # seconds the program's timings gave

    def rows(self, *needles: str) -> List[Tuple[str, int, int]]:
        return [r for r in self.profile.device
                if any(n in r[0] for n in needles)]

    def lost_rows(self) -> Optional[str]:
        """Why the trace cannot be read, or None: it holds fewer rows of a
        counted kernel than its wrapper counted launches."""
        if not self.profile.device:
            return "the trace holds no device row"
        for name, launched in self.launches.items():
            seen = len(self.rows(name))
            if seen < launched:
                return (f"the trace lost device rows: {seen} rows of "
                        f"{name} for {launched} launches")
        return None


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals in ns, in s."""
    total, end = 0, -float("inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e9


def idle_pct(trace: Optional[Trace]) -> Optional[float]:
    """The device's idle share of a traced piece of work, 1 - U / W in %,
    or None where there is no trace or it lost rows."""
    if trace is None or trace.lost_rows():
        return None
    busy = union_s((s, e) for _, s, e in trace.profile.device)
    return 100.0 * (1.0 - busy / trace.wall_s)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(fn: Callable[[], object], device: torch.device) -> float:
    """Host seconds of fn() between two synchronizes."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def profile(fn: Callable[[], object], device: torch.device) -> Profile:
    """fn() under torch.profiler, read from the raw events (building the
    profiler's event tree of a long piece of work takes minutes).  On the
    CPU the trace has host rows only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        sync(device)
        with record_function(SPAN_PREFIX + "window"):
            fn()
            sync(device)
    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        row = (e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            device.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
            if e.name() == SPAN_PREFIX + "window":
                window = row
    if window is None:
        raise RuntimeError("the trace lost the window's own range")
    # a host range opened with record_function also shows on the device's
    # timeline, spanning the device work inside it: not a device row
    ranges = {name for name, _, _ in host}
    device = [r for r in device if r[0] not in ranges]
    return Profile(device, host, window[1], window[2])


def idle_gaps(prof: Profile, top: int = 10) -> List[list]:
    """The device's idle time inside the window, by what the host was
    doing: each gap between merged device rows is put to the innermost
    host row (the latest to start) that spans the gap's middle, or, where
    that is a range of the benchmark's own, to "after <op>", the host op
    that ended last before the middle; the names with the most seconds,
    [name, seconds]."""
    busy = []
    for _, start, stop in sorted(prof.device, key=lambda r: r[1]):
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], stop)
        else:
            busy.append([start, stop])
    edges = [prof.start] + [x for b in busy for x in b] + [prof.end]
    gaps = sorted((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    by_start = sorted(prof.host, key=lambda r: r[1])
    by_end = sorted((r for r in prof.host
                     if not r[0].startswith(SPAN_PREFIX)),
                    key=lambda r: r[2])
    active: list = []          # heap of (-start, end, name)
    by_name: Dict[str, float] = {}
    i = j = 0
    last = None
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(by_start) and by_start[i][1] <= mid:
            row = by_start[i]
            heapq.heappush(active, (-row[1], row[2], row[0]))
            i += 1
        while j < len(by_end) and by_end[j][2] <= mid:
            last = by_end[j][0]
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "none"
        if name.startswith(SPAN_PREFIX) and last is not None:
            name = "after " + last
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) / 1e9
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def device_ops(prof: Profile, top: int = 10) -> List[list]:
    """The device rows' names with the most seconds, [name, seconds]."""
    by_name: Dict[str, float] = {}
    for name, start, stop in prof.device:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e9
    return [[k[:160], v] for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:top]]
