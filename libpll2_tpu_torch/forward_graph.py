"""CUDA graphs of the forward: engine.loglikelihood's device work captured
once per input key and replayed, so that a caller who evaluates the same
tree, model and alignment again and again with new branch lengths (a
branch-length or model optimiser) pays one graph launch a stage instead of
the host's launch of every kernel and plain-torch op.

The graph path runs the eager path's code: the same kernels, the same ops,
the same arithmetic, so a replayed logL equals the eager one bit for bit.

* Eligibility (`eligible`): a CUDA device, no process group, a tree-sweep
  form chosen (the dense path stays eager), no input that needs a gradient
  while grad mode is on, and a stream that is not capturing already.
* Key (`key`): the program object, the configuration, the device, shape,
  dtype, stride and address of every model tensor the forward reads and of
  tipchars, pattern_weights and invariant, and the shape and dtype of the
  branch lengths.  A key holds strong references to its tensors, so their
  addresses cannot pass to another tensor while it is held; the graphs
  read the tensors at replay, so a model changed in place is read there.
* Capture (`Cache.call`): a key is captured the CAPTURE_SIGHTING-th time
  it is seen, so one-shot callers run eager; at most MAX_GRAPHS keys hold
  graphs (and as many keys are remembered as seen), the least recently
  used evicted.  The capture call computes its own result eagerly on the
  capture stream, then captures the P-matrices, the sweep and the root
  reduction as three graphs in one memory pool, with spans suppressed.
* Replay (`Graphs.replay`): the branch lengths are copied into the static
  buffer, each graph replays inside its span ("pmatrix", "sweep", "root"),
  the sweep's launch counters advance by what its capture launched, and
  the logL returned is a copy of the static output.
"""
from __future__ import annotations

import collections
import warnings
from typing import Callable, Optional, Sequence

import torch

from . import spans
from .ops import partials_tree

MAX_GRAPHS = 8          # keys that hold graphs, least recently used evicted
CAPTURE_SIGHTING = 2    # a key is captured the time it is seen this often

EAGER, CAPTURE, REPLAY = "eager_calls", "graph_captures", "graph_replays"


def eligible(device: torch.device, group, choice, tensors: Sequence,
             grad_enabled: bool, capturing: bool) -> bool:
    """Whether a call may take the graph path: CUDA, no `group`, a sweep
    form chosen (`choice` not None), no tensor of `tensors` that requires
    grad while `grad_enabled`, and not `capturing` already."""
    if device.type != "cuda" or group is not None or choice is None:
        return False
    if capturing:
        return False
    return not (grad_enabled and any(getattr(t, "requires_grad", False)
                                     for t in tensors))


def key(program, cfg, device: torch.device, tensors: Sequence[torch.Tensor],
        branch_lengths: torch.Tensor) -> tuple:
    """The cache key of a call (module docstring)."""
    return (program, cfg, device,
            tuple((tuple(t.shape), t.dtype, t.stride(), t.data_ptr())
                  for t in tensors),
            (tuple(branch_lengths.shape), branch_lengths.dtype))


class Cache:
    """Keys seen and keys captured, each an LRU of at most `size`."""

    def __init__(self, size: int = MAX_GRAPHS):
        self.size = size
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()

    def _put(self, table, k, value):
        table[k] = value
        while len(table) > self.size:
            table.popitem(last=False)

    def call(self, k: tuple, refs: tuple, eager: Callable[[], object],
             capture: Callable[[], tuple],
             replay: Callable[[object], object]):
        """(result, how): replay(graphs) where `k` holds graphs; else
        eager() until its CAPTURE_SIGHTING-th sighting, where capture()
        gives (result, graphs or None); None (a capture that failed)
        keeps the key eager.  `how` is EAGER, CAPTURE or REPLAY; `refs`
        are the key's tensors and program, held while the key is."""
        if k in self.graphs:
            self.graphs.move_to_end(k)
            graphs = self.graphs[k][0]
            if graphs is None:
                return eager(), EAGER
            return replay(graphs), REPLAY
        count = self.seen.pop(k, (0, None))[0] + 1
        if count < CAPTURE_SIGHTING:
            self._put(self.seen, k, (count, refs))
            return eager(), EAGER
        result, graphs = capture()
        self._put(self.graphs, k, (graphs, refs))
        return result, CAPTURE

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()


def _sweep_counts() -> tuple:
    s = partials_tree.sweep
    return (s.launches, dict(s.launches_by_mode), s.launches_generic,
            dict(s.launches_bf16))


def _set_sweep_counts(counts: tuple) -> None:
    s = partials_tree.sweep
    s.launches, by_mode, s.launches_generic, bf16 = counts
    s.launches_by_mode.update(by_mode)
    s.launches_bf16.update(bf16)


def _sweep_delta(after: tuple, before: tuple) -> tuple:
    return (after[0] - before[0],
            {m: after[1][m] - before[1][m] for m in after[1]},
            after[2] - before[2],
            {m: after[3][m] - before[3][m] for m in after[3]})


def _add_sweep_counts(delta: tuple) -> None:
    s = partials_tree.sweep
    s.launches += delta[0]
    for m, n in delta[1].items():
        s.launches_by_mode[m] += n
    s.launches_generic += delta[2]
    for m, n in delta[3].items():
        s.launches_bf16[m] += n


class Graphs:
    """One key's three graphs, their static tensors and the sweep launches
    a replay of the sweep graph makes."""

    def __init__(self, graphs: tuple, branch_lengths: torch.Tensor,
                 out: torch.Tensor, sweep_delta: tuple, held: tuple):
        self.graphs = graphs
        self.branch_lengths = branch_lengths     # static input
        self.out = out                           # static logL
        self.sweep_delta = sweep_delta
        self.held = held                         # the graphs' other tensors

    def replay(self, branch_lengths) -> torch.Tensor:
        pmatrix, sweep, root = self.graphs
        with spans.span("pmatrix"):
            self.branch_lengths.copy_(branch_lengths)
            pmatrix.replay()
        with spans.span("sweep"):
            sweep.replay()
            _add_sweep_counts(self.sweep_delta)
        with spans.span("root"):
            root.replay()
            return self.out.clone()


_streams: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _captured(fn: Callable[[], object], pool) -> tuple:
    """(graph, fn's output) with fn's work captured on the current
    stream into `pool`."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        out = fn()
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass
        raise
    graph.capture_end()
    return graph, out


def capture(stages: tuple, eager: Callable[[], torch.Tensor],
            device: torch.device, branch_lengths: torch.Tensor) -> tuple:
    """(this call's logL, Graphs or None).  stages: (bl -> pmatrix,
    pmatrix -> sweep rows, (rows, pmatrix) -> logL), the eager path's own
    pieces.  The logL is eager()'s on the capture stream, which also makes
    whatever the stream's first use of a library allocates before any
    capture.  A capture that raises gives None with a warning, and the key
    stays eager."""
    pm_stage, sweep_stage, root_stage = stages
    current = torch.cuda.current_stream(device)
    stream = _capture_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        result = eager()
    result.record_stream(current)
    # the static input, written by each replay before the graphs run
    bl = torch.empty(branch_lengths.shape, dtype=branch_lengths.dtype,
                     device=device)
    before = _sweep_counts()
    graphs: Optional[Graphs] = None
    try:
        with spans.suppressed(), torch.cuda.stream(stream):
            pool = torch.cuda.graph_pool_handle()
            g_pm, pmatrix = _captured(lambda: pm_stage(bl), pool)
            g_sweep, rows = _captured(lambda: sweep_stage(pmatrix), pool)
            g_root, out = _captured(lambda: root_stage(rows, pmatrix), pool)
        graphs = Graphs((g_pm, g_sweep, g_root), bl, out,
                        _sweep_delta(_sweep_counts(), before),
                        (pmatrix, rows))
    except Exception as err:      # noqa: BLE001 - the eager result stands
        warnings.warn(f"engine.loglikelihood runs this key eagerly: its "
                      f"CUDA graph capture failed: {err}", RuntimeWarning,
                      stacklevel=5)
    finally:
        _set_sweep_counts(before)
    current.wait_stream(stream)
    return result, graphs
