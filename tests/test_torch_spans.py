"""The port's spans (libpll2_tpu_torch/spans.py): off, a span touches
neither the profiler nor CUDA; on, records nest with their parent and
request ids and the profiler's trace holds the ranges inside one another
as the layers call one another; spr_round's timings keep their phases.
The last test needs a card: select and apply launch no device work."""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from libpll2_tpu_torch import engine, search_fast, spans
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.models.gamma import compute_gamma_cats
from libpll2_tpu_torch.tree.generate import random_newick, simulate_alignment

SUBST = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
FREQS = [0.28, 0.24, 0.22, 0.26]
PHASES = ("setup", "score", "select", "apply", "verify")


def search_case(device, n=14, sites=128, seed=3):
    """A random start tree, an alignment simulated down another, f32 with
    the edge scorer taken (its plain version on CPU tensors)."""
    rng = np.random.default_rng(seed)
    rates = compute_gamma_cats(0.8, 4)
    truth = T.parse_newick_string(random_newick(n, rng))
    chars = simulate_alignment(truth, sites, rng, SUBST, FREQS, rates)
    start = T.parse_newick_string(random_newick(n, rng))
    cfg = PartitionConfig(
        tips=n, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=torch.float32,
        use_kernel=True)
    model = engine.make_model([SUBST], [FREQS], rates, dtype=torch.float32,
                              device=device)
    return search_fast.compile_spr(start, cfg, radius=3), model, chars


def forward(device):
    """One engine.loglikelihood call on a small DNA case."""
    case = engine.build_case(10, 64, device=device)
    cfg, program, model, bl, tips, pw, inv = case
    return engine.loglikelihood(program, cfg, model, bl, tips, pw, inv)


def both(device):
    """A search round with its timings, then a forward."""
    prog, model, chars = search_case(device)
    timings: dict = {}
    search_fast.spr_round(prog, model, chars, timings=timings)
    forward(device)
    return timings


def host_rows(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def inside(rows, outer, inner):
    """The rows named `inner` that lie within a row named `outer`."""
    outers = [(s, e) for n, s, e in rows if n == outer]
    return [(n, s, e) for n, s, e in rows if n == inner
            and any(s0 <= s and e <= e0 for s0, e0 in outers)]


@pytest.fixture(scope="module")
def profiled():
    """The host rows of a round and a forward under torch.profiler on
    the CPU, and the span records of the same work."""
    spans.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        timings = both(torch.device("cpu"))
    recs = spans.records()
    spans.clear()
    return host_rows(prof), recs, timings


def test_off_touches_neither_profiler_nor_cuda(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("an off span reached the profiler or CUDA")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    spans.clear()
    timings = both(torch.device("cpu"))
    assert spans.records() == []
    assert set(PHASES) <= set(timings)
    assert spans.span("pmatrix") is spans.span("message_sweep")


@pytest.mark.parametrize("on", [False, True])
def test_timings_keep_their_phases(on):
    """spr_round's timings: the five phases in seconds, on or off, with
    the scorer's keys and the verification's."""
    spans.clear()
    if on:
        with spans.recording():
            timings = both(torch.device("cpu"))
    else:
        timings = both(torch.device("cpu"))
    spans.clear()
    for key in PHASES:
        assert isinstance(timings[key], float) and timings[key] > 0, key
    assert timings["scorer"] == "kernel" and timings["n_applied"] > 1
    assert timings["ladder"] in (0, 1, 2)
    assert not {"n_improving", "n_cand_improving", "n_chosen"} & set(timings)


def test_records_nest():
    spans.clear()
    with spans.recording():
        with spans.span("a"):
            with spans.span("b"):
                with spans.span("c"):
                    pass
            with spans.span("d"):
                pass
        with spans.span("e"):
            pass
    with spans.span("f"):           # off again: not recorded
        pass
    recs = spans.records()
    spans.clear()
    assert [r.name for r in recs] == [f"libpll2.{k}" for k in "abcde"]
    a, b, c, d, e = recs
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == \
        (None, a.id, b.id, a.id, None)
    assert {r.request for r in (a, b, c, d)} == {a.id}
    assert e.request == e.id != a.id
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns
    assert all(r.stream_ms is None and r.host_ms >= 0 for r in recs)


def test_timings_dict_adds_up():
    timings: dict = {}
    for _ in range(2):
        with spans.span("search.score", timings):
            pass
    first = timings["score"]
    with spans.recording():
        with spans.span("search.score", timings):
            pass
    spans.clear()
    assert set(timings) == {"score"} and timings["score"] > first > 0


def test_clear_forgets_the_records():
    with spans.recording():
        with spans.span("a"):
            pass
    assert spans.records()
    spans.clear()
    assert spans.records() == []


@pytest.mark.parametrize("outer,inner", [
    ("libpll2.search.round", "libpll2.search.setup"),
    ("libpll2.search.round", "libpll2.search.score"),
    ("libpll2.search.round", "libpll2.search.select"),
    ("libpll2.search.round", "libpll2.search.apply"),
    ("libpll2.search.round", "libpll2.search.verify"),
    ("libpll2.search.score", "libpll2.message_sweep"),
    ("libpll2.search.score", "libpll2.ball_recursion"),
    ("libpll2.search.score", "libpll2.edge_scorer"),
    ("libpll2.search.score", "libpll2.root"),
    ("libpll2.search.round", "libpll2.ball_recursion"),
    ("libpll2.search.round", "libpll2.edge_scorer"),
    ("libpll2.search.apply", "libpll2.search.compile_spr"),
    ("libpll2.ball_recursion", "libpll2.pmatrix"),
    ("libpll2.forward", "libpll2.pmatrix"),
    ("libpll2.forward", "libpll2.sweep"),
    ("libpll2.forward", "libpll2.root"),
])
def test_trace_holds_the_ranges_inside_one_another(profiled, outer, inner):
    rows, _, _ = profiled
    assert inside(rows, outer, inner), (outer, inner)


@pytest.mark.parametrize("top", ["libpll2.search.round", "libpll2.forward"])
def test_records_share_their_request(profiled, top):
    """Every span under a round or a forward carries its request id, and
    the records match the trace's ranges one for one."""
    rows, recs, _ = profiled
    tops = [r for r in recs if r.name == top]
    assert len(tops) == 1
    under = [r for r in recs if r.request == tops[0].id]
    assert len(under) > 3
    ids = {r.id for r in under}
    assert all(r.parent in ids for r in under if r is not tops[0])
    named = sorted(r[0] for r in rows if r[0].startswith(spans.PREFIX))
    assert named == sorted(r.name for r in recs)


def test_stream_ms_is_none_on_the_cpu(profiled):
    _, recs, _ = profiled
    assert recs and all(r.stream_ms is None for r in recs)


@pytest.mark.cuda
def test_select_and_apply_launch_no_device_work():
    """On the card, the host phases of a round hold no kernel launch, copy
    or fill in the trace (the spans' own event records aside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    prog, model, chars = search_case(device, n=24, sites=256)
    search_fast.spr_round(prog, model, chars)           # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        new, _, moves = search_fast.spr_round(prog, model, chars)
        torch.cuda.synchronize()
    spans.clear()
    rows = host_rows(prof)
    assert moves > 0
    for phase in ("libpll2.search.select", "libpll2.search.apply"):
        spans_of = [(s, e) for n, s, e in rows if n == phase]
        assert spans_of, phase
        found = [n for n, s, e in rows
                 if any(w in n for w in ("LaunchKernel", "Memcpy", "Memset"))
                 and any(s0 <= s and e <= e0 for s0, e0 in spans_of)]
        assert not found, (phase, found)


def test_records_keep_the_last(monkeypatch):
    """The list is bounded: past its length the oldest records go."""
    monkeypatch.setattr(spans, "_records",
                        spans.collections.deque(maxlen=3))
    with spans.recording():
        for k in "abcde":
            with spans.span(k):
                pass
    assert [r.name for r in spans.records()] == \
        [f"libpll2.{k}" for k in "cde"]
    assert spans.MAX_RECORDS >= 1 << 16


class Event:
    """A raw profiler event as profiling.read_events reads it."""

    def __init__(self, device, name, start, dur, corr=0, linked=0):
        self.device, self.label = device, name
        self.start, self.dur, self.corr, self.linked = start, dur, corr, linked

    def device_type(self):
        return self.device

    def name(self):
        return self.label

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


@pytest.mark.parametrize("ranges", [
    (), ("libpll2.forward", "libpll2.edge_scorer"), ("user.range",)])
def test_profile_leaves_out_the_ranges_device_rows(ranges):
    """A host range also leaves a CUDA row spanning the work inside it:
    profile_kernels counts it neither as kernel time nor as a matched or
    own row, so a spanned profile reads as one without spans."""
    from libpll2_tpu_torch import profiling
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Event(cpu, "aten::mm", 0, 10, corr=1),
              Event(cuda, "void edge_score_kernel<4>", 100, 1_000_000,
                    linked=1),
              Event(cuda, "void tree_sweep<4>", 3_000_000, 1_000_000),
              Event(cuda, "Memset (Device)", 4_000_000, 0),
              Event(cuda, "libpll2.root", 100, 3_999_900)]
    for k, name in enumerate(ranges):
        events += [Event(cpu, name, 0, 9_000_000, corr=10 + k),
                   Event(cuda, name, 100, 3_999_900)]
    prof = profiling.read_events(events, wall_ms=10.0, profiled=12.0)
    assert prof.kernel_ms == pytest.approx(2.0)
    assert [r[0] for r in prof.rows] == ["void edge_score_kernel<4>",
                                         "void tree_sweep<4>",
                                         "Memset (Device)"]
    assert prof.ops == {"aten::mm": pytest.approx(1.0)}
    fields = profiling.card_fields(prof, own_launches=2, reps=1,
                                   match="edge_score")
    assert fields["own_rows"] == 2 and fields["matched_ms"] == \
        pytest.approx(1.0)
    assert fields["idle_share"] == pytest.approx(0.8)


@pytest.mark.cuda
def test_profile_reads_as_without_spans(monkeypatch):
    """On the card, a profile of a spanned round holds the same device
    rows as with the spans held off, and about the same kernel time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from libpll2_tpu_torch import profiling
    device = torch.device("cuda", 0)
    prog, model, chars = search_case(device, n=24, sites=256)

    def work():
        search_fast.spr_round(prog, model, chars)
        forward(device)
    work()
    profiles = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(spans, "span", lambda name, timings=None:
                                spans._OFF if timings is None
                                else spans._Timed(name, timings))
        launches = profiling._own_launches()
        prof = profiling.profile_kernels(work)
        profiles[on] = (prof, profiling.card_fields(
            prof, profiling._own_launches() - launches, 1,
            match="edge_score"))
    spans.clear()
    (on, f_on), (off, f_off) = profiles[True], profiles[False]
    assert sorted((n, c) for n, _, c in on.rows) == \
        sorted((n, c) for n, _, c in off.rows)
    assert f_on["own_rows"] == f_off["own_rows"] > 0
    for key in ("kernel_ms", "matched_ms"):
        assert f_on[key] == pytest.approx(f_off[key], rel=0.25), key


def test_profiling_reads_the_recursion_spans():
    """profiling.py round's recurse_ms: the spans' stream ms per call,
    None without CUDA events."""
    from libpll2_tpu_torch import profiling
    spans.clear()
    assert profiling.span_ms("libpll2.ball_recursion", 2) is None
    with spans.recording():
        for _ in range(3):
            with spans.span("ball_recursion"):
                pass
        with spans.span("edge_scorer"):
            pass
    assert profiling.span_ms("libpll2.ball_recursion", 2) is None
    for r in spans.records():
        r.stream_ms = 4.0
    assert profiling.span_ms("libpll2.ball_recursion", 2) == 6.0
    spans.clear()
