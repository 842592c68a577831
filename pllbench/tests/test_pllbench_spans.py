"""The readers of the program's spans on hand-built records: the summed
stream ms or host ms of the named spans per traced unit, the last records
of a name as many as the trace holds ranges of it, and None without a
trace, without a range or record of the name, with fewer records than
ranges, without CUDA events or without the program's spans module."""
import sys
from types import SimpleNamespace

import pytest

from libpll2_tpu_torch import spans

from .test_pllbench_metrics import metric

STREAM = {"ball_recursion_ms.search": "libpll2.ball_recursion",
          "message_sweep_ms.search": "libpll2.message_sweep",
          "pmatrix_ms.eval": "libpll2.pmatrix",
          "root_ms.eval": "libpll2.root"}


def record(name, host_ms, stream_ms, rid=1):
    return spans.Record(name, rid, None, rid, 0, int(host_ms * 1e6),
                        stream_ms)


def run(units=2, ranges=None):
    """A traced run whose trace holds the given host ranges, by default
    one of each record the readers are handed (`held`)."""
    rows = [(name, 0, 1) for name in (HELD if ranges is None else ranges)]
    return SimpleNamespace(trace=SimpleNamespace(
        units=units, profile=SimpleNamespace(host=rows)))


HELD: list = []


@pytest.fixture
def held(monkeypatch):
    """Hand the readers the given records in place of the program's."""
    def hold(*recs):
        monkeypatch.setattr(spans, "records", lambda: list(recs))
        HELD[:] = [r.name for r in recs]
    return hold


@pytest.mark.parametrize("name", sorted(STREAM))
def test_stream_ms_per_unit(held, name):
    span = STREAM[name]
    held(record(span, 9.0, 1.5), record(span, 9.0, 2.5),
         record("libpll2.other", 9.0, 100.0))
    assert metric(name).read(run(units=2)) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(STREAM))
def test_stream_ms_none(held, name, monkeypatch):
    span = STREAM[name]
    held(record("libpll2.other", 1.0, 1.0))
    assert metric(name).read(run()) is None             # no such span
    held(record(span, 1.0, None))
    assert metric(name).read(run()) is None             # no CUDA events
    held(record(span, 1.0, 1.0))
    assert metric(name).read(SimpleNamespace(trace=None)) is None
    monkeypatch.setitem(sys.modules, "libpll2_tpu_torch.spans", None)
    monkeypatch.delattr(sys.modules["libpll2_tpu_torch"], "spans")
    assert metric(name).read(run()) is None             # an older program


@pytest.mark.parametrize("name", sorted(STREAM))
def test_stream_ms_reads_the_traced_pass(held, name):
    """Records from before the traced pass are left out: the last n of a
    name, n its ranges in the trace; fewer records than ranges, or no
    range, read nothing."""
    span = STREAM[name]
    held(record(span, 1.0, 50.0), record(span, 1.0, 1.5),
         record(span, 1.0, 2.5))
    assert metric(name).read(run(units=2, ranges=[span] * 2)) == \
        pytest.approx(2.0)
    assert metric(name).read(run(ranges=[span] * 4)) is None
    assert metric(name).read(run(ranges=["libpll2.other"])) is None


def test_search_host_ms(held):
    m = metric("search_host_ms.search")
    held(record("libpll2.search.select", 2.0, None),
         record("libpll2.search.apply", 30.0, 0.1),
         record("libpll2.search.apply", 10.0, None),
         record("libpll2.search.verify", 500.0, 400.0))
    assert m.read(run(units=3)) == pytest.approx(14.0)
    held(record("libpll2.search.score", 5.0, 5.0))
    assert m.read(run()) is None
