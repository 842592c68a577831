"""A run whose timed path is broken underneath comes out not correct: the
harness past its look for a card, at a test size on the CPU, with each
fault a cell can have planted in the program (pllbench/faults.py; one
chip, so no exchange between chips to leave out)."""
import pytest

from pllbench import faults

from . import tiny


def planted(monkeypatch, kind, driver):
    for owner, name, new in faults.plant(kind, driver):
        monkeypatch.setattr(owner, name, new)


@pytest.mark.parametrize("workload", ["dna_eval", "protein_eval"])
@pytest.mark.parametrize("fault", (None,) + faults.EVAL)
def test_eval_faults(monkeypatch, workload, fault):
    if fault:
        planted(monkeypatch, fault, "eval_loop")
    result = tiny.execute(workload, 0.3)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("fault", (None,) + faults.SEARCH)
def test_search_faults(monkeypatch, fault):
    if fault:
        planted(monkeypatch, fault, "spr_climb")
    result = tiny.execute("dna_search", 3.0)
    assert result["attempted"] >= 2
    assert result["correct"] is (fault is None), result["checks"]
    if fault == "scorer_low":
        # only the rounds that report the scorer's own score can show it
        gap = result["checks"]["logl_rel_gap"]
        assert gap["value"] > 5 * gap["limit"], result["checks"]


def test_trace_run_is_checked_too(monkeypatch):
    planted(monkeypatch, "altered", "eval_loop")
    result = tiny.execute("dna_eval", 0.3, trace=True)
    assert result["correct"] is False and "busy_s" in result["device"]


def test_search_trace_run_sees_scorer_rounds():
    result = tiny.execute("dna_search", 0.0, trace=True)
    assert result["correct"], result["checks"]
    assert result["checks"]["scorer_priced_rounds"]["value"] >= 1
