"""Faults planted in the program's timed path, to show that a run's check
turns false on them (the benchmark's own runs plant none):

    plant(kind) -> [(owner, attribute, replacement), ...]

A test sets each with monkeypatch.setattr; `python3 -m pllbench.readings
--fault <kind>` sets them for its whole process on the card.

Evaluation cells (engine.loglikelihood): "unchanged" answers every call
with the first call's logL; "half" leaves out half the sites and doubles
the rest; "altered" scales each logL by 1 + 1e-4.

Search cells (search_fast.spr_round): "unchanged" returns the input tree
with the round's claim; "half" as above, through the round's pattern
weights; "altered" scales the reported logL by 1 + 1e-4; "scorer_low"
scales every score the edge scorer gives by 1 + 1e-5, so each move is
priced slightly low (the kernel, edge_score.edge_scores, on the card; its
plain version, search_fast._score_slots, on the CPU).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

EVAL = ("unchanged", "half", "altered")
SEARCH = ("unchanged", "half", "altered", "scorer_low")
SCORER_SCALE = 1 + 1e-5


def _eval(kind):
    from libpll2_tpu_torch import engine
    real = engine.loglikelihood
    first = []

    def unchanged(*args, **kw):
        if not first:
            first.append(real(*args, **kw))
        return first[0]

    def half(program, cfg, model, bl, tips, pw, inv, **kw):
        keep = torch.zeros_like(pw)
        keep[:cfg.sites // 2] = 2.0
        return real(program, cfg, model, bl, tips, pw * keep, inv, **kw)

    def altered(*args, **kw):
        return real(*args, **kw) * (1 + 1e-4)

    return [(engine, "loglikelihood",
             {"unchanged": unchanged, "half": half,
              "altered": altered}[kind])]


def _scaled(fn):
    """fn with its first output, the scores, multiplied by SCORER_SCALE."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        scores, t3 = fn(*args, **kw)
        return scores * SCORER_SCALE, t3
    return wrapper


def _search(kind):
    from libpll2_tpu_torch import search_fast
    from libpll2_tpu_torch.ops import edge_score
    if kind == "scorer_low":
        return [(edge_score, "edge_scores", _scaled(edge_score.edge_scores)),
                (search_fast, "_score_slots",
                 _scaled(search_fast._score_slots))]
    real = search_fast.spr_round

    def unchanged(prog, *args, **kw):
        _, logl, moves = real(prog, *args, **kw)
        return prog, logl, moves

    def half(prog, model, chars, **kw):
        pw = np.zeros(prog.cfg_ext.sites_padded)
        pw[:prog.cfg_ext.sites // 2] = 2.0
        return real(prog, model, chars, pattern_weights=pw, **kw)

    def altered(*args, **kw):
        new, logl, moves = real(*args, **kw)
        return new, logl * (1 + 1e-4), moves

    return [(search_fast, "spr_round",
             {"unchanged": unchanged, "half": half,
              "altered": altered}[kind])]


def plant(kind: str, driver: str):
    """The replacements that plant fault `kind` under the traffic
    `driver` ("eval_loop" or "spr_climb")."""
    if driver == "eval_loop" and kind in EVAL:
        return _eval(kind)
    if driver == "spr_climb" and kind in SEARCH:
        return _search(kind)
    raise ValueError(f"no fault {kind!r} for the driver {driver!r}")
