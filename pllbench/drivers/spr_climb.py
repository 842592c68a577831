"""SPR hill climbs one after another on the configuration's alignment, each
from a random start tree drawn from the seed: search_fast.compile_spr at
the traffic's radius, then search_fast.spr_round until a round applies no
move or `max_rounds` have run (hill_climb's order with smooth_every=0,
which bench.py's measure_search_scale runs).  The rounds of a climb whose
index is in `single_move_rounds` apply only their best move, as
RAxML-NG applies moves one at a time; the others apply every
non-conflicting improving move.  The window ends between rounds.

Checked, for every round of the window: the logL the round reports
against the reference's float64 logL of the tree it returns (the largest
relative gap); no round that claims moves returns its input topology;
every climb's first round, from a random start, applies a move; and at
least `scorer_priced_rounds` rounds report the edge scorer's own score.
A round reports the scorer's score of its move where it applies one move
(the program's timings: n_applied 1) or falls back to the single best
move (ladder 2); those rounds hold the ball recursion and the scorer to
the reference.  Every climb's single-move rounds are such rounds, so
every run, a traced one too, holds some; near a climb's end others come
at random.  A round that applies a batch reports the batch's verified
sweep, and a round without a move the base logL: those hold the forward
sweep.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List

import numpy as np
import torch

from .. import inputs, tracing
from ..reference import newick
from . import common


@dataclasses.dataclass
class Round:
    index: int          # within its climb
    before: object      # the program's input tree (UTree)
    after: object       # the tree the round returned
    logl: float
    moves: int
    timings: dict

    @property
    def scorer_priced(self) -> bool:
        """The reported logL is the edge scorer's score of the move."""
        return self.timings.get("n_applied") == 1 or \
            self.timings.get("ladder") == 2


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        data = common.make_inputs(config, seed)
        self.chars = data.chars
        lo, hi = traffic["start_bl"]
        gen = inputs.rng(seed, 1)
        self.starts = [inputs.random_newick(config["tips"], gen, lo, hi)
                       for _ in range(traffic["starts"])]
        self.warm_start = inputs.random_newick(config["tips"],
                                               inputs.rng(seed, 2), lo, hi)
        self.cfg = common.port_config(config, config["tips"] - 2)
        self.model = common.port_model(config, device)
        self.rounds: List[Round] = []
        self.climbs = 0

    def compile(self, text: str):
        from libpll2_tpu_torch import search_fast
        from libpll2_tpu_torch import tree as T
        return search_fast.compile_spr(T.parse_newick_string(text), self.cfg,
                                       radius=self.traffic["radius"])

    def round(self, prog, index: int, keep: bool):
        from libpll2_tpu_torch import search_fast
        timings: dict = {}
        with torch.profiler.record_function(tracing.SPAN_PREFIX + "spr_round"):
            new, logl, moves = search_fast.spr_round(
                prog, self.model, self.chars,
                newton_iters=self.traffic["newton_iters"],
                eps=self.traffic["eps"], timings=timings,
                max_moves=1 if index in self.traffic["single_move_rounds"]
                else None)
        if keep:
            self.rounds.append(Round(index, prog.tree, new.tree,
                                     float(logl), int(moves), timings))
        return new, moves

    def warm(self) -> None:
        prog = self.compile(self.warm_start)
        for i in range(self.traffic["warmup_rounds"]):
            prog, _ = self.round(prog, i, keep=False)

    def window(self, seconds: float) -> float:
        """Climbs until the clock passes `seconds` at the end of a round;
        the window's seconds."""
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            start_tree = self.starts[self.climbs % len(self.starts)]
            self.climbs += 1
            prog = self.compile(start_tree)
            for index in range(self.traffic["max_rounds"]):
                prog, moves = self.round(prog, index, keep=True)
                now = time.perf_counter()
                if now >= deadline:
                    return now - start
                if moves == 0:
                    break

    def traced(self) -> tracing.Trace:
        """The first `trace_rounds` rounds of the first climb timed without
        the profiler, then the same rounds under it."""
        from libpll2_tpu_torch.ops import edge_score, partials_tree
        n = self.traffic["trace_rounds"]
        first = self.compile(self.starts[0])
        self.climbs = 1

        def rounds(keep: bool):
            prog = first
            for index in range(n):
                prog, _ = self.round(prog, index, keep)

        wall = tracing.wall_s(lambda: rounds(True), self.device)
        sweeps = partials_tree.sweep.launches
        scores = edge_score.edge_scores.launches
        prof = tracing.profile(lambda: rounds(False), self.device)
        return tracing.Trace(
            prof, wall, n,
            {"tree_sweep": partials_tree.sweep.launches - sweeps,
             "edge_score": edge_score.edge_scores.launches - scores},
            {"score": [r.timings["score"] for r in self.rounds]})

    @property
    def units(self) -> int:
        return len(self.rounds)

    @property
    def failed(self) -> int:
        return int(sum(not math.isfinite(r.logl) for r in self.rounds))

    def release(self) -> None:
        self.model = None

    def reference(self, tree_text: str, precision: str = "f64") -> float:
        tree = newick.parse(tree_text)
        return float(common.reference_logl(
            self.config, tree, np.asarray([tree.lengths]), self.chars,
            self.device, precision)[0])

    def control(self) -> List[float]:
        """The control in the program's place: the reference at TF32 on
        the tree each round returned."""
        from libpll2_tpu_torch.tree import export_newick
        return [self.reference(export_newick(r.after.vroot, precision=None),
                               "tf32") for r in self.rounds]

    def check(self, limits: dict, values=None) -> List[common.Check]:
        """The run's comparisons; `values` in place of the program's
        reported logL of each round (the control)."""
        from libpll2_tpu_torch.tree import export_newick
        gaps, unchanged = [], 0
        for k, r in enumerate(self.rounds):
            after = export_newick(r.after.vroot, precision=None)
            ref = self.reference(after)
            got = r.logl if values is None else values[k]
            gaps.append(abs(got - ref) / abs(ref))
            if r.moves and newick.splits(newick.parse(after)) == \
                    newick.splits(newick.parse(export_newick(
                        r.before.vroot, precision=None))):
                unchanged += 1
        idle_starts = sum(1 for r in self.rounds
                          if r.index == 0 and r.moves == 0)
        priced = sum(1 for r in self.rounds if r.scorer_priced)
        return [common.Check("logl_rel_gap", max(gaps, default=math.inf),
                             limits["logl_rel_gap"]),
                common.Check("moves_without_change", float(unchanged), 0.0),
                common.Check("first_rounds_without_move", float(idle_starts),
                             0.0),
                common.Check("failed_rounds", float(self.failed), 0.0),
                common.Check("scorer_priced_rounds", float(priced),
                             float(limits["scorer_priced_rounds"]),
                             floor=True)]
