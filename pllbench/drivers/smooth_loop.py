"""Closed-loop branch-length smoothing: one caller,
engine.optimize_branch_lengths on the configuration's tree, each call from
the next row of a bank of start vectors (every length of the tree scaled
by a factor log-uniform in the traffic's `scale`), `rounds` rounds of
`newton_iters` Newton steps over every colour class, its logL read back as
a float: what RAxML-NG runs between SPR rounds and in its final
branch-length optimisation.

One call is one unit of work: rounds * n_colors message sweeps and the
final one, each (tips - 2) * 3 CLV operations over every site (the
message program's operations, read from the FullTreeProgram).

Checked, on a sample of the window's calls drawn from the seed: the logL
the call returned against the reference's float64 logL at the lengths it
returned (the largest relative gap); the reference's logL gained from the
start lengths to the returned ones, relative to the start's (the smallest
over the sample, held to a floor, so that a call that returns its start
lengths, or worse ones, fails); no logL non-finite.
"""
from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from .. import inputs, tracing
from ..reference import newick
from . import common


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from libpll2_tpu_torch import engine
        from libpll2_tpu_torch import tree as T

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        data = common.make_inputs(config, seed)
        self.tree, self.chars = data.tree, data.chars
        tree_p = T.parse_newick_string(data.newick)
        cfg = common.port_config(config, tree_p.inner_count)
        self.program = engine.compile_tree_full(tree_p, cfg)
        # the program takes its lengths in its own branch order: read it
        # from the same tree with edge k's length set to k + 1
        n_edges = len(data.tree.lengths)
        probe = engine.compile_tree_full(T.parse_newick_string(newick.write(
            data.tree, [float(k + 1) for k in range(n_edges)])), cfg)
        self.perm = np.rint(probe.default_branch_lengths).astype(np.int64) - 1
        base = np.asarray(data.tree.lengths)[self.perm]
        if not np.array_equal(base, self.program.default_branch_lengths):
            raise RuntimeError("the program's branch order could not be read")
        self.cfg = cfg
        self.model = common.port_model(config, device)
        codes = np.zeros((cfg.tips, cfg.sites), dtype=np.uint64)
        for node in tree_p.nodes[:cfg.tips]:
            codes[node.clv_index] = data.chars[node.label]
        self.tipchars = torch.as_tensor(engine.pad_tipchars(codes, cfg),
                                        device=device)
        pw = torch.zeros(cfg.sites_padded, dtype=cfg.dtype, device=device)
        pw[:cfg.sites] = 1.0
        self.pattern_weights = pw
        self.invariant = torch.full((cfg.sites_padded,), -1,
                                    dtype=torch.int32, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        lo, hi = (math.log(x) for x in traffic["scale"])
        u = torch.rand((traffic["bank"], n_edges), generator=gen,
                       dtype=torch.float64, device=device)
        self.bank = (torch.as_tensor(base, device=device)
                     * torch.exp(lo + (hi - lo) * u)).to(cfg.dtype)
        level_ops = self.program.level_ops
        ops = int((level_ops[..., 0] != self.program.cfg_ext.clv_scratch)
                  .sum())
        self.work_per_unit = (traffic["rounds"] * self.program.n_colors
                              + 1) * ops * cfg.sites
        self.values: List[float] = []
        self.returned: List[torch.Tensor] = []
        self.latencies: List[float] = []

    def call(self, i: int) -> float:
        from libpll2_tpu_torch import engine
        bl, logl = engine.optimize_branch_lengths(
            self.program, self.cfg, self.model,
            self.bank[i % self.bank.shape[0]], self.tipchars,
            self.pattern_weights, self.invariant,
            rounds=self.traffic["rounds"],
            newton_iters=self.traffic["newton_iters"])
        self.last = bl
        return float(logl)

    def warm(self) -> None:
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def _keep(self, value: float) -> None:
        self.values.append(value)
        self.returned.append(self.last)

    def window(self, seconds: float) -> float:
        """Calls until the clock passes `seconds`; the window's seconds."""
        start = time.perf_counter()
        deadline = start + seconds
        t0 = start
        while True:
            value = self.call(len(self.values))
            t1 = time.perf_counter()
            self._keep(value)
            self.latencies.append(t1 - t0)
            if t1 >= deadline:
                return t1 - start
            t0 = t1

    def traced(self) -> tracing.Trace:
        """`trace_calls` calls timed without the profiler, then the same
        calls under it."""
        n = self.traffic["trace_calls"]

        def calls(keep: bool):
            for i in range(n):
                with torch.profiler.record_function(
                        tracing.SPAN_PREFIX + "optimize_branch_lengths"):
                    value = self.call(i)
                if keep:
                    self._keep(value)

        wall = tracing.wall_s(lambda: calls(True), self.device)
        prof = tracing.profile(lambda: calls(False), self.device)
        return tracing.Trace(prof, wall, n, {}, {})

    @property
    def units(self) -> int:
        return len(self.values)

    @property
    def failed(self) -> int:
        return int(sum(not math.isfinite(v) for v in self.values))

    def release(self) -> None:
        for name in ("program", "model", "tipchars", "pattern_weights",
                     "invariant", "last"):
            setattr(self, name, None)
        self.bank = self.bank.cpu()
        self.returned = [bl.cpu() for bl in self.returned]

    def sample(self) -> np.ndarray:
        """The calls the check compares, drawn from the seed."""
        k = min(self.traffic["check_sample"], self.units)
        return np.sort(inputs.rng(self.seed, 7).choice(
            self.units, size=k, replace=False))

    def _reference(self, rows, precision: str) -> np.ndarray:
        """The reference's logL of lengths rows [n, E] in the program's
        branch order."""
        lengths = np.empty(rows.shape, dtype=np.float64)
        lengths[:, self.perm] = rows.double().cpu().numpy()
        batch = self.traffic["check_batch"]
        return np.concatenate([
            common.reference_logl(self.config, self.tree,
                                  lengths[i:i + batch], self.chars,
                                  self.device, precision)
            for i in range(0, len(lengths), batch)])

    def reference(self, calls, precision: str = "f64") -> np.ndarray:
        """The reference's logL at the lengths the given calls returned."""
        return self._reference(torch.stack(
            [self.returned[c] for c in calls]), precision)

    def control(self) -> np.ndarray:
        """The control in the program's place: the reference at TF32 at
        the lengths the sampled calls returned."""
        return self.reference(self.sample(), "tf32")

    def check(self, limits: dict, values=None) -> List[common.Check]:
        """The run's comparisons; `values` in place of the program's
        logL of the sampled calls (the control)."""
        calls = self.sample()
        ref = self.reference(calls)
        bank = self.bank.cpu()
        start = self._reference(bank[calls % bank.shape[0]], "f64")
        got = np.asarray(self.values)[calls] if values is None else values
        return [common.Check("logl_rel_gap", max(common.rel_gaps(got, ref)),
                             limits["logl_rel_gap"]),
                common.Check("logl_gain",
                             float(np.min((ref - start) / np.abs(start))),
                             limits["logl_gain"], floor=True),
                common.Check("failed_calls", float(self.failed), 0.0)]
