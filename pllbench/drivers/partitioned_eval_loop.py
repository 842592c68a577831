"""Closed-loop evaluations of a partitioned supermatrix: one caller,
multipartition.loglikelihood over all of the configuration's partitions on
one tree, each call with the next row of a bank of shared branch-length
vectors (the partitions' models and --brlen scaled multipliers fixed), its
logL read back as a float, as RAxML-NG's branch-length and model
optimisers read it at every step.

The inputs: the partitions' models drawn from the configuration's
params_seed (`draw_models`); a random tree and every partition's sites
simulated down it at t * s_k under the partition's own model from the run
seed (`simulate`, on the device).  Each partition's columns are padded to
its configuration's sites_padded with weight 0; the padding repeats the
partition's first columns, so that a program that counted padding would
be seen.  The bank is made on the device from the seed: every length of
the tree scaled by a factor log-uniform in the traffic's `scale`.

Checked: the logL of a sample of the window's calls, drawn from the seed,
against the reference's float64 sum over partitions at the same lengths
(reference/partitioned.py; the number compared is the largest relative
gap), and no call's logL non-finite.
"""
from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from .. import inputs, tracing
from ..reference import model as ref_model
from ..reference import newick, partitioned
from . import common


def draw_models(config: dict) -> List[partitioned.PartitionModel]:
    """Every partition's LG+G+F model and multiplier, drawn from the
    configuration's params_seed in partition order: alpha log-uniform,
    frequencies Dirichlet around the base frequencies, multiplier
    log-uniform (the configuration's `assumed`)."""
    m, p = config["model"], config["partition_model"]
    gen = np.random.default_rng(p["params_seed"])
    base = np.asarray(m["freqs"], np.float64)
    base = base / base.sum()
    out = []
    for _ in config["partition_sites"]:
        alpha = math.exp(gen.uniform(*np.log(p["alpha"])))
        freqs = gen.dirichlet(p["freqs_concentration"] * base)
        scaler = math.exp(gen.uniform(*np.log(p["scaler"])))
        out.append(partitioned.PartitionModel(m["subst"], freqs.tolist(),
                                              alpha, scaler))
    return out


def simulate(tree: newick.Tree, sizes, models, rate_cats: int, seed: int,
             device) -> dict:
    """Tip states of every partition's sites simulated down `tree` at
    t * s_k under partition k's model, a Gamma category drawn uniformly a
    site, all partitions at once on `device` in float64 from a generator
    seeded with `seed`: {tip label: [N] uint64 bitmask codes}, partition k
    at its offset in `sizes`."""
    f64 = torch.float64
    systems = [ref_model.eigensystem(m.subst, m.freqs) for m in models]

    def stacked(i):
        return torch.as_tensor(np.stack([s[i] for s in systems]),
                               device=device)

    values, left, right = stacked(0), stacked(1), stacked(2)
    rates = torch.as_tensor(np.stack([ref_model.gamma_rates(m.alpha,
                                                            rate_cats)
                                      for m in models]), device=device)
    scale = torch.as_tensor([m.scaler for m in models], dtype=f64,
                            device=device)
    freqs = torch.as_tensor(np.stack([np.asarray(m.freqs) / np.sum(m.freqs)
                                      for m in models]), device=device)
    states = freqs.shape[1]
    part = torch.repeat_interleave(
        torch.arange(len(sizes), device=device),
        torch.as_tensor(np.asarray(sizes), device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = part.shape[0]
    cats = torch.randint(0, rate_cats, (n,), generator=gen, device=device)

    def draw(cum):                      # a state per site from its row
        u = torch.rand(n, generator=gen, dtype=f64, device=device)
        return torch.clamp((u[:, None] > cum).sum(dim=1), max=states - 1)

    root = draw(torch.cumsum(freqs, dim=1)[part])
    out = {}
    stack = [(child, root) for child in tree.root.children]
    while stack:
        node, parent = stack.pop()
        t = tree.lengths[node.edge] * scale[:, None] * rates      # [K, R]
        p = torch.matmul(left[:, None] * torch.exp(
            values[:, None, :] * t[:, :, None])[..., None, :],
            right[:, None])                                   # [K, R, S, S]
        p = torch.clamp(p, min=0.0)
        p = p / p.sum(dim=-1, keepdim=True)
        state = draw(torch.cumsum(p, dim=-1)[part, cats, parent])
        if node.children:
            stack.extend((child, state) for child in node.children)
        else:
            out[node.label] = (np.uint64(1) << state.cpu().numpy().astype(
                np.uint64))
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from libpll2_tpu_torch import engine, multipartition
        from libpll2_tpu_torch import tree as T
        from libpll2_tpu_torch.config import PartitionConfig
        from libpll2_tpu_torch.models.gamma import compute_gamma_cats

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        tips, dtype = config["tips"], getattr(torch, config["dtype"])
        rate_cats = config["model"]["rate_cats"]
        sizes = list(config["partition_sites"])
        self.bounds = np.concatenate([[0], np.cumsum(sizes)])
        shape = config["tree"]
        text = inputs.random_newick(tips, inputs.rng(seed, 0),
                                    shape["min_bl"], shape["max_bl"])
        self.tree = newick.parse(text)
        self.models = draw_models(config)
        self.chars = simulate(self.tree, sizes, self.models, rate_cats, seed,
                              device)
        tree_p = T.parse_newick_string(text)
        cfgs = [PartitionConfig(
            tips=tips, clv_buffers=tree_p.inner_count,
            states=config["model"]["states"], sites=n, rate_matrices=1,
            prob_matrices=2 * tips - 3, rate_cats=rate_cats,
            scale_buffers=tree_p.inner_count, dtype=dtype) for n in sizes]
        self.program = multipartition.compile_multipartition(tree_p, cfgs)
        # the program takes its lengths in its own branch order: read it
        # from the same tree with edge k's length set to k + 1
        n_edges = len(self.tree.lengths)
        probe = engine.compile_tree(T.parse_newick_string(newick.write(
            self.tree, [float(k + 1) for k in range(n_edges)])), cfgs[0])
        self.perm = np.rint(probe.default_branch_lengths).astype(np.int64) - 1
        base = np.asarray(self.tree.lengths)[self.perm]
        if not np.array_equal(base,
                              self.program.programs[0].default_branch_lengths):
            raise RuntimeError("the program's branch order could not be read")
        self.port_models = [engine.make_model(
            [m.subst], [m.freqs], compute_gamma_cats(m.alpha, rate_cats),
            dtype=dtype, device=device) for m in self.models]
        self.scalers = torch.as_tensor([m.scaler for m in self.models],
                                       dtype=torch.float64, device=device)
        self.tipchars, self.pattern_weights, self.invariant = \
            self._columns(cfgs, tree_p, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        lo, hi = (math.log(x) for x in traffic["scale"])
        u = torch.rand((traffic["bank"], n_edges), generator=gen,
                       dtype=torch.float64, device=device)
        self.bank = (torch.as_tensor(base, device=device)
                     * torch.exp(lo + (hi - lo) * u)).to(dtype)
        self.work_per_unit = (tips - 2) * int(self.bounds[-1])
        self.values: List[float] = []
        self.latencies: List[float] = []

    def _columns(self, cfgs, tree_p, device):
        """Each partition's tip codes, pattern weights and invariant flags
        at its sites_padded: the padding columns repeat its first columns
        and weigh 0."""
        tips = self.config["tips"]
        order = [node.label for node in sorted(
            tree_p.nodes[:tips], key=lambda n: n.clv_index)]
        codes = np.stack([self.chars[label] for label in order])
        tipchars, weights, invariant = [], [], []
        for k, cfg in enumerate(cfgs):
            lo, n = int(self.bounds[k]), cfg.sites
            cols = lo + np.arange(cfg.sites_padded) % n
            tipchars.append(torch.as_tensor(
                codes[:, cols].astype(np.int32), device=device))
            w = torch.zeros(cfg.sites_padded, dtype=cfg.dtype, device=device)
            w[:n] = 1.0
            weights.append(w)
            invariant.append(torch.full((cfg.sites_padded,), -1,
                                        dtype=torch.int32, device=device))
        return tipchars, weights, invariant

    def call(self, i: int) -> float:
        from libpll2_tpu_torch import multipartition
        return float(multipartition.loglikelihood(
            self.program, self.port_models,
            self.bank[i % self.bank.shape[0]], self.tipchars,
            self.pattern_weights, self.invariant, self.scalers))

    def warm(self) -> None:
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def window(self, seconds: float) -> float:
        """Calls until the clock passes `seconds`; the window's seconds."""
        start = time.perf_counter()
        deadline = start + seconds
        t0 = start
        while True:
            value = self.call(len(self.values))
            t1 = time.perf_counter()
            self.values.append(value)
            self.latencies.append(t1 - t0)
            if t1 >= deadline:
                return t1 - start
            t0 = t1

    def traced(self) -> tracing.Trace:
        """`trace_calls` calls timed without the profiler, then the same
        calls under it."""
        from libpll2_tpu_torch.ops import partials_tree
        n = self.traffic["trace_calls"]

        def calls(keep: bool):
            for i in range(n):
                with torch.profiler.record_function(
                        tracing.SPAN_PREFIX + "loglikelihood"):
                    value = self.call(i)
                if keep:
                    self.values.append(value)

        wall = tracing.wall_s(lambda: calls(True), self.device)
        launches = partials_tree.sweep.launches
        prof = tracing.profile(lambda: calls(False), self.device)
        return tracing.Trace(
            prof, wall, n,
            {"tree_sweep": partials_tree.sweep.launches - launches}, {})

    @property
    def units(self) -> int:
        return len(self.values)

    @property
    def failed(self) -> int:
        return int(sum(not math.isfinite(v) for v in self.values))

    def release(self) -> None:
        for name in ("program", "port_models", "tipchars", "pattern_weights",
                     "invariant"):
            setattr(self, name, None)
        self.bank = self.bank.cpu()

    def sample(self) -> np.ndarray:
        """The calls the check compares, drawn from the seed."""
        k = min(self.traffic["check_sample"], self.units)
        return np.sort(inputs.rng(self.seed, 7).choice(
            self.units, size=k, replace=False))

    def reference(self, calls, precision: str = "f64") -> np.ndarray:
        """The reference's logL of the given calls' lengths."""
        bank = self.bank.cpu()
        rows = bank[np.asarray(calls) % bank.shape[0]]
        lengths = np.empty(rows.shape, dtype=np.float64)
        lengths[:, self.perm] = rows.double().numpy()
        batch = self.traffic["check_batch"]
        return np.concatenate([
            partitioned.loglikelihood(
                self.tree, lengths[i:i + batch], self.chars, self.bounds,
                self.models, self.config["model"]["rate_cats"],
                device=self.device, precision=precision)
            for i in range(0, len(lengths), batch)])

    def control(self) -> np.ndarray:
        """The control in the program's place: the reference at TF32 on
        the sampled calls' lengths."""
        return self.reference(self.sample(), "tf32")

    def check(self, limits: dict, values=None) -> List[common.Check]:
        """The run's comparisons; `values` in place of the program's
        logL of the sampled calls (the control)."""
        calls = self.sample()
        ref = self.reference(calls)
        got = np.asarray(self.values)[calls] if values is None else values
        return [common.Check("logl_rel_gap", max(common.rel_gaps(got, ref)),
                             limits["logl_rel_gap"]),
                common.Check("failed_calls", float(self.failed), 0.0)]
