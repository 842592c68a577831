"""Multi-partition models: K per-gene partitions sharing ONE topology.

Counterpart of libpll2_tpu/multipartition.py.  Reference clients (RAxML-NG
/ ModelTest-NG) drive one partition per gene over its site range
(SURVEY.md §2.6) and combine log-likelihoods and derivative sums branch by
branch.  Here the per-partition sweeps run back to back on the device (on
CUDA tensors each forward sweep is the tree-sweep kernel that
`partials_tree.choose` picks for that partition), the per-edge Newton steps
optimize the SHARED branch lengths against the summed (d1, d2), and the
total log-likelihood is a single scalar.

Partitions may differ in everything but the topology: states (mixed DNA +
protein runs), rate categories, models, site counts, asc-bias, scaler
mode.  Branch-length linkage (the RAxML-NG brlen modes):

  * linked  — one branch-length vector shared by all partitions
              (scalers=None);
  * scaled  — shared vector, per-partition multiplier (pass `scalers`,
              shape [K]; d/dt folds the chain rule into the Newton sums);
  * unlinked — K independent engines (search_fast.hill_climb_multi).

The JAX package maps over the edges one at a time; this batches them as
engine.optimize_branch_lengths does: edges in chunks sized from the tensor
bytes of all K partitions, the K sumtables of a chunk alive together
across the Newton steps.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import engine
from .config import PartitionConfig
from .ops import derivatives as derivatives_ops
from .ops import likelihood as likelihood_ops
from .tree.utree import UTree


@dataclasses.dataclass(frozen=True, eq=False)
class MultiPartition:
    """Static compiled form: one topology, K partition configs."""
    programs: tuple                  # TreeProgram per partition
    fulls: tuple                     # FullTreeProgram per partition
    cfgs: tuple                      # PartitionConfig per partition

    @property
    def n_partitions(self) -> int:
        return len(self.cfgs)


def compile_multipartition(tree: UTree, cfgs: Sequence[PartitionConfig]
                           ) -> MultiPartition:
    """Compile one topology against K partition configs.

    All cfgs must agree on `tips` (same taxa); everything else may vary.
    The edge layout (edge_rows order, colors, pmatrix indices) depends on
    the topology only, so it is identical across the K FullTreePrograms —
    the shared branch vector indexes all of them consistently.
    """
    tips = {c.tips for c in cfgs}
    if len(tips) != 1 or tips.pop() != tree.tip_count:
        raise ValueError("all partitions must cover the same taxa as the "
                         "shared topology")
    programs = tuple(engine.compile_tree(tree, c) for c in cfgs)
    fulls = tuple(engine.compile_tree_full(tree, c) for c in cfgs)
    for f in fulls[1:]:
        np.testing.assert_array_equal(f.edge_rows, fulls[0].edge_rows)
        np.testing.assert_array_equal(f.pmatrix_indices,
                                      fulls[0].pmatrix_indices)
    return MultiPartition(programs=programs, fulls=fulls, cfgs=tuple(cfgs))


def _scalers_tensor(scalers, device):
    """Optional [K] per-partition multipliers as an f64 tensor."""
    if scalers is None:
        return None
    return torch.as_tensor(scalers, dtype=torch.float64, device=device)


def _partition_branches(branch_lengths, scalers, k: int, dtype):
    bl = branch_lengths.to(dtype)
    if scalers is None:
        return bl
    return bl * scalers[k].to(dtype)


def _scale(scalers, k: int, dtype, device):
    """s_k in the partition's dtype (1 under linked lengths)."""
    if scalers is None:
        return torch.ones((), dtype=dtype, device=device)
    return scalers[k].to(dtype)


def loglikelihood(mp: MultiPartition, models, branch_lengths, tipchars,
                  pattern_weights, invariant, scalers=None):
    """Total log-likelihood over all partitions.

    models / tipchars / pattern_weights / invariant: K-sequences (one
    entry per partition, shaped for that partition's cfg); branch_lengths:
    the SHARED [E] vector; scalers: optional [K] per-partition multipliers.
    """
    scalers = _scalers_tensor(scalers, branch_lengths.device)
    total = torch.zeros(
        (), dtype=(torch.float64 if mp.cfgs[0].dtype == torch.float64
                   else torch.float32), device=branch_lengths.device)
    for k in range(mp.n_partitions):
        cfg = mp.cfgs[k]
        lk = engine.loglikelihood(
            mp.programs[k], cfg, models[k],
            _partition_branches(branch_lengths, scalers, k, cfg.dtype),
            tipchars[k], pattern_weights[k], invariant[k])
        total = total + lk.to(total.dtype)
    return total


def _sweep_partitions(mp: MultiPartition, models, branch_lengths, tipchars,
                      scalers):
    """The all-directions message sweep of every partition at its own
    (scaled) lengths: [(clv, scalers, pmatrix)] * K."""
    return [engine._sweep_all(
        mp.fulls[k], mp.cfgs[k], models[k],
        _partition_branches(branch_lengths, scalers, k, mp.cfgs[k].dtype),
        tipchars[k]) for k in range(mp.n_partitions)]


def _edge_chunks(mp: MultiPartition, edges):
    """Split a 1-D index tensor of branch positions into chunks whose
    per-edge tensors (engine.EDGE_CHUNK_BYTES) fit with the sumtables of
    all K partitions alive together."""
    per_edge = sum(
        4 * cfg.span * cfg.sites_padded
        * torch.empty((), dtype=cfg.dtype).element_size()
        for cfg in mp.cfgs)
    return torch.split(edges, max(1, engine.EDGE_CHUNK_BYTES // per_edge))


def _chunk_sumtables(mp: MultiPartition, models, sweeps, rows):
    """Sumtables of the edges with rows [n, 4], one per partition."""
    return [engine._edge_sumtables(mp.fulls[k], mp.cfgs[k], models[k],
                                   sweeps[k][0], sweeps[k][1], rows)
            for k in range(mp.n_partitions)]


def _summed_derivatives(mp: MultiPartition, models, sumtables, t,
                        pattern_weights, invariant, scalers):
    """(d1, d2) [n] f64 of -lnL at shared lengths t [n], summed over the
    partitions through the chain rule d/dt Σ_k L_k(s_k t) = Σ_k s_k d1_k,
    d² = Σ_k s_k² d2_k."""
    d1 = torch.zeros(t.shape, dtype=torch.float64, device=t.device)
    d2 = torch.zeros(t.shape, dtype=torch.float64, device=t.device)
    for k in range(mp.n_partitions):
        cfg, model = mp.cfgs[k], models[k]
        idx = model.params_indices.long()
        s_k = _scale(scalers, k, cfg.dtype, t.device)
        d1k, d2k = derivatives_ops.likelihood_derivatives(
            sumtables[k], t.to(cfg.dtype) * s_k, model.rates,
            model.eigenvals[idx], model.cat_pinv, model.rate_weights,
            model.cat_freqs, invariant[k], pattern_weights[k], cfg)
        d1 = d1 + (s_k * d1k).double()
        d2 = d2 + (s_k * s_k * d2k).double()
    return d1, d2


def branch_derivatives(mp: MultiPartition, models, branch_lengths, tipchars,
                       pattern_weights, invariant, scalers=None):
    """Summed (d1, d2) of -lnL w.r.t. every SHARED branch length ([E], [E],
    f64): the per-branch sumtable machinery evaluated per partition and
    chain-ruled through the optional per-partition scaler."""
    device = branch_lengths.device
    scalers = _scalers_tensor(scalers, device)
    edge_rows = engine._edge_rows(mp.fulls[0], device)
    sweeps = _sweep_partitions(mp, models, branch_lengths, tipchars, scalers)
    d1s, d2s = [], []
    for chunk in _edge_chunks(mp, torch.arange(len(edge_rows),
                                               device=device)):
        sts = _chunk_sumtables(mp, models, sweeps, edge_rows[chunk])
        d1, d2 = _summed_derivatives(mp, models, sts, branch_lengths[chunk],
                                     pattern_weights, invariant, scalers)
        d1s.append(d1)
        d2s.append(d2)
    return torch.cat(d1s), torch.cat(d2s)


def optimize_branch_lengths(mp: MultiPartition, models, branch_lengths,
                            tipchars, pattern_weights, invariant,
                            scalers=None, rounds: int = 3,
                            newton_iters: int = 10,
                            min_branch: float = 1e-8,
                            max_branch: float = 100.0):
    """Newton-optimize the SHARED branch lengths against the summed
    multi-partition likelihood (engine.optimize_branch_lengths lifted to
    K partitions; same colour-class Jacobi smoothing over all n_colors
    classes).

    Returns (optimized_branch_lengths, total_logl_after [] f64).
    """
    device = branch_lengths.device
    scalers = _scalers_tensor(scalers, device)
    full0 = mp.fulls[0]
    edge_rows = engine._edge_rows(full0, device)
    colors = torch.as_tensor(full0.edge_colors, device=device)
    bl = branch_lengths
    for _ in range(rounds):
        for c in range(full0.n_colors):
            members = torch.nonzero(colors == c).flatten()
            sweeps = _sweep_partitions(mp, models, bl, tipchars, scalers)
            bl = bl.clone()
            for chunk in _edge_chunks(mp, members):
                sts = _chunk_sumtables(mp, models, sweeps, edge_rows[chunk])
                t = bl[chunk]
                for _ in range(newton_iters):
                    d1, d2 = _summed_derivatives(
                        mp, models, sts, t, pattern_weights, invariant,
                        scalers)
                    # the JAX step has no non-finite guard; keep its
                    # semantics
                    t = derivatives_ops.newton_update(
                        t, d1, d2, min_branch, max_branch,
                        hold_nonfinite=False).to(bl.dtype)
                bl[chunk] = t
            del sweeps

    total = torch.zeros((), dtype=torch.float64, device=device)
    ra, rsa, rb, rsb = full0.edge_rows[full0.root_edge].tolist()
    root_slot = int(full0.pmatrix_indices[full0.root_edge])
    for k in range(mp.n_partitions):
        cfg, model = mp.cfgs[k], models[k]
        clv, scals, pmatrix = engine._sweep_all(
            mp.fulls[k], cfg, model,
            _partition_branches(bl, scalers, k, cfg.dtype), tipchars[k])
        lk = likelihood_ops.edge_loglikelihood(
            clv[ra], scals[rsa], clv[rb], scals[rsb], pmatrix[root_slot],
            model.cat_freqs, model.rate_weights, model.cat_pinv,
            invariant[k], pattern_weights[k], cfg)
        total = total + lk.double()
    return bl, total
