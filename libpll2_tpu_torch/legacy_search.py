"""LEGACY per-topology SPR search (comparison baseline).

Superseded by `search_fast.hill_climb`, the production search.  Kept as an
independent implementation for cross-checks and for the optimize demo
(examples/optimize_demo.py); a copy of libpll2_tpu.legacy_search on this
package's engine.

The reference provides the *mechanics* of search (SPR/NNI moves, partial
traversals, parsimony stepwise addition) and leaves ML search loops to
clients (RAxML-NG).  Here the batched placement scorer
(engine.score_placements) evaluates ALL regraft destinations of a pruned
subtree in one batched call, so an SPR round is a host loop over prune
candidates with one batched device call each, instead of the reference
clients' one-partial-traversal-per-candidate-edge loop.  Every call runs
the dense plain-PyTorch path on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import engine
from .config import PartitionConfig
from .constants import INT32_MASK_STATES
from .ops import partials as partials_ops
from .ops import pmatrix as pmatrix_ops
from .partition import levelize_operations
from .tree import create_operations, moves, parse_newick_string, traverse
from .tree.utree import (UTree, export_newick, reset_template_indices,
                         traverse_subtree, wrap_tree)


def _mkcfg(tree: UTree, like: PartitionConfig) -> PartitionConfig:
    return dataclasses.replace(
        like, tips=tree.tip_count, clv_buffers=tree.inner_count,
        prob_matrices=2 * tree.tip_count - 3,
        scale_buffers=tree.inner_count)


def _tipchars_for(tree: UTree, cfg: PartitionConfig,
                  tipchars_by_label: Dict[str, np.ndarray],
                  device) -> torch.Tensor:
    raw = np.zeros((tree.tip_count, cfg.sites_alloc), dtype=np.uint64)
    for n in tree.nodes[:tree.tip_count]:
        raw[n.clv_index] = tipchars_by_label[n.label][:cfg.sites_alloc]
    return torch.as_tensor(engine.pad_tipchars(raw, cfg), device=device)


def _subtree_clv(tree: UTree, cfg: PartitionConfig, model, tipchars,
                 branch_lengths, pmatrix_indices, h):
    """CLV (and scaler) of the subtree behind half-node h, directed at the
    cut, via the level-batched dense path."""
    R, S, T = cfg.rate_cats, cfg.states, cfg.sites_padded
    dtype = cfg.dtype
    device = tipchars.device
    scal_shape = (R, T) if cfg.per_rate_scalers else (T,)
    if h.next is None:
        tip = engine.expand_tipchars(tipchars[h.clv_index:h.clv_index + 1],
                                     S, dtype)[0]
        clv = tip[None].expand(R, S, T)
        return clv, torch.zeros(scal_shape, dtype=torch.int32,
                                device=device)
    pmats = pmatrix_ops.compute_pmatrices(
        branch_lengths, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=dtype)
    num_slots = int(np.max(pmatrix_indices)) + 1
    pmatrix = torch.zeros((num_slots, R, S, S), dtype=dtype, device=device)
    pmatrix[torch.as_tensor(np.asarray(pmatrix_indices), dtype=torch.int64,
                            device=device)] = pmats

    ops, _, _ = create_operations(traverse_subtree(h))
    level_ops = levelize_operations(ops, cfg)
    clv0 = torch.zeros((cfg.num_clvs + 1, R, S, T), dtype=dtype,
                       device=device)
    tip_clv = engine.expand_tipchars(tipchars, S, dtype)
    clv0[:cfg.tips] = tip_clv[:, None]
    scal0 = torch.zeros((cfg.scale_buffers + 2,) + scal_shape,
                        dtype=torch.int32, device=device)
    clv, scalers = partials_ops.update_partials(
        clv0, scal0, pmatrix, level_ops, cfg)
    scaler = (scalers[h.scaler_index] if h.scaler_index >= 0
              else torch.zeros(scal_shape, dtype=torch.int32,
                               device=device))
    return clv[h.clv_index], scaler


def _half_nodes(tree: UTree):
    for n in tree.nodes:
        if n.next is None:
            yield n
        else:
            yield from n.roundabout()


def _tips_behind(h) -> frozenset:
    return frozenset(n.label for n in traverse_subtree(h)
                     if n.next is None)


def ml_spr_round(tree: UTree, cfg: PartitionConfig, model,
                 tipchars_by_label: Dict[str, np.ndarray],
                 *, max_subtree_tips: Optional[int] = None
                 ) -> Tuple[UTree, float, int]:
    """One greedy ML SPR round.

    Evaluates pruning every inner half-node's subtree and regrafting it on
    every remainder edge (one batched score_placements call per prune
    candidate), then applies the single best improving move.  Every
    tensor goes on the model's device.

    Returns (tree, logl, improved): `tree` is a NEW UTree (the input is
    not mutated), `logl` its likelihood, `improved` 1 if a move was
    applied.  Iterate until improved == 0 for a full SPR hill-climb.
    """
    if cfg.states > INT32_MASK_STATES:
        raise ValueError(f"legacy_search.ml_spr_round takes at most "
                         f"{INT32_MASK_STATES} states (int32 tip masks), "
                         f"got {cfg.states}")
    device = model.eigenvals.device
    newick = export_newick(tree.vroot)
    base = parse_newick_string(newick)
    cfg0 = _mkcfg(base, cfg)
    program0 = engine.compile_tree(base, cfg0)
    tipchars0 = _tipchars_for(base, cfg0, tipchars_by_label, device)
    pw = np.zeros(cfg0.sites_padded)
    pw[:cfg0.sites] = 1.0
    pw0 = torch.as_tensor(pw, dtype=cfg0.dtype, device=device)
    inv0 = torch.as_tensor(np.full(cfg0.sites_padded, -1, np.int32),
                           device=device)
    bl0 = torch.as_tensor(program0.default_branch_lengths, dtype=cfg0.dtype,
                          device=device)
    logl0 = float(engine.loglikelihood(program0, cfg0, model, bl0,
                                       tipchars0, pw0, inv0))

    n_tips = base.tip_count
    trav = traverse(base.vroot)
    _, branches_all, pmat_idx_all = create_operations(trav)
    bl_all = torch.as_tensor(np.asarray(branches_all), dtype=cfg0.dtype,
                             device=device)

    best = (logl0, None, None)  # (logl, prune node_index, regraft labelset)
    for p in list(_half_nodes(base)):
        if p.next is None:
            continue
        k = len(_tips_behind(p.back))
        if k < 1 or n_tips - k < 4:
            continue
        if max_subtree_tips is not None and k > max_subtree_tips:
            continue

        sub_clv, sub_scaler = _subtree_clv(
            base, cfg0, model, tipchars0, bl_all, pmat_idx_all, p.back)
        sub_t3 = p.length

        rtree_src = parse_newick_string(newick)
        p_r = next(h for h in _half_nodes(rtree_src)
                   if h.node_index == p.node_index)
        u = moves.prune_subtree(p_r)
        root_r = u if u.next is not None else u.back
        reset_template_indices(root_r, n_tips - k)
        rtree = wrap_tree(root_r)
        cfg_r = _mkcfg(rtree, cfg)
        full_r = engine.compile_tree_full(rtree, cfg_r)
        tip_r = _tipchars_for(rtree, cfg_r, tipchars_by_label, device)
        bl_r = torch.as_tensor(full_r.default_branch_lengths,
                               dtype=cfg_r.dtype, device=device)
        scores = engine.score_placements(
            full_r, cfg_r, model, bl_r, tip_r, pw0, inv0, sub_clv,
            sub_scaler, sub_t3).cpu().numpy().copy()

        # the merged edge (where the subtree came from) regrafts to the
        # SAME topology — not a move (pll_utree_spr rejects it too)
        merged = np.nonzero(
            full_r.pmatrix_indices == u.pmatrix_index)[0]
        scores[merged] = -np.inf

        e = int(np.argmax(scores))
        if scores[e] > best[0] + 1e-9:
            # identify the regraft edge by its remainder bipartition
            by_pmatrix = {}
            for g in _half_nodes(rtree):
                by_pmatrix.setdefault(g.back.pmatrix_index, g)
            g = by_pmatrix[int(full_r.pmatrix_indices[e])]
            best = (float(scores[e]), p.node_index, _tips_behind(g))

    if best[1] is None:
        return base, logl0, 0

    # apply the winning move on a fresh copy
    out = parse_newick_string(newick)
    p3 = next(h for h in _half_nodes(out) if h.node_index == best[1])
    cands = [h for h in _half_nodes(out)
             if _tips_behind(h) == best[2]
             and not (_tips_behind(h.back) & best[2])]
    moves.spr(p3, cands[0])
    new_newick = export_newick(out.vroot)
    new_tree = parse_newick_string(new_newick)
    return new_tree, best[0], 1
