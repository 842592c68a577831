"""ML SPR search: every (prune, regraft) pair of a round scored on the
device, for any topology of a given tip count.

Counterpart of libpll2_tpu/search_fast.py: the single-partition search
and its `*_multi` forms (K partitions over one topology, unlinked branch
lengths, summed scores).  The search rests on two ideas, both kept from the JAX package:

1. **Runtime topology.**  The level-batched operation tensor, edge-row
   table and pmatrix-slot vector are data, not constants.  The JAX package
   pads them to a coarse shape ladder so that XLA's jit cache hits; the
   port keeps the same padding so that every program array is byte-equal
   to the JAX package's (the tests compare them), though eager PyTorch
   compiles nothing.

2. **The gap-tip identity.**  Pruning subtree S at node u leaves a
   remainder whose directional CLVs equal those of the ORIGINAL topology
   with S's tips replaced by the gap state (an all-ones CLV stays all-ones
   through any P), and the half-edges (a,u),(u,b) chain into the merged
   edge (a,b) because P(t1)·P(t2) = P(t1+t2).  So remainder messages for
   every prune candidate come from fixed-shape sweeps.

A round: one all-directions message sweep (every pruned-subtree CLV and
every base message) → per candidate, the outward recursion of changed
messages over its radius-K ball → per (candidate, regraft edge) slot, a
sumtable, a few Newton steps on the attachment branch and the logL
(core_derivatives.c:321-471 semantics).  That last stage is the fused edge
scorer (ops/edge_score.py), a hand-written CUDA kernel on CUDA tensors.
Host side per round: numpy bookkeeping, greedy non-conflicting move
selection, the graph surgery (tree/moves.py) and an exact verification of
multi-move batches, so the logL trace is monotone by construction.

The ball recursion and the smoothing Newton are plain PyTorch (XLA in the
JAX package, not Pallas).  The message sweep (engine.message_sweep) is one
hand-written CUDA kernel launch on the card at f32 (ops/message_sweep.py),
which reads the padded runtime program as it is and skips its no-op rows;
elsewhere it is the dense plain path.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import engine, spans
from .config import PartitionConfig
from .constants import AB_NONE, gap_state, gap_state_mask
from .ops import derivatives as derivatives_ops
from .ops import edge_score
from .ops import likelihood as likelihood_ops
from .ops import pmatrix as pmatrix_ops
from .tree import moves, parse_newick_string
from .tree.utree import UTree, export_newick


def _pad_level_ops(level_ops: np.ndarray, cfg: PartitionConfig,
                   min_shape: Optional[Tuple[int, int]] = None
                   ) -> np.ndarray:
    """Pad [L, W, 8] to bucketed (L, W) (no-op rows write the scratch
    slots; no-op levels are entire rows of them).

    min_shape: carry-forward floor — a hill-climb passes the previous
    topology's padded shape so buckets only ever grow."""
    L, W, _ = level_ops.shape
    Lb = _ladder(max(L, 1))
    Wb = _ladder(max(W, 1))
    if min_shape is not None:
        Lb, Wb = max(Lb, min_shape[0]), max(Wb, min_shape[1])
    noop = np.array([cfg.clv_scratch, cfg.clv_scratch, cfg.clv_scratch,
                     0, 0, cfg.scaler_scratch, cfg.scaler_zero,
                     cfg.scaler_zero], dtype=np.int32)
    out = np.broadcast_to(noop, (Lb, Wb, 8)).copy()
    out[:L, :W] = level_ops
    return out


def _ladder(n: int, margin: float = 1.25) -> int:
    """Round a shape dimension UP a coarse ladder with 25 % headroom (the
    JAX package's jit-cache buckets, kept for byte-equal programs)."""
    n = int(math.ceil(n * margin))
    for step, cap in ((16, 64), (32, 128), (64, 256), (128, 1 << 30)):
        if n <= cap:
            return -(-n // step) * step
    raise AssertionError


@dataclasses.dataclass
class BallGroup:
    """One ball-size bucket of prune candidates (radius-limited scoring).

    Ball sizes are skewed (an interior candidate's radius-K ball has ~2^K
    regraft edges, a near-leaf candidate's a handful), so candidates are
    bucketed by ball size into fixed-size groups, each padded only to its
    own widths."""
    cand_ids: np.ndarray                   # [Cg] global candidate positions
    ball_levels: Tuple[np.ndarray, ...]    # K arrays [Cg, W_d, 12] int32
    score_ops: np.ndarray                  # [Cg, Vg, 12] int32 (valid ops)
    sub_rows: np.ndarray                   # [Cg, 2] int32
    edge_pos: np.ndarray                   # [Cg] int32 (pruned edge)
    merge_edges: np.ndarray                # [Cg, 2] int32

    @property
    def shape_key(self) -> tuple:
        return (tuple(a.shape[1] for a in self.ball_levels),
                self.score_ops.shape[1])


@dataclasses.dataclass
class SprProgram:
    """Host-compiled SPR search state for one topology (numpy arrays;
    converted to tensors on the model's device per call)."""
    tree: UTree
    cfg: PartitionConfig            # caller's config
    cfg_ext: PartitionConfig        # row space extended to message slots
    level_ops: np.ndarray           # [Lb, Wb, 8] int32
    edge_rows: np.ndarray           # [E, 4] int32
    pmatrix_slots: np.ndarray       # [E] int32
    branch_lengths: np.ndarray      # [E] f64
    color_masks: np.ndarray         # [n_colors, E] bool (proper edge
                                    # coloring, one mask per class)
    root_edge: int
    # candidates (C = 3*tips - 6, fixed per tip count)
    cand_edge: np.ndarray           # [C] int32
    cand_sub_rows: np.ndarray       # [C, 2] int32 (clv row, scaler row)
    cand_gap_mask: np.ndarray       # [C, tips] bool
    cand_edge_valid: np.ndarray     # [C, E] bool (all-False = invalid cand)
    # host metadata for applying moves
    cand_prune_node: np.ndarray     # [C] node_index of remainder half-node p
    cand_affected: List[frozenset]  # clv-index sets for conflict detection
    cand_hard: List[frozenset]      # clv sets the SPR surgery itself touches
    edge_endpoints: np.ndarray      # [E, 2] clv indices of edge endpoints
    edge_node: np.ndarray           # [E] node_index of the A-side half-node
    # radius-limited scoring (present when compiled with radius=K):
    radius: Optional[int] = None
    ball_groups: Optional[Tuple[BallGroup, ...]] = None
    ball_slots: Optional[int] = None         # scratch rows per candidate


# ball-op column layout (one row = one outward "changed message" op,
# which is ALSO one (candidate, regraft-edge) score slot):
BOP_PARENT = 0        # scratch slot this op writes
BOP_C1_ROW = 1        # base msg row (seed) | scratch slot (deeper)
BOP_C1_SCAL = 2       # base scaler row (seed) | scratch slot (deeper)
BOP_C1_SEED = 3       # 1 -> c1 is a base row propagated through MERGED P
BOP_C1_PM = 4         # pmatrix slot of the in-edge (ignored when seed)
BOP_C2_ROW = 5        # base msg row of the side subtree
BOP_C2_SCAL = 6
BOP_C2_PM = 7
BOP_SC_ROW = 8        # base msg row facing the changed message across e
BOP_SC_SCAL = 9
BOP_EDGE = 10         # edge position of the regraft target
BOP_VALID = 11
BOP_COLS = 12

# candidates whose ball recursion shares one scratch tensor
# [CAND_BATCH, ball_slots, R, S, T].  Sized on an H100 80GB at 256 taxa x
# 4096 sites, radius 5, f32: the score phase's device work per round was
# 302 / 287 / 272 / 269 ms at 16 / 32 / 64 / 128, with peak memory 2.0 /
# 3.8 / 5.5 / 10.7 GB (PERF.md)
CAND_BATCH = 64


def compile_spr(tree: UTree, cfg: PartitionConfig,
                min_level_shape: Optional[Tuple[int, int]] = None,
                radius: Optional[int] = None,
                min_group_shapes: Optional[Tuple[tuple, ...]] = None,
                min_ball_slots: Optional[int] = None
                ) -> SprProgram:
    """Compile one topology into runtime search arrays + candidate table."""
    with spans.span("search.compile_spr"):
        return _compile_spr(tree, cfg, min_level_shape, radius,
                            min_group_shapes, min_ball_slots)


def _compile_spr(tree: UTree, cfg: PartitionConfig,
                 min_level_shape: Optional[Tuple[int, int]],
                 radius: Optional[int],
                 min_group_shapes: Optional[Tuple[tuple, ...]],
                 min_ball_slots: Optional[int]) -> SprProgram:
    """compile_spr's work, inside its span."""
    if cfg.per_rate_scalers and cfg.asc_bias != 0:
        raise ValueError("per-rate scalers cannot combine with asc bias "
                         "(reference partition-creation rule)")
    full = engine.compile_tree_full(tree, cfg)
    cfg_ext = full.cfg_ext
    level_ops = _pad_level_ops(full.level_ops, cfg_ext,
                               min_shape=min_level_shape)

    E = len(full.pmatrix_indices)
    n = tree.tip_count

    # A-side half-node of each edge, matching compile_tree_full's edge_rows
    by_pmatrix = {}
    seen = set()
    for node in tree.nodes:
        for g in ([node] if node.next is None else list(node.roundabout())):
            key = tuple(sorted((g.node_index, g.back.node_index)))
            if key in seen:
                continue
            seen.add(key)
            by_pmatrix[g.back.pmatrix_index] = g
    # compile_tree_full's canonical edge orientation (parent side first:
    # the end whose clv_index differs from the pmatrix index)
    edge_half = [by_pmatrix[int(p)] for p in full.pmatrix_indices]
    edge_half = [g.back if g.clv_index == int(p) else g
                 for g, p in zip(edge_half, full.pmatrix_indices)]
    edge_endpoints = np.array([[g.clv_index, g.back.clv_index]
                               for g in edge_half], np.int32)
    edge_node = np.array([g.node_index for g in edge_half], np.int32)

    # behind-set DP: one bool mask per half-edge,
    # S(h) = {clv(h)} | S(h.next.back) | S(h.next2.back)
    nrows = int(max(edge_endpoints.max(), n - 1)) + 1
    behind: Dict[int, np.ndarray] = {}

    def behind_of(h0):
        out = behind.get(h0.node_index)
        if out is not None:
            return out
        stack = [(h0, False)]
        while stack:
            h, ready = stack.pop()
            if h.node_index in behind:
                continue
            if h.next is None:
                r = np.zeros(nrows, bool)
                r[h.clv_index] = True
                behind[h.node_index] = r
                continue
            kids = (h.next.back, h.next.next.back)
            if not ready:
                stack.append((h, True))
                stack.extend((k, False) for k in kids
                             if k.node_index not in behind)
            else:
                r = behind[kids[0].node_index] \
                    | behind[kids[1].node_index]
                r[h.clv_index] = True
                behind[h.node_index] = r
        return behind[h0.node_index]

    cands = []
    for i, g in enumerate(edge_half):
        for side, (sub_h, p) in enumerate(((g, g.back), (g.back, g))):
            # prune the subtree behind sub_h (containing node(sub_h));
            # p is the remainder-side endpoint and must be inner
            if p.next is None:
                continue
            bh = behind_of(sub_h)
            k = int(bh[:n].sum())
            valid = (n - k) >= 4
            sub_rows = full.edge_rows[i, 0:2] if side == 0 \
                else full.edge_rows[i, 2:4]
            gap = bh[:n].copy()
            # regraft targets: edges fully inside the remainder and not
            # incident to p's node (those reconstruct the same topology)
            if valid:
                ev = ~(bh[edge_endpoints[:, 0]]
                       | bh[edge_endpoints[:, 1]]
                       | (edge_endpoints[:, 0] == p.clv_index)
                       | (edge_endpoints[:, 1] == p.clv_index))
            else:
                ev = np.zeros(E, bool)
            # conservative conflict set: pruned nodes + p's node + p's
            # other neighbors; the HARD set is only the surgery anchor
            # (p's node and the pruned subtree's root)
            hard = {p.clv_index, p.back.clv_index}
            affected = set(np.nonzero(bh)[0].tolist()) | hard \
                | {h.back.clv_index for h in p.roundabout()}
            cands.append((i, sub_rows, gap, ev, p.node_index,
                          frozenset(affected), frozenset(hard)))

    C = len(cands)
    if C != 3 * n - 6:
        raise ValueError(f"{C} prune candidates for {n} tips (expected "
                         f"{3 * n - 6}): not a binary unrooted tree")

    ball_groups = ball_slots = None
    if radius is not None:
        # Radius-limited exact scoring (bounded partial traversals,
        # examples/partial-traversal/partial.c:365-463, as batched ops).
        # Pruning S at p leaves every message directed AWAY from p
        # unchanged; the changed ones — remainder messages FACING each
        # regraft edge from the prune side — form an outward recursion
        # from the merged edge that consumes only base messages as side
        # inputs.  Each op doubles as one (candidate, regraft edge) score
        # slot, so a round costs O(n * 2^K) message ops.
        inner_nodes = [nd for nd in tree.nodes if nd.next is not None]
        msg_half = [g for nd in inner_nodes for g in nd.roundabout()]
        msg_row = {g.node_index: cfg_ext.tips + k
                   for k, g in enumerate(msg_half)}
        msg_scal = {g.node_index: k for k, g in enumerate(msg_half)}
        pos_of_pm = {int(p): i for i, p in enumerate(full.pmatrix_indices)}
        zero_row = cfg_ext.scaler_zero

        def incoming(s):
            """(msg row, scaler row, pmatrix slot) arriving through s."""
            if s.back.next is None:
                return s.back.clv_index, zero_row, s.back.pmatrix_index
            return (msg_row[s.back.node_index],
                    msg_scal[s.back.node_index], s.back.pmatrix_index)

        def build_ball(p, valid):
            """Levelized changed-message ops for pruning at half-edge p."""
            levels: List[List[List[int]]] = [[] for _ in range(radius)]
            slot_of: Dict[int, int] = {}
            n_slots = 0
            if not valid:
                return levels, 0
            sides = [(p.next, p.next.next), (p.next.next, p.next)]
            frontier = []
            for h_in, h_far in sides:
                x = h_in.back                   # half-node back toward p
                if x.next is None:
                    continue
                far_row, far_scal, _ = incoming(h_far)
                outs = [g for g in x.roundabout() if g is not x]
                for g in outs:
                    o = next(s for s in x.roundabout()
                             if s is not x and s is not g)
                    o_row, o_scal, o_pm = incoming(o)
                    sc_row, sc_scal, _ = incoming(g)
                    slot = n_slots
                    n_slots += 1
                    slot_of[g.node_index] = slot
                    levels[0].append([
                        slot, far_row, far_scal, 1, 0,
                        o_row, o_scal, o_pm,
                        sc_row, sc_scal,
                        pos_of_pm[int(g.back.pmatrix_index)], 1])
                    if radius > 1 and g.back.next is not None:
                        frontier.append((g, 1))
            while frontier:
                g_prev, d = frontier.pop()
                if d >= radius:
                    continue
                v_in = g_prev.back              # entered node via this half
                in_row = slot_of[g_prev.node_index]
                in_pm = int(v_in.back.pmatrix_index)
                for gg in v_in.roundabout():
                    if gg is v_in:
                        continue
                    o = next(s for s in v_in.roundabout()
                             if s is not v_in and s is not gg)
                    o_row, o_scal, o_pm = incoming(o)
                    sc_row, sc_scal, _ = incoming(gg)
                    slot = n_slots
                    n_slots += 1
                    slot_of[gg.node_index] = slot
                    levels[d].append([
                        slot, in_row, in_row, 0, in_pm,
                        o_row, o_scal, o_pm,
                        sc_row, sc_scal,
                        pos_of_pm[int(gg.back.pmatrix_index)], 1])
                    if gg.back.next is not None:
                        frontier.append((gg, d + 1))
            return levels, n_slots

        def renumber_slots(levels):
            """Remap scratch slots to FLAT level-major positions, so the
            away message of score row v lives in scratch slot v."""
            mapping = {}
            pos = 0
            for lv in levels:
                for row in lv:
                    mapping[row[BOP_PARENT]] = pos
                    pos += 1
            for lv in levels:
                for row in lv:
                    row[BOP_PARENT] = mapping[row[BOP_PARENT]]
                    if row[BOP_C1_SEED] == 0:
                        row[BOP_C1_ROW] = mapping[row[BOP_C1_ROW]]
                        row[BOP_C1_SCAL] = mapping[row[BOP_C1_SCAL]]

        balls = []
        ball_slots = 1 if min_ball_slots is None else int(min_ball_slots)
        for i, g in enumerate(edge_half):
            for sub_h, p in ((g, g.back), (g.back, g)):
                if p.next is None:
                    continue
                k = int(behind_of(sub_h)[:n].sum())
                levels, n_slots = build_ball(p, (n - k) >= 4)
                renumber_slots(levels)
                ball_slots = max(ball_slots, n_slots + 1)
                balls.append(levels)

        # the scratch pool covers the widest padded score table
        v_bound = max((sum(len(lv) for lv in levels) for levels in balls),
                      default=0)
        struct = sum(4 << d for d in range(radius))
        ball_slots = max(ball_slots,
                         min(_ladder(max(v_bound, 1)),
                             -(-struct // 16) * 16) + 1)
        dump = ball_slots - 1
        # level-0 rows are ALL seeds and deeper rows never are; padding
        # rows match their level's kind: the seed no-op reads base row 0,
        # the deep no-op reads the dump scratch slot.  Every padding row
        # writes the dump slot, which no valid row ever reads.
        noop = np.asarray(
            [dump, 0, zero_row, 1, 0, 0, zero_row, 0, 0, zero_row, 0, 0],
            np.int32)
        noop_deep = np.asarray(
            [dump, dump, dump, 0, 0, 0, zero_row, 0, 0, zero_row, 0, 0],
            np.int32)
        merge_edges = np.zeros((C, 2), np.int32)
        ci = 0
        for i, g in enumerate(edge_half):
            for sub_h, p in ((g, g.back), (g.back, g)):
                if p.next is None:
                    continue
                merge_edges[ci] = (
                    pos_of_pm[int(p.next.back.pmatrix_index)],
                    pos_of_pm[int(p.next.next.back.pmatrix_index)])
                ci += 1

        # ---- ball-size buckets (see BallGroup) --------------------------
        valid_counts = np.asarray(
            [sum(len(lv) for lv in levels) for levels in balls])
        order = np.argsort(-valid_counts, kind="stable")
        if C >= 48:
            s0, s1 = -(-C // 8), -(-3 * C // 8)
            sizes = (s0, s1, C - s0 - s1)
        else:
            sizes = (C,)
        all_sub_rows = np.stack([c[1] for c in cands]).astype(np.int32)
        all_edge_pos = np.array([c[0] for c in cands], np.int32)
        groups = []
        off = 0
        for gi, sz in enumerate(sizes):
            ids = np.sort(order[off:off + sz])
            off += sz
            # pad each group to a multiple of 16 candidates (padding rows
            # are all-noop / valid=0, masked out at flatten time)
            sz0 = sz
            szp = -(-sz // 16) * 16
            ids = np.concatenate([ids, np.full(szp - sz, ids[0],
                                               ids.dtype)])
            sz = szp
            pin = (min_group_shapes[gi]
                   if min_group_shapes is not None
                   and len(min_group_shapes) == len(sizes)
                   and len(min_group_shapes[gi][0]) == radius else None)
            w_ds = [max((len(balls[c][d]) for c in ids), default=0)
                    for d in range(radius)]
            # ladder bucketing with headroom, capped by the structural
            # per-level bound (level d holds <= 4*2^d messages)
            bound = [4 << d for d in range(radius)]
            w_ds = [min(_ladder(max(w, 1)), -(-b // 16) * 16)
                    for w, b in zip(w_ds, bound)]
            if pin is not None:
                w_ds = [max(w, int(m)) for w, m in zip(w_ds, pin[0])]
            lvls = []
            for d, wd in enumerate(w_ds):
                arr = np.tile(noop if d == 0 else noop_deep, (sz, wd, 1))
                for k, c in enumerate(ids[:sz0]):
                    lv = balls[c][d]
                    if lv:
                        arr[k, :len(lv)] = np.asarray(lv, np.int32)
                lvls.append(arr)
            vg = max((int(valid_counts[c]) for c in ids), default=0)
            vg = min(_ladder(max(vg, 1)),
                     -(-sum(bound) // 16) * 16)
            if pin is not None:
                vg = max(vg, int(pin[1]))
            sco = np.tile(noop, (sz, vg, 1))
            for k, c in enumerate(ids[:sz0]):
                flat = [row for lv in balls[c] for row in lv]
                if flat:
                    sco[k, :len(flat)] = np.asarray(flat, np.int32)
            groups.append(BallGroup(
                cand_ids=ids.astype(np.int32),
                ball_levels=tuple(lvls),
                score_ops=sco,
                sub_rows=all_sub_rows[ids],
                edge_pos=all_edge_pos[ids],
                merge_edges=merge_edges[ids],
            ))
        ball_groups = tuple(groups)

    return SprProgram(
        tree=tree, cfg=cfg, cfg_ext=cfg_ext,
        level_ops=level_ops,
        edge_rows=full.edge_rows,
        pmatrix_slots=np.asarray(full.pmatrix_indices, np.int32),
        branch_lengths=np.asarray(full.default_branch_lengths, np.float64),
        color_masks=np.stack([np.asarray(full.edge_colors) == c
                              for c in range(full.n_colors)]),
        root_edge=full.root_edge,
        cand_edge=np.array([c[0] for c in cands], np.int32),
        cand_sub_rows=np.stack([c[1] for c in cands]).astype(np.int32),
        cand_gap_mask=np.stack([c[2] for c in cands]),
        cand_edge_valid=np.stack([c[3] for c in cands]),
        cand_prune_node=np.array([c[4] for c in cands], np.int32),
        cand_affected=[c[5] for c in cands],
        cand_hard=[c[6] for c in cands],
        edge_endpoints=edge_endpoints,
        edge_node=edge_node,
        radius=radius,
        ball_groups=ball_groups,
        ball_slots=ball_slots,
    )


# --------------------------------------------------------------------------
# device half (tensors on the model's device)
# --------------------------------------------------------------------------


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def _pmatrices(model, branch_lengths, dtype):
    return pmatrix_ops.compute_pmatrices(
        branch_lengths, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=dtype)


def _sweep_rt(cfg: PartitionConfig, model, level_ops, pmat_slots,
              branch_lengths, tipchars, pmatrix=None):
    """Directional-message sweep with the topology as runtime data.

    cfg is the EXTENDED config (message row space); level_ops [Lb, Wb, 8]
    and pmat_slots [E] are int64 tensors.  Returns (clv, scalers,
    pmatrix)."""
    if pmatrix is None:
        pmats = _pmatrices(model, branch_lengths, cfg.dtype)  # [E, R, S, S]
        num_slots = 2 * cfg.tips - 2     # template pmatrix index space
        pmatrix = torch.zeros((num_slots,) + pmats.shape[1:],
                              dtype=cfg.dtype, device=pmats.device)
        pmatrix[pmat_slots] = pmats
    clv, scalers = engine.message_sweep(cfg, model, level_ops, pmatrix,
                                        tipchars)
    return clv, scalers, pmatrix


def _model_factors(model):
    """(eigenvecs, inv_eigenvecs, eigenvals) gathered per rate category."""
    idx = model.params_indices.long()
    return model.eigenvecs[idx], model.inv_eigenvecs[idx], \
        model.eigenvals[idx]


def _score_slots(cfg: PartitionConfig, model, ph, away, away_s, other,
                 other_s, sub_clv, sub_scal, t0, pattern_weights, invariant,
                 newton_iters: int, group=None):
    """Plain scorer of regraft slots (any leading batch axes ...):
    sumtable of the edge split by the regrafted subtree, Newton on the
    attachment branch, logL at the refined length.  Returns (score [...],
    t3 [...]).

    ph [..., R, S, S] half-branch P; away/other [..., R, S, T] the two
    messages facing the regraft edge; away_s/other_s their scalers
    ([..., T] or per-rate [..., R, T]); sub_clv/sub_scal the pruned
    subtree's message (broadcast against the slots); t0 [...].  With a
    process group the Newton sums and the score are summed over its ranks'
    site slices, so every rank takes the same steps."""
    evecs, inv_evecs, evals = _model_factors(model)
    ta = torch.einsum("...rij,...rjt->...rit", ph, away)
    tb = torch.einsum("...rij,...rjt->...rit", ph, other)
    clvp = ta * tb
    if cfg.per_rate_scalers:
        # relative (capped) per-rate scalers fold into the sumtable; the
        # site MIN is the absolute correction (core_derivatives.c:418-460)
        sp = away_s + other_s                                 # [..., R, T]
        st = derivatives_ops.update_sumtable(
            clvp, sub_clv, sp, sub_scal, evecs, inv_evecs,
            model.cat_freqs, cfg)
        scal = torch.min(sp + sub_scal, dim=-2).values        # [..., T]
    else:
        scal = away_s + other_s + sub_scal
        st = derivatives_ops.update_sumtable(
            clvp, sub_clv, None, None, evecs, inv_evecs, model.cat_freqs,
            cfg, asc_scalers=scal)
    t = t0.expand(st.shape[:-3])
    for _ in range(newton_iters):
        d1, d2 = derivatives_ops.likelihood_derivatives(
            st, t, model.rates, evals, model.cat_pinv, model.rate_weights,
            model.cat_freqs, invariant, pattern_weights, cfg, group=group)
        t = derivatives_ops.newton_update(t, d1, d2)
    score = derivatives_ops.sumtable_loglikelihood(
        st, t, model.rates, evals, model.cat_pinv, model.rate_weights,
        model.cat_freqs, invariant, pattern_weights, scal, cfg, group=group)
    return score, t


def _spr_all_scores(cfg: PartitionConfig, model, level_ops, edge_rows,
                    pmat_slots, branch_lengths, tipchars, pattern_weights,
                    invariant, cand_edge, cand_sub_rows, cand_gap_mask,
                    cand_edge_valid, newton_iters: int = 5):
    """Exact post-SPR log-likelihood of every (prune candidate, regraft
    edge) pair: ([C, E] scores, [C, E] Newton-optimized attachment branch).

    cfg is the extended config; index arrays are int64 tensors and the
    masks bool tensors.  Invalid pairs score -inf.  One gapped sweep per
    candidate (the exhaustive radius-None path)."""
    base_clv, base_scal, pmatrix = _sweep_rt(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    halves = _pmatrices(model, branch_lengths * 0.5, cfg.dtype)  # [E,R,S,S]
    gap = torch.tensor(gap_state_mask(cfg.states), dtype=tipchars.dtype,
                       device=tipchars.device)
    ninf = torch.tensor(-math.inf, dtype=cfg.dtype, device=tipchars.device)
    scores, t3s = [], []
    for c in range(cand_edge.shape[0]):
        gapped = torch.where(cand_gap_mask[c][:, None], gap, tipchars)
        rem_clv, rem_scal, _ = _sweep_rt(
            cfg, model, level_ops, pmat_slots, branch_lengths, gapped,
            pmatrix=pmatrix)
        s, t3 = _score_slots(
            cfg, model, halves, rem_clv[edge_rows[:, 0]],
            rem_scal[edge_rows[:, 1]], rem_clv[edge_rows[:, 2]],
            rem_scal[edge_rows[:, 3]], base_clv[cand_sub_rows[c, 0]],
            base_scal[cand_sub_rows[c, 1]], branch_lengths[cand_edge[c]],
            pattern_weights, invariant, newton_iters)
        scores.append(torch.where(cand_edge_valid[c], s, ninf))
        t3s.append(t3)
    return torch.stack(scores), torch.stack(t3s)


def _spr_base(cfg: PartitionConfig, model, level_ops, pmat_slots,
              branch_lengths, tipchars):
    """Shared per-round device state for the ball-group scorers: the base
    directional-message sweep and the half-length P matrices."""
    base_clv, base_scal, pmatrix = _sweep_rt(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    halves = _pmatrices(model, branch_lengths * 0.5, cfg.dtype)
    return base_clv, base_scal, pmatrix, halves


def _recurse(cfg: PartitionConfig, model, base_clv, base_scal, pmatrix,
             branch_lengths, ball_levels, merge_edges, cands, scratch, sscr):
    """Ball recursion of the candidates `cands` ([cb] int64), written into
    scratch [cb, slots, R, S, T] and sscr [cb, slots, T] (per-rate
    [cb, slots, R, T]) in place — the JAX package's per-candidate
    `recurse_one` with the candidate axis written out.

    Level 0 seeds every op with a base message propagated through the
    merged edge's P(t1 + t2); deeper levels read the scratch slots of the
    previous level.  Padding rows all write the dump slot: on CUDA those
    duplicate writes land in any order, which is harmless because no
    valid row reads the dump slot."""
    cb = cands.shape[0]
    m = merge_edges[cands]                                   # [cb, 2]
    merged = _pmatrices(model, branch_lengths[m[:, 0]]
                        + branch_lengths[m[:, 1]], cfg.dtype)  # [cb,R,S,S]
    ar = torch.arange(cb, device=cands.device)[:, None]
    scratch.zero_()
    sscr.zero_()
    for d, lv_all in enumerate(ball_levels):
        lv = lv_all[cands]                                   # [cb, W, 12]
        w = lv.shape[1]
        if d == 0:
            c1 = base_clv[lv[..., BOP_C1_ROW]]               # [cb,W,R,S,T]
            s1 = base_scal[lv[..., BOP_C1_SCAL]]
            p1 = merged[:, None].expand(cb, w, *merged.shape[1:])
        else:
            c1 = scratch[ar, lv[..., BOP_C1_ROW]]
            s1 = sscr[ar, lv[..., BOP_C1_SCAL]]
            p1 = pmatrix[lv[..., BOP_C1_PM]]
        c2 = base_clv[lv[..., BOP_C2_ROW]]
        s2 = base_scal[lv[..., BOP_C2_SCAL]]
        p2 = pmatrix[lv[..., BOP_C2_PM]]
        left = torch.einsum("...rij,...rjt->...rit", p1, c1)
        right = torch.einsum("...rij,...rjt->...rit", p2, c2)
        del c1, c2
        parent = left * right
        del left, right
        below = parent < cfg.scale_threshold
        if cfg.per_rate_scalers:
            mask = below.all(dim=-2)                         # [cb, W, R, T]
            parent = torch.where(mask[..., None, :],
                                 parent * cfg.scale_factor, parent)
        else:
            mask = below.all(dim=-2).all(dim=-2)             # [cb, W, T]
            parent = torch.where(mask[..., None, None, :],
                                 parent * cfg.scale_factor, parent)
        scratch[ar, lv[..., BOP_PARENT]] = parent
        sscr[ar, lv[..., BOP_PARENT]] = s1 + s2 + mask.to(torch.int32)


def _score_group(cfg: PartitionConfig, model, base_clv, base_scal,
                 pmatrix, halves, branch_lengths, pattern_weights,
                 invariant, ball_levels, score_ops, sub_rows, edge_pos,
                 merge_edges, ball_slots: int, newton_iters: int = 5,
                 cand_batch: int = CAND_BATCH,
                 use_kernel: bool = False, form: Optional[str] = None,
                 group=None):
    """Radius-limited exact SPR scores of ONE ball-size group:
    ([Cg, Vg] scores, [Cg, Vg] t3).

    Candidates run cand_batch at a time: the ball recursion (plain
    PyTorch) fills a [cand_batch, ball_slots, R, S, T] scratch, then every
    score slot of those candidates is priced.  use_kernel=True prices them
    with ops/edge_score.edge_scores (the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors); its contract — f32, per-site scalers,
    no asc bias, no invariant-marked site — is the caller's to check;
    `form` forces one of its forms (edge_score.FORMS, for the profiler),
    None takes the one its plan picks.  Otherwise the plain scorer of the
    JAX package's XLA path runs, which takes every configuration.

    Index arrays (ball_levels, score_ops, sub_rows, edge_pos,
    merge_edges) are int64 tensors."""
    Cg, Vg = score_ops.shape[:2]
    cb = min(cand_batch, Cg)
    while Cg % cb:
        cb -= 1
    R, S = cfg.rate_cats, cfg.states
    T = base_clv.shape[-1]
    device = base_clv.device
    scratch = torch.empty((cb, ball_slots, R, S, T), dtype=cfg.dtype,
                          device=device)
    sshape = (cb, ball_slots, R, T) if cfg.per_rate_scalers \
        else (cb, ball_slots, T)
    sscr = torch.empty(sshape, dtype=torch.int32, device=device)
    ar = torch.arange(cb, device=device)[:, None]
    ninf = torch.tensor(-math.inf, dtype=cfg.dtype, device=device)
    if use_kernel:
        consts = edge_score.model_constants(model, cfg)
        halves = halves.contiguous()
        ops32 = score_ops.to(torch.int32)
        rows32 = sub_rows.to(torch.int32)
    scores, t3s = [], []
    for cs in range(0, Cg, cb):
        cands = torch.arange(cs, cs + cb, device=device)
        with spans.span("ball_recursion"):
            _recurse(cfg, model, base_clv, base_scal, pmatrix,
                     branch_lengths, ball_levels, merge_edges, cands,
                     scratch, sscr)
        sops = score_ops[cs:cs + cb]                          # [cb, Vg, 12]
        if use_kernel:
            t0 = torch.clamp(branch_lengths[edge_pos[cs:cs + cb]],
                             1e-8, 100.0)
            with spans.span("edge_scorer"):
                s, t3 = edge_score.edge_scores(
                    scratch, sscr, base_clv, base_scal, halves,
                    ops32[cs:cs + cb].contiguous(),
                    rows32[cs:cs + cb].contiguous(), t0, *consts,
                    pattern_weights, newton_iters=newton_iters,
                    log_thresh=cfg.log_scale_threshold, form=form)
        else:
            srows = sub_rows[cs:cs + cb]
            s, t3 = _score_slots(
                cfg, model, halves[sops[..., BOP_EDGE]],
                scratch[ar, sops[..., BOP_PARENT]],
                sscr[ar, sops[..., BOP_PARENT]],
                base_clv[sops[..., BOP_SC_ROW]],
                base_scal[sops[..., BOP_SC_SCAL]],
                base_clv[srows[:, 0]][:, None],
                base_scal[srows[:, 1]][:, None],
                branch_lengths[edge_pos[cs:cs + cb]][:, None],
                pattern_weights, invariant, newton_iters, group=group)
        scores.append(torch.where(sops[..., BOP_VALID] == 1, s, ninf))
        t3s.append(t3)
    return torch.cat(scores), torch.cat(t3s)


def _spr_round_device(cfg: PartitionConfig, model, level_ops, pmat_slots,
                      branch_lengths, tipchars, pattern_weights, invariant,
                      root_rows, root_slot, group_args, ball_slots: int,
                      newton_iters: int = 3, use_kernel: bool = False,
                      group=None):
    """The device work of one SPR round: the base message sweep, the
    root-edge logL, and every ball-size group's recursion + scoring, all
    from one sweep.  Returns (logl0, ((scores, t3) per group)).

    `group`: the process group whose ranks hold the site slices
    (parallel/); `cfg` is the whole partition's, the site-indexed inputs
    this rank's slices.  The root-edge logL and the plain scorer's Newton
    sums are then summed over the ranks.  The edge-scorer kernel runs its
    Newton steps over the sites it holds, so use_kernel=True with a group
    raises."""
    if group is not None:
        if use_kernel:
            raise ValueError("the edge-scorer kernel runs Newton over the "
                             "sites of one device: a site-sharded round "
                             "takes use_kernel=False")
        cfg = engine._local(cfg, group, tipchars)
    base_clv, base_scal, pmatrix, halves = _spr_base(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    logl0 = likelihood_ops.edge_loglikelihood(
        base_clv[root_rows[0]], base_scal[root_rows[1]],
        base_clv[root_rows[2]], base_scal[root_rows[3]],
        pmatrix[root_slot], model.cat_freqs, model.rate_weights,
        model.cat_pinv, invariant, pattern_weights, cfg, group=group)
    outs = tuple(
        _score_group(cfg, model, base_clv, base_scal, pmatrix, halves,
                     branch_lengths, pattern_weights, invariant, lvls, sops,
                     srows, epos, medges, ball_slots=ball_slots,
                     newton_iters=newton_iters, use_kernel=use_kernel,
                     group=group)
        for (lvls, sops, srows, epos, medges) in group_args)
    return logl0, outs


def _logl_rt(cfg: PartitionConfig, model, level_ops, pmat_slots,
             branch_lengths, tipchars, pattern_weights, invariant,
             root_rows, root_slot):
    """Edge logL across the root edge with runtime topology (extended
    cfg); verifies multi-move batches exactly."""
    clv, scalers, pmatrix = _sweep_rt(
        cfg, model, level_ops, pmat_slots, branch_lengths, tipchars)
    return likelihood_ops.edge_loglikelihood(
        clv[root_rows[0]], scalers[root_rows[1]],
        clv[root_rows[2]], scalers[root_rows[3]],
        pmatrix[root_slot], model.cat_freqs, model.rate_weights,
        model.cat_pinv, invariant, pattern_weights, cfg)


def _smooth_rt(cfg: PartitionConfig, model, level_ops, edge_rows,
               pmat_slots, branch_lengths, tipchars, pattern_weights,
               invariant, color_masks, rounds: int = 2,
               newton_iters: int = 8):
    """Batched Newton branch smoothing with runtime topology (extended
    cfg): per round and per color class of the proper edge coloring
    ([n_colors, E] bool), one message sweep, then Newton on that class's
    branches from their sumtables (no two share a node).  The JAX package
    computes a proposal for every branch and keeps the class's; this
    computes only the class's, with the same values."""
    evecs, inv_evecs, evals = _model_factors(model)
    bl = branch_lengths
    for _ in range(rounds):
        for c in range(color_masks.shape[0]):
            idx = torch.nonzero(color_masks[c]).flatten()
            if idx.numel() == 0:
                continue
            clv, scalers, _ = _sweep_rt(cfg, model, level_ops, pmat_slots,
                                        bl, tipchars)
            rows = edge_rows[idx]                             # [Ec, 4]
            if cfg.per_rate_scalers:
                st = derivatives_ops.update_sumtable(
                    clv[rows[:, 0]], clv[rows[:, 2]], scalers[rows[:, 1]],
                    scalers[rows[:, 3]], evecs, inv_evecs,
                    model.cat_freqs, cfg)
            else:
                st = derivatives_ops.update_sumtable(
                    clv[rows[:, 0]], clv[rows[:, 2]], None, None, evecs,
                    inv_evecs, model.cat_freqs, cfg,
                    asc_scalers=scalers[rows[:, 1]] + scalers[rows[:, 3]])
            t = bl[idx]
            for _ in range(newton_iters):
                d1, d2 = derivatives_ops.likelihood_derivatives(
                    st, t, model.rates, evals, model.cat_pinv,
                    model.rate_weights, model.cat_freqs, invariant,
                    pattern_weights, cfg)
                t = derivatives_ops.newton_update(t, d1, d2)
            bl = bl.clone()
            bl[idx] = t
    return bl


# --------------------------------------------------------------------------
# host side of a round: selection, surgery, verification
# --------------------------------------------------------------------------


def _device_of(model) -> torch.device:
    return model.eigenvals.device


def _aux_arrays(prog: SprProgram, device):
    """Default pattern weights (1 on real sites) and invariant (-1)."""
    cfg = prog.cfg_ext
    pw = np.zeros(cfg.sites_padded)
    pw[:cfg.sites] = 1.0
    inv = np.full(cfg.sites_padded, -1, np.int32)
    return (torch.as_tensor(pw, dtype=cfg.dtype, device=device),
            torch.as_tensor(inv, device=device))


def _tipchars_for(prog: SprProgram, tipchars_by_label: Dict[str, np.ndarray],
                  device) -> torch.Tensor:
    cfg = prog.cfg_ext
    tree = prog.tree
    # sites_alloc exceeds the user's columns under asc bias (phantom
    # per-state room); missing columns default to gap and the phantoms
    # are stamped by pad_tipchars
    raw = np.full((tree.tip_count, cfg.sites_alloc),
                  gap_state(cfg.states), dtype=np.uint64)
    for node in tree.nodes[:tree.tip_count]:
        seq = tipchars_by_label[node.label]
        m = min(seq.shape[0], cfg.sites_alloc)
        raw[node.clv_index, :m] = seq[:m]
    return torch.as_tensor(engine.pad_tipchars(raw, cfg), device=device)


def _site_arrays(prog: SprProgram, tipchars_by_label, device,
                 pattern_weights=None, invariant=None):
    """(tipchars, pattern weights, invariant) tensors of one program."""
    tipchars = _tipchars_for(prog, tipchars_by_label, device)
    pw, inv = _aux_arrays(prog, device)
    if pattern_weights is not None:
        pw = torch.as_tensor(np.asarray(pattern_weights),
                             dtype=prog.cfg_ext.dtype, device=device)
    if invariant is not None:
        inv = torch.as_tensor(np.asarray(invariant), device=device)
    return tipchars, pw, inv


def _program_logl(prog: SprProgram, model, tipchars, pw, inv) -> float:
    """Exact logL of a program's topology and branch lengths."""
    device = tipchars.device
    cfg = prog.cfg_ext
    pslots = _long(prog.pmatrix_slots, device)
    rows = _long(prog.edge_rows, device)
    return float(_logl_rt(
        cfg, model, _long(prog.level_ops, device), pslots,
        torch.as_tensor(prog.branch_lengths, dtype=cfg.dtype, device=device),
        tipchars, pw, inv, rows[prog.root_edge], pslots[prog.root_edge]))


def _half_nodes(tree: UTree):
    for node in tree.nodes:
        if node.next is None:
            yield node
        else:
            yield from node.roundabout()


def _contains_iter(start, target) -> bool:
    """Iterative `target inside the subtree behind start`
    (moves.subtree_contains without the recursion limit)."""
    stack = [start]
    while stack:
        h = stack.pop()
        if h is target:
            return True
        if h.next is None:
            continue
        g = h.next
        while g is not h:
            if g is target:
                return True
            stack.append(g.back)
            g = g.next
    return False


def _flatten_groups(ball_groups, outs):
    """Compact a round's per-group (score, t3) tables into flat arrays
    over the valid slots: (scores, t3s, cand_of, edge_of).  An all--inf
    round is a legitimate outcome: selection then finds no move."""
    flat_s, flat_t, flat_c, flat_e = [], [], [], []
    for g, (s, t3) in zip(ball_groups, outs):
        s, t3 = s.cpu().numpy(), t3.cpu().numpy()
        vmask = g.score_ops[..., BOP_VALID] == 1
        rows, cols = np.nonzero(vmask)
        flat_s.append(s[rows, cols])
        flat_t.append(t3[rows, cols])
        flat_c.append(g.cand_ids[rows])
        flat_e.append(g.score_ops[rows, cols, BOP_EDGE])
    scores = np.concatenate(flat_s)
    # NaNs (f32 pathologies) sort FIRST under descending argsort and
    # would end selection immediately — mask them out
    scores = np.where(np.isnan(scores), -np.inf, scores)
    return (scores, np.concatenate(flat_t), np.concatenate(flat_c),
            np.concatenate(flat_e))


def _select_improving(scores, cand_of, edge_of, logl0, eps, limit,
                      region_sets, edge_endpoints,
                      block_regraft_edge: bool):
    """Greedy improving-move selection over flat score arrays.

    Two region granularities feed this (see spr_round): the surgery-
    anchor sets (cand_hard, the default) and the full staleness sets
    (cand_affected, the verified-ladder fallback)."""
    order = np.argsort(scores, kind="stable")[::-1]
    chosen: List[Tuple[int, int]] = []
    chosen_idx: List[int] = []
    used: set = set()
    for f in order:
        f = int(f)
        if scores[f] <= logl0 + eps or not np.isfinite(scores[f]):
            break
        c, e = int(cand_of[f]), int(edge_of[f])
        region = set(region_sets[c])
        if block_regraft_edge:
            region |= set(edge_endpoints[e])
        if used & region:
            continue
        chosen.append((c, e))
        chosen_idx.append(f)
        used |= region
        if len(chosen) >= limit:
            break
    return chosen, chosen_idx


def _apply_to_tree(prog: SprProgram, selection, sel_idx, t3s):
    """Apply moves sequentially on a fresh copy of prog's tree; moves
    made inapplicable by earlier surgery (regraft target swallowed by a
    pruned subtree, or now-degenerate) are skipped.  Returns
    (new_tree, applied flat indices)."""
    work = parse_newick_string(
        export_newick(prog.tree.vroot, precision=None))
    halves = {h.node_index: h for h in _half_nodes(work)}
    applied: List[int] = []
    for (c, e), f in zip(selection, sel_idx):
        p = halves[int(prog.cand_prune_node[c])]
        r = halves[int(prog.edge_node[e])]
        if _contains_iter(p.back, r):
            continue
        try:
            moves.spr(p, r)
        except ValueError:
            continue
        p.length = p.back.length = float(t3s[f])
        applied.append(f)
    return parse_newick_string(
        export_newick(work.vroot, precision=None)), applied


def use_edge_kernel(cfg: PartitionConfig, invariant, device) -> bool:
    """Whether a round prices its slots with the edge scorer (kernel on
    CUDA tensors): `plain_scorer_reason` finds no reason against it."""
    return plain_scorer_reason(cfg, invariant, device) is None


def plain_scorer_reason(cfg: PartitionConfig, invariant,
                        device) -> Optional[str]:
    """Why a round prices its slots with the plain scorer, or None where
    it takes the edge scorer (kernel on CUDA tensors).  The scorer's
    contract: f32, per-site scalers, no asc bias, no invariant-marked
    site, and a shape the kernel takes (edge_score.unsupported: any state
    count from 2 to 32, where its shared memory fits `device`'s, an
    H100's without a card present), so that the gate and the kernel never
    disagree.  cfg.use_kernel: None takes the kernel exactly when the
    contract holds on a CUDA device, and warns with the kernel's reason
    where only its shared memory refuses the case; True takes it (its
    plain version on the CPU) and raises when the contract fails; False
    takes the plain scorer."""
    contract = (cfg.dtype == torch.float32 and cfg.asc_bias == AB_NONE
                and not cfg.per_rate_scalers
                and bool((invariant < 0).all()))
    if cfg.use_kernel is False:
        return "use_kernel=False"
    if cfg.use_kernel is None and not contract:
        return ("outside the edge scorer's contract (f32, per-site "
                "scalers, no asc bias, no invariant-marked site)")
    if cfg.use_kernel is None and device.type != "cuda":
        return f"the edge scorer kernel runs on CUDA devices, not {device}"
    if not contract:
        raise ValueError("the edge scorer takes f32, per-site scalers, no "
                         "asc bias and no invariant-marked site")
    reason = edge_score.unsupported(cfg.rate_cats, cfg.states,
                                    edge_score.smem_limit_of(device))
    if reason is None:
        return None
    if cfg.use_kernel:
        raise ValueError(f"the edge scorer kernel cannot take this case: "
                         f"{reason}")
    warnings.warn(f"the plain scorer prices this SPR round on {device}: "
                  f"{reason}", stacklevel=2)
    return reason


def _round_args(prog: SprProgram, device) -> tuple:
    """The topology arguments of _spr_round_device for a radius-compiled
    program, on `device`: (level_ops, pmat_slots, branch_lengths,
    root_rows, root_slot, group_args)."""
    erow = _long(prog.edge_rows, device)
    pslots = _long(prog.pmatrix_slots, device)
    group_args = tuple(
        (tuple(_long(a, device) for a in g.ball_levels),
         _long(g.score_ops, device), _long(g.sub_rows, device),
         _long(g.edge_pos, device), _long(g.merge_edges, device))
        for g in prog.ball_groups)
    bl = torch.as_tensor(prog.branch_lengths, dtype=prog.cfg_ext.dtype,
                         device=device)
    return (_long(prog.level_ops, device), pslots, bl, erow[prog.root_edge],
            pslots[prog.root_edge], group_args)


def _score_partition(prog: SprProgram, model, site, newton_iters: int):
    """The score phase of one radius-compiled program: the device round
    and its flat tables.  site: (tipchars, pattern weights, invariant) on
    the model's device.  Returns (logl0, scores, t3s, cand_of, edge_of,
    scorer, edge-scorer launches, the reason the plain scorer ran or
    None)."""
    device = _device_of(model)
    cfg = prog.cfg_ext
    tipchars, pw_d, inv_d = site
    level_ops, pslots, bl, root_rows, root_slot, group_args = _round_args(
        prog, device)
    reason = plain_scorer_reason(cfg, inv_d, device)
    kernel_on = reason is None
    launches0 = edge_score.edge_scores.launches
    logl0_d, outs = _spr_round_device(
        cfg, model, level_ops, pslots, bl, tipchars, pw_d, inv_d, root_rows,
        root_slot, group_args, ball_slots=prog.ball_slots,
        newton_iters=newton_iters, use_kernel=kernel_on)
    return (float(logl0_d),) + _flatten_groups(prog.ball_groups, outs) + (
        "kernel" if kernel_on else "plain",
        edge_score.edge_scores.launches - launches0, reason)


def _recompile_pins(prog: SprProgram) -> dict:
    """compile_spr keywords that keep a recompiled program in prog's shape
    buckets."""
    pins = {"min_level_shape": prog.level_ops.shape[:2],
            "radius": prog.radius}
    if prog.radius is not None:
        pins["min_group_shapes"] = tuple(g.shape_key
                                         for g in prog.ball_groups)
        pins["min_ball_slots"] = prog.ball_slots
    return pins


def _select_apply_verify(progs: List[SprProgram], models, labels_list,
                         sites, scores, t3_list, cand_of, edge_of,
                         logl0: float, eps: float,
                         max_moves: Optional[int], timings: Optional[dict]):
    """The host half of a round after scoring, over K >= 1 programs of one
    topology (scores: the move scores summed over the partitions; t3_list:
    each partition's refined attachment branches): greedy selection, the
    surgery on every partition's tree, and the exact verification ladder.
    Returns (new programs or None when no move was made, logl, moves)."""
    prog0 = progs[0]
    # greedy improving move selection (flat arrays).  Two region
    # granularities:
    #   * cand_hard — only the nodes the SPR surgery itself rewires: moves
    #     may interact through stale scores, but every batch is verified
    #     exactly below, so correctness never depends on the region
    #     choice.  The default: conservative regions block most improving
    #     moves on random starts.
    #   * cand_affected — the full staleness region (pruned subtree +
    #     attachment); scores of non-conflicting moves stay exact.  The
    #     fallback when the aggressive batch verifies worse.
    limit = max_moves if max_moves is not None else len(prog0.cand_affected)

    def select(region_sets, block_regraft_edge: bool):
        return _select_improving(scores, cand_of, edge_of, logl0, eps,
                                 limit, region_sets,
                                 prog0.edge_endpoints, block_regraft_edge)

    with spans.span("search.select", timings):
        chosen, chosen_idx = select(prog0.cand_hard, block_regraft_edge=False)
    if not chosen:
        return None, logl0, 0

    def apply_all(selection, sel_idx):
        """Apply the moves to every partition's tree (shared topology,
        per-partition t3); returns (new programs or None, applied flat
        indices)."""
        new_trees, applied_ref = [], None
        for prog, t3s in zip(progs, t3_list):
            tree_k, applied = _apply_to_tree(prog, selection, sel_idx, t3s)
            if applied_ref is None:
                applied_ref = applied
            elif applied != applied_ref:   # topology-driven: the same
                raise RuntimeError("partitions applied different moves")
            new_trees.append(tree_k)
        if not applied_ref:
            return None, applied_ref
        return [compile_spr(t, prog.cfg, **_recompile_pins(prog))
                for t, prog in zip(new_trees, progs)], applied_ref

    def total_exact(new_progs):
        tot = 0.0
        for new_prog, model, labels, (_, pw_d, inv_d) in zip(
                new_progs, models, labels_list, sites):
            tip_n = _tipchars_for(new_prog, labels, _device_of(model))
            tot += _program_logl(new_prog, model, tip_n, pw_d, inv_d)
        return tot

    best_single = float(scores[chosen_idx[0]])
    with spans.span("search.apply", timings):
        new_progs, applied = apply_all(chosen, chosen_idx)
    if timings is not None:
        timings["n_applied"] = len(applied)
    if not applied:
        return None, logl0, 0

    if len(applied) == 1:
        # a single move's score is its exact post-move likelihood
        return new_progs, float(scores[applied[0]]), 1

    # verify the aggressive batch exactly; ladder down to the
    # conservative-region batch, then the single best move — each rung
    # is verified, so the returned logL is exact and monotone
    with spans.span("search.verify", timings):
        logl_batch = total_exact(new_progs)
        if logl_batch >= best_single - eps:
            if timings is not None:
                timings["ladder"] = 0
            return new_progs, logl_batch, len(applied)

        chosen2, chosen_idx2 = select(prog0.cand_affected,
                                      block_regraft_edge=True)
        if len(chosen2) > 1:
            progs2, applied2 = apply_all(chosen2, chosen_idx2)
            if progs2 is not None:
                logl2 = total_exact(progs2)
                if logl2 >= best_single - eps:
                    if timings is not None:
                        timings["ladder"] = 1
                    return progs2, logl2, len(applied2)

        progs1, _applied1 = apply_all(chosen[:1], chosen_idx[:1])
        if timings is not None:
            timings["ladder"] = 2
        return progs1, best_single, 1


def _score_exhaustive(prog: SprProgram, model, site, newton_iters: int):
    """The score phase of a program without a radius: every (prune,
    regraft) pair by one gapped sweep a candidate, in _score_partition's
    form (no edge-scorer launch)."""
    device = _device_of(model)
    cfg = prog.cfg_ext
    tipchars, pw_d, inv_d = site
    bl = torch.as_tensor(prog.branch_lengths, dtype=cfg.dtype,
                         device=device)
    lops = _long(prog.level_ops, device)
    erow = _long(prog.edge_rows, device)
    pslots = _long(prog.pmatrix_slots, device)
    logl0 = float(_logl_rt(cfg, model, lops, pslots, bl, tipchars,
                           pw_d, inv_d, erow[prog.root_edge],
                           pslots[prog.root_edge]))
    scores2, t3s2 = _spr_all_scores(
        cfg, model, lops, erow, pslots, bl, tipchars, pw_d, inv_d,
        _long(prog.cand_edge, device), _long(prog.cand_sub_rows, device),
        torch.as_tensor(prog.cand_gap_mask, device=device),
        torch.as_tensor(prog.cand_edge_valid, device=device),
        newton_iters=newton_iters)
    scores2, t3s2 = scores2.cpu().numpy(), t3s2.cpu().numpy()
    C, E = scores2.shape
    cand_of = np.repeat(np.arange(C, dtype=np.int32), E)
    edge_of = np.tile(np.arange(E, dtype=np.int32), C)
    # NaNs (f32 pathologies) sort FIRST under descending argsort
    scores = scores2.reshape(-1)
    scores = np.where(np.isnan(scores), -np.inf, scores)
    return (logl0, scores, t3s2.reshape(-1), cand_of, edge_of, "plain", 0,
            "the program has no radius: the edge scorer prices ball slots")


def spr_round(prog: SprProgram, model,
              tipchars_by_label: Dict[str, np.ndarray],
              *, newton_iters: int = 3, max_moves: Optional[int] = None,
              eps: float = 1e-6, pattern_weights=None, invariant=None,
              timings: Optional[dict] = None
              ) -> Tuple[SprProgram, float, int]:
    """One SPR round: score all pairs, apply all non-conflicting improving
    moves (see hill_climb for smoothing cadence).  Runs on the model's
    device.

    timings: if a dict is passed, per-phase wall seconds are accumulated
    into it ("setup", "score", "select", "apply", "verify": the host
    seconds of the round's phase spans, spans.py), with the scorer taken
    ("scorer": "kernel" or "plain", and "scorer_reason") and the edge
    scorer's kernel launches of this round ("edge_score_launches");
    "n_applied" and "ladder" say how the moves were verified.

    Returns (new_program, logl, moves_applied); logl is exact for the
    returned topology and monotone vs. the input's."""
    with spans.span("search.round"):
        with spans.span("search.setup", timings):
            site = _site_arrays(prog, tipchars_by_label, _device_of(model),
                                pattern_weights, invariant)
        score = _score_exhaustive if prog.radius is None \
            else _score_partition
        with spans.span("search.score", timings):
            logl0, scores, t3s, cand_of, edge_of, scorer, launches, \
                reason = score(prog, model, site, newton_iters)
        if timings is not None:
            timings["scorer"] = scorer
            timings["scorer_reason"] = reason
            timings["edge_score_launches"] = launches
        new_progs, logl, applied = _select_apply_verify(
            [prog], [model], [tipchars_by_label], [site], scores, [t3s],
            cand_of, edge_of, logl0, eps, max_moves, timings)
    return (prog if new_progs is None else new_progs[0]), logl, applied


def smooth_branches(prog: SprProgram, model,
                    tipchars_by_label: Dict[str, np.ndarray],
                    *, rounds: int = 2, newton_iters: int = 8,
                    pattern_weights=None, invariant=None) -> SprProgram:
    """Batched Newton smoothing of all branch lengths (runtime topology);
    returns a program with updated branch_lengths (tree lengths synced)."""
    device = _device_of(model)
    cfg = prog.cfg_ext
    tipchars, pw_d, inv_d = _site_arrays(prog, tipchars_by_label, device,
                                         pattern_weights, invariant)
    bl = _smooth_rt(
        cfg, model, _long(prog.level_ops, device),
        _long(prog.edge_rows, device), _long(prog.pmatrix_slots, device),
        torch.as_tensor(prog.branch_lengths, dtype=cfg.dtype, device=device),
        tipchars, pw_d, inv_d,
        torch.as_tensor(prog.color_masks, device=device), rounds=rounds,
        newton_iters=newton_iters)
    bl = bl.cpu().numpy().astype(np.float64)
    _write_lengths(prog, bl)
    return dataclasses.replace(prog, branch_lengths=bl)


def _write_lengths(prog: SprProgram, bl: np.ndarray) -> None:
    """Write branch lengths into the program's tree, so that later exports
    carry them."""
    pm_to_len = {int(p): float(t) for p, t in zip(prog.pmatrix_slots, bl)}
    for h in _half_nodes(prog.tree):
        h.length = pm_to_len[h.pmatrix_index]


def _per_partition(values, k: int):
    """Entry k of an optional per-partition list."""
    return values[k] if values is not None else None


def _total_logl(progs, models, labels_list, pattern_weights_list=None,
                invariant_list=None) -> float:
    """Sum of the exact logLs of K programs, each at its own lengths."""
    total = 0.0
    for k, (prog, model) in enumerate(zip(progs, models)):
        site = _site_arrays(prog, labels_list[k], _device_of(model),
                            _per_partition(pattern_weights_list, k),
                            _per_partition(invariant_list, k))
        total += _program_logl(prog, model, *site)
    return total


def _smooth_all_if_better(progs, models, labels_list, *, rounds: int = 2,
                          pattern_weights_list=None, invariant_list=None
                          ) -> Tuple[List[SprProgram], bool]:
    """smooth_branches on each of K programs (K = 1: a single-partition
    climb), kept only if the summed exact logL did not fall.  A class of
    branches moves at once (a Jacobi step), which can lower the logL where
    neighbouring branches interact; the climb's trace is promised
    monotone, so such a smoothing is dropped as a whole.  Returns
    (programs, kept)."""
    before = _total_logl(progs, models, labels_list, pattern_weights_list,
                         invariant_list)
    out = [smooth_branches(
        prog, models[k], labels_list[k], rounds=rounds,
        pattern_weights=_per_partition(pattern_weights_list, k),
        invariant=_per_partition(invariant_list, k))
        for k, prog in enumerate(progs)]
    if _total_logl(out, models, labels_list, pattern_weights_list,
                   invariant_list) >= before:
        return out, True
    for prog in progs:
        _write_lengths(prog, prog.branch_lengths)    # the trees are shared
    return list(progs), False


def _smooth_if_better(prog: SprProgram, model, tipchars_by_label, *,
                      rounds: int = 2, pattern_weights=None, invariant=None
                      ) -> Tuple[SprProgram, bool]:
    """_smooth_all_if_better for one program."""
    out, kept = _smooth_all_if_better(
        [prog], [model], [tipchars_by_label], rounds=rounds,
        pattern_weights_list=None if pattern_weights is None
        else [pattern_weights],
        invariant_list=None if invariant is None else [invariant])
    return out[0], kept


def evaluate_tree(tree: UTree, cfg: PartitionConfig, model,
                  tipchars_by_label: Dict[str, np.ndarray],
                  *, smooth_rounds: int = 2,
                  pattern_weights=None, invariant=None
                  ) -> Tuple[float, SprProgram]:
    """Exact logL of one topology, after `smooth_rounds` rounds of batched
    Newton branch smoothing (0 = score the lengths as given).

    The search-quality yardstick: score a known-truth topology with the
    same machinery the hill-climb uses, so Δ logL between the search
    result and the truth is an apples-to-apples comparison."""
    tree = parse_newick_string(export_newick(tree.vroot, precision=None))
    prog = compile_spr(tree, cfg)
    if smooth_rounds:
        prog = smooth_branches(prog, model, tipchars_by_label,
                               rounds=smooth_rounds,
                               pattern_weights=pattern_weights,
                               invariant=invariant)
    site = _site_arrays(prog, tipchars_by_label, _device_of(model),
                        pattern_weights, invariant)
    return _program_logl(prog, model, *site), prog


def hill_climb(tree: UTree, cfg: PartitionConfig, model,
               tipchars_by_label: Dict[str, np.ndarray],
               *, max_rounds: int = 30, newton_iters: int = 3,
               smooth_every: int = 2, smooth_rounds: int = 2,
               eps: float = 1e-6,
               radius: Optional[int] = None,
               radius_max: Optional[int] = None,
               pattern_weights=None, invariant=None,
               checkpoint_dir=None) -> Tuple[UTree, float, dict]:
    """Full SPR hill-climb: rounds of batched moves until no improvement.

    radius: regraft-distance bound for each round's scoring (RAxML-NG's
    SPR radius).  None scores every (prune, regraft) pair exhaustively —
    O(n^2) message sweeps per round; a radius K costs O(n * 2^K).

    radius_max: adaptive schedule — when a radius-K round finds no
    improving move, the radius doubles up to radius_max before the climb
    is declared converged.

    checkpoint_dir: if set, every round appends the current newick +
    exact logL to <dir>/search_trace.jsonl and rewrites
    <dir>/latest.newick, so a killed search resumes by restarting from
    latest.newick (all state lives in the tree: branch lengths included).

    Returns (tree, logl, stats) with stats = {"rounds", "moves",
    "logl_trace", "round_secs", "radius_trace", "phase_timings",
    "init_smooth_s"}; logl_trace is monotone non-decreasing."""
    ckpt = pathlib.Path(checkpoint_dir) if checkpoint_dir else None
    if ckpt:
        ckpt.mkdir(parents=True, exist_ok=True)
        # a resumed run appends round numbers starting at 1 again; a
        # separator record keeps the trace parseable as distinct runs
        if (ckpt / "search_trace.jsonl").exists():
            with open(ckpt / "search_trace.jsonl", "a") as f:
                f.write(json.dumps({"run_start": True}) + "\n")

    smooth_kw = dict(rounds=smooth_rounds, pattern_weights=pattern_weights,
                     invariant=invariant)
    # normalize to parser template indexing (trees from other builders
    # may carry non-template clv indices)
    tree = parse_newick_string(export_newick(tree.vroot, precision=None))
    prog = compile_spr(tree, cfg, radius=radius)
    init_smooth_s = 0.0
    if smooth_every:
        # optimize the starting branch lengths first: SPR scores against
        # unsmoothed branches under-rank good moves
        t0 = time.perf_counter()
        prog, _ = _smooth_if_better(prog, model, tipchars_by_label,
                                    **smooth_kw)
        init_smooth_s = time.perf_counter() - t0
    trace: List[float] = []
    round_secs: List[float] = []
    radius_trace: List[Optional[int]] = []
    total_moves = 0
    rounds = 0
    cur_radius = radius
    phase_timings: List[dict] = []
    for r in range(max_rounds):
        t0 = time.perf_counter()
        tm: dict = {}
        prog, logl, applied = spr_round(
            prog, model, tipchars_by_label, newton_iters=newton_iters,
            eps=eps, pattern_weights=pattern_weights, invariant=invariant,
            timings=tm)
        round_secs.append(time.perf_counter() - t0)
        phase_timings.append(tm)
        trace.append(logl)
        radius_trace.append(cur_radius)
        rounds += 1
        total_moves += applied
        if ckpt:
            newick = export_newick(prog.tree.vroot, precision=9)
            (ckpt / "latest.newick").write_text(newick + "\n")
            with open(ckpt / "search_trace.jsonl", "a") as f:
                f.write(json.dumps({"round": rounds, "logl": logl,
                                    "moves": applied,
                                    "radius": cur_radius}) + "\n")
        if applied == 0:
            if (cur_radius is not None and radius_max is not None
                    and cur_radius < radius_max):
                cur_radius = min(2 * cur_radius, radius_max)
                prog = compile_spr(prog.tree, cfg, radius=cur_radius,
                                   min_level_shape=prog.level_ops.shape[:2],
                                   min_ball_slots=prog.ball_slots)
                continue
            break
        if smooth_every and (r + 1) % smooth_every == 0:
            ts = time.perf_counter()
            prog, _ = _smooth_if_better(prog, model, tipchars_by_label,
                                        **smooth_kw)
            tm["smooth"] = time.perf_counter() - ts
    if smooth_every:
        prog, _ = _smooth_if_better(prog, model, tipchars_by_label,
                                    **smooth_kw)
    site = _site_arrays(prog, tipchars_by_label, _device_of(model),
                        pattern_weights, invariant)
    logl = _program_logl(prog, model, *site)
    trace.append(logl)
    return prog.tree, logl, {"rounds": rounds, "moves": total_moves,
                             "logl_trace": trace,
                             "round_secs": round_secs,
                             "radius_trace": radius_trace,
                             "phase_timings": phase_timings,
                             "init_smooth_s": init_smooth_s}


# --------------------------------------------------------------------------
# multi-partition search (K per-gene partitions, ONE topology)
# --------------------------------------------------------------------------


def compile_spr_multi(tree: UTree, cfgs: Sequence[PartitionConfig],
                      radius: Optional[int] = None,
                      pins: Optional[List[dict]] = None
                      ) -> List[SprProgram]:
    """K SprPrograms over one topology (reference clients drive one
    partition per gene over the same tree — SURVEY.md §2.6).

    The candidate tables, ball groups and edge layouts depend only on the
    topology, so the K programs share one move/index structure; only the
    per-partition row spaces and branch lengths differ."""
    tips = {c.tips for c in cfgs}
    if len(tips) != 1 or tips.pop() != tree.tip_count:
        raise ValueError("all partitions must cover the same taxa as the "
                         "shared topology")
    progs = []
    newick = export_newick(tree.vroot, precision=None)
    for k, cfg in enumerate(cfgs):
        pin = pins[k] if pins is not None else {}
        # each partition owns its tree COPY: branch lengths are unlinked,
        # and smooth_branches writes lengths back into the tree graph
        progs.append(compile_spr(parse_newick_string(newick), cfg,
                                 radius=radius, **pin))
    for p in progs[1:]:
        np.testing.assert_array_equal(p.cand_edge, progs[0].cand_edge)
        np.testing.assert_array_equal(p.edge_endpoints,
                                      progs[0].edge_endpoints)
    return progs


def spr_round_multi(progs: List[SprProgram], models,
                    tipchars_by_label_list, *, newton_iters: int = 3,
                    max_moves: Optional[int] = None, eps: float = 1e-6,
                    pattern_weights_list=None, invariant_list=None,
                    timings: Optional[dict] = None
                    ) -> Tuple[List[SprProgram], float, int]:
    """One SPR round over K partitions under UNLINKED branch lengths
    (RAxML-NG `--brlen unlinked`): each partition keeps its own branch
    vector, each move's attachment branch is Newton-optimized per
    partition, and the move score is the SUM of the partitions' exact
    post-move logLs.  Selection, verification and the monotone-logL
    guarantee work exactly as in the single-partition spr_round, on the
    summed scores.

    timings: as in spr_round; "scorer" and "edge_score_launches" are lists
    with one entry per partition.

    Returns (new_programs, total_logl, moves_applied)."""
    K = len(progs)
    if len(models) != K or len(tipchars_by_label_list) != K:
        raise ValueError(f"{K} programs need {K} models and tip tables")
    with spans.span("search.round"):
        with spans.span("search.setup", timings):
            sites = []
            for k, prog in enumerate(progs):
                if prog.radius is None:
                    raise ValueError("spr_round_multi requires "
                                     "radius-compiled programs")
                sites.append(_site_arrays(
                    prog, tipchars_by_label_list[k], _device_of(models[k]),
                    _per_partition(pattern_weights_list, k),
                    _per_partition(invariant_list, k)))
        with spans.span("search.score", timings):
            logl0 = 0.0
            scores = cand_of = edge_of = None
            t3_list, scorers, reasons, launches = [], [], [], []
            for prog, model, site in zip(progs, models, sites):
                logl0_k, scores_k, t3s_k, cand_k, edge_k, scorer, n, \
                    reason = _score_partition(prog, model, site,
                                              newton_iters)
                logl0 += logl0_k
                t3_list.append(t3s_k)
                scorers.append(scorer)
                reasons.append(reason)
                launches.append(n)
                if scores is None:
                    scores, cand_of, edge_of = scores_k, cand_k, edge_k
                else:
                    np.testing.assert_array_equal(cand_k, cand_of)
                    np.testing.assert_array_equal(edge_k, edge_of)
                    scores = scores + scores_k
        if timings is not None:
            timings["scorer"] = scorers
            timings["scorer_reason"] = reasons
            timings["edge_score_launches"] = launches
        new_progs, logl, applied = _select_apply_verify(
            progs, models, tipchars_by_label_list, sites, scores, t3_list,
            cand_of, edge_of, logl0, eps, max_moves, timings)
    return (progs if new_progs is None else new_progs), logl, applied


def hill_climb_multi(tree: UTree, cfgs: Sequence[PartitionConfig], models,
                     tipchars_by_label_list, *, max_rounds: int = 30,
                     newton_iters: int = 3, smooth_every: int = 2,
                     smooth_rounds: int = 2, eps: float = 1e-6,
                     radius: int = 5, pattern_weights_list=None,
                     invariant_list=None) -> Tuple[UTree, float, dict]:
    """Multi-partition SPR hill-climb (unlinked branch lengths): one
    shared topology, K per-gene partitions, summed logL maximized.  Every
    partition is smoothed on its own; a smoothing is kept only if the
    summed logL did not fall (see _smooth_all_if_better), so the trace of
    the summed logL is monotone.

    Returns (tree, total_logl, stats); the tree carries partition 0's
    branch lengths (each partition's own lengths live in its program —
    exposed via stats["programs"])."""
    tree = parse_newick_string(export_newick(tree.vroot, precision=None))
    progs = compile_spr_multi(tree, cfgs, radius=radius)
    smooth_kw = dict(rounds=smooth_rounds,
                     pattern_weights_list=pattern_weights_list,
                     invariant_list=invariant_list)
    if smooth_every:
        progs, _ = _smooth_all_if_better(progs, models,
                                         tipchars_by_label_list, **smooth_kw)
    trace: List[float] = []
    round_secs: List[float] = []
    phase_timings: List[dict] = []
    total_moves = rounds = 0
    for r in range(max_rounds):
        t0 = time.perf_counter()
        tm: dict = {}
        progs, logl, applied = spr_round_multi(
            progs, models, tipchars_by_label_list,
            newton_iters=newton_iters, eps=eps,
            pattern_weights_list=pattern_weights_list,
            invariant_list=invariant_list, timings=tm)
        round_secs.append(time.perf_counter() - t0)
        phase_timings.append(tm)
        trace.append(logl)
        rounds += 1
        total_moves += applied
        if applied == 0:
            break
        if smooth_every and (r + 1) % smooth_every == 0:
            ts = time.perf_counter()
            progs, _ = _smooth_all_if_better(
                progs, models, tipchars_by_label_list, **smooth_kw)
            tm["smooth"] = time.perf_counter() - ts
    if smooth_every:
        progs, _ = _smooth_all_if_better(progs, models,
                                         tipchars_by_label_list, **smooth_kw)
    # final exact total at the smoothed lengths
    total = _total_logl(progs, models, tipchars_by_label_list,
                        pattern_weights_list, invariant_list)
    trace.append(total)
    return progs[0].tree, total, {
        "rounds": rounds, "moves": total_moves, "logl_trace": trace,
        "round_secs": round_secs, "phase_timings": phase_timings,
        "programs": progs}
