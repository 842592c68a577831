"""Fast (Fitch) parsimony: bit-parallel unweighted scoring.

Counterpart of libpll2_tpu/parsimony/fitch.py.  Reference semantics
(libpll-2 src/fast_parsimony.c):

  * init (pll_fastparsimony_init, :523-555): informative-site filter —
    a site is informative iff >=2 distinct tip codes occur >=2 times;
    non-informative sites contribute ``singletons * weight`` to a constant
    cost (pll_set_informative :369-403, check_informative :128-194);
  * vectors (fill_parsimony_vectors, :196-367): per (node, state) packed
    bit-vectors over informative site occurrences (expanded by pattern
    weight); trailing pad bits are set to ONES so they never score;
    ``tips + 3*inner`` vectors — one per direction of each inner node
    (alloc_pars_structs :26-80);
  * update (pll_fastparsimony_update_vector, :557-609): Fitch rule
    ``orvand = OR_j(c1_j & c2_j)``,
    ``parent_j = (c1_j & c2_j) | (~orvand & (c1_j | c2_j))``,
    ``cost[parent] = popcount(~orvand) + cost[c1] + cost[c2]``;
  * edge score (:611-648): ``popcount(~OR_j(v1_j & v2_j)) + costs +
    const_cost``; root score (:776-781) = ``cost[root] + const_cost``.

The informative filter and the packing run on the host in numpy, as in the
JAX package.  The vectors then live in one dense tensor
``packed[nodes, states, W]`` on the FastParsimony's device: 32-bit words
held as int32 (the same bits as the reference's uint32 words, since torch
offers uint32 few operations on CUDA).  Updates run levelized (all ops
whose children are ready as one batched gather and scatter), and
``placement_scores`` scores every candidate edge of a stepwise insertion in
one call.  torch has no population count, so ``popcount32`` counts bits by
SWAR arithmetic on the words widened to int64 (int32 right shifts are
arithmetic and its sums would overflow).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import round_up
from .sankoff import ParsBuildOp, levels_of

BITVECTOR_SIZE = 32  # PLL_BITVECTOR_SIZE (fast_parsimony.c:24)


def _informative_filter(tipchars: np.ndarray, weights: np.ndarray,
                        sites: int):
    """Mark informative sites; accumulate singleton const-cost.

    Mirrors pll_set_informative (fast_parsimony.c:369-403): for each site
    count occurrences of each distinct tip code; informative iff >1 code
    occurs >1 time; else const_cost += singletons * weight.
    """
    informative = np.zeros(sites, dtype=bool)
    const_cost = 0
    cols = tipchars[:, :sites]
    for j in range(sites):
        _, counts = np.unique(cols[:, j], return_counts=True)
        repeated = int(np.count_nonzero(counts > 1))
        singletons = int(np.count_nonzero(counts == 1))
        if repeated > 1:
            informative[j] = True
        else:
            const_cost += singletons * int(weights[j])
    return informative, const_cost


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 holding 32 bits), as
    int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _or_states(v: torch.Tensor) -> torch.Tensor:
    """OR over the state axis: [K, S, W] -> [K, W]."""
    return functools.reduce(torch.bitwise_or, v.unbind(1))


def _fitch(c1: torch.Tensor, c2: torch.Tensor):
    """Fitch parents [K, S, W] of children c1, c2 and the changes each
    costs [K]."""
    vand = c1 & c2
    orvand = _or_states(vand)                              # [K, W]
    parent = vand | (~orvand[:, None, :] & (c1 | c2))
    return parent, popcount32(~orvand).sum(dim=1)


def _fitch_level(packed: torch.Tensor, node_cost: torch.Tensor,
                 ops: torch.Tensor) -> None:
    """One level of independent Fitch updates, in place.

    packed: [N, S, W] int32; node_cost: [N] int64; ops: [K, 3] int64."""
    parent, score = _fitch(packed[ops[:, 1]], packed[ops[:, 2]])
    packed[ops[:, 0]] = parent
    node_cost[ops[:, 0]] = score + node_cost[ops[:, 1]] \
        + node_cost[ops[:, 2]]


def _placement_scores(packed: torch.Tensor, node_cost: torch.Tensor,
                      pairs: torch.Tensor, sub_index: int) -> torch.Tensor:
    """Batched insertion scoring: for each candidate edge (c1, c2) in
    ``pairs`` [K, 2], form the Fitch parent of (c1, c2) and score the new
    edge against the subtree vector ``sub_index`` — the whole
    splice-update-score-unsplice loop of the reference's stepwise
    insertion (stepwise.c:486-525) as one batched computation."""
    parent, score = _fitch(packed[pairs[:, 0]], packed[pairs[:, 1]])
    pcost = score + node_cost[pairs[:, 0]] + node_cost[pairs[:, 1]]
    orv2 = _or_states(parent & packed[sub_index][None])
    escore = popcount32(~orv2).sum(dim=1)
    return escore + pcost + node_cost[sub_index]


def _edge_scores(packed: torch.Tensor, node_cost: torch.Tensor,
                 pairs: torch.Tensor) -> torch.Tensor:
    """Batched edge scores (without const_cost): pairs [K, 2] int64."""
    orvand = _or_states(packed[pairs[:, 0]] & packed[pairs[:, 1]])
    score = popcount32(~orvand).sum(dim=1)
    return score + node_cost[pairs[:, 0]] + node_cost[pairs[:, 1]]


class FastParsimony:
    """Mirrors pll_parsimony_t in fast (Fitch) mode + its functions
    (pll_fastparsimony_{init,update_vectors,edge_score,root_score},
    fast_parsimony.c:523-781).

    Takes the tip characters and pattern weights of a `Partition`
    (``partition``, whose tips were set by set_tip_states), or directly:
    ``tipchars`` [tips, >= sites] state bit-masks (as set_tip_states
    encodes them) and ``weights`` [>= sites] pattern weights.  device:
    where the vectors live; None is the partition's device, or the card
    without a partition."""

    def __init__(self, partition=None, *, tipchars=None, weights=None,
                 tips: Optional[int] = None, states: Optional[int] = None,
                 sites: Optional[int] = None,
                 word_pad: int = 128, device=None):
        if partition is not None:
            cfg = partition.cfg
            tips, states, sites = cfg.tips, cfg.states, cfg.sites
            tipchars = partition.tipchars
            weights = partition.pattern_weights
            if device is None:
                device = partition.device
        if device is None:
            device = "cuda"
        tipchars = np.asarray(tipchars, dtype=np.uint64)
        weights = np.asarray(weights[:sites], dtype=np.int64)
        self.tips = tips
        self.states = states
        self.sites = sites
        self.inner_nodes = tips - 1
        nodes_count = tips + 3 * self.inner_nodes

        self.informative, self.const_cost = _informative_filter(
            tipchars, weights, sites)
        self.informative_count = int(np.count_nonzero(self.informative))

        # weight-expand informative columns -> [tips, bitcount] codes
        inf_idx = np.flatnonzero(self.informative)
        rep = np.repeat(inf_idx, weights[inf_idx])
        bitcount = rep.size
        self.packedvector_count = W = max(
            1, round_up((bitcount + BITVECTOR_SIZE - 1) // BITVECTOR_SIZE,
                        word_pad))

        # bits[t, k, b] = 1 iff state k set at occurrence b (pad -> ones)
        total_bits = W * BITVECTOR_SIZE
        bits = np.ones((tips, states, total_bits), dtype=np.uint8)
        codes = tipchars[:, rep]                            # [tips, bitcount]
        for k in range(states):
            bits[:, k, :bitcount] = ((codes >> np.uint64(k))
                                     & np.uint64(1)).astype(np.uint8)
        # pack LSB-first within each 32-bit word (val |= 1 << bitcount)
        words = bits.reshape(tips, states, W, 4, 8)
        packed8 = np.packbits(words, axis=-1, bitorder="little")[..., 0]
        packed = (packed8.astype(np.uint32).reshape(tips, states, W, 4)
                  * (1 << (8 * np.arange(4, dtype=np.uint32)))).sum(
                      axis=-1, dtype=np.uint32)

        # the words move to the device as int32 with the same bits
        full = np.full((nodes_count, states, W), np.uint32(0xFFFFFFFF))
        full[:tips] = packed
        self.packed = torch.as_tensor(full.view(np.int32), device=device)
        self.node_cost = torch.zeros(nodes_count, dtype=torch.int64,
                                     device=device)

    def _index(self, pairs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pairs, dtype=np.int64),
                               device=self.packed.device)

    # --- build (fast_parsimony.c:557-609 / levelized) -----------------------

    def update_vectors(self, operations: Sequence[ParsBuildOp]) -> None:
        for arr in levels_of(operations):
            _fitch_level(self.packed, self.node_cost, self._index(arr))

    # --- scores (fast_parsimony.c:611-648, 776-781) -------------------------

    def edge_score(self, node1_score_index: int,
                   node2_score_index: int) -> int:
        return int(self.edge_scores_batch(
            [[node1_score_index, node2_score_index]])[0])

    def edge_scores_batch(self, pairs) -> np.ndarray:
        """Score many (node1, node2) edges at once."""
        out = _edge_scores(self.packed, self.node_cost, self._index(pairs))
        return out.cpu().numpy() + self.const_cost

    def placement_scores(self, pairs, subtree_index: int) -> np.ndarray:
        """Insertion scores of a subtree at many candidate edges at once
        (replaces the loop of stepwise.c:486-525)."""
        out = _placement_scores(self.packed, self.node_cost,
                                self._index(pairs), int(subtree_index))
        return out.cpu().numpy() + self.const_cost

    def root_score(self, root_index: int) -> int:
        return int(self.node_cost[root_index]) + self.const_cost
