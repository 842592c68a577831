"""Partition object: owns the CLV, scaler and P-matrix tensors and the
model parameters, and exposes libpll-2's partition API.

Counterpart of libpll2_tpu/partition.py: `Operation`
(pll_operation_t, pll.h:325-335), `levelize_operations`,
`levelize_operations_repeats` and `Partition` (pll_partition_t and its
lifecycle functions, libpll-2 src/pll.c:424-1224, src/models.c:445-493):

  * the numeric state is dense tensors on one device (the site axis
    innermost and padded, see config.py): CLVs [num_clvs+1, R, S, T],
    scalers [scale_buffers+2, T] (per-rate: [..., R, T]), P-matrices
    [P, R, S, S];
  * tips are materialized as 0/1 CLV rows from bit-encoded ambiguity
    states (pll.c:959-1024), so one update serves tip-tip, tip-inner and
    inner-inner cases;
  * the eigendecomposition is lazy and on the host (models/ratematrix.py),
    invalidated by set_subst_params / set_frequencies as in the reference
    (models.c:466,490);
  * the compute methods call the plain PyTorch functions of ops/ (the JAX
    package runs them through jax.jit; no kernel of its own), in place.

The mutating API serves parity and scripting; the performance paths are
the functional engine (engine.py) and its CUDA tree sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import constants
from . import repeats as repeats_mod
from .config import PartitionConfig
from .models import gamma as gamma_mod
from .models import ratematrix
from .ops import derivatives as derivatives_ops
from .ops import likelihood as likelihood_ops
from .ops import partials as partials_ops
from .ops import pmatrix as pmatrix_ops
from .ops.partials import OP_COLS

SCALE_BUFFER_NONE = constants.SCALE_BUFFER_NONE


@dataclasses.dataclass
class Operation:
    """One CLV update: mirrors pll_operation_t (pll.h:325-335)."""
    parent_clv_index: int
    child1_clv_index: int
    child2_clv_index: int
    child1_matrix_index: int
    child2_matrix_index: int
    parent_scaler_index: int = SCALE_BUFFER_NONE
    child1_scaler_index: int = SCALE_BUFFER_NONE
    child2_scaler_index: int = SCALE_BUFFER_NONE


# --------------------------------------------------------------------------
# levelization of operation lists
# --------------------------------------------------------------------------

def _levels(ops: Sequence[Operation]) -> list[list[Operation]]:
    """Post-order ops grouped into levels: an op runs one level after the
    later of its children; ops whose children are all tips run first."""
    level_of: dict[int, int] = {}
    levels: list[list[Operation]] = []
    for op in ops:
        lvl = max(level_of.get(op.child1_clv_index, 0),
                  level_of.get(op.child2_clv_index, 0))
        level_of[op.parent_clv_index] = lvl + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(op)
    return levels


def _encode_levels(levels: list[list[Operation]], cfg: PartitionConfig
                   ) -> np.ndarray:
    """[L, W, 8] int32, padded with no-op rows that target the scratch
    CLV/scaler rows (config.py row conventions)."""
    width = max(len(l) for l in levels)
    out = np.empty((len(levels), width, OP_COLS), dtype=np.int32)
    out[:] = np.array([cfg.clv_scratch, cfg.clv_scratch, cfg.clv_scratch,
                       0, 0, cfg.scaler_scratch, cfg.scaler_zero,
                       cfg.scaler_zero], dtype=np.int32)
    for li, lops in enumerate(levels):
        for wi, op in enumerate(lops):
            out[li, wi] = _encode_op(op, cfg)
    return out


def levelize_operations(ops: Sequence[Operation], cfg: PartitionConfig
                        ) -> np.ndarray:
    """Group a post-order operation list into levels of independent updates.

    The result is a dense [L, W, 8] int32 array, padded with no-op rows.
    The reference executes ops strictly serially (partials.c:245-291); here
    each level is one batched update.
    """
    levels = _levels(ops)
    if not levels:
        return np.zeros((0, 1, OP_COLS), dtype=np.int32)
    return _encode_levels(levels, cfg)


def levelize_operations_repeats(ops: Sequence[Operation],
                                cfg: PartitionConfig,
                                repeats: repeats_mod.Repeats) -> tuple:
    """Levelize AND update the site-repeats class structure in post-order,
    emitting per-op child gather arrays (see repeats.py).

    Returns (level_ops [L, W, 8], level_gathers [L, W, 2, T]) int32; the
    gathers of padding rows are the identity."""
    T = cfg.sites_padded
    gather_of: dict[int, np.ndarray] = {}
    for op in ops:
        repeats.update(op.parent_clv_index, op.child1_clv_index,
                       op.child2_clv_index, op.parent_scaler_index)
        gather_of[id(op)] = np.stack([
            repeats.child_gather(op.parent_clv_index, op.child1_clv_index,
                                 T),
            repeats.child_gather(op.parent_clv_index, op.child2_clv_index,
                                 T)])
    levels = _levels(ops)
    if not levels:
        return (np.zeros((0, 1, OP_COLS), dtype=np.int32),
                np.zeros((0, 1, 2, T), dtype=np.int32))
    out = _encode_levels(levels, cfg)
    gathers = np.broadcast_to(np.arange(T, dtype=np.int32),
                              out.shape[:2] + (2, T)).copy()
    for li, lops in enumerate(levels):
        for wi, op in enumerate(lops):
            gathers[li, wi] = gather_of[id(op)]
    return out, gathers


def _encode_op(op: Operation, cfg: PartitionConfig) -> np.ndarray:
    def scaler_read(idx):
        return cfg.scaler_zero if idx == SCALE_BUFFER_NONE else idx

    def scaler_write(idx):
        return cfg.scaler_scratch if idx == SCALE_BUFFER_NONE else idx

    return np.array([
        op.parent_clv_index,
        op.child1_clv_index,
        op.child2_clv_index,
        op.child1_matrix_index,
        op.child2_matrix_index,
        scaler_write(op.parent_scaler_index),
        scaler_read(op.child1_scaler_index),
        scaler_read(op.child2_scaler_index),
    ], dtype=np.int32)


# --------------------------------------------------------------------------
# Partition
# --------------------------------------------------------------------------

class Partition:
    """PyTorch equivalent of pll_partition_t, on one device.

    `device` defaults to the card and raises where there is none; pass
    device="cpu" to run on the host."""

    def __init__(self, tips: int, clv_buffers: int, states: int, sites: int,
                 rate_matrices: int, prob_matrices: int, rate_cats: int,
                 scale_buffers: int, *, per_rate_scalers: bool = False,
                 pattern_tip: bool = False, site_repeats: bool = False,
                 asc_bias: int = constants.AB_NONE,
                 dtype=torch.float64, site_block: int = 128,
                 device="cuda"):
        # repeats auto-disabled for tiny alignments (pll.c:446-449)
        site_repeats = site_repeats and sites >= repeats_mod.MIN_SITES
        cfg = PartitionConfig(
            tips=tips, clv_buffers=clv_buffers, states=states, sites=sites,
            rate_matrices=rate_matrices, prob_matrices=prob_matrices,
            rate_cats=rate_cats, scale_buffers=scale_buffers,
            per_rate_scalers=per_rate_scalers, pattern_tip=pattern_tip,
            site_repeats=site_repeats, asc_bias=asc_bias, dtype=dtype,
            site_block=site_block)
        self.cfg = cfg
        self.device = torch.device(device)
        self.repeats: Optional[repeats_mod.Repeats] = None
        if site_repeats:
            self.repeats = repeats_mod.Repeats(
                cfg.num_clvs, scale_buffers, sites, cfg.sites_alloc - sites)
        T = cfg.sites_padded
        R, S = rate_cats, states

        self.clv = torch.zeros((cfg.num_clvs + 1, R, S, T), dtype=dtype,
                               device=self.device)
        scaler_shape = ((scale_buffers + 2, R, T) if per_rate_scalers
                        else (scale_buffers + 2, T))
        self.scalers = torch.zeros(scaler_shape, dtype=torch.int32,
                                   device=self.device)
        self.pmatrix = torch.zeros((prob_matrices, R, S, S), dtype=dtype,
                                   device=self.device)

        M = rate_matrices
        self.frequencies = np.full((M, S), 1.0 / S)
        self.subst_params = np.ones((M, S * (S - 1) // 2))
        self.rates = np.zeros(R)
        self.rate_weights = np.full(R, 1.0 / R)
        self.prop_invar = np.zeros(M)
        self.invariant: Optional[np.ndarray] = None

        self.pattern_weights = np.zeros(T)
        self.pattern_weights[:sites] = 1.0
        if cfg.asc_bias != constants.AB_NONE:
            # phantom per-state sites get weight 1 by default (pll.c:1145+)
            self.pattern_weights[sites:sites + states] = 1.0

        # per-rate-matrix eigen decomposition (lazy, host-side)
        self.eigenvals = np.zeros((M, S))
        self.eigenvecs = np.zeros((M, S, S))
        self.inv_eigenvecs = np.zeros((M, S, S))
        self.eigen_decomp_valid = np.zeros(M, dtype=bool)

        # encoded tip characters (for invariant sites & parsimony)
        self.tipchars = np.zeros((tips, cfg.sites_alloc), dtype=np.uint64)
        self.tipchars_valid = np.zeros(tips, dtype=bool)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # --- setters (pll.c / models.c) ---------------------------------------

    def set_tip_states(self, tip_index: int, charmap: np.ndarray,
                       sequence: str) -> None:
        """Encode an ASCII sequence into a 0/1 tip CLV (pll.c:1026-1064);
        class-indexed under site repeats."""
        cfg = self.cfg
        if len(sequence) != cfg.sites:
            raise ValueError(
                f"sequence length {len(sequence)} != sites {cfg.sites}")
        codes = charmap[np.frombuffer(sequence.encode("ascii"), np.uint8)]
        if np.any(codes == 0):
            bad = np.flatnonzero(codes == 0)[0]
            raise ValueError(
                f"illegal state character {sequence[bad]!r} at site {bad}")
        full = np.zeros(cfg.sites_alloc, dtype=np.uint64)
        full[:cfg.sites] = codes
        if cfg.asc_bias != constants.AB_NONE:
            # phantom site s observes pure state s (pll.c:1006-1018)
            full[cfg.sites:cfg.sites + cfg.states] = \
                1 << np.arange(cfg.states, dtype=np.uint64)
        self.tipchars[tip_index] = full
        self.tipchars_valid[tip_index] = True

        if self.repeats is not None:
            # class-indexed tip CLV (pll_update_repeats_tips,
            # repeats.c:189-254): one 0/1 column per distinct state code
            self.repeats.update_tip(tip_index, full)
            ns = self.repeats.sites_number(tip_index)
            full = full[self.repeats.pernode_id_site[tip_index, :ns]]
        codes_t = self._tensor(full.astype(np.int64))
        shifts = torch.arange(cfg.states, device=self.device)
        bits = ((codes_t[None, :] >> shifts[:, None]) & 1).to(cfg.dtype)
        row = self.clv[tip_index]
        row.zero_()
        row[:, :, :full.size] = bits[None]

    def set_tip_clv(self, tip_index: int, clv: np.ndarray,
                    padded: bool = False) -> None:
        """Set a tip CLV from user-supplied values (pll.c:1066-1129).

        clv is [sites, rate_cats, states] (or [sites*rate_cats*states] flat).
        `padded` is accepted and ignored, as in the JAX package.
        """
        cfg = self.cfg
        arr = np.asarray(clv, dtype=np.float64).reshape(
            cfg.sites, cfg.rate_cats, cfg.states)
        row = np.zeros((cfg.rate_cats, cfg.states, cfg.sites_padded))
        row[:, :, :cfg.sites] = np.transpose(arr, (1, 2, 0))
        if cfg.asc_bias != constants.AB_NONE:
            for s in range(cfg.states):
                row[:, s, cfg.sites + s] = 1.0
        self.clv[tip_index] = self._tensor(row, cfg.dtype)
        self.tipchars_valid[tip_index] = False

    def set_frequencies(self, freqs_index: int, freqs) -> None:
        self.frequencies[freqs_index] = ratematrix.normalize_frequencies(
            np.asarray(freqs))
        self.eigen_decomp_valid[freqs_index] = False

    def set_subst_params(self, params_index: int, params) -> None:
        self.subst_params[params_index] = np.asarray(params, dtype=np.float64)
        self.eigen_decomp_valid[params_index] = False

    def set_category_rates(self, rates) -> None:
        self.rates = np.asarray(rates, dtype=np.float64)

    def set_category_weights(self, weights) -> None:
        self.rate_weights = np.asarray(weights, dtype=np.float64)

    def set_gamma_rates(self, alpha: float,
                        mode: int = constants.GAMMA_RATES_MEAN) -> None:
        self.set_category_rates(
            gamma_mod.compute_gamma_cats(alpha, self.cfg.rate_cats, mode))

    def set_pattern_weights(self, weights) -> None:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape[0] != self.cfg.sites:
            raise ValueError("pattern weights length mismatch")
        self.pattern_weights[:self.cfg.sites] = w

    def set_asc_state_weights(self, weights) -> None:
        """Weights of the phantom per-state sites (pll.c:1193-1224)."""
        cfg = self.cfg
        if cfg.asc_bias == constants.AB_NONE:
            raise ValueError("partition created without asc bias")
        self.pattern_weights[cfg.sites:cfg.sites + cfg.states] = \
            np.asarray(weights, dtype=np.float64)

    # --- invariant sites (models.c:495-752) --------------------------------

    def update_invariant_sites(self) -> None:
        cfg = self.cfg
        if not self.tipchars_valid.all():
            raise ValueError("all tips must be set via set_tip_states first")
        state = np.full(cfg.sites, constants.gap_state(cfg.states),
                        dtype=np.uint64)
        for t in range(cfg.tips):
            state &= self.tipchars[t, :cfg.sites]
        popcnt = np.array([bin(int(v)).count("1") for v in state])
        inv = np.where(popcnt == 1,
                       np.array([(int(v) & -int(v)).bit_length() - 1
                                 if v else 0 for v in state]),
                       -1).astype(np.int32)
        full = np.full(cfg.sites_padded, -1, dtype=np.int32)
        full[:cfg.sites] = inv
        self.invariant = full

    def count_invariant_sites(self) -> int:
        """Weighted count of invariant sites (pll_count_invariant_sites,
        models.c:546-649)."""
        if self.invariant is None:
            self.update_invariant_sites()
        inv = self.invariant[:self.cfg.sites]
        w = self.pattern_weights[:self.cfg.sites]
        return int(np.sum(np.where(inv >= 0, w, 0)))

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        if prop_invar < 0 or prop_invar >= 1:
            raise ValueError(f"invalid proportion of invariant sites "
                             f"({prop_invar})")
        if prop_invar > 0 and self.invariant is None:
            self.update_invariant_sites()
            if not np.any(self.invariant[:self.cfg.sites] >= 0):
                raise ValueError("no invariant sites found")
        self.prop_invar[params_index] = prop_invar

    # --- eigen + P-matrices ------------------------------------------------

    def update_eigen(self, params_index: int) -> None:
        dec = ratematrix.update_eigen(self.subst_params[params_index],
                                      self.frequencies[params_index])
        self.eigenvals[params_index] = dec.eigenvals
        self.eigenvecs[params_index] = dec.eigenvecs
        self.inv_eigenvecs[params_index] = dec.inv_eigenvecs
        self.eigen_decomp_valid[params_index] = True

    def _valid_eigen(self, params_indices) -> np.ndarray:
        pi = np.asarray(params_indices, dtype=np.int32)
        for p in np.unique(pi):
            if not self.eigen_decomp_valid[p]:
                self.update_eigen(p)
        return pi

    def update_prob_matrices(self, params_indices, matrix_indices,
                             branch_lengths) -> None:
        """Mirror of pll_update_prob_matrices (models.c:412-443)."""
        pi = self._valid_eigen(params_indices)
        t = self._tensor
        new = pmatrix_ops.compute_pmatrices(
            t(branch_lengths, self.cfg.dtype), t(self.eigenvals),
            t(self.eigenvecs), t(self.inv_eigenvecs), t(self.rates),
            t(self.prop_invar), t(pi), dtype=self.cfg.dtype)
        self.pmatrix[t(matrix_indices, torch.int64)] = new

    # --- partials ----------------------------------------------------------

    def update_partials(self, operations: Sequence[Operation]) -> None:
        if self.repeats is not None:
            level_ops, level_gathers = levelize_operations_repeats(
                operations, self.cfg, self.repeats)
            partials_ops.update_partials_repeats(
                self.clv, self.scalers, self.pmatrix, level_ops,
                level_gathers, self.cfg)
            return
        partials_ops.update_partials(
            self.clv, self.scalers, self.pmatrix,
            levelize_operations(operations, self.cfg), self.cfg)

    # --- likelihoods -------------------------------------------------------

    def _gather_model(self, freqs_indices):
        fi = np.asarray(freqs_indices, dtype=np.int32)
        return self._tensor(self.frequencies[fi]), \
            self._tensor(self.prop_invar[fi])

    def _invariant_arr(self):
        if self.invariant is None:
            return torch.full((self.cfg.sites_padded,), -1,
                              dtype=torch.int32, device=self.device)
        return self._tensor(self.invariant)

    def _weights(self):
        return self._tensor(self.pattern_weights, self.cfg.dtype)

    def _expand(self, row, node: int):
        """A class-indexed row of `node` expanded to site-indexed."""
        g = self.repeats.expand_gather(node, self.cfg.sites_padded)
        return row[..., self._tensor(g, torch.int64)]

    def _clv_row(self, idx):
        """CLV row, expanded to site-indexed when class-indexed (repeats)."""
        row = self.clv[idx]
        if self.repeats is not None and self.repeats.pernode_ids[idx]:
            row = self._expand(row, idx)
        return row

    def _scaler_row(self, idx, node_idx=None):
        if idx == SCALE_BUFFER_NONE:
            return self.scalers[self.cfg.scaler_zero]
        row = self.scalers[idx]
        if self.repeats is not None and self.repeats.perscale_ids[idx]:
            node = self.repeats.perscale_node[idx] \
                if node_idx is None else node_idx
            row = self._expand(row, node)
        return row

    def _persite(self, logl, persite, return_persite):
        if return_persite:
            return logl.item(), persite[:self.cfg.sites].cpu().numpy()
        return logl.item()

    def compute_root_loglikelihood(self, clv_index: int, scaler_index: int,
                                   freqs_indices, return_persite=False):
        freqs, pinv = self._gather_model(freqs_indices)
        logl, persite = likelihood_ops.root_loglikelihood(
            self._clv_row(clv_index), self._scaler_row(scaler_index), freqs,
            self._tensor(self.rate_weights), pinv, self._invariant_arr(),
            self._weights(), self.cfg, with_persite=True)
        return self._persite(logl, persite, return_persite)

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int, freqs_indices,
                                   return_persite=False):
        freqs, pinv = self._gather_model(freqs_indices)
        logl, persite = likelihood_ops.edge_loglikelihood(
            self._clv_row(parent_clv_index),
            self._scaler_row(parent_scaler_index),
            self._clv_row(child_clv_index),
            self._scaler_row(child_scaler_index),
            self.pmatrix[matrix_index], freqs,
            self._tensor(self.rate_weights), pinv, self._invariant_arr(),
            self._weights(), self.cfg, with_persite=True)
        return self._persite(logl, persite, return_persite)

    def compute_node_ancestral(self, node_clv_index: int,
                               node_scaler_index: int,
                               other_clv_index: int,
                               other_scaler_index: int,
                               matrix_index: int, freqs_indices) -> np.ndarray:
        """Marginal ancestral state probabilities, [sites, states]
        (pll_compute_node_ancestral, likelihood.c:639-823)."""
        freqs, _ = self._gather_model(freqs_indices)
        anc = likelihood_ops.node_ancestral(
            self._clv_row(node_clv_index),
            self._scaler_row(node_scaler_index),
            self._clv_row(other_clv_index),
            self._scaler_row(other_scaler_index),
            self.pmatrix[matrix_index], freqs,
            self._tensor(self.rate_weights), self.cfg)
        return anc[:self.cfg.sites].cpu().numpy()

    # --- derivatives -------------------------------------------------------

    def update_sumtable(self, parent_clv_index: int, child_clv_index: int,
                        parent_scaler_index: int, child_scaler_index: int,
                        params_indices):
        """The edge's sumtable [R, S, T] (pll_update_sumtable)."""
        pi = self._valid_eigen(params_indices)
        cfg = self.cfg
        sp = sc = asc_scalers = None
        if cfg.per_rate_scalers:
            sp = self._scaler_row(parent_scaler_index)
            sc = self._scaler_row(child_scaler_index)
        elif cfg.asc_bias in (constants.AB_LEWIS, constants.AB_FELSENSTEIN):
            asc_scalers = (self._scaler_row(parent_scaler_index)
                           + self._scaler_row(child_scaler_index))
        return derivatives_ops.update_sumtable(
            self._clv_row(parent_clv_index), self._clv_row(child_clv_index),
            sp, sc, self._tensor(self.eigenvecs[pi]),
            self._tensor(self.inv_eigenvecs[pi]),
            self._tensor(self.frequencies[pi]), cfg,
            asc_scalers=asc_scalers)

    def compute_likelihood_derivatives(self, sumtable, branch_length: float,
                                       params_indices):
        pi = np.asarray(params_indices, dtype=np.int32)
        t = self._tensor
        d1, d2 = derivatives_ops.likelihood_derivatives(
            sumtable, t(branch_length, self.cfg.dtype), t(self.rates),
            t(self.eigenvals[pi]), t(self.prop_invar[pi]),
            t(self.rate_weights), t(self.frequencies[pi]),
            self._invariant_arr(), self._weights(), self.cfg)
        return d1.item(), d2.item()

    # --- debug accessors ---------------------------------------------------

    def get_clv(self, index: int) -> np.ndarray:
        """CLV as [sites_alloc, rate_cats, states] (reference layout); a
        class-indexed row is returned as stored."""
        row = self.clv[index, :, :, :self.cfg.sites_alloc]
        return row.permute(2, 0, 1).cpu().numpy()

    def get_pmatrix(self, index: int) -> np.ndarray:
        return self.pmatrix[index].cpu().numpy()

    def get_scaler(self, index: int) -> np.ndarray:
        return self.scalers[index, ..., :self.cfg.sites_alloc].cpu().numpy()

    # --- site-repeats queries (repeats.c:63-98) ----------------------------

    def repeats_enabled(self) -> bool:
        return self.repeats is not None

    def get_sites_number(self, clv_index: int) -> int:
        """pll_get_sites_number: class count (or sites) + phantom sites."""
        if self.repeats is not None:
            return self.repeats.sites_number(clv_index)
        return self.cfg.sites_alloc

    def get_clv_size(self, clv_index: int) -> int:
        return self.get_sites_number(clv_index) * self.cfg.span

    def get_site_id(self, clv_index: int):
        """site -> class id map, or None when the node is dense."""
        if self.repeats is None:
            return None
        return self.repeats.site_id(clv_index)

    def get_id_site(self, clv_index: int):
        """class id -> representative site map, or None when dense."""
        if self.repeats is None:
            return None
        return self.repeats.id_site(clv_index)
