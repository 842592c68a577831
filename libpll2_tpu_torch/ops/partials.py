"""Conditional-likelihood-vector (CLV) updates, level-batched (plain PyTorch).

Counterpart of libpll2_tpu/ops/partials.py (`_level_update`,
`update_partials`, and the site-repeats update `_level_update_gather`,
`update_partials_repeats`).  It is the engine's dense path: the path for CPU
tensors and for `use_kernel=False`, as XLA is for the JAX package on the
CPU.  Reference semantics: pll_core_update_partial_ii and the scaling
protocol (libpll-2 src/core_partials.c:612-765, src/pll.h:96-104):

  parent[site, r, i] = (sum_j PL[r,i,j] * left[site,r,j])
                     * (sum_j PR[r,i,j] * right[site,r,j])

with counter-based underflow rescue: if every entry of a site's (per-rate
mode: a (site, rate)'s) new CLV is below scale_threshold, multiply by
scale_factor and increment the integer scaler; parent scaler = left scaler
+ right scaler + this increment.

CLVs live in one dense tensor [num_clvs+1, R, S, T]; row num_clvs is
write-scratch for padded (no-op) lanes, scaler rows scale_buffers /
scale_buffers+1 are read-zeros / write-scratch (config.py).  Unlike the
JAX version, the update writes into `clv` and `scalers` in place.
"""
from __future__ import annotations

import torch

from ..config import PartitionConfig

# Column layout of an operation row (partition.levelize_operations):
OP_PARENT_CLV = 0
OP_CHILD1_CLV = 1
OP_CHILD2_CLV = 2
OP_CHILD1_MAT = 3
OP_CHILD2_MAT = 4
OP_PARENT_SCALER = 5
OP_CHILD1_SCALER = 6
OP_CHILD2_SCALER = 7
OP_COLS = 8


def _parent(c1, c2, p1, p2, s1, s2, cfg: PartitionConfig):
    """Parent CLVs and scalers of a batch of W updates from the children's
    (site-aligned) CLVs c1, c2 [W, R, S, T], P-matrices p1, p2
    [W, R, S, S] and scalers s1, s2 [W, T] / [W, R, T].

    bf16 is a storage format: the products accumulate in f32 and the
    stored parent is rounded once per level, as in the JAX package."""
    dtype = c1.dtype
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    left = torch.einsum("wrij,wrjt->writ", p1.to(acc), c1.to(acc))
    right = torch.einsum("wrij,wrjt->writ", p2.to(acc), c2.to(acc))
    parent = (left * right).to(dtype)         # [W, R, S, T]
    del left, right

    below = parent < cfg.scale_threshold
    if cfg.per_rate_scalers:
        # per-(site, rate): all states below threshold -> rescue
        mask = below.all(dim=2)                               # [W, R, T]
        parent = torch.where(mask[:, :, None, :],
                             parent * cfg.scale_factor, parent)
    else:
        # per-site: all (rate, state) entries below threshold -> rescue
        mask = below.all(dim=2).all(dim=1)                    # [W, T]
        parent = torch.where(mask[:, None, None, :],
                             parent * cfg.scale_factor, parent)
    return parent, s1 + s2 + mask.to(torch.int32)


def _level_update(clv, scalers, pmatrix, ops, cfg: PartitionConfig):
    """Execute one level: a batch of W independent CLV updates, in place.

    clv:      [N+1, R, S, T]
    scalers:  [Z+2, T] int32  (per-rate: [Z+2, R, T])
    pmatrix:  [P, R, S, S]
    ops:      [W, 8] int64
    """
    parent, snew = _parent(
        clv[ops[:, OP_CHILD1_CLV]], clv[ops[:, OP_CHILD2_CLV]],
        pmatrix[ops[:, OP_CHILD1_MAT]], pmatrix[ops[:, OP_CHILD2_MAT]],
        scalers[ops[:, OP_CHILD1_SCALER]], scalers[ops[:, OP_CHILD2_SCALER]],
        cfg)
    clv[ops[:, OP_PARENT_CLV]] = parent
    scalers[ops[:, OP_PARENT_SCALER]] = snew
    return clv, scalers


def update_partials(clv, scalers, pmatrix, level_ops, cfg: PartitionConfig):
    """Run a level-batched operations program in place.

    level_ops: [L, W, 8] int — L levels of up to W ops each, padded with
    no-op rows that read/write the scratch rows.  Returns (clv, scalers).
    """
    level_ops = torch.as_tensor(level_ops, device=clv.device).long()
    for ops in level_ops:
        clv, scalers = _level_update(clv, scalers, pmatrix, ops, cfg)
    return clv, scalers


def _level_update_gather(clv, scalers, pmatrix, ops, gathers,
                         cfg: PartitionConfig):
    """One level of CLV updates with per-op site-axis gathers, in place:
    the site-repeats update (repeats.c semantics; see repeats.py).

    gathers: [W, 2, T] int64 — the child1/child2 slot feeding each parent
    slot.  Identity rows make this the dense update; class-indexed
    children are dereferenced by the gather, and the parent row is
    written class-indexed (slots beyond its class count hold unread
    values)."""
    g1, g2 = gathers[:, 0], gathers[:, 1]                     # [W, T]
    c1 = torch.take_along_dim(clv[ops[:, OP_CHILD1_CLV]],
                              g1[:, None, None, :], dim=3)
    c2 = torch.take_along_dim(clv[ops[:, OP_CHILD2_CLV]],
                              g2[:, None, None, :], dim=3)
    s1 = scalers[ops[:, OP_CHILD1_SCALER]]
    s2 = scalers[ops[:, OP_CHILD2_SCALER]]
    if cfg.per_rate_scalers:
        s1 = torch.take_along_dim(s1, g1[:, None, :], dim=2)
        s2 = torch.take_along_dim(s2, g2[:, None, :], dim=2)
    else:
        s1 = torch.take_along_dim(s1, g1, dim=1)
        s2 = torch.take_along_dim(s2, g2, dim=1)
    parent, snew = _parent(c1, c2, pmatrix[ops[:, OP_CHILD1_MAT]],
                           pmatrix[ops[:, OP_CHILD2_MAT]], s1, s2, cfg)
    del c1, c2
    clv[ops[:, OP_PARENT_CLV]] = parent
    scalers[ops[:, OP_PARENT_SCALER]] = snew
    return clv, scalers


def update_partials_repeats(clv, scalers, pmatrix, level_ops, level_gathers,
                            cfg: PartitionConfig):
    """Level-batched operations program with site-repeats gathers, in
    place.  level_ops: [L, W, 8]; level_gathers: [L, W, 2, T], both on the
    host (partition.levelize_operations_repeats).  Only the gathers of
    real operations are copied to the device, a level at a time; padding
    rows (parent = the scratch row) gather the identity."""
    device = clv.device
    level_ops = torch.as_tensor(level_ops).long()
    ident = torch.arange(clv.shape[-1], device=device)
    for level, ops in enumerate(level_ops):
        real = torch.nonzero(ops[:, OP_PARENT_CLV] != cfg.clv_scratch)[:, 0]
        gathers = ident.repeat(ops.shape[0], 2, 1)
        gathers[real.to(device)] = torch.as_tensor(
            level_gathers[level])[real].to(device).long()
        clv, scalers = _level_update_gather(clv, scalers, pmatrix,
                                            ops.to(device), gathers, cfg)
    return clv, scalers


def update_partials_unrolled(clv, scalers, pmatrix, levels, cfg):
    """update_partials over a list of level tensors of different widths
    ([W_l, 8] each), so no level runs padded no-op rows (caterpillar
    trees)."""
    for ops in levels:
        ops = torch.as_tensor(ops, device=clv.device).long()
        clv, scalers = _level_update(clv, scalers, pmatrix, ops, cfg)
    return clv, scalers
