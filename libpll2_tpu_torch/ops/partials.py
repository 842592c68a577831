"""Conditional-likelihood-vector (CLV) updates, level-batched (plain PyTorch).

Counterpart of libpll2_tpu/ops/partials.py (`_level_update`,
`update_partials`).  It is the engine's dense path: the path for CPU
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


def _level_update(clv, scalers, pmatrix, ops, cfg: PartitionConfig):
    """Execute one level: a batch of W independent CLV updates, in place.

    clv:      [N+1, R, S, T]
    scalers:  [Z+2, T] int32  (per-rate: [Z+2, R, T])
    pmatrix:  [P, R, S, S]
    ops:      [W, 8] int64
    """
    c1 = clv[ops[:, OP_CHILD1_CLV]]          # [W, R, S, T]
    c2 = clv[ops[:, OP_CHILD2_CLV]]
    p1 = pmatrix[ops[:, OP_CHILD1_MAT]]      # [W, R, S, S]
    p2 = pmatrix[ops[:, OP_CHILD2_MAT]]

    left = torch.einsum("wrij,wrjt->writ", p1, c1)
    right = torch.einsum("wrij,wrjt->writ", p2, c2)
    parent = left * right                     # [W, R, S, T]
    del c1, c2, left, right

    s1 = scalers[ops[:, OP_CHILD1_SCALER]]
    s2 = scalers[ops[:, OP_CHILD2_SCALER]]
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
    snew = s1 + s2 + mask.to(torch.int32)

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
