"""Operations and their level-batched encoding.

Only the part of libpll2_tpu/partition.py that the forward slice needs:
`Operation` (pll_operation_t, pll.h:325-335), `levelize_operations` and
`_encode_op`.  The mutable `Partition` API is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import constants
from .config import PartitionConfig
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


def levelize_operations(ops: Sequence[Operation], cfg: PartitionConfig
                        ) -> np.ndarray:
    """Group a post-order operation list into levels of independent updates.

    An op runs one level after the later of its children; ops whose
    children are all tips run first.  The result is a dense [L, W, 8] int32
    array, padded with no-op rows that target the scratch CLV/scaler rows
    (config.py row conventions).  The reference executes ops strictly
    serially (partials.c:245-291); here each level is one batched update.
    """
    level_of: dict[int, int] = {}
    levels: list[list[Operation]] = []
    for op in ops:
        l1 = level_of.get(op.child1_clv_index, 0)
        l2 = level_of.get(op.child2_clv_index, 0)
        lvl = max(l1, l2)
        level_of[op.parent_clv_index] = lvl + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(op)

    if not levels:
        return np.zeros((0, 1, OP_COLS), dtype=np.int32)

    width = max(len(l) for l in levels)
    out = np.empty((len(levels), width, OP_COLS), dtype=np.int32)
    noop = np.array([cfg.clv_scratch, cfg.clv_scratch, cfg.clv_scratch,
                     0, 0, cfg.scaler_scratch, cfg.scaler_zero,
                     cfg.scaler_zero], dtype=np.int32)
    out[:] = noop
    for li, lops in enumerate(levels):
        for wi, op in enumerate(lops):
            out[li, wi] = _encode_op(op, cfg)
    return out


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
