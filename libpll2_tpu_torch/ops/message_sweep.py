"""The all-directions message sweep on the card: one CUDA kernel launch
(csrc/message_sweep.cu) walks every directed message of a level-ordered op
table for a block of sites per CTA, into the dense clv and scaler tensors
of ops/partials.py.

`sweep_messages` is the wrapper, which launches the kernel on CUDA tensors
and raises on anything else; `sweep_messages_reference` is its plain
version.  The op table is runtime data: the [L, W, 8] int64 level program
on the device (engine.FullTreeProgram caches its own per device; the
search passes its runtime topology, search_fast._sweep_rt), whose padding
rows (parent = cfg.clv_scratch) the kernel skips.

What the sweep writes: every message row (the parent of an op) and its
scaler row, the tip rows decoded from the packed masks (the consumers read
them by index), and zeros in the clv scratch row and in the scalers' zero
and scratch rows; at the same values as ops/partials.update_partials over
the same program on rows initialised as engine.message_sweep's dense path
does, except that padding rows write nothing.  The kernel computes in f32
with the dense path's rescue rule; its sums run in another order than the
dense path's batched products, so rows agree to f32 rounding.

Cases the kernel takes (`unsupported` names the others): f32, 2 to 32
states, 1 to 32 rates, per-site or per-rate scalers.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..config import PartitionConfig
from . import partials
from .partials import (OP_CHILD1_CLV, OP_CHILD1_MAT, OP_CHILD2_CLV,
                       OP_CHILD2_MAT, OP_COLS, OP_PARENT_CLV)

MIN_STATES, MAX_STATES, MAX_RATES = 2, 32, 32
# Threads a CTA may have by state count: copies of csrc/message_sweep.cu's
# THREADS_SMALL, THREADS_20 and THREADS_LARGE (a CPU test holds them
# equal).
THREADS_SMALL, THREADS_20, THREADS_LARGE = 1024, 512, 256
# Copies of a site block's threads a CTA holds, each taking every
# MAX_GROUPS-th op of a level.
MAX_GROUPS = 8
# The SM count `plan` fills when it is given none (an H100 SXM's).
SM_COUNT = 132


def unsupported(cfg: PartitionConfig) -> Optional[str]:
    """Why the kernel cannot take `cfg`'s case, or None."""
    if cfg.dtype != torch.float32:
        return f"the message-sweep kernel computes f32, not {cfg.dtype}"
    if not MIN_STATES <= cfg.states <= MAX_STATES:
        return (f"{cfg.states} states, outside the kernel's "
                f"{MIN_STATES}-{MAX_STATES}")
    if cfg.rate_cats > MAX_RATES:
        return (f"{cfg.rate_cats} rate categories, above the kernel's "
                f"{MAX_RATES}")
    return None


def rate_lanes(rate_cats: int) -> int:
    """Threads a site has: one per rate category, rounded up to a power of
    two (the padding lanes repeat the last rate and write nothing)."""
    return 1 << max(rate_cats - 1, 0).bit_length()


def max_threads(states: int) -> int:
    """Threads a CTA may have at this state count (the instantiation's
    launch bound)."""
    if states <= 8:
        return THREADS_SMALL
    return THREADS_20 if states == 20 else THREADS_LARGE


def plan(rate_cats: int, states: int, sites: int,
         sm_count: int = SM_COUNT) -> tuple:
    """(site block, groups) of a launch: the block starts at a warp of
    whole sites and doubles while the blocks still number at least the SM
    count and the CTA's threads allow; then as many groups as the threads
    allow, at most MAX_GROUPS."""
    lanes = rate_lanes(rate_cats)
    cap = max_threads(states)
    tb = max(1, 32 // lanes)
    while 2 * tb * lanes <= cap and -(-sites // (2 * tb)) >= sm_count:
        tb *= 2
    return tb, max(1, min(MAX_GROUPS, cap // (tb * lanes)))


def _outputs(cfg: PartitionConfig, sites: int, device, make):
    """(clv [num_clvs + 1, R, S, T], scalers [scale_buffers + 2, T] or
    [..., R, T]) made by `make` (torch.zeros or torch.empty)."""
    R, S = cfg.rate_cats, cfg.states
    clv = make((cfg.num_clvs + 1, R, S, sites), dtype=cfg.dtype,
               device=device)
    shape = ((cfg.scale_buffers + 2, R, sites) if cfg.per_rate_scalers
             else (cfg.scale_buffers + 2, sites))
    return clv, make(shape, dtype=torch.int32, device=device)


def sweep_messages_reference(level_ops, pmatrix, tipchars,
                             cfg: PartitionConfig):
    """Plain PyTorch version of the kernel (sweep_messages' inputs and
    outputs, on any device and at any dtype): its walk, level by level
    over the real rows, each level one batched update (ops/partials.py).
    Rows that no op writes and no tip fills are zeros here."""
    device = tipchars.device
    clv, scalers = _outputs(cfg, tipchars.shape[-1], device, torch.zeros)
    from ..engine import expand_tipchars
    clv[:cfg.tips] = expand_tipchars(tipchars, cfg.states, cfg.dtype)[:, None]
    for ops in torch.as_tensor(level_ops).long():
        ops = ops[ops[:, OP_PARENT_CLV] != cfg.clv_scratch]
        if len(ops):
            partials._level_update(clv, scalers, pmatrix, ops.to(device),
                                   cfg)
    return clv, scalers


def _check(level_ops, pmatrix, tipchars, cfg: PartitionConfig):
    reason = unsupported(cfg)
    if reason is not None:
        raise ValueError(f"the message-sweep kernel cannot take this case: "
                         f"{reason}")
    tensors = (level_ops, pmatrix, tipchars)
    device = tipchars.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("message sweep inputs must all lie on one CUDA "
                         "device, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("message sweep inputs must be contiguous")
    R, S = cfg.rate_cats, cfg.states
    if pmatrix.dtype != torch.float32 or pmatrix.dim() != 4 or \
            tuple(pmatrix.shape[1:]) != (R, S, S):
        raise ValueError(f"pmatrix must be f32 [P, {R}, {S}, {S}], got "
                         f"{pmatrix.dtype} {tuple(pmatrix.shape)}")
    if tipchars.dtype != torch.int32 or tipchars.dim() != 2 or \
            tipchars.shape[0] != cfg.tips:
        raise ValueError(f"tipchars must be int32 [{cfg.tips}, T], got "
                         f"{tipchars.dtype} {tuple(tipchars.shape)}")
    if level_ops.dtype != torch.int64 or level_ops.dim() != 3 or \
            level_ops.shape[-1] != OP_COLS:
        raise ValueError(f"the op table must be int64 [L, W, {OP_COLS}], "
                         f"got {level_ops.dtype} {tuple(level_ops.shape)}")
    if level_ops.numel() == 0:
        raise ValueError("the op table holds no level")
    if level_ops.data_ptr() % 16 or pmatrix.data_ptr() % 16:
        raise ValueError("the op table and pmatrix must be 16-byte aligned")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sweep_messages(level_ops, pmatrix, tipchars, cfg: PartitionConfig):
    """Sweep every message of the table in one kernel launch; raises on
    inputs the kernel does not take (CPU tensors among them).

    level_ops:   [L, W, 8] int64, padding rows (parent = cfg.clv_scratch)
                 skipped
    pmatrix:     [P, R, S, S] f32
    tipchars:    [tips, T] int32 packed state masks
    cfg:         the message program's (extended) config; f32
    The launch's site block and groups are `plan`'s.  Returns (clv
    [num_clvs + 1, R, S, T] f32, scalers [scale_buffers + 2, T] int32, or
    [..., R, T] with per-rate scalers)."""
    _check(level_ops, pmatrix, tipchars, cfg)
    from .. import _build

    device = tipchars.device
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    T = tipchars.shape[-1]
    tb, groups = plan(cfg.rate_cats, cfg.states, T, _sm_count(index))
    clv, scalers = _outputs(cfg, T, device, torch.empty)
    err = _build.library().message_sweep_launch(
        level_ops.data_ptr(), level_ops.shape[0], level_ops.shape[1],
        pmatrix.data_ptr(), tipchars.data_ptr(), cfg.tips, clv.data_ptr(),
        scalers.data_ptr(), T, tb, groups, cfg.rate_cats, cfg.states,
        cfg.clv_scratch, cfg.scaler_zero, cfg.scaler_scratch,
        int(cfg.per_rate_scalers), ctypes.c_float(cfg.scale_threshold),
        ctypes.c_float(cfg.scale_factor), index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"message_sweep kernel launch failed (site block "
                           f"{tb}, {groups} groups): CUDA error {err} "
                           f"({_build.error_string(err)})")
    sweep_messages.launches += 1
    return clv, scalers


# kernel launches by this wrapper (plain runs excluded)
sweep_messages.launches = 0


def sweep_bytes(level_ops, cfg: PartitionConfig, sites: int) -> tuple:
    """(least, traffic): the device-memory bytes of a sweep of the
    [L, W, 8] program.  least: what the sweep must move, each input read
    once and each output written once: the tip masks and the P-matrices
    the ops name read; the tip rows, every op's parent row and scaler row,
    the clv scratch row and the two reserved scaler rows written.
    traffic: least plus each op's reads of its children (a message
    child's row, a tip child's mask), which a walk that keeps no child on
    the chip moves again for every op that reads it."""
    ops = np.asarray(level_ops).reshape(-1, OP_COLS)
    ops = ops[ops[:, OP_PARENT_CLV] != cfg.clv_scratch]
    R, S = cfg.rate_cats, cfg.states
    row = R * S * sites * 4
    mask = sites * 4
    scaler = (R if cfg.per_rate_scalers else 1) * sites * 4
    children = ops[:, [OP_CHILD1_CLV, OP_CHILD2_CLV]]
    tip_children = int((children < cfg.tips).sum())
    msg_children = children.size - tip_children
    pmatrices = len(np.unique(ops[:, [OP_CHILD1_MAT, OP_CHILD2_MAT]]))
    least = (cfg.tips * (mask + row) + pmatrices * R * S * S * 4
             + len(ops) * (row + scaler) + row + 2 * scaler)
    return least, least + msg_children * row + tip_children * mask
