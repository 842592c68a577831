"""Shared-memory tree sweep: the CLV path of the forward step on the card.

Counterpart of libpll2_tpu/ops/partials_pallas_tree.py.  The Felsenstein
recursion over one site block is a tree-shaped expression whose live set,
under Sethi–Ullman evaluation order, is O(depth) CLV slabs.  `schedule()`
assigns every inner CLV a slot of a small pool (ported line for line, so
the op table, pool size and export maps are byte-equal to the JAX
package's), and the CUDA kernel (csrc/tree_sweep.cu) runs the whole op
list for one site block with the pool in shared memory: tips enter as
packed state bitmasks and only the exported rows (the root edge's CLVs and
scalers) reach device memory.

The schedule `[OPS, 9] int32` is runtime data for the kernels, so one
compiled kernel serves every topology and op count.  The kernels read it as
`mma_device_table` [OPS, 12] and `fma_device_table` [OPS, 8]: the children
ordered tip before pool slot before handed on, the op's case by the kinds
of its children, and the columns of `carry_flags`.  Under the Sethi–Ullman
order most ops consume the parent the op before them wrote; `carry_flags`
marks those, and the kernels hand such a parent on in registers instead of
through its pool slot (same values, so the rows are bit-equal with the
carry on or off).  Three forms of the kernel exist, picked by
`sweep(..., mode=)`:

  * "fma" (csrc/tree_sweep.cu): a thread per rate category of two sites
    (one above 4 states), the propagation as f32 FMAs, each warp's operands
    staged a few ops ahead in shared memory.  It replaces the JAX package's
    static kernels (the unrolled `_tree_kernel_static`, <= 512 ops, and the
    segmented `_tree_kernel_static_seg`, 513-4096 ops, whose segments exist
    only to bound Mosaic's compile time) and is the counterpart of the
    runtime-ops kernel's "vpu" mode (`_tree_kernel` with broadcast FMAs).
    The state counts of FMA_STATES have instantiations of their own; every
    other count from 2 to 32 (odd counts, Dayhoff-6, multistate
    morphology) runs its generic instantiation
    (csrc/tree_sweep_generic.cu), which takes the state count at run time:
    a column's rows split over `generic_groups` threads, each child entry
    read once an op, the P-matrices staged in shared memory;
  * "mma" (csrc/tree_sweep_mma.cu): the propagation as one product with the
    rate-block-diagonal P on the tensor cores, TF32 with a compensated
    split of both operands (bf16 operands at a bf16 pool).  It is the
    counterpart of the runtime-ops kernels' "mxu" and "splitk" modes
    (`_tree_kernel`, `_tree_kernel_splitk`);
  * "wide" (csrc/tree_sweep_wide.cu): 33 to 64 states (codon models), the
    tip masks int64, f32; a thread forms a 4 x 4 tile of rows and sites of
    one rate over half the contraction, an inner child's P-matrix staged a
    rate at a time and a tip child's columns read from device memory, the
    exported parents written straight to device memory.  The JAX package,
    whose masks are int32, has no counterpart.

The forms take the site block that fills the card (`pick_site_block` with
the SM count).  `choose()` picks the form by the times measured on an H100
(see its docstring), not by the JAX package's op-count limits.

`sweep()` is the kernel wrapper; `sweep_reference()` is the plain PyTorch
version of every form, with the same signature and output.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .. import spans
from ..config import PartitionConfig
from ..constants import (INT32_MASK_STATES, MAX_MASK_STATES,
                         tip_mask_torch_dtype)

OP_COLS = 9
# columns: 0 parent_slot, 1 c1_tip_idx, 2 c1_slot, 3 c1_is_tip,
#          4 c2_tip_idx, 5 c2_slot, 6 c2_is_tip, 7 pmatrix1, 8 pmatrix2

# Site-block sizes the kernels take (one CTA per block); the generic "fma"
# instantiation, whose pools grow with any state count up to 32, also takes
# the smaller GENERIC_SITE_BLOCKS where no larger block fits.
SITE_BLOCKS = (256, 128, 64, 32)
GENERIC_SITE_BLOCKS = SITE_BLOCKS + (16, 8)
# Dynamic shared memory one block may opt in to on an H100 (sm_90):
# 227 KB = 232,448 bytes.  The wrapper also checks the device's own limit.
SMEM_LIMIT = 232448
# State counts the "fma" form takes: 2 to 32, the bits of an int32 tip
# mask (libpll-2's any-state partitions), at up to FMA_MAX_RATES rate
# categories, with per-site or per-rate scalers.  FMA_STATES (bin, nt, gt10,
# gt16, aa) have instantiations of their own, with the state count a
# compile-time constant; every other count runs the generic instantiation,
# which takes the state count at run time (`generic`; csrc/tree_sweep.cu
# instantiates it for at most 8, 16 and 32 states).  A site has
# `rate_lanes(R)` lanes, one per rate, R rounded up to a power of two; a
# thread holds one lane of `sites_a_thread` sites.
# For the rate counts in FMA_RATE_LANES R is a compile-time constant of the
# specialised instantiations and a CTA has at most FMA_THREADS threads;
# other counts, and the generic instantiation, at most FMA_THREADS_ANY.
# The generic instantiation's row-group form (`generic_groups`) gives a
# thread at most GENERIC_ROWS of a column's rows, and stages an op's two
# P-matrices in shared memory where two buffers of both take at most
# GENERIC_STAGE_BYTES (`generic_staged`): the names GROUP_ROWS and
# GENERIC_STAGE_BYTES of csrc/tree_sweep_generic.cu, which a test holds
# equal.
GENERIC_ROWS = 8
GENERIC_STAGE_BYTES = 73728
# Up to GENERIC_SITES_STATES states a thread of the row-group form holds
# GENERIC_SITES_A_THREAD sites (one P load feeds that many times the FMAs)
# and a CTA at most GENERIC_SITES_THREADS threads: the .cu's GROUP_SITES,
# GROUP_SITES_THREADS and sites_of<SMAX>, SMAX 8.
GENERIC_SITES_A_THREAD, GENERIC_SITES_STATES = 2, 8
GENERIC_SITES_THREADS = 256
MIN_STATES, MAX_STATES = 2, 32
# The wide form (csrc/tree_sweep_wide.cu) takes the state counts above
# MAX_STATES that an int64 tip mask holds (codon models: 61 states), f32,
# 1 to FMA_MAX_RATES rates, per-site or per-rate scalers, in site blocks of
# WIDE_SITE_BLOCKS.  A CTA has WIDE_THREADS_A_SITE threads a site of its
# block: two halves of the contraction (states 0-31, 32-63) by 16 groups of
# four rows by the block's groups of four sites.  It stages an inner
# child's P-matrix of one rate at a time, transposed and its rows padded to
# WIDE_P_ROWS, in two buffers, in the order of `wide_items` (a tip child's
# columns are read from device memory); its pool holds only the parents
# that are not exported (`wide_device_table`), and an exported parent goes
# straight to its row in device memory (`wide_smem_bytes`).  WIDE_P_ROWS
# and WIDE_THREADS_A_SITE are the .cu's WIDE_SMAX and THREADS_A_SITE,
# which a test holds equal.
WIDE = "wide"
WIDE_MIN_STATES, WIDE_MAX_STATES = INT32_MASK_STATES + 1, MAX_MASK_STATES
WIDE_SITE_BLOCKS = (32, 16, 8)
WIDE_P_ROWS = 64
WIDE_THREADS_A_SITE = 8
WIDE_TABLE_COLS = 8
FMA_STATES = (2, 4, 10, 16, 20)
FMA_MAX_RATES = 32
FMA_RATE_LANES = (1, 4)
FMA_THREADS, FMA_THREADS_ANY = 256, 1024
# Up to FMA_SITES_STATES states an "fma" thread holds FMA_SITES_A_THREAD
# sites of its rate (one above).  Each warp stages its operands in a ring of
# shared memory, FMA_AHEAD ops ahead: rows, tip masks and, up to
# FMA_STAGE_P_MAX_STATES states at the compile-time rate counts, the P rows.
# The names of csrc/tree_sweep.cu (SITES_A_THREAD, AHEAD,
# STAGE_P_MAX_STATES; `ring_words`), which a test holds equal.
FMA_SITES_A_THREAD, FMA_SITES_STATES = 2, 4
FMA_AHEAD = 2
FMA_STAGE_P_MAX_STATES = 4
# (states, rate_cats) the "mma" form is instantiated for: its span must fill
# whole 16-row tensor-core tiles, and it keeps per-site scalers only.
MMA_CASES = ((4, 4), (20, 4))
MODES = ("fma", "mma")
# every form sweep() takes: the two forms up to MAX_STATES and the wide one
SWEEP_MODES = MODES + (WIDE,)
# The pool types both forms take: cfg.dtype, the storage of the CLV pool.
DTYPES = (torch.float32, torch.bfloat16)
# Columns of the "mma" kernel's device table (`mma_device_table`): the nine
# above, the op's case by the kinds of its children, whether the parent is
# stored to its slot, whether it is handed on to the next op in registers.
# Twelve int32: three 16-byte loads per op.  The "fma" kernel reads the same
# in eight (`fma_device_table`): two 16-byte halves, what the copies ahead
# of an op need and what the op needs.
MMA_OP_COLS = 12
FMA_TABLE_COLS = 8
# (states, rate_cats) that run on the "mma" form's small-span kernel, which
# honours the hand-on columns; at span 80 the general kernel never hands a
# parent on and always stores (its registers are full).
MMA_CARRY_CASES = ((4, 4),)
# With the SM count known, the "mma" form takes the largest site block that
# still gives a CTA to this share of the SMs (site counts are powers of two,
# SM counts are not: 8,192 sites in 64-site blocks are 128 CTAs for 132 SMs),
# and on the small-span kernel no block above MMA_SMALL_BLOCK sites: its
# warps share nothing, and small blocks pack more of them into an SM's
# shared memory (on an H100 at 700 W, probes/variants.py blocks: 256 taxa x
# 65,536 sites 0.56 ms in 256-site blocks, 0.59 in 128, 0.50 in 64, 0.51
# in 32; 1,024 x 16,384: 1.13, 0.98, 0.86, 0.88; 8,192 x 8,192: 7.8, 6.0,
# 6.0, 6.0 ms).
SM_FILL = 15 / 16
MMA_SMALL_BLOCK = 64
# From this many sites on, at the (states, rate_cats) of the small-span
# "mma" kernel, `choose` takes "mma": there the sites fill the card several
# times over and the tensor cores' shorter stream of instructions wins;
# with fewer sites an SM holds one or two CTAs and the "fma" form, whose op
# waits less, wins (times in `choose`).
MMA_MIN_SITES = 65536
# At bf16, (states, rate_cats) where `choose` takes "mma" at any site count:
# the general kernel's bf16 products (13 k16 tile pairs, one product each)
# replace 22 pairs of three TF32 products, and it won from 2,048 to 16,384
# sites (times in `choose`).
MMA_BF16_CASES = ((20, 4),)


@dataclasses.dataclass(frozen=True, eq=False)
class TreeVmemProgram:
    """Host-compiled slot-allocated schedule of one tree traversal
    (the JAX package's name, kept so the counterpart is easy to find)."""
    ops: np.ndarray                    # [OPS, 9] int32
    pool_size: int
    exports: tuple                     # ((op_index, slot), ...) row-ordered
    export_clv_map: dict               # clv_index -> export row
    export_scaler_map: dict            # scaler_index -> export row
    # device copies of the op table and export slots, made on first use
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_ops(self) -> int:
        return self.ops.shape[0]

    def device_tables(self, device: torch.device, mode: str = "fma",
                      carry: bool = True):
        """(op table int32, export slots [E] int32, export rows [OPS]
        int32) on `device`: for "fma" `fma_device_table` [OPS, 8], for
        "mma" `mma_device_table` [OPS, 12]; with carry=False nothing is
        handed on and every parent is stored.  The f32 kernels copy the
        export slots out after the sweep; the bf16 ones write the f32
        parent of each op that `export_rows` marks as it is made."""
        key = (str(device), mode, carry)
        if key not in self._device:
            table = fma_device_table(self, carry) if mode == "fma" \
                else wide_device_table(self)[0] if mode == WIDE \
                else mma_device_table(self, carry)
            slots = np.asarray([s for _, s in self.exports], np.int32)
            self._device[key] = tuple(
                torch.as_tensor(a, device=device).contiguous()
                for a in (table, slots, export_rows(self)))
        return self._device[key]


def export_rows(prog: TreeVmemProgram) -> np.ndarray:
    """[OPS] int32: the export row each op's parent goes to, -1 for an op
    that exports nothing (an exported parent is made by one op)."""
    rows = np.full(prog.n_ops, -1, dtype=np.int32)
    for e, (op_index, _slot) in enumerate(prog.exports):
        rows[op_index] = e
    return rows


def carry_flags(prog: TreeVmemProgram, enabled: bool = True) -> np.ndarray:
    """[OPS, 3] int32, per op of the schedule: which child is the parent the
    previous op handed on in registers (0 none, 1, 2), whether this op's
    parent is stored to its pool slot, whether it is handed on to the next
    op instead.

    A parent is handed on when the next op reads it as an inner child,
    nothing else reads it before its slot is written again, and it is not
    exported; then its store is dropped.  Every other parent is stored and
    loaded as before: a parent is never both.  enabled=False: nothing
    handed on, everything stored."""
    n = prog.n_ops
    flags = np.zeros((n, 3), dtype=np.int32)
    flags[:, 1] = 1
    if not enabled:
        return flags
    rows = prog.ops.tolist()
    reads = [0] * n               # reads of the value op w wrote
    writer: dict[int, int] = {}   # slot -> the op that wrote it last
    for w, (p_slot, _t1, s1, f1, _t2, s2, f2, _pm1, _pm2) in enumerate(rows):
        for slot, is_tip in ((s1, f1), (s2, f2)):
            if not is_tip and slot in writer:
                reads[writer[slot]] += 1
        writer[p_slot] = w
    exported = {op_index for op_index, _slot in prog.exports}
    for w in range(1, n):
        _p, _t1, s1, f1, _t2, s2, f2, _pm1, _pm2 = rows[w]
        prev = rows[w - 1][0]
        took = 1 if (not f1 and s1 == prev) else \
            2 if (not f2 and s2 == prev) else 0
        if took and reads[w - 1] == 1 and w - 1 not in exported:
            flags[w, 0] = took
            flags[w - 1, 1:] = (0, 1)
    return flags


# The kernels' cases by the kinds of an op's two children, the first kind
# never after the second: (tip, tip), (tip, pool), (tip, carried),
# (pool, pool), (pool, carried).
KINDS = {("tip", "tip"): 0, ("tip", "pool"): 1, ("tip", "carried"): 2,
         ("pool", "pool"): 3, ("pool", "carried"): 4}


def mma_device_table(prog: TreeVmemProgram, carry: bool = True) -> np.ndarray:
    """[OPS, MMA_OP_COLS] int32, the table the "mma" kernel reads: the
    schedule's nine columns with an op's children ordered tip before pool
    slot before carried (left * right commutes exactly, so the rows do not
    change), then the op's case in KINDS and the store and hand-on
    columns of `carry_flags`."""
    order = {"tip": 0, "pool": 1, "carried": 2}
    table = np.zeros((prog.n_ops, MMA_OP_COLS), dtype=np.int32)
    for w, (row, (took, store, keep)) in enumerate(zip(
            prog.ops.tolist(), carry_flags(prog, enabled=carry).tolist())):
        p_slot, t1, s1, f1, t2, s2, f2, pm1, pm2 = row
        kids = [("tip" if f1 else "carried" if took == 1 else "pool",
                 (t1, s1, f1), pm1),
                ("tip" if f2 else "carried" if took == 2 else "pool",
                 (t2, s2, f2), pm2)]
        kids.sort(key=lambda kid: order[kid[0]])
        (k1, c1, m1), (k2, c2, m2) = kids
        table[w] = [p_slot, *c1, *c2, m1, m2, KINDS[(k1, k2)], store,
                    keep]
    return table


def fma_device_table(prog: TreeVmemProgram, carry: bool = True
                     ) -> np.ndarray:
    """[OPS, FMA_TABLE_COLS] int32, the table the "fma" kernel reads: the
    rows of `mma_device_table` in two 16-byte halves.  Columns 0-3, what the
    copies ahead of the op need: the tip index of child 1 and of child 2
    (-1 where that child is not a tip), their P-matrices; columns 4-7, what
    the op needs: the parent's slot, the children's slots, and 2 * case +
    hand-on (the case in KINDS; a parent not handed on is stored)."""
    t = mma_device_table(prog, carry)
    tip1 = np.where(t[:, 3] != 0, t[:, 1], -1)
    tip2 = np.where(t[:, 6] != 0, t[:, 4], -1)
    return np.ascontiguousarray(np.stack([
        tip1, tip2, t[:, 7], t[:, 8], t[:, 0], t[:, 2], t[:, 5],
        2 * t[:, 9] + t[:, 11]], axis=1).astype(np.int32))


def wide_device_table(prog: TreeVmemProgram) -> tuple:
    """([OPS, WIDE_TABLE_COLS] int32, pool slots): the table the wide
    kernel reads and the slots its pool needs.  Columns: the tip index of
    child 1 and of child 2 (-1 where that child is not a tip), their
    P-matrices, the parent's slot (-1 - e for the op whose parent is
    export row e: it goes straight to device memory), the children's
    slots, 0.  Slots are given anew, in the schedule's order, to the
    parents that are not exported: a parent never takes a slot that one of
    its children frees at its op (the kernel writes the parent of one rate
    while it still reads the children's other rates), and an exported
    parent, which nothing reads, takes none.  So the pool is the schedule's
    less the slots its exports hold to the end.  Cached on the program."""
    key = ("wide_table",)
    if key in prog._device:
        return prog._device[key]
    rows = prog.ops.tolist()
    exported = {op_index: e for e, (op_index, _slot) in
                enumerate(prog.exports)}
    writer: dict = {}      # schedule slot -> the op that wrote it last
    kids: list = []        # per op, the ops whose parents it reads
    last: dict = {}        # op -> the last op that reads its parent
    for w, (p_slot, _t1, s1, f1, _t2, s2, f2, _pm1, _pm2) in enumerate(rows):
        reads = [writer[s] for s, f in ((s1, f1), (s2, f2)) if not f]
        for v in reads:
            if v in exported:
                raise ValueError("an exported parent is read by a later op: "
                                 "the wide sweep writes exports to device "
                                 "memory only")
            last[v] = w
        kids.append(reads)
        writer[p_slot] = w
    slot_of: dict = {}
    free: list = []
    n_slots = 0
    table = np.zeros((len(rows), WIDE_TABLE_COLS), dtype=np.int32)
    for w, (_p, t1, _s1, f1, t2, _s2, f2, pm1, pm2) in enumerate(rows):
        if w in exported:
            slot_of[w] = -1 - exported[w]
        elif free:
            slot_of[w] = free.pop()
        else:
            slot_of[w], n_slots = n_slots, n_slots + 1
        it = iter(kids[w])
        c1 = 0 if f1 else slot_of[next(it)]
        c2 = 0 if f2 else slot_of[next(it)]
        table[w] = [t1 if f1 else -1, t2 if f2 else -1, pm1, pm2,
                    slot_of[w], c1, c2, 0]
        for v in kids[w]:
            if last[v] == w:
                free.append(slot_of[v])
    prog._device[key] = (table, n_slots)
    return prog._device[key]


def wide_items(prog: TreeVmemProgram, rate_cats: int,
               device: torch.device):
    """[n] int32 on `device`: the P-matrices the wide kernel stages, in the
    order it uses them, matrix * rate_cats + rate for each (op, rate,
    child) of the schedule whose child is not a tip (a tip child's columns
    are read from device memory).  Cached on the program."""
    key = ("wide_items", rate_cats, str(device))
    if key not in prog._device:
        table = wide_device_table(prog)[0]
        items = [pm * rate_cats + r
                 for tip1, tip2, pm1, pm2 in table[:, :4].tolist()
                 for r in range(rate_cats)
                 for tip, pm in ((tip1, pm1), (tip2, pm2)) if tip < 0]
        prog._device[key] = torch.as_tensor(
            np.asarray(items, dtype=np.int32), device=device)
    return prog._device[key]


def schedule(ops: Sequence, tips: int, export_clvs: Sequence[int]
             ) -> Optional[TreeVmemProgram]:
    """Sethi–Ullman slot allocation over an operation forest.

    ops: partition.Operation list (any topological order).  Returns None
    when the list is not a forest (a CLV written twice, or a child that is
    neither a tip nor produced here — e.g. partial traversals).
    """
    producer = {}
    for i, op in enumerate(ops):
        if op.parent_clv_index in producer:
            return None
        producer[op.parent_clv_index] = op
    if not producer:
        return None

    refcount: dict[int, int] = {}
    for op in ops:
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= tips:
                if c not in producer:
                    return None
                refcount[c] = refcount.get(c, 0) + 1

    exports = [c for c in dict.fromkeys(export_clvs) if c in producer]
    roots = [p for p in producer if refcount.get(p, 0) == 0]

    # need(): minimum live slots to evaluate a subtree (heavier child first)
    need: dict[int, int] = {}
    for root in roots:
        stack = [(root, False)]
        while stack:
            node, seen = stack.pop()
            if node < tips or node in need:
                continue
            op = producer[node]
            kids = [c for c in (op.child1_clv_index, op.child2_clv_index)
                    if c >= tips]
            if not seen:
                stack.append((node, True))
                stack.extend((k, False) for k in kids)
            else:
                ns = sorted((need[k] for k in kids), reverse=True)
                if len(ns) == 0:
                    need[node] = 1
                elif len(ns) == 1:
                    need[node] = max(ns[0], 2)  # child held + parent slot
                else:
                    inner = max(ns[0], ns[1] + 1)
                    need[node] = max(inner, 3)  # both held + parent slot

    no_free = set(exports)
    slot_of: dict[int, int] = {}
    free: list[int] = []
    next_slot = 0
    rows: list[list[int]] = []
    export_pos: dict[int, tuple[int, int]] = {}  # clv -> (op_index, slot)
    live_ref = dict(refcount)

    def alloc() -> int:
        nonlocal next_slot
        if free:
            return free.pop()
        s = next_slot
        next_slot += 1
        return s

    for root in roots:
        stack = [(root, False)]
        while stack:
            node, seen = stack.pop()
            if node < tips:
                continue
            op = producer[node]
            kids = [c for c in (op.child1_clv_index, op.child2_clv_index)
                    if c >= tips]
            if not seen:
                stack.append((node, True))
                # push lighter child first so the heavier pops (runs) first
                for k in sorted(kids, key=lambda k: need[k]):
                    stack.append((k, False))
                continue
            # children evaluated; emit this op.  The parent gets a FRESH
            # slot, never a child's.  Export slots are never freed, so an
            # exported row stays valid to the end of the sweep.
            p_slot = alloc()
            slot_of[node] = p_slot

            def enc(c):
                if c < tips:
                    return [c, 0, 1]
                return [0, slot_of[c], 0]

            rows.append([p_slot]
                        + enc(op.child1_clv_index)
                        + enc(op.child2_clv_index)
                        + [op.child1_matrix_index, op.child2_matrix_index])
            if node in no_free:
                export_pos[node] = (len(rows) - 1, p_slot)
            for c in kids:
                live_ref[c] -= 1
                if live_ref[c] == 0 and c not in no_free:
                    free.append(slot_of[c])

    export_clv_map = {}
    export_scaler_map = {}
    export_list = []
    for row, clv in enumerate(exports):
        export_clv_map[clv] = row
        sidx = producer[clv].parent_scaler_index
        if sidx is not None and sidx >= 0:
            export_scaler_map[sidx] = row
        export_list.append(export_pos[clv])

    return TreeVmemProgram(
        ops=np.asarray(rows, dtype=np.int32).reshape(len(rows), OP_COLS),
        pool_size=next_slot,
        exports=tuple(export_list),
        export_clv_map=export_clv_map,
        export_scaler_map=export_scaler_map,
    )


def _scaler_rows(cfg: PartitionConfig) -> int:
    return cfg.rate_cats if cfg.per_rate_scalers else 1


def pool_itemsize(cfg: PartitionConfig) -> int:
    """Bytes of one CLV entry in the kernels' pools: 2 for bf16 storage,
    4 for f32 (scaler entries are int32 either way)."""
    return 2 if cfg.dtype == torch.bfloat16 else 4


def rate_lanes(rate_cats: int) -> int:
    """Threads a site has in the "fma" kernel: one per rate category,
    rounded up to a power of two (the padding lanes repeat the last rate)."""
    return 1 << max(rate_cats - 1, 0).bit_length()


def generic(cfg: PartitionConfig) -> bool:
    """Whether the "fma" form runs its generic instantiation (the state
    count at run time) for this case: every state count outside
    FMA_STATES."""
    return cfg.states not in FMA_STATES


def generic_groups(cfg: PartitionConfig) -> int:
    """Row groups G of a (site, rate lane) column in the generic
    instantiation's row-group form (csrc/tree_sweep_generic.cu): the
    fewest, a power of two, that leave each thread at most GENERIC_ROWS of
    the parent's rows (rows g, g + G, ...).  0 for a state count of
    FMA_STATES."""
    if not generic(cfg):
        return 0
    groups = 1
    while -(-cfg.states // groups) > GENERIC_ROWS:
        groups *= 2
    return groups


def generic_spans_warps(cfg: PartitionConfig) -> bool:
    """Whether a site's G * lanes threads of the row-group form span warps
    under per-site scalers (9-32 rates at many states), so that its rescue
    ANDs the warps' words through shared memory, one word a warp
    (csrc/tree_sweep_generic.cu: `spans`)."""
    return not cfg.per_rate_scalers and \
        generic_groups(cfg) * rate_lanes(cfg.rate_cats) > 32


def generic_matrix_floats(cfg: PartitionConfig) -> int:
    """f32 words of one P-matrix in the row-group form's layout
    [R][G][block] (csrc/tree_sweep_generic.cu:group_matrix_floats): a
    (rate, group) block holds S columns of the group's rows padded to a
    multiple of 4, rounded up to an odd count of 16-byte pieces; 0 for a
    state count of FMA_STATES."""
    groups = generic_groups(cfg)
    if not groups:
        return 0
    S = cfg.states
    rows = (-(-S // groups) + 3) & ~3
    return cfg.rate_cats * groups * ((S * rows // 4) | 1) * 4


def generic_staged(cfg: PartitionConfig) -> bool:
    """Whether the row-group form copies each op's two P-matrices into
    shared memory (two buffers of both, at most GENERIC_STAGE_BYTES;
    csrc/tree_sweep_generic.cu:group_staged) rather than read them
    through L1."""
    floats = generic_matrix_floats(cfg)
    return 0 < 2 * 2 * floats * 4 <= GENERIC_STAGE_BYTES


def max_threads(cfg: PartitionConfig) -> int:
    """Threads an "fma" CTA may have at this rate and state count."""
    if generic(cfg):
        return GENERIC_SITES_THREADS if sites_a_thread(cfg) > 1 \
            else FMA_THREADS_ANY
    return FMA_THREADS if cfg.rate_cats in FMA_RATE_LANES \
        else FMA_THREADS_ANY


def sites_a_thread(cfg: PartitionConfig) -> int:
    """Sites one "fma" thread holds: FMA_SITES_A_THREAD up to
    FMA_SITES_STATES states of a specialised instantiation,
    GENERIC_SITES_A_THREAD up to GENERIC_SITES_STATES states of the
    generic row-group form, else one."""
    if generic(cfg):
        return GENERIC_SITES_A_THREAD if generic_groups(cfg) and \
            cfg.states <= GENERIC_SITES_STATES else 1
    return FMA_SITES_A_THREAD if cfg.states <= FMA_SITES_STATES else 1


def fma_threads(cfg: PartitionConfig, tb: int) -> int:
    """Threads of an "fma" CTA at site block tb: a thread holds one rate
    lane of `sites_a_thread` sites, or in the generic row-group form one
    of a column's `generic_groups` row groups."""
    return tb * rate_lanes(cfg.rate_cats) // sites_a_thread(cfg) \
        * max(generic_groups(cfg), 1)


def ring_words(cfg: PartitionConfig) -> int:
    """32-bit words of one warp's staging ring in the "fma" kernel: 2 *
    FMA_AHEAD + 1 op rows of 8, then FMA_AHEAD + 1 slots of both P-matrices
    (where staged; a rate block padded to 20 floats at S = 4) and of two tip
    masks for each of the warp's sites; rounded up to a multiple of 4.  The
    generic instantiation stages nothing: 0."""
    S, R = cfg.states, cfg.rate_cats
    if generic(cfg):
        return 0
    p_floats = 0
    if R in FMA_RATE_LANES and S <= FMA_STAGE_P_MAX_STATES:
        p_floats = 2 * R * (20 if S == 4 else S * S)
    sites = sites_a_thread(cfg) * (32 // rate_lanes(R))
    words = (2 * FMA_AHEAD + 1) * FMA_TABLE_COLS \
        + (FMA_AHEAD + 1) * (p_floats + 2 * sites)
    return (words + 3) & ~3


def smem_bytes(prog: TreeVmemProgram, cfg: PartitionConfig, tb: int,
               mode: str = "fma") -> int:
    """Dynamic shared memory of one CTA at site-block size tb.  "fma": the
    CLV pool [pool_size, S, tb * L] in cfg.dtype (f32 or bf16,
    `pool_itemsize`), the scaler pool [pool_size, tb * L or tb] int32
    (per-rate or per-site), L = rate_lanes(R) (at a power-of-two R the
    pools [pool_size, R*S, tb] and [pool_size, SR, tb]), and one staging
    ring a warp (`ring_words`), or in the generic row-group form two
    buffers of an op's two P-matrices where it stages them
    (`generic_staged`) and one word a warp where a site's rescue spans
    warps (`generic_spans_warps`).  "mma": the CLV pool tiled as [tb/8,
    R*S, 8] in cfg.dtype and one scaler row."""
    item = pool_itemsize(cfg)
    if mode == WIDE:
        return wide_smem_bytes(wide_device_table(prog)[1], cfg, tb)
    if mode == "mma":
        return prog.pool_size * (cfg.span * item + 4) * tb
    lanes = rate_lanes(cfg.rate_cats)
    sr = lanes if cfg.per_rate_scalers else 1
    staged = 2 * 2 * generic_matrix_floats(cfg) * 4 \
        if generic_staged(cfg) else 0
    if generic_spans_warps(cfg):
        staged += fma_threads(cfg, tb) // 32 * 4
    return (prog.pool_size * (lanes * cfg.states * item + sr * 4) * tb
            + fma_threads(cfg, tb) // 32 * ring_words(cfg) * 4 + staged)


def wide_smem_bytes(n_slots: int, cfg: PartitionConfig, tb: int) -> int:
    """Dynamic shared memory of one wide CTA at site block tb with a pool
    of n_slots: the CLV pool [n_slots, R, S, tb] f32, the scaler pool
    [n_slots, SR, tb] int32, two staging buffers of one P-matrix of one
    rate [S, WIDE_P_ROWS] f32, one exchange buffer [S, tb] f32 (the second
    half's products with child 2) and two rescue flags [2, SR, tb] int32
    (csrc/tree_sweep_wide.cu:wide_smem)."""
    R, S = cfg.rate_cats, cfg.states
    sr = _scaler_rows(cfg)
    return 4 * (n_slots * (R * S + sr) * tb + 2 * S * WIDE_P_ROWS
                + S * tb + 2 * sr * tb)


def site_blocks(cfg: PartitionConfig, mode: str = "fma") -> tuple:
    """The site blocks `mode` may run at, largest first: SITE_BLOCKS, and
    GENERIC_SITE_BLOCKS for the generic "fma" instantiation,
    WIDE_SITE_BLOCKS for the wide form."""
    if mode == WIDE:
        return WIDE_SITE_BLOCKS
    return GENERIC_SITE_BLOCKS if mode == "fma" and generic(cfg) \
        else SITE_BLOCKS


def fitting_blocks(prog: TreeVmemProgram, cfg: PartitionConfig,
                   smem_limit: int = SMEM_LIMIT, mode: str = "fma") -> list:
    """The site blocks of `site_blocks`, largest first, that divide
    sites_padded, whose pools fit `smem_limit` bytes and, for "fma", whose
    CTA has whole warps and at most `max_threads` threads."""
    return [tb for tb in site_blocks(cfg, mode)
            if cfg.sites_padded % tb == 0
            and smem_bytes(prog, cfg, tb, mode) <= smem_limit
            and (mode in ("mma", WIDE)
                 or (fma_threads(cfg, tb) % 32 == 0
                     and fma_threads(cfg, tb) <= max_threads(cfg)))]


def pick_site_block(prog: TreeVmemProgram, cfg: PartitionConfig,
                    smem_limit: int = SMEM_LIMIT, mode: str = "fma",
                    sm_count: Optional[int] = None) -> int:
    """Site block for `mode` among `fitting_blocks`; 0 if none fits.

    Without `sm_count` the largest such block.  With it (the device's SMs)
    the card is filled first: the largest block (at most MMA_SMALL_BLOCK
    sites on the small-span "mma" kernel) that gives at least SM_FILL *
    sm_count CTAs, or the smallest block where none gives that many.  The
    warps of both forms share nothing, so small blocks lose nothing, and
    they pack an SM's shared memory more tightly."""
    fits = fitting_blocks(prog, cfg, smem_limit, mode)
    if not fits:
        return 0
    if sm_count is None:
        return fits[0]
    if mode == "mma" and (cfg.states, cfg.rate_cats) in MMA_CARRY_CASES:
        fits = [tb for tb in fits if tb <= MMA_SMALL_BLOCK] or fits[-1:]
    for tb in fits:
        if cfg.sites_padded // tb >= SM_FILL * sm_count:
            return tb
    return fits[-1]


def unsupported(prog: Optional[TreeVmemProgram], cfg: PartitionConfig,
                smem_limit: int = SMEM_LIMIT,
                mode: str = "fma") -> Optional[str]:
    """Why the tree sweep's `mode` form cannot take this case, or None if
    it can."""
    if mode not in SWEEP_MODES:
        return f"unknown sweep mode {mode!r}, not one of {SWEEP_MODES}"
    if prog is None or prog.n_ops == 0:
        return "the operation list is not a full forest of new CLVs"
    if mode == WIDE:
        return _wide_unsupported(prog, cfg, smem_limit)
    if cfg.dtype not in DTYPES:
        return (f"the tree-sweep kernels ({mode!r} included) store CLVs in "
                f"f32 or bf16 (torch.float32, torch.bfloat16), got "
                f"{cfg.dtype}")
    if mode == "fma" and not MIN_STATES <= cfg.states <= MAX_STATES:
        return (f"the 'fma' tree-sweep kernel takes {MIN_STATES} to "
                f"{MAX_STATES} states (an int32 tip mask), got {cfg.states}")
    if mode == "fma" and cfg.rate_cats > FMA_MAX_RATES:
        return (f"the 'fma' tree-sweep kernel runs one thread per site and "
                f"rate, at most {FMA_MAX_RATES} rates, got {cfg.rate_cats}")
    if mode == "mma":
        if (cfg.states, cfg.rate_cats) not in MMA_CASES:
            return (f"the 'mma' tree-sweep kernel is built for (states, "
                    f"rate_cats) in {MMA_CASES}, got ({cfg.states}, "
                    f"{cfg.rate_cats}); the 'fma' form serves other cases")
        if cfg.per_rate_scalers:
            return ("the 'mma' tree-sweep kernel keeps per-site scalers "
                    "only; the 'fma' form serves per-rate scalers")
    if pick_site_block(prog, cfg, smem_limit, mode) == 0:
        blocks = site_blocks(cfg, mode)
        small = blocks[-1]
        return (f"in mode {mode!r} a {small}-site block needs "
                f"{smem_bytes(prog, cfg, small, mode)} bytes of shared "
                f"memory for a pool of {prog.pool_size} slots at "
                f"{cfg.states} states and {cfg.rate_cats} rates, above the "
                f"{smem_limit}-byte limit, or no block size in {blocks} "
                f"divides {cfg.sites_padded} sites within the thread limit")
    return None


def _wide_unsupported(prog: TreeVmemProgram, cfg: PartitionConfig,
                      smem_limit: int) -> Optional[str]:
    """unsupported() of the wide form, for a non-empty schedule."""
    if cfg.dtype != torch.float32:
        return (f"the 'wide' tree-sweep kernel stores f32 CLVs "
                f"(torch.float32), got {cfg.dtype}")
    if not WIDE_MIN_STATES <= cfg.states <= WIDE_MAX_STATES:
        return (f"the 'wide' tree-sweep kernel takes {WIDE_MIN_STATES} to "
                f"{WIDE_MAX_STATES} states (an int64 tip mask), got "
                f"{cfg.states}")
    if cfg.rate_cats > FMA_MAX_RATES:
        return (f"the 'wide' tree-sweep kernel takes at most {FMA_MAX_RATES}"
                f" rates, got {cfg.rate_cats}")
    try:
        n_slots = wide_device_table(prog)[1]
    except ValueError as err:
        return str(err)
    if not fitting_blocks(prog, cfg, smem_limit, WIDE):
        small = WIDE_SITE_BLOCKS[-1]
        return (f"in mode 'wide' an {small}-site block needs "
                f"{wide_smem_bytes(n_slots, cfg, small)} bytes of shared "
                f"memory for a pool of {n_slots} slots at {cfg.states} "
                f"states and {cfg.rate_cats} rates, above the "
                f"{smem_limit}-byte limit, or no block size in "
                f"{WIDE_SITE_BLOCKS} divides {cfg.sites_padded} sites")
    return None


def choose(prog: Optional[TreeVmemProgram], cfg: PartitionConfig,
           smem_limit: int = SMEM_LIMIT,
           sm_count: Optional[int] = None) -> Optional[tuple]:
    """Pick (site_block, mode) for the kernel, or None if no form takes the
    case (`unsupported` gives the reason).  `sm_count` goes to
    `pick_site_block` and does not change the mode.

    "mma" at four states and four rates (MMA_CARRY_CASES) with per-site
    scalers from MMA_MIN_SITES sites on, "fma" everywhere else that it
    takes the case, at any op count; either form where only it takes the
    case.  The rule rests on both forms' times on an NVIDIA H100 80GB HBM3
    at 700 W, calls back to back at the blocks `pick_site_block` gives
    (chip_smoke.phase_sweep_times; PERF.md): at 256 taxa x 65,536 sites
    "mma" 0.42-0.43 ms, "fma" 0.46-0.55; at 1,024 x 16,384 "fma" 0.61
    against 0.74; at a random 8,192-taxon tree x 8,192 sites 3.82-3.84
    against 5.67-5.71; at 128 protein taxa x 16,384 sites 2.08 against
    2.33-2.34.  Between 16,384 and 65,536 DNA sites no time was taken.
    Every state count outside MMA_CASES takes "fma", on its generic
    instantiation outside FMA_STATES (`generic`); above MAX_STATES (33 to
    64, an int64 tip mask) the wide form, at f32, in the largest site
    block of WIDE_SITE_BLOCKS that gives the card its CTAs (at 128 codon
    taxa x 16,384 sites it is the only form; PERF.md holds its time
    against the dense path's).
    The JAX package's rule (the static kernels up to 4,096 ops) follows a
    limit of Mosaic's compile time that the CUDA kernels, which read the
    op table at run time, do not have.  None for an empty schedule or a
    dtype outside DTYPES (f32, bf16).

    At bf16 the same rule, and "mma" at MMA_BF16_CASES (20 states, four
    rates) with per-site scalers at any site count.  Both forms' times at
    bf16 on an NVIDIA H100 80GB HBM3 at 700 W, calls back to back, two
    runs in one call (chip_smoke.phase_sweep_times; PERF.md): at
    256 x 65,536 "mma" 0.2568-0.2570 ms, "fma" 0.4853-0.4855; at 1,024 x
    16,384 "fma" 0.6954-0.6956 against 0.7107-0.7116; at 8,192 x 8,192
    "fma" 4.3372-4.3735 against 5.5888-5.5895; at 128 protein taxa x
    16,384 sites "mma" 0.5525-0.5530 against 2.2031-2.2034; at fewer
    20-state sites, where either form runs 64-128 CTAs of 32 sites, "mma"
    0.3275 against 0.4225 at 64 LG4X taxa x 2,048 sites and 0.6734
    against 0.8510 at 128 LG taxa x 4,096."""
    if prog is None or prog.n_ops == 0 or cfg.dtype not in DTYPES:
        return None
    if cfg.states > MAX_STATES:
        if unsupported(prog, cfg, smem_limit, WIDE) is not None:
            return None
        return pick_site_block(prog, cfg, smem_limit, WIDE, sm_count), WIDE
    modes = MODES
    case = (cfg.states, cfg.rate_cats)
    if (case in MMA_CARRY_CASES and cfg.sites_padded >= MMA_MIN_SITES) or \
            (cfg.dtype == torch.bfloat16 and case in MMA_BF16_CASES):
        modes = ("mma", "fma")
    for mode in modes:
        if unsupported(prog, cfg, smem_limit, mode) is None:
            return pick_site_block(prog, cfg, smem_limit, mode,
                                   sm_count), mode
    return None


def split_tf32(x):
    """Split f32 `x` into (hi, lo), both TF32 values held in f32 (the low
    13 mantissa bits zero), with hi + lo = x up to 2^-22 |x|.  Rounding is
    to nearest, ties away from zero, in the integer domain: what the
    kernel's cvt.rna.tf32.f32 does to the other operand."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


@functools.cache
def mma_fragment_index(states: int, rate_cats: int,
                       bf16: bool = False) -> np.ndarray:
    """Where every register of the "mma" kernel's P operand comes from: an
    int64 index into P's flattened [R, S, S] (R*S*S = the zero outside the
    rate blocks), per nonzero tile pair and lane (g = lane / 4,
    q = lane % 4).

    f32 (mma.m16n8k8.row.col.tf32):
    MMA_CARRY_CASES (the small-span kernel; P^T is the B operand) ->
    [SPAN/8, 32, 2]: for n-tile j the registers b0, b1 = Pbd[8j + g,
    8j + 2q (+ 1)]: output state 8j + g, and the contraction index permuted
    so that k-index q is state 8j + 2q and q + 4 is state 8j + 2q + 1.  Only
    the pairs with k-step == n-tile are nonzero there (8 % S == 0).
    Other cases (the general kernel; the block-diagonal P is the A operand)
    -> [NP, 32, 4]: for every nonzero (m-tile, k-step) pair in row-major
    order the registers a0 (row g, col q), a1 (g + 8, q), a2 (g, q + 4),
    a3 (g + 8, q + 4).

    bf16 (mma.m16n8k16.row.col.bf16, two bf16 a 32-bit register, the
    lower index in the low half; the contraction in its natural order):
    MMA_CARRY_CASES -> [32, SPAN/8, 2, 2]: lane, n-tile j, register b0
    (k = 2q, 2q + 1) or b1 (k = 2q + 8, 2q + 9), half: Pbd[8j + g, k], one
    k16 step over the whole span of 16.  Other cases -> [NP, 32, 4, 2]: for
    every nonzero (m-tile, k-step) pair of 16 x 16 tiles in row-major
    order, lane, register a0 (row g, cols 2q, 2q + 1), a1 (g + 8, the
    same), a2 (g, 2q + 8, 2q + 9), a3 (g + 8, the same), half."""
    S, R = states, rate_cats
    span = R * S
    lane = np.arange(32)
    g, q = lane // 4, lane % 4

    def index(rows, cols):
        same = rows // S == cols // S
        idx = (rows // S) * S * S + (rows % S) * S + cols % S
        return np.where(same, idx, R * S * S)

    if bf16:
        half = np.array([0, 1])
        if (S, R) in MMA_CARRY_CASES:
            if span != 16:
                raise ValueError(f"the bf16 small-span layout is one k16 "
                                 f"step, span 16, got {span}")
            j = np.arange(span // 8)
            reg = np.array([0, 1])
            rows = 8 * j[None, :, None, None] + g[:, None, None, None]
            cols = (2 * q[:, None, None, None] + 8 * reg[None, None, :, None]
                    + half[None, None, None, :])
            rows, cols = np.broadcast_arrays(rows, cols)
            return index(rows, cols).astype(np.int64)     # [32, NT, 2, 2]
        reg = np.arange(4)
        pairs = []
        for mt in range(span // 16):
            for ks in range(span // 16):
                rows = (16 * mt + g[:, None, None]
                        + 8 * (reg[None, :, None] % 2) + 0 * half)
                cols = (16 * ks + 2 * q[:, None, None]
                        + 8 * (reg[None, :, None] // 2) + half[None, None, :])
                if not (rows // S == cols // S).any():
                    continue
                pairs.append(index(rows, cols))             # [32, 4, 2]
        return np.stack(pairs).astype(np.int64)
    pairs = []
    if (S, R) in MMA_CARRY_CASES:
        if 8 % S:
            raise ValueError(f"the small-span layout needs 8 % states == 0, "
                             f"got {S}")
        for j in range(span // 8):
            rows = 8 * j + g[:, None] + np.array([0, 0])           # [32, 2]
            cols = 8 * j + 2 * q[:, None] + np.array([0, 1])
            pairs.append(index(rows, cols))
        return np.stack(pairs).astype(np.int64)
    for mt in range(span // 16):
        for ks in range(span // 8):
            rows = 16 * mt + g[:, None] + np.array([0, 8, 0, 8])   # [32, 4]
            cols = 8 * ks + q[:, None] + np.array([0, 0, 4, 4])
            if not (rows // S == cols // S).any():
                continue
            pairs.append(index(rows, cols))
    return np.stack(pairs).astype(np.int64)


def _fragment_run(index: np.ndarray) -> int:
    """Entries of the fragment table whose TF32 heads are stored together,
    followed by their remainders: a lane's two registers in the small-span
    layout (one 16-byte load fetches heads and remainders), a pair's 32 x 4
    in the general one."""
    return 2 if index.shape[-1] == 2 else 128


@functools.cache
def _fragment_index_tensor(states: int, rate_cats: int, device_key: str,
                           dtype=torch.int64, bf16: bool = False):
    return torch.as_tensor(mma_fragment_index(states, rate_cats, bf16),
                           dtype=dtype, device=torch.device(device_key))


def pmatrix_fragments_reference(pmatrix, cfg: PartitionConfig):
    """Plain PyTorch version of pmatrix_fragments (same output): one
    gather and, for f32, a few elementwise ops."""
    P = pmatrix.shape[0]
    bf16 = pmatrix.dtype == torch.bfloat16
    idx = _fragment_index_tensor(cfg.states, cfg.rate_cats,
                                 str(pmatrix.device), bf16=bf16)
    flat = torch.cat([pmatrix.reshape(P, -1),
                      pmatrix.new_zeros((P, 1))], dim=1)
    frag = flat[:, idx]                 # [P, *mma_fragment_index's shape]
    if bf16:
        return frag.contiguous()
    dim = 3 if idx.shape[-1] == 2 else 2
    return torch.stack(split_tf32(frag), dim=dim).contiguous()


def pmatrix_fragments(pmatrix, cfg: PartitionConfig):
    """[P, R, S, S] -> the "mma" kernel's P operand in fragment order
    (mma_fragment_index).  f32: the block-diagonal P of every slot split
    into TF32 (hi, lo): [P, SPAN/8, 32, 2 (hi, lo), 2] for MMA_CARRY_CASES,
    [P, NP, 2 (hi, lo), 32, 4] otherwise.  bf16: the entries as they are,
    [P, 32, SPAN/8, 2, 2] or [P, NP, 32, 4, 2] bf16 (a lane's registers
    are one 16-byte load).  Once per call, not per op: a small CUDA kernel
    of csrc/tree_sweep_mma.cu on a CUDA tensor, the plain version on a CPU
    tensor."""
    if pmatrix.device.type != "cuda":
        return pmatrix_fragments_reference(pmatrix, cfg)
    from .. import _build
    bf16 = pmatrix.dtype == torch.bfloat16
    if pmatrix.dtype not in DTYPES or not pmatrix.is_contiguous():
        raise ValueError(f"pmatrix must be contiguous f32 or bf16, got "
                         f"{pmatrix.dtype}")
    idx = _fragment_index_tensor(cfg.states, cfg.rate_cats,
                                 str(pmatrix.device), torch.int32, bf16)
    P, regs = pmatrix.shape[0], idx.shape[-1]
    if bf16:
        shape, run = (P,) + tuple(idx.shape), 1
    else:
        shape = (P, idx.shape[0], 32, 2, 2) if regs == 2 \
            else (P, idx.shape[0], 2, 32, 4)
        run = _fragment_run(idx)
    out = torch.empty(shape, dtype=pmatrix.dtype, device=pmatrix.device)
    with torch.cuda.device(pmatrix.device):
        err = _build.library().tree_sweep_mma_fragments(
            pmatrix.data_ptr(), idx.data_ptr(), out.data_ptr(), P,
            idx.numel(), run, cfg.rate_cats * cfg.states ** 2, int(bf16),
            torch.cuda.current_stream(pmatrix.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pmatrix_fragments kernel launch failed: CUDA "
                           f"error {err} ({_build.error_string(err)})")
    return out


def _check_inputs(tip_blocked, pmatrix, prog, cfg, tb, p_base=None):
    nt, tips, tb_in = tip_blocked.shape
    if tb_in != tb or nt * tb != cfg.sites_padded or tips != cfg.tips:
        raise ValueError(
            f"tip_blocked {tuple(tip_blocked.shape)} does not match "
            f"[{cfg.sites_padded // tb}, {cfg.tips}, {tb}]")
    mask = tip_mask_torch_dtype(cfg.states)
    if tip_blocked.dtype != mask:
        raise TypeError(f"tip_blocked must be {mask} at {cfg.states} states,"
                        f" got {tip_blocked.dtype}")
    R, S = cfg.rate_cats, cfg.states
    if pmatrix.dim() != 4 or tuple(pmatrix.shape[1:]) != (R, S, S):
        raise ValueError(f"pmatrix {tuple(pmatrix.shape)} is not [P, {R}, "
                         f"{S}, {S}]")
    if int(prog.ops[:, [7, 8]].max()) >= pmatrix.shape[0]:
        raise ValueError("the schedule reads a P-matrix beyond the buffer")
    if p_base is not None and (
            tuple(p_base.shape) != (nt,) or p_base.dtype != torch.int32
            or p_base.device != tip_blocked.device):
        raise ValueError(f"p_base must be [{nt}] int32 on "
                         f"{tip_blocked.device}, got {tuple(p_base.shape)} "
                         f"{p_base.dtype} on {p_base.device}")


def sweep_reference(tip_blocked, pmatrix, prog: TreeVmemProgram,
                    cfg: PartitionConfig, tb: int, carry: bool = False,
                    p_base=None):
    """Plain PyTorch version of the tree sweep (same contract as sweep()).

    A Python loop over the schedule rows, each row one einsum per child
    over all site blocks at once (with `p_base`, each block's P-matrices
    gathered first).  carry=True honours `carry_flags` as the
    kernels do: a carried child is taken from the value the previous
    op handed on, not from its pool slot, and a parent whose store is
    dropped never reaches the pool.  The pool holds pmatrix.dtype; at bf16
    the arithmetic is f32 (P and the children widened exactly), the rescue
    is decided on the f32 parent, and the parent is rounded to bf16 where
    it is stored or handed on.  Returns (clv_rows [E, NT, R, S, TB] in the
    arithmetic's type, the parents unrounded; scaler_rows [E, NT, SR, TB]
    int32) in prog.exports order."""
    _check_inputs(tip_blocked, pmatrix, prog, cfg, tb, p_base)
    nt = tip_blocked.shape[0]
    R, S = cfg.rate_cats, cfg.states
    sr = _scaler_rows(cfg)
    dev, dtype = tip_blocked.device, pmatrix.dtype
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    pm = pmatrix.to(acc)
    base = None if p_base is None else p_base.long()

    def propagate(index, clv):          # P . child, [NT, R, S, TB]
        if base is None:
            return torch.einsum("rij,nrjt->nrit", pm[index], clv)
        return torch.einsum("nrij,nrjt->nrit", pm[base + index], clv)

    pool = torch.zeros((prog.pool_size, nt, R, S, tb), dtype=dtype,
                       device=dev)
    spool = torch.zeros((prog.pool_size, nt, sr, tb), dtype=torch.int32,
                        device=dev)
    shifts = torch.arange(S, dtype=torch.int32, device=dev)[:, None]

    def child(tip, slot, is_tip, carried):
        if is_tip:
            bits = ((tip_blocked[:, tip, None, :] >> shifts) & 1).to(acc)
            return bits[:, None].expand(nt, R, S, tb), 0      # [NT,R,S,TB]
        if carried:
            return held
        return pool[slot].to(acc), spool[slot]

    flags = carry_flags(prog, enabled=carry).tolist()
    exports = export_rows(prog).tolist()
    rows = [None] * len(prog.exports)
    held = None          # (CLV, scalers) the previous op handed on
    for (p_slot, t1, s1, f1, t2, s2, f2, pm1, pm2), (took, store, keep), e \
            in zip(prog.ops.tolist(), flags, exports):
        c1, sc1 = child(t1, s1, f1, took == 1)
        c2, sc2 = child(t2, s2, f2, took == 2)
        left = propagate(pm1, c1)
        right = propagate(pm2, c2)
        parent = left * right                                 # [NT,R,S,TB]
        below = parent < cfg.scale_threshold
        if cfg.per_rate_scalers:
            mask = below.all(dim=2)                           # [NT, R, TB]
        else:
            mask = below.all(dim=2).all(dim=1, keepdim=True)  # [NT, 1, TB]
        parent = torch.where(mask[:, :, None], parent * cfg.scale_factor,
                             parent)
        scal = mask.to(torch.int32) + sc1 + sc2
        if store:
            pool[p_slot] = parent
            spool[p_slot] = scal
        held = (parent.to(dtype).to(acc), scal) if keep else None
        if e >= 0:
            rows[e] = parent

    slots = [slot for _, slot in prog.exports]
    return torch.stack(rows), spool[slots]


def sweep(tip_blocked, pmatrix, prog: TreeVmemProgram, cfg: PartitionConfig,
          tb: int, mode: Optional[str] = None, carry: bool = True,
          p_base=None):
    """Run the tree sweep: a CUDA kernel on CUDA tensors, the plain
    version (sweep_reference) on CPU tensors, an error on anything else.

    tip_blocked: [NT, tips, TB] packed state bitmasks (block-major), int32
                 up to MAX_STATES states, int64 above
    pmatrix:     [P, R, S, S] in cfg.dtype (f32, or bf16: the pool's type)
    mode:        "fma" (csrc/tree_sweep.cu; the counterpart of the JAX
                 package's static kernels and of its runtime-ops "vpu"
                 mode), "mma" (csrc/tree_sweep_mma.cu, tensor cores; the
                 counterpart of its "mxu" and "splitk" modes) or "wide"
                 (csrc/tree_sweep_wide.cu, 33-64 states, int64 tip masks;
                 no JAX counterpart); None is "fma".  `choose` picks one.
    carry:       hand a parent on to the next op in registers where
                 `carry_flags` allows (the default), or store every parent
                 and load every child (the same rows, bit for bit; the card
                 tests and timings hold the two side by side).  The "mma"
                 form's general kernel (span 80) and the "fma" form's
                 generic instantiation (csrc/tree_sweep_generic.cu) store
                 every parent.
    p_base:      None, or [NT] int32 on the inputs' device: the P-matrix that
                 the schedule's index 0 names in each site block (its index
                 p reads pmatrix[p_base[block] + p]), so that one launch
                 sweeps the blocks of several partitions, each at its own
                 P-matrices (multipartition.py).  Its values are the
                 caller's to keep inside the buffer.
    Returns (clv_rows [E, NT, R, S, TB] f32, scaler_rows [E, NT, SR, TB]
    int32) for the E exported rows, SR = R under per-rate scalers else 1.
    At bf16 the rows are the f32 parents before their rounding to the
    pool's bf16 (the JAX static kernels' exports at one split part).
    """
    with spans.span("sweep"):
        return _run_sweep(tip_blocked, pmatrix, prog, cfg, tb, mode,
                          carry, p_base)


def _run_sweep(tip_blocked, pmatrix, prog: TreeVmemProgram,
               cfg: PartitionConfig, tb: int, mode: Optional[str],
               carry: bool, p_base=None):
    """sweep's work, inside its span."""
    mode = "fma" if mode is None else mode
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {mode!r}, not one of "
                         f"{SWEEP_MODES}")
    if tip_blocked.device.type == "cpu" and pmatrix.device.type == "cpu":
        return sweep_reference(tip_blocked, pmatrix, prog, cfg, tb,
                               carry=carry, p_base=p_base)
    if tip_blocked.device.type != "cuda" or pmatrix.device != \
            tip_blocked.device:
        raise ValueError(
            f"tree sweep needs both inputs on one CUDA device or both on "
            f"the CPU, got {tip_blocked.device} and {pmatrix.device}")
    from .. import _build

    device = tip_blocked.device
    limit = _build.max_shared_memory(device)
    reason = unsupported(prog, cfg, limit, mode)
    if reason is not None:
        raise ValueError(f"tree sweep kernel cannot take this case: {reason}")
    _check_inputs(tip_blocked, pmatrix, prog, cfg, tb, p_base)
    if tb not in site_blocks(cfg, mode):
        raise ValueError(f"site block {tb} not in {site_blocks(cfg, mode)}")
    if smem_bytes(prog, cfg, tb, mode) > limit:
        raise ValueError(f"site block {tb} needs "
                         f"{smem_bytes(prog, cfg, tb, mode)} bytes of shared "
                         f"memory in mode {mode!r}")
    if mode == "fma" and tb not in fitting_blocks(prog, cfg, limit, mode):
        raise ValueError(f"site block {tb} at {cfg.rate_cats} rates needs "
                         f"{fma_threads(cfg, tb)} threads in mode 'fma', not "
                         f"a multiple of 32 up to {max_threads(cfg)}")
    if pmatrix.dtype != cfg.dtype:
        raise TypeError(f"pmatrix must be the config's {cfg.dtype}, got "
                        f"{pmatrix.dtype}")
    if not (tip_blocked.is_contiguous() and pmatrix.is_contiguous()):
        raise ValueError("tree sweep inputs must be contiguous")
    if pmatrix.data_ptr() % 16:
        raise ValueError("pmatrix must be 16-byte aligned")

    nt = tip_blocked.shape[0]
    R, S = cfg.rate_cats, cfg.states
    sr = _scaler_rows(cfg)
    bf16 = cfg.dtype == torch.bfloat16
    ops_dev, slots_dev, export_dev = prog.device_tables(device, mode, carry)
    n_exp = slots_dev.shape[0]
    clv_rows = torch.empty((n_exp, nt, R, S, tb), dtype=torch.float32,
                           device=device)
    scal_rows = torch.empty((n_exp, nt, sr, tb), dtype=torch.int32,
                            device=device)
    lib = _build.library()
    base = None if p_base is None else p_base.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if mode == WIDE:
            # the P-matrices laid out [P, R, S, WIDE_P_ROWS] (transposed,
            # rows padded) in room the wrapper gives, then the sweep
            n_slots = wide_device_table(prog)[1]
            items = wide_items(prog, R, device)
            pt = torch.empty(pmatrix.shape[0] * R * S * WIDE_P_ROWS,
                             dtype=torch.float32, device=device)
            err = lib.tree_sweep_wide_launch(
                ops_dev.data_ptr(), prog.n_ops, items.data_ptr(),
                items.shape[0], pmatrix.data_ptr(), base,
                pmatrix.shape[0], pt.data_ptr(), tip_blocked.data_ptr(),
                cfg.tips, clv_rows.data_ptr(), scal_rows.data_ptr(), nt, tb,
                R, S, n_slots, int(cfg.per_rate_scalers),
                ctypes.c_float(cfg.scale_threshold),
                ctypes.c_float(cfg.scale_factor), stream)
        elif mode == "mma":
            pfrag = pmatrix_fragments(pmatrix, cfg)
            err = lib.tree_sweep_mma_launch(
                ops_dev.data_ptr(), prog.n_ops, pfrag.data_ptr(), base,
                tip_blocked.data_ptr(), cfg.tips, slots_dev.data_ptr(),
                n_exp, export_dev.data_ptr(), clv_rows.data_ptr(),
                scal_rows.data_ptr(), nt, tb, R, S, prog.pool_size,
                int(bf16), ctypes.c_float(cfg.scale_threshold),
                ctypes.c_float(cfg.scale_factor), stream)
        else:
            # the bf16 P-matrices widened to f32 (exact): the kernel stages
            # and reads f32 P rows whatever its pool's type; the generic
            # row-group form lays them out first in room the wrapper gives
            pmat = pmatrix.float() if bf16 else pmatrix
            groups = generic_groups(cfg)
            pg = torch.empty(pmat.shape[0] * generic_matrix_floats(cfg),
                             dtype=torch.float32, device=device) \
                if groups else pmat
            err = lib.tree_sweep_launch(
                ops_dev.data_ptr(), prog.n_ops, pmat.data_ptr(), base,
                pmat.shape[0], pg.data_ptr(), tip_blocked.data_ptr(),
                cfg.tips, slots_dev.data_ptr(), n_exp,
                export_dev.data_ptr(), clv_rows.data_ptr(),
                scal_rows.data_ptr(), nt, tb, R, S, prog.pool_size,
                int(cfg.per_rate_scalers), int(bf16), groups,
                ctypes.c_float(cfg.scale_threshold),
                ctypes.c_float(cfg.scale_factor), stream)
    if err != 0:
        raise RuntimeError(f"tree_sweep ({mode}) kernel launch failed: CUDA "
                           f"error {err} ({_build.error_string(err)})")
    sweep.launches += 1
    sweep.launches_by_mode[mode] += 1
    if mode == "fma" and generic(cfg):
        sweep.launches_generic += 1
    if bf16:
        sweep.launches_bf16[mode] += 1
    return clv_rows, scal_rows


# kernel launches by this wrapper (plain runs excluded), in all, per mode,
# of the "fma" form's generic instantiation and per mode with a bf16 pool
# (both within the per-mode counts; the wide form's are
# launches_by_mode[WIDE]), and the sweeps above MAX_STATES that the engine
# ran on its dense path instead (engine._tree_rows)
sweep.launches = 0
sweep.launches_by_mode = {mode: 0 for mode in SWEEP_MODES}
sweep.launches_generic = 0
sweep.launches_bf16 = {mode: 0 for mode in MODES}
sweep.wide_dense_calls = 0


def unblock_clv_row(row_blocked):
    """[NT, R, S, TB] -> [R, S, NT*TB]."""
    nt, R, S, tb = row_blocked.shape
    return row_blocked.permute(1, 2, 0, 3).reshape(R, S, nt * tb)


def unblock_scaler_row(row_blocked):
    """[NT, 1, TB] -> [NT*TB]; per-rate [NT, R, TB] -> [R, NT*TB]."""
    nt, sr, tb = row_blocked.shape
    if sr == 1:
        return row_blocked.reshape(nt * tb)
    return row_blocked.permute(1, 0, 2).reshape(sr, nt * tb)
