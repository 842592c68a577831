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

The op table `[OPS, 9] int32` is runtime data for the kernel, so one
compiled kernel serves every topology and op count.  That replaces both of
the JAX package's static kernels: the unrolled `_tree_kernel_static`
(<= 512 ops) and the segmented `_tree_kernel_static_seg` (513-4096 ops),
whose segments exist only to bound Mosaic's compile time.

`sweep()` is the kernel wrapper; `sweep_reference()` is its plain PyTorch
version with the same signature and output.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import PartitionConfig

OP_COLS = 9
# columns: 0 parent_slot, 1 c1_tip_idx, 2 c1_slot, 3 c1_is_tip,
#          4 c2_tip_idx, 5 c2_slot, 6 c2_is_tip, 7 pmatrix1, 8 pmatrix2

# Site-block sizes the kernel takes (one thread per site, one CTA per block).
SITE_BLOCKS = (256, 128, 64, 32)
# Dynamic shared memory one block may opt in to on an H100 (sm_90):
# 227 KB = 232,448 bytes.  The wrapper also checks the device's own limit.
SMEM_LIMIT = 232448
# State counts the kernel is instantiated for (bin, nt, gt10, gt16, aa).
KERNEL_STATES = (2, 4, 10, 16, 20)


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

    def device_tables(self, device: torch.device):
        """(ops [OPS, 9] int32, export slots [E] int32) on `device`."""
        key = str(device)
        if key not in self._device:
            slots = np.asarray([s for _, s in self.exports], np.int32)
            self._device[key] = (
                torch.as_tensor(self.ops, device=device).contiguous(),
                torch.as_tensor(slots, device=device).contiguous())
        return self._device[key]


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


def smem_bytes(prog: TreeVmemProgram, cfg: PartitionConfig, tb: int) -> int:
    """Dynamic shared memory of one CTA at site-block size tb: the CLV
    pool [pool_size, R*S, tb] f32 and the scaler pool [pool_size, SR, tb]
    int32."""
    return prog.pool_size * (cfg.span + _scaler_rows(cfg)) * tb * 4


def pick_site_block(prog: TreeVmemProgram, cfg: PartitionConfig,
                    smem_limit: int = SMEM_LIMIT) -> int:
    """Largest site block in SITE_BLOCKS that divides sites_padded and
    whose pools fit `smem_limit` bytes; 0 if none does."""
    for tb in SITE_BLOCKS:
        if (cfg.sites_padded % tb == 0
                and smem_bytes(prog, cfg, tb) <= smem_limit):
            return tb
    return 0


def unsupported(prog: Optional[TreeVmemProgram], cfg: PartitionConfig,
                smem_limit: int = SMEM_LIMIT) -> Optional[str]:
    """Why the tree sweep cannot take this case, or None if it can."""
    if prog is None or prog.n_ops == 0:
        return "the operation list is not a full forest of new CLVs"
    if cfg.dtype != torch.float32:
        return f"the tree-sweep kernel is f32 only, got {cfg.dtype}"
    if cfg.states not in KERNEL_STATES:
        return (f"the tree-sweep kernel is built for states "
                f"{KERNEL_STATES}, got {cfg.states}")
    if pick_site_block(prog, cfg, smem_limit) == 0:
        return (f"a {SITE_BLOCKS[-1]}-site block needs "
                f"{smem_bytes(prog, cfg, SITE_BLOCKS[-1])} bytes of shared "
                f"memory for a pool of {prog.pool_size} slots, above the "
                f"{smem_limit}-byte limit, or no block size in {SITE_BLOCKS} "
                f"divides {cfg.sites_padded} sites")
    return None


def _check_inputs(tip_blocked, pmatrix, prog, cfg, tb):
    nt, tips, tb_in = tip_blocked.shape
    if tb_in != tb or nt * tb != cfg.sites_padded or tips != cfg.tips:
        raise ValueError(
            f"tip_blocked {tuple(tip_blocked.shape)} does not match "
            f"[{cfg.sites_padded // tb}, {cfg.tips}, {tb}]")
    if tip_blocked.dtype != torch.int32:
        raise TypeError(f"tip_blocked must be int32, got {tip_blocked.dtype}")
    R, S = cfg.rate_cats, cfg.states
    if pmatrix.dim() != 4 or tuple(pmatrix.shape[1:]) != (R, S, S):
        raise ValueError(f"pmatrix {tuple(pmatrix.shape)} is not [P, {R}, "
                         f"{S}, {S}]")
    if int(prog.ops[:, [7, 8]].max()) >= pmatrix.shape[0]:
        raise ValueError("the schedule reads a P-matrix beyond the buffer")


def sweep_reference(tip_blocked, pmatrix, prog: TreeVmemProgram,
                    cfg: PartitionConfig, tb: int):
    """Plain PyTorch version of the tree sweep (same contract as sweep()).

    A Python loop over the schedule rows, each row one einsum per child
    over all site blocks at once.  Returns (clv_rows [E, NT, R, S, TB],
    scaler_rows [E, NT, SR, TB] int32) in prog.exports order."""
    _check_inputs(tip_blocked, pmatrix, prog, cfg, tb)
    nt = tip_blocked.shape[0]
    R, S = cfg.rate_cats, cfg.states
    sr = _scaler_rows(cfg)
    dev, dtype = tip_blocked.device, pmatrix.dtype
    pool = torch.zeros((prog.pool_size, nt, R, S, tb), dtype=dtype,
                       device=dev)
    spool = torch.zeros((prog.pool_size, nt, sr, tb), dtype=torch.int32,
                        device=dev)
    shifts = torch.arange(S, dtype=torch.int32, device=dev)[:, None]

    def child(tip, slot, is_tip):
        if is_tip:
            bits = ((tip_blocked[:, tip, None, :] >> shifts) & 1).to(dtype)
            return bits[:, None].expand(nt, R, S, tb), 0      # [NT,R,S,TB]
        return pool[slot], spool[slot]

    for (p_slot, t1, s1, f1, t2, s2, f2, pm1, pm2) in prog.ops.tolist():
        c1, sc1 = child(t1, s1, f1)
        c2, sc2 = child(t2, s2, f2)
        left = torch.einsum("rij,nrjt->nrit", pmatrix[pm1], c1)
        right = torch.einsum("rij,nrjt->nrit", pmatrix[pm2], c2)
        parent = left * right                                 # [NT,R,S,TB]
        below = parent < cfg.scale_threshold
        if cfg.per_rate_scalers:
            mask = below.all(dim=2)                           # [NT, R, TB]
        else:
            mask = below.all(dim=2).all(dim=1, keepdim=True)  # [NT, 1, TB]
        pool[p_slot] = torch.where(mask[:, :, None],
                                   parent * cfg.scale_factor, parent)
        spool[p_slot] = mask.to(torch.int32) + sc1 + sc2

    slots = [slot for _, slot in prog.exports]
    return pool[slots], spool[slots]


def sweep(tip_blocked, pmatrix, prog: TreeVmemProgram, cfg: PartitionConfig,
          tb: int):
    """Run the tree sweep: the CUDA kernel on CUDA tensors, the plain
    version (sweep_reference) on CPU tensors, an error on anything else.

    tip_blocked: [NT, tips, TB] int32 packed state bitmasks (block-major)
    pmatrix:     [P, R, S, S] f32
    Returns (clv_rows [E, NT, R, S, TB] f32, scaler_rows [E, NT, SR, TB]
    int32) for the E exported rows, SR = R under per-rate scalers else 1.
    """
    if tip_blocked.device.type == "cpu" and pmatrix.device.type == "cpu":
        return sweep_reference(tip_blocked, pmatrix, prog, cfg, tb)
    if tip_blocked.device.type != "cuda" or pmatrix.device != \
            tip_blocked.device:
        raise ValueError(
            f"tree sweep needs both inputs on one CUDA device or both on "
            f"the CPU, got {tip_blocked.device} and {pmatrix.device}")
    from .. import _build

    device = tip_blocked.device
    reason = unsupported(prog, cfg, _build.max_shared_memory(device))
    if reason is not None:
        raise ValueError(f"tree sweep kernel cannot take this case: {reason}")
    _check_inputs(tip_blocked, pmatrix, prog, cfg, tb)
    if tb not in SITE_BLOCKS:
        raise ValueError(f"site block {tb} not in {SITE_BLOCKS}")
    if smem_bytes(prog, cfg, tb) > _build.max_shared_memory(device):
        raise ValueError(f"site block {tb} needs {smem_bytes(prog, cfg, tb)}"
                         f" bytes of shared memory")
    if pmatrix.dtype != torch.float32:
        raise TypeError(f"pmatrix must be f32, got {pmatrix.dtype}")
    if not (tip_blocked.is_contiguous() and pmatrix.is_contiguous()):
        raise ValueError("tree sweep inputs must be contiguous")
    if pmatrix.data_ptr() % 16:
        raise ValueError("pmatrix must be 16-byte aligned")

    nt = tip_blocked.shape[0]
    R, S = cfg.rate_cats, cfg.states
    sr = _scaler_rows(cfg)
    ops_dev, slots_dev = prog.device_tables(device)
    n_exp = slots_dev.shape[0]
    clv_rows = torch.empty((n_exp, nt, R, S, tb), dtype=torch.float32,
                           device=device)
    scal_rows = torch.empty((n_exp, nt, sr, tb), dtype=torch.int32,
                            device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tree_sweep_launch(
            ops_dev.data_ptr(), prog.n_ops, pmatrix.data_ptr(),
            tip_blocked.data_ptr(), cfg.tips, slots_dev.data_ptr(), n_exp,
            clv_rows.data_ptr(), scal_rows.data_ptr(),
            nt, tb, R, S, prog.pool_size, int(cfg.per_rate_scalers),
            ctypes.c_float(cfg.scale_threshold),
            ctypes.c_float(cfg.scale_factor), stream)
    if err != 0:
        raise RuntimeError(f"tree_sweep kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    sweep.launches += 1
    return clv_rows, scal_rows


sweep.launches = 0   # kernel launches by this wrapper (plain runs excluded)


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
