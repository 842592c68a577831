"""Likelihood engine: a topology compiled once on the host, then
P-matrices + CLV sweep + log-likelihood on tensors.

Counterpart of libpll2_tpu/engine.py: the forward step (`compile_tree`,
`Model`, `make_model`, `_sweep`, `loglikelihood`), the training step
(`optimize_root_branch`) and the all-edge engine over the all-directions
message sweep (`compile_tree_full`, `_sweep_all`,
`all_edge_loglikelihoods`, `optimize_branch_lengths`, `score_placements`,
`branch_derivatives`) with the analytic reverse pass built on it
(`loglikelihood_analytic`), and the sharded training step
(`dryrun_multichip`).  `loglikelihood`, `optimize_root_branch`,
`branch_derivatives` and `all_edge_loglikelihoods` take `group=`: the
process group whose ranks hold the site slices (parallel/); each rank
passes the whole partition's `cfg` and its slices of the site-indexed
inputs, and gets the whole partition's results.  The smoothing and the
derivatives have one body each (`_optimize_branch_lengths`,
`_branch_derivatives`) over K partitions that share the topology and the
branch lengths: the entry points here call them with one partition, and
multipartition.py with K, the (d1, d2) summed through the chain rule of
the per-partition multipliers.  The forward CLV sweep runs in a
hand-written CUDA tree-sweep kernel on CUDA tensors (ops/partials_tree.py:
the "fma" or the tensor-core "mma" form, picked by `partials_tree.choose`)
and in the dense level-batched path (ops/partials.py) on CPU tensors, when
`cfg.use_kernel` is False, or, under the default None, where no sweep form
takes the case (f64 among them: `kernel_choice_for` warns).  The
all-directions message sweep runs in one hand-written CUDA kernel launch
on CUDA tensors at f32 (ops/message_sweep.py) and in the dense path on CPU
tensors, when `cfg.use_kernel` is False, or where the kernel does not take
the case (`message_sweep_choice`).  The smoothing's Newton steps of a
colour class (sumtables, steps, the f32 keep) run in one hand-written CUDA
kernel launch on CUDA tensors at f32 for one partition
(ops/newton_edges.py) and on the plain path elsewhere (`newton_choice`).
PyTorch runs eagerly, so there is no jit and no static-argument hashing.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import forward_graph, spans
from .config import PartitionConfig
from .constants import AB_NONE, tip_mask_torch_dtype
from .ops import derivatives as derivatives_ops
from .ops import edge_score as edge_score_ops
from .ops import likelihood as likelihood_ops
from .ops import message_sweep as message_sweep_ops
from .ops import newton_edges as newton_edges_ops
from .ops import partials as partials_ops
from .ops import partials_tree
from .ops import pmatrix as pmatrix_ops
from .parallel import sharding
from .partition import Operation, levelize_operations
from .tree import create_operations, traverse
from .tree.utree import UTree


@dataclasses.dataclass(frozen=True, eq=False)
class TreeProgram:
    """Host-compiled static form of one topology."""
    level_ops: np.ndarray          # [L, W, 8] int32 (dense path)
    vmem_prog: Optional[partials_tree.TreeVmemProgram]  # tree-sweep schedule
    pmatrix_indices: np.ndarray    # [E] int32: branch i -> pmatrix slot
    default_branch_lengths: np.ndarray  # [E] f64 (from the newick)
    root_clv: int
    root_scaler: int
    root_back_clv: int
    root_back_scaler: int
    root_pmatrix: int
    tip_count: int
    inner_count: int
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_branches(self) -> int:
        return len(self.pmatrix_indices)

    def pmatrix_index_tensor(self, device: torch.device) -> torch.Tensor:
        """pmatrix_indices as an int64 tensor on `device` (cached)."""
        key = str(device)
        if key not in self._device:
            self._device[key] = torch.as_tensor(
                self.pmatrix_indices, dtype=torch.int64, device=device)
        return self._device[key]


def compile_tree(tree: UTree, cfg: PartitionConfig) -> TreeProgram:
    """Traverse + compile + levelize + schedule one topology."""
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    level_ops = levelize_operations(ops, cfg)
    root = tree.vroot
    # rows the logL reduction consumes; tips are re-expanded from tipchars
    # instead of exported
    exports = [i for i in (root.clv_index, root.back.clv_index)
               if i >= cfg.tips]
    vmem_prog = partials_tree.schedule(ops, cfg.tips, exports)
    return TreeProgram(
        level_ops=level_ops,
        vmem_prog=vmem_prog,
        pmatrix_indices=np.asarray(pmat_idx, dtype=np.int32),
        default_branch_lengths=np.asarray(branches, dtype=np.float64),
        root_clv=root.clv_index,
        root_scaler=root.scaler_index,
        root_back_clv=root.back.clv_index,
        root_back_scaler=root.back.scaler_index,
        root_pmatrix=root.pmatrix_index,
        tip_count=tree.tip_count,
        inner_count=tree.inner_count,
    )


class Model(nn.Module):
    """Model parameters (eigen factors precomputed on the host), held as
    buffers so that `.to(device)` moves them together."""

    FIELDS = ("eigenvals", "eigenvecs", "inv_eigenvecs", "frequencies",
              "rates", "rate_weights", "prop_invar", "params_indices")

    def __init__(self, eigenvals, eigenvecs, inv_eigenvecs, frequencies,
                 rates, rate_weights, prop_invar, params_indices):
        super().__init__()
        self.register_buffer("eigenvals", eigenvals)            # [M, S]
        self.register_buffer("eigenvecs", eigenvecs)            # [M, S, S]
        self.register_buffer("inv_eigenvecs", inv_eigenvecs)    # [M, S, S]
        self.register_buffer("frequencies", frequencies)        # [M, S]
        self.register_buffer("rates", rates)                    # [R]
        self.register_buffer("rate_weights", rate_weights)      # [R]
        self.register_buffer("prop_invar", prop_invar)          # [M]
        self.register_buffer("params_indices", params_indices)  # [R] int32

    @property
    def cat_freqs(self):
        return self.frequencies[self.params_indices.long()]

    @property
    def cat_pinv(self):
        return self.prop_invar[self.params_indices.long()]


def make_model(subst_params, frequencies, rates, rate_weights=None,
               prop_invar=None, params_indices=None, dtype=torch.float64,
               device="cuda") -> Model:
    """Build a Model from raw parameters: eigendecompose each rate matrix
    on the host (models/ratematrix.py) and stack the factors.

    subst_params: [M, S*(S-1)/2]; frequencies: [M, S]; rates: [R].
    """
    from .models import ratematrix
    subst_params = np.atleast_2d(np.asarray(subst_params, dtype=np.float64))
    frequencies = np.atleast_2d(np.asarray(frequencies, dtype=np.float64))
    M, S = frequencies.shape
    R = len(rates)
    evals = np.zeros((M, S))
    evecs = np.zeros((M, S, S))
    inv_evecs = np.zeros((M, S, S))
    for m in range(M):
        freqs = ratematrix.normalize_frequencies(frequencies[m])
        frequencies[m] = freqs
        evals[m], evecs[m], inv_evecs[m] = ratematrix.update_eigen(
            subst_params[m], freqs)
    if rate_weights is None:
        rate_weights = np.full(R, 1.0 / R)
    if prop_invar is None:
        prop_invar = np.zeros(M)
    if params_indices is None:
        params_indices = np.zeros(R, dtype=np.int32)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return Model(t(evals), t(evecs), t(inv_evecs), t(frequencies), t(rates),
                 t(rate_weights), t(prop_invar),
                 t(params_indices, torch.int32))


def expand_tipchars(tipchars, states: int, dtype):
    """Bit-decode packed tip state masks [tips, T] (int32, or int64 above
    32 states) into 0/1 tip CLVs [tips, S, T]."""
    shifts = torch.arange(states, dtype=tipchars.dtype,
                          device=tipchars.device)[None, :, None]
    return ((tipchars[:, None, :] >> shifts) & 1).to(dtype)


def pad_tipchars(tipchars: np.ndarray, cfg: PartitionConfig) -> np.ndarray:
    """Pad encoded tip characters [tips, sites or sites_alloc] (bitmask) to
    the engine's [tips, T] input (padding columns = gap state, so padded
    CLV entries are 1.0 and inert under scaling checks): int32 up to 32
    states, int64 from 33 to 64 (constants.tip_mask_dtype; a mask with bit
    31 or 63 set reads negative).

    Under ascertainment bias the phantom per-state columns are stamped with
    pure states (phantom site j observes state j at every tip,
    pll.c:1006-1018) whether or not the input carries them."""
    from .constants import AB_NONE, gap_state_mask, tip_mask_dtype
    mask = tip_mask_dtype(cfg.states)
    out = np.full((cfg.tips, cfg.sites_padded), gap_state_mask(cfg.states),
                  dtype=mask)
    out[:, :tipchars.shape[1]] = tipchars.astype(mask)
    if cfg.asc_bias != AB_NONE:
        out[:, cfg.sites:cfg.sites + cfg.states] = \
            1 << np.arange(cfg.states, dtype=mask)
    return out


def kernel_choice(program: TreeProgram, cfg: PartitionConfig,
                  device: torch.device) -> Optional[tuple]:
    """(site block, mode) of the tree-sweep kernel for this call, or None
    for the dense path.  See PartitionConfig.use_kernel and .sweep_mode;
    `kernel_choice_for` decides, from `device`'s shared-memory limit and SM
    count (an H100's limit, and no SM count, off the card)."""
    limit, sm_count = partials_tree.SMEM_LIMIT, None
    if device.type == "cuda" and cfg.use_kernel is not False:
        from . import _build
        limit = _build.max_shared_memory(device)
        sm_count = torch.cuda.get_device_properties(
            device).multi_processor_count
    return kernel_choice_for(program, cfg, device, limit, sm_count)


def kernel_choice_for(program: TreeProgram, cfg: PartitionConfig,
                      device: torch.device, limit: int,
                      sm_count: Optional[int] = None) -> Optional[tuple]:
    """The decision of `kernel_choice` at a shared-memory limit and SM
    count, made on the host before any launch.  use_kernel False, or None
    on the CPU: None (the dense path).  A case that no form takes
    (`partials_tree.unsupported`: f64, more than 32 rates, a pool above
    the limit, ...): under use_kernel=None the dense path computes it on
    `device`, with one UserWarning naming the reason, as the JAX package
    leaves such a case to XLA; under use_kernel=True it raises."""
    if cfg.use_kernel is False:
        return None
    if cfg.use_kernel is None and device.type == "cpu":
        return None
    prog = program.vmem_prog
    if cfg.sweep_mode is None:
        choice = partials_tree.choose(prog, cfg, limit, sm_count)
        # the form whose refusal is reported
        mode = partials_tree.WIDE if cfg.states > partials_tree.MAX_STATES \
            else "fma"
    else:
        mode = cfg.sweep_mode
        choice = None
        if partials_tree.unsupported(prog, cfg, limit, mode) is None:
            choice = (partials_tree.pick_site_block(prog, cfg, limit, mode,
                                                    sm_count), mode)
    if choice is None:
        reason = partials_tree.unsupported(prog, cfg, limit, mode)
        if cfg.use_kernel is None:
            warnings.warn(f"the dense path computes this call on {device}: "
                          f"the tree-sweep kernel cannot take it: {reason}",
                          UserWarning, stacklevel=3)
            return None
        raise ValueError(f"tree-sweep kernel cannot take this case: {reason}"
                         f" (use_kernel=False selects the dense path)")
    return choice


def pmatrix_buffer(program: TreeProgram, cfg: PartitionConfig, model: Model,
                   branch_lengths):
    """P-matrices of every branch, scattered into a [P, R, S, S] buffer
    with one slot per possible pmatrix index (= clv index space)."""
    pmats = pmatrix_ops.compute_pmatrices(
        branch_lengths, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=cfg.dtype)                # [E, R, S, S]
    device = pmats.device
    num_slots = int(program.pmatrix_indices.max()) + 1
    pmatrix = torch.zeros((num_slots,) + pmats.shape[1:], dtype=cfg.dtype,
                          device=device)
    pmatrix[program.pmatrix_index_tensor(device)] = pmats
    return pmatrix


def block_tips(tipchars, cfg: PartitionConfig, tb: int):
    """[tips, T] packed tip states -> block-major [T/tb, tips, tb], int32
    up to 32 states, int64 above (the wide sweep's masks)."""
    nt = cfg.sites_padded // tb
    return tipchars.to(tip_mask_torch_dtype(cfg.states)) \
        .reshape(cfg.tips, nt, tb).permute(1, 0, 2).contiguous()


def _sweep(program: TreeProgram, cfg: PartitionConfig, model: Model,
           branch_lengths, tipchars, pattern_weights):
    """P-matrices + full CLV sweep.  Returns (row view, pmatrix).

    tipchars: packed bitmask states [tips, T] int32 (int64 above 32
    states, pad_tipchars).
    """
    pmatrix = pmatrix_buffer(program, cfg, model, branch_lengths)
    choice = kernel_choice(program, cfg, tipchars.device)
    return _tree_rows(program, cfg, pmatrix, tipchars, choice), pmatrix


def _tree_rows(program: TreeProgram, cfg: PartitionConfig, pmatrix,
               tipchars, choice):
    """The CLV sweep from the P-matrices under `choice` (kernel_choice's):
    a row view."""
    dtype = cfg.dtype
    R, S, T = cfg.rate_cats, cfg.states, tipchars.shape[-1]
    device = tipchars.device
    if choice is not None:
        # shared-memory sweep: tips stay packed, only root rows are written
        tb, mode = choice
        clv_rows, scal_rows = partials_tree.sweep(
            block_tips(tipchars, cfg, tb), pmatrix, program.vmem_prog, cfg,
            tb, mode=mode)
        return _TreeView(clv_rows, scal_rows, program.vmem_prog,
                         tipchars, cfg)

    if S > partials_tree.MAX_STATES:
        partials_tree.sweep.wide_dense_calls += 1
    with spans.span("sweep"):
        clv = torch.zeros((cfg.num_clvs + 1, R, S, T), dtype=dtype,
                          device=device)
        clv[:cfg.tips] = expand_tipchars(tipchars, S, dtype)[:, None]
        sshape = ((cfg.scale_buffers + 2, R, T) if cfg.per_rate_scalers
                  else (cfg.scale_buffers + 2, T))
        scalers = torch.zeros(sshape, dtype=torch.int32, device=device)
        clv, scalers = partials_ops.update_partials(
            clv, scalers, pmatrix, program.level_ops, cfg)
    return _StandardView(clv, scalers)


class _StandardView:
    """Row accessors over dense sweep results."""

    def __init__(self, clv, scalers):
        self._clv = clv
        self._scalers = scalers

    def clv_row(self, index: int):
        return self._clv[index]                               # [R, S, T]

    def scaler_row(self, index: int):
        return self._scalers[index]                           # [T] / [R, T]


class _TreeView:
    """Row accessors over tree-sweep results: only exported rows exist;
    tip rows are re-expanded from the packed bitmasks on demand, and scaler
    rows that were not exported are zeros."""

    def __init__(self, clv_rows, scal_rows, vmem_prog, tipchars,
                 cfg: PartitionConfig):
        self._clv_rows = clv_rows            # [E, NT, R, S, TB]
        self._scal_rows = scal_rows          # [E, NT, SR, TB]
        self._prog = vmem_prog
        self._tipchars = tipchars
        self._cfg = cfg

    def clv_row(self, index: int):
        cfg = self._cfg
        if index < cfg.tips:
            tip = expand_tipchars(self._tipchars[index:index + 1],
                                  cfg.states, cfg.dtype)[0]   # [S, T]
            return tip[None].expand(cfg.rate_cats, cfg.states, tip.shape[-1])
        row = self._clv_rows[self._prog.export_clv_map[index]]
        return partials_tree.unblock_clv_row(row)

    def scaler_row(self, index: int):
        cfg = self._cfg
        if index in self._prog.export_scaler_map:
            row = self._scal_rows[self._prog.export_scaler_map[index]]
            return partials_tree.unblock_scaler_row(row)
        shape = ((cfg.rate_cats, cfg.sites_padded) if cfg.per_rate_scalers
                 else (cfg.sites_padded,))
        return torch.zeros(shape, dtype=torch.int32,
                           device=self._tipchars.device)


def _local(cfg: PartitionConfig, group, tipchars) -> PartitionConfig:
    """The configuration of this rank's site slice (cfg without a
    group), checked against the width of its inputs."""
    if group is None:
        return cfg
    cfg = sharding.local_config(cfg, group)
    sharding.check_slice(cfg, tipchars)
    return cfg


def _root_logl(program: TreeProgram, cfg: PartitionConfig, model: Model,
               view, pmatrix, pattern_weights, invariant, group=None):
    """The reduction across the root edge from the sweep's row view."""
    return likelihood_ops.edge_loglikelihood(
        view.clv_row(program.root_clv),
        view.scaler_row(program.root_scaler if program.root_scaler >= 0
                        else cfg.scaler_zero),
        view.clv_row(program.root_back_clv),
        view.scaler_row(program.root_back_scaler
                        if program.root_back_scaler >= 0
                        else cfg.scaler_zero),
        pmatrix[program.root_pmatrix],
        model.cat_freqs, model.rate_weights, model.cat_pinv,
        invariant, pattern_weights, cfg, group=group)


_graphs = forward_graph.Cache()


def loglikelihood(program: TreeProgram, cfg: PartitionConfig, model: Model,
                  branch_lengths, tipchars, pattern_weights, invariant,
                  group=None):
    """Full-tree log-likelihood across the root edge.

    tipchars: [tips, T] packed state bitmasks, int32 (int64 above 32
    states: pad_tipchars); pattern_weights: [T];
    invariant: [T] int32 (-1 = variant).  With `group`, T is this rank's
    slice and the sum runs over every rank's.

    A call on the card that repeats an earlier call's program, model and
    alignment tensors replays that call's device work as CUDA graphs, with
    the same kernels and ops and the same result (forward_graph.py);
    loglikelihood.graph_captures, .graph_replays and .eager_calls count
    the calls each way.
    """
    with spans.span("forward"):
        cfg = _local(cfg, group, tipchars)
        device = tipchars.device
        choice = kernel_choice(program, cfg, device)

        # the three stages a graph each; eager runs them in turn
        def pmatrices(bl):
            return pmatrix_buffer(program, cfg, model, bl)

        def rows(pmatrix):
            return _tree_rows(program, cfg, pmatrix, tipchars, choice)

        def root(view, pmatrix):
            return _root_logl(program, cfg, model, view, pmatrix,
                              pattern_weights, invariant, group)

        def eager():
            pmatrix = pmatrices(branch_lengths)
            return root(rows(pmatrix), pmatrix)

        tensors = [getattr(model, f) for f in Model.FIELDS] + \
            [tipchars, pattern_weights, invariant]
        capturing = device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        if not forward_graph.eligible(device, group, choice,
                                      tensors + [branch_lengths],
                                      torch.is_grad_enabled(), capturing):
            _counters.eager_calls += 1
            return eager()
        bl = branch_lengths if isinstance(branch_lengths, torch.Tensor) \
            else torch.as_tensor(np.asarray(branch_lengths))
        logl, how = _graphs.call(
            forward_graph.key(program, cfg, device, tensors, bl),
            (program, *tensors), eager,
            lambda: forward_graph.capture((pmatrices, rows, root), eager,
                                          device, bl),
            lambda graphs: graphs.replay(bl))
        setattr(_counters, how, getattr(_counters, how) + 1)
        return logl


# calls by path: captured (the call that captures runs eager on the capture
# stream), replayed, and eager (not eligible, or before the capture); the
# function holds them, and counts on itself under a wrapper that takes its
# name in the module
loglikelihood.graph_captures = 0
loglikelihood.graph_replays = 0
loglikelihood.eager_calls = 0
_counters = loglikelihood


def optimize_root_branch(program: TreeProgram, cfg: PartitionConfig,
                         model: Model, branch_lengths, tipchars,
                         pattern_weights, invariant, newton_iters: int = 10,
                         group=None):
    """One 'training step': CLV sweep, then Newton optimization of the
    root branch length from analytic (d1, d2) (newton.c:31-100).

    The sweep is the same as loglikelihood's (the tree-sweep kernel on
    CUDA tensors).  With `group`, (d1, d2) are summed over the ranks in
    every Newton iteration, so every rank takes the same steps.  Returns
    (new_branch_lengths, logl_before)."""
    cfg = _local(cfg, group, tipchars)
    view, pmatrix = _sweep(program, cfg, model, branch_lengths,
                           tipchars, pattern_weights)
    rs = view.scaler_row(program.root_scaler if program.root_scaler >= 0
                         else cfg.scaler_zero)
    rbs = view.scaler_row(program.root_back_scaler
                          if program.root_back_scaler >= 0
                          else cfg.scaler_zero)
    root_clv = view.clv_row(program.root_clv)
    root_back_clv = view.clv_row(program.root_back_clv)

    logl = likelihood_ops.edge_loglikelihood(
        root_clv, rs, root_back_clv, rbs,
        pmatrix[program.root_pmatrix], model.cat_freqs, model.rate_weights,
        model.cat_pinv, invariant, pattern_weights, cfg, group=group)

    idx = model.params_indices.long()
    sumtable = derivatives_ops.update_sumtable(
        root_clv, root_back_clv, rs, rbs, model.eigenvecs[idx],
        model.inv_eigenvecs[idx], model.cat_freqs, cfg,
        asc_scalers=None if cfg.per_rate_scalers else rs + rbs)

    # position of the root branch in the branch_lengths vector
    root_pos = int(np.nonzero(
        program.pmatrix_indices == program.root_pmatrix)[0][0])
    t = branch_lengths[root_pos]
    for _ in range(newton_iters):
        d1, d2 = derivatives_ops.likelihood_derivatives(
            sumtable, t, model.rates, model.eigenvals[idx], model.cat_pinv,
            model.rate_weights, model.cat_freqs, invariant, pattern_weights,
            cfg, group=group)
        # the JAX step has no non-finite guard here; keep its semantics
        t = derivatives_ops.newton_update(t, d1, d2, hold_nonfinite=False)
    new_bl = branch_lengths.clone()
    new_bl[root_pos] = t
    return new_bl, logl


# --------------------------------------------------------------------------
# Bidirectional message passing (all-edge engine)
# --------------------------------------------------------------------------
#
# Every *directed* message msg(u->v) — the CLV of node u in the direction
# of neighbor v — is the same binary operation as a CLV update, so one
# level-batched sweep over an extended operation list computes all 2E
# directional CLVs; every branch then has both facing CLVs at hand.


@dataclasses.dataclass(frozen=True, eq=False)
class FullTreeProgram:
    """All-directions message program for one topology."""
    cfg_ext: PartitionConfig        # row space extended to message slots
    level_ops: np.ndarray           # [L, W, 8] int32
    pmatrix_indices: np.ndarray     # [E] branch i -> pmatrix slot
    default_branch_lengths: np.ndarray
    edge_rows: np.ndarray           # [E, 4] int32: rowA, scalA, rowB, scalB
    edge_colors: np.ndarray         # [E] int32 proper edge coloring
    n_colors: int
    root_edge: int                  # branch position of the vroot edge
    tip_count: int
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    def level_ops_tensor(self, device: torch.device) -> torch.Tensor:
        """level_ops as an int64 tensor on `device` (cached): the table
        that message_sweep reads."""
        key = str(device)
        if key not in self._device:
            self._device[key] = torch.as_tensor(
                self.level_ops, dtype=torch.int64, device=device)
        return self._device[key]

    def edge_rows_tensor(self, device: torch.device) -> torch.Tensor:
        """edge_rows as an int64 [E, 4] tensor on `device` (cached): the
        rows the all-edge body and the Newton kernel read."""
        key = ("edge_rows", str(device))
        if key not in self._device:
            self._device[key] = torch.as_tensor(
                self.edge_rows, dtype=torch.int64, device=device)
        return self._device[key]

    def color_members(self, device: torch.device) -> list:
        """Each colour class's branch positions, ascending, as int64
        tensors on `device` (cached): read on the host from edge_colors,
        so that no class costs a device sync."""
        key = ("color_members", str(device))
        if key not in self._device:
            self._device[key] = [
                torch.as_tensor(np.flatnonzero(self.edge_colors == c),
                                dtype=torch.int64, device=device)
                for c in range(self.n_colors)]
        return self._device[key]


def compile_tree_full(tree: UTree, cfg: PartitionConfig) -> FullTreeProgram:
    """Compile msg(u->v) for every half-node g at an inner node u, where
    msg rows live after the tip rows; tips' messages are their tip CLVs."""
    inner = [n for n in tree.nodes if n.next is not None]
    half_nodes = [g for n in inner for g in n.roundabout()]
    msg_row = {g.node_index: cfg.tips + k
               for k, g in enumerate(half_nodes)}
    msg_scaler = {g.node_index: k for k, g in enumerate(half_nodes)}
    n_msgs = len(half_nodes)

    cfg_ext = dataclasses.replace(cfg, clv_buffers=n_msgs,
                                  scale_buffers=n_msgs)

    def incoming(s):  # message arriving through half-node s (from s.back)
        if s.back.next is None:     # tip neighbor
            return s.back.clv_index, -1
        return msg_row[s.back.node_index], msg_scaler[s.back.node_index]

    # Kahn ordering: a message is ready once its two feeding messages are
    ready = {g.node_index: False for g in half_nodes}
    ops = []
    emitted = 0
    while emitted < n_msgs:
        progress = False
        for g in half_nodes:
            if ready[g.node_index]:
                continue
            sibs = [s for s in g.roundabout() if s is not g]
            deps = [s for s in sibs if s.back.next is not None]
            if any(not ready[s.back.node_index] for s in deps):
                continue
            (c1, s1), (c2, s2) = incoming(sibs[0]), incoming(sibs[1])
            ops.append(Operation(
                parent_clv_index=msg_row[g.node_index],
                child1_clv_index=c1, child2_clv_index=c2,
                child1_matrix_index=sibs[0].back.pmatrix_index,
                child2_matrix_index=sibs[1].back.pmatrix_index,
                parent_scaler_index=msg_scaler[g.node_index],
                child1_scaler_index=s1, child2_scaler_index=s2))
            ready[g.node_index] = True
            emitted += 1
            progress = True
        if not progress:
            raise ValueError("cyclic message dependencies (corrupt tree)")

    level_ops = levelize_operations(ops, cfg_ext)

    # branch list in the same order as compile_tree's pmatrix_indices
    trav = traverse(tree.vroot)
    _, branches, pmat_idx = create_operations(trav)
    by_pmatrix = {}
    seen = set()
    for n in tree.nodes:
        for g in ([n] if n.next is None else list(n.roundabout())):
            key = tuple(sorted((g.node_index, g.back.node_index)))
            if key in seen:
                continue
            seen.add(key)
            by_pmatrix[g.back.pmatrix_index] = g

    edge_rows = np.zeros((len(pmat_idx), 4), np.int32)
    for i, p in enumerate(pmat_idx):
        g = by_pmatrix[p]
        # canonical orientation: row A = the PARENT side of the edge (the
        # end whose clv_index differs from the template pmatrix index)
        if g.clv_index == p:
            g = g.back
        a, sa = ((msg_row[g.node_index], msg_scaler[g.node_index])
                 if g.next is not None else (g.clv_index, -1))
        h = g.back
        b, sb = ((msg_row[h.node_index], msg_scaler[h.node_index])
                 if h.next is not None else (h.clv_index, -1))
        edge_rows[i] = (a, cfg_ext.scaler_zero if sa < 0 else sa,
                        b, cfg_ext.scaler_zero if sb < 0 else sb)

    # proper edge coloring (greedy; <= 4 colors on a binary tree): no two
    # branches of one color share an endpoint, so a simultaneous Newton
    # step within a class behaves like sequential smoothing
    colors = np.full(len(pmat_idx), -1, np.int32)
    used_at: dict[int, set] = {}
    for i, p in enumerate(pmat_idx):
        g = by_pmatrix[p]
        a = min(h.node_index for h in ([g] if g.next is None
                                       else list(g.roundabout())))
        b = min(h.node_index for h in ([g.back] if g.back.next is None
                                       else list(g.back.roundabout())))
        taken = used_at.get(a, set()) | used_at.get(b, set())
        c = 0
        while c in taken:
            c += 1
        colors[i] = c
        used_at.setdefault(a, set()).add(c)
        used_at.setdefault(b, set()).add(c)

    root_edge = int(np.nonzero(
        np.asarray(pmat_idx) == tree.vroot.pmatrix_index)[0][0])
    return FullTreeProgram(
        cfg_ext=cfg_ext,
        level_ops=level_ops,
        pmatrix_indices=np.asarray(pmat_idx, np.int32),
        default_branch_lengths=np.asarray(branches, np.float64),
        edge_rows=edge_rows,
        edge_colors=colors,
        n_colors=int(colors.max()) + 1,
        root_edge=root_edge,
        tip_count=tree.tip_count,
    )


def _asc_scalers(scalers, rows, cfg: PartitionConfig):
    """Per-site scaler sum of edges for the asc-bias phantom-column fold in
    update_sumtable (core_derivatives.c:884-892); None when the correction
    does not need absolute phantom likelihoods.  rows: [..., 4] edge rows.
    PartitionConfig refuses asc bias with per-rate scalers, so nothing is
    dropped here."""
    from .constants import AB_FELSENSTEIN, AB_LEWIS
    if cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN):
        return scalers[rows[..., 1]] + scalers[rows[..., 3]]
    return None


def message_sweep_choice(cfg: PartitionConfig, device: torch.device,
                         grad: bool = False) -> bool:
    """Whether a message sweep on `device` runs the kernel (True) or the
    dense path (False), decided on the host from what the call shows:
    the kernel on a CUDA device, where message_sweep.unsupported takes the
    case and no input needs grad (the kernel has no backward).  use_kernel
    False, or a CPU device: the dense path.  A refused case: under
    use_kernel=None the dense path, with one UserWarning naming the reason;
    under use_kernel=True a ValueError."""
    if cfg.use_kernel is False or device.type != "cuda":
        return False
    reason = message_sweep_ops.unsupported(cfg)
    if reason is None and grad:
        reason = "an input requires grad (the kernel has no backward)"
    if reason is None:
        return True
    if cfg.use_kernel is None:
        warnings.warn(f"the dense path computes this message sweep on "
                      f"{device}: {reason}", UserWarning, stacklevel=3)
        return False
    raise ValueError(f"message-sweep kernel cannot take this case: {reason}"
                     f" (use_kernel=False selects the dense path)")


def message_sweep(cfg_ext: PartitionConfig, model: Model, level_ops,
                  pmatrix, tipchars):
    """Sweep every directed message of a program: returns (clv [rows, R,
    S, T], scalers [rows, T] or [rows, R, T]).

    level_ops: the [L, W, 8] level program, padding rows included (an
    int64 tensor on the device is read as it is: FullTreeProgram.
    level_ops_tensor, or the search's runtime program).  Where
    `message_sweep_choice` says so, one kernel launch
    (ops/message_sweep.py) computes the sweep; else the dense
    level-batched path (ops/partials.py).  Counters on the function:
    `kernel_sweeps`, `dense_sweeps`."""
    device = tipchars.device
    grad = torch.is_grad_enabled() and pmatrix.requires_grad
    with spans.span("message_sweep"):
        if message_sweep_choice(cfg_ext, device, grad):
            out = message_sweep_ops.sweep_messages(
                torch.as_tensor(level_ops, device=device).long(),
                pmatrix.contiguous(), tipchars.to(torch.int32).contiguous(),
                cfg_ext)
            message_sweep.kernel_sweeps += 1
            return out
        message_sweep.dense_sweeps += 1
        dtype = cfg_ext.dtype
        R, S, T = cfg_ext.rate_cats, cfg_ext.states, tipchars.shape[-1]
        clv = torch.zeros((cfg_ext.num_clvs + 1, R, S, T), dtype=dtype,
                          device=device)
        clv[:cfg_ext.tips] = expand_tipchars(tipchars, S, dtype)[:, None]
        shape = ((cfg_ext.scale_buffers + 2, R, T)
                 if cfg_ext.per_rate_scalers
                 else (cfg_ext.scale_buffers + 2, T))
        scalers = torch.zeros(shape, dtype=torch.int32, device=device)
        return partials_ops.update_partials(clv, scalers, pmatrix,
                                            level_ops, cfg_ext)


# sweeps by each path since the process started
message_sweep.kernel_sweeps = 0
message_sweep.dense_sweeps = 0


def _sweep_all(program: FullTreeProgram, cfg: PartitionConfig, model: Model,
               branch_lengths, tipchars):
    """Compute all directional messages; returns (clv, scalers, pmatrix)."""
    pmats = pmatrix_ops.compute_pmatrices(
        branch_lengths, model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=cfg.dtype)
    num_slots = int(program.pmatrix_indices.max()) + 1
    pmatrix = torch.zeros((num_slots,) + pmats.shape[1:], dtype=cfg.dtype,
                          device=pmats.device)
    pmatrix[torch.as_tensor(program.pmatrix_indices, dtype=torch.int64,
                            device=pmats.device)] = pmats
    cfg_ext = program.cfg_ext
    if cfg_ext.use_kernel is not cfg.use_kernel:    # the call's choice
        cfg_ext = dataclasses.replace(cfg_ext, use_kernel=cfg.use_kernel)
    clv, scalers = message_sweep(
        cfg_ext, model, program.level_ops_tensor(tipchars.device), pmatrix,
        tipchars)
    return clv, scalers, pmatrix


def all_edge_loglikelihoods(program: FullTreeProgram, cfg: PartitionConfig,
                            model: Model, branch_lengths, tipchars,
                            pattern_weights, invariant, group=None):
    """Edge logL evaluated across EVERY branch ([E]).  All entries must be
    equal (the likelihood is invariant to the evaluation edge) — the
    strongest whole-sweep self-check the message structure admits.
    `group`: as in loglikelihood."""
    cfg = _local(cfg, group, tipchars)
    clv, scalers, pmatrix = _sweep_all(program, cfg, model, branch_lengths,
                                       tipchars)
    out = [likelihood_ops.edge_loglikelihood(
        clv[a], scalers[sa], clv[b], scalers[sb], pmatrix[slot],
        model.cat_freqs, model.rate_weights, model.cat_pinv, invariant,
        pattern_weights, cfg, group=group)
        for (a, sa, b, sb), slot in zip(program.edge_rows.tolist(),
                                        program.pmatrix_indices.tolist())]
    return torch.stack(out)


# Bytes of per-edge tensors (two gathered CLVs, their product or sumtable
# and one temporary, each [R, S, T]) that one chunk of edges may hold in
# the all-edge entry points below, summed over the partitions whose
# sumtables a chunk keeps alive together.
EDGE_CHUNK_BYTES = 1 << 30


def _edge_chunks(cfgs, edges):
    """Split a 1-D index tensor of branch positions into chunks whose
    per-edge tensors, over every partition of `cfgs`, fit
    EDGE_CHUNK_BYTES."""
    per_edge = sum(4 * cfg.span * cfg.sites_padded
                   * torch.empty((), dtype=cfg.dtype).element_size()
                   for cfg in cfgs)
    return torch.split(edges, max(1, EDGE_CHUNK_BYTES // per_edge))


def _edge_sumtables(program: FullTreeProgram, cfg: PartitionConfig,
                    model: Model, clv, scalers, rows):
    """Sumtables [n, R, S, T] of the edges with rows [n, 4] (rowA, scalA,
    rowB, scalB).  Per-site scalers cancel in L'/L; per-rate relative
    scalers fold into the sumtable (core_derivatives.c:418-460)."""
    idx = model.params_indices.long()
    sp, sc = ((scalers[rows[:, 1]], scalers[rows[:, 3]])
              if cfg.per_rate_scalers else (None, None))
    return derivatives_ops.update_sumtable(
        clv[rows[:, 0]], clv[rows[:, 2]], sp, sc, model.eigenvecs[idx],
        model.inv_eigenvecs[idx], model.cat_freqs, cfg,
        asc_scalers=_asc_scalers(scalers, rows, cfg))


# One partition of an all-edge call over shared branch lengths: its inputs,
# its eigenvalues per rate category and its multiplier s_k in its dtype
# (None under linked lengths).
_Part = collections.namedtuple("_Part", "program cfg model evals tipchars "
                               "pattern_weights invariant scale")


def _parts(programs, cfgs, models, tipchars, pattern_weights, invariant,
           scalers):
    return [_Part(p, c, m, m.eigenvals[m.params_indices.long()], x, w, i,
                  None if scalers is None else scalers[k].to(c.dtype))
            for k, (p, c, m, x, w, i) in enumerate(zip(
                programs, cfgs, models, tipchars, pattern_weights,
                invariant))]


def _at(part: _Part, t):
    """Shared lengths t as `part` sees them: s_k * t in its dtype, or t
    itself under linked lengths (the ops cast it)."""
    return t if part.scale is None else t.to(part.cfg.dtype) * part.scale


def _summed(terms):
    """The sum over the partitions of their terms: a lone partition's term
    as it is, else the f64 sum (the partitions' dtypes may differ)."""
    if len(terms) == 1:
        return terms[0]
    return functools.reduce(torch.add, [x.double() for x in terms])


def _sweeps(parts, branch_lengths):
    return [_sweep_all(p.program, p.cfg, p.model, _at(p, branch_lengths),
                       p.tipchars) for p in parts]


def _sumtables(parts, sweeps, rows):
    return [_edge_sumtables(p.program, p.cfg, p.model, clv, scalers, rows)
            for p, (clv, scalers, _) in zip(parts, sweeps)]


def _derivatives(parts, sumtables, t, group=None):
    """(d1, d2) [n] of -lnL at shared lengths t [n], summed over the
    partitions through the chain rule d/dt sum_k L_k(s_k t) = sum_k s_k
    d1_k, d2 = sum_k s_k^2 d2_k."""
    d1s, d2s = [], []
    for p, st in zip(parts, sumtables):
        d1, d2 = derivatives_ops.likelihood_derivatives(
            st, _at(p, t), p.model.rates, p.evals, p.model.cat_pinv,
            p.model.rate_weights, p.model.cat_freqs, p.invariant,
            p.pattern_weights, p.cfg, group=group)
        if p.scale is not None:
            d1, d2 = p.scale * d1, p.scale * p.scale * d2
        d1s.append(d1)
        d2s.append(d2)
    return _summed(d1s), _summed(d2s)


def _finite_or_start(parts, sumtables, start, end):
    """`end` [n] where each edge's logL there, summed over the partitions
    (each at s_k * end, from its sumtable), is finite, else `start`.  At
    f32 a Newton step from far above an edge's optimum can overshoot to
    min_branch, where the sumtable's terms cancel: the edge's logL and
    (d1, d2) are NaN there, and the steps end NaN, or, held or halved and
    doubled, just above it (1.6e-7 from an optimum near 0.5).  Such an
    edge keeps its start length.  At f64 the logL stays finite there, and
    every edge keeps its end."""
    logl = _summed([derivatives_ops.sumtable_loglikelihood(
        st, _at(p, end), p.model.rates, p.evals, p.model.cat_pinv,
        p.model.rate_weights, p.model.cat_freqs, p.invariant,
        p.pattern_weights,
        torch.zeros(st.shape[-1], dtype=torch.int32, device=st.device),
        p.cfg) for p, st in zip(parts, sumtables)])
    return torch.where(torch.isfinite(logl), end, start.to(end.dtype))


# per invariant tensor: (its in-place version when read, whether it marks
# a site), so that the device is read once a tensor, not once a call
_marked_sites = torch.utils.weak.WeakIdKeyDictionary()


def _marks_a_site(invariant) -> bool:
    """Whether `invariant` marks a site (an entry >= 0); cached per tensor
    and in-place version."""
    seen = _marked_sites.get(invariant)
    if seen is None or seen[0] != invariant._version:
        seen = (invariant._version, bool((invariant >= 0).any()))
        _marked_sites[invariant] = seen
    return seen[1]


def newton_refusal(parts, device) -> Optional[str]:
    """Why the Newton kernel (ops/newton_edges.py) cannot smooth these
    partitions' colour classes on `device`, or None: its contract is one
    partition with no multiplier, f32, per-site scalers, no ascertainment
    bias, no invariant-marked site, and a shape whose sumtable stripe fits
    a CTA at some cluster size (newton_edges.unsupported, on an H100's
    shared memory where `device` is not a card of this process)."""
    if len(parts) != 1:
        return (f"{len(parts)} partitions (the kernel smooths one; K > 1 "
                f"sum their derivatives on the plain path)")
    p = parts[0]
    cfg = p.cfg
    if p.scale is not None:
        return "a per-partition branch-length multiplier"
    if cfg.dtype != torch.float32:
        return f"the kernel computes f32, not {cfg.dtype}"
    if cfg.per_rate_scalers:
        return "per-rate scalers"
    if cfg.asc_bias != AB_NONE:
        return "an ascertainment bias correction"
    if _marks_a_site(p.invariant):
        return "an invariant-marked site"
    return newton_edges_ops.unsupported(cfg.rate_cats, cfg.states,
                                        cfg.sites_padded,
                                        edge_score_ops.smem_limit_of(device))


def newton_choice(parts, device) -> bool:
    """Whether the all-edge body smooths each colour class with the Newton
    kernel (True: one launch a class) or on the plain path (False),
    decided on the host from what the call shows: the kernel on a CUDA
    device where `newton_refusal` finds no reason against it.  use_kernel
    False, or a CPU device: the plain path.  A refused case: under
    use_kernel=None the plain path, with one UserWarning naming the
    reason; under use_kernel=True a ValueError.  Counters on the function,
    since the process started: .kernel_classes and .plain_classes, the
    colour classes each path smoothed."""
    use = [p.cfg.use_kernel for p in parts]
    if False in use or device.type != "cuda":
        return False
    reason = newton_refusal(parts, device)
    if reason is None:
        return True
    if True not in use:
        warnings.warn(f"the plain path smooths these colour classes on "
                      f"{device}: {reason}", UserWarning, stacklevel=3)
        return False
    raise ValueError(f"the Newton kernel cannot take this case: {reason} "
                     f"(use_kernel=False selects the plain path)")


newton_choice.kernel_classes = 0
newton_choice.plain_classes = 0


def _newton_plain(parts, sweeps, edge_rows, members, bl, newton_iters,
                  min_branch, max_branch):
    """One colour class's Newton work on the plain path, by edge chunk:
    sumtables, newton_iters steps on the summed (d1, d2), the f32 keep.
    Returns a copy of bl with the class's new lengths."""
    bl = bl.clone()
    for chunk in _edge_chunks([p.cfg for p in parts], members):
        sts = _sumtables(parts, sweeps, edge_rows[chunk])
        start = bl[chunk]
        t = start
        for _ in range(newton_iters):
            d1, d2 = _derivatives(parts, sts, t)
            # the JAX step has no non-finite guard; keep its semantics (a
            # NaN length ends at its start below)
            t = derivatives_ops.newton_update(t, d1, d2, min_branch,
                                              max_branch,
                                              hold_nonfinite=False)
        t = _finite_or_start(parts, sts, start, t)
        bl[chunk] = t.to(bl.dtype)
    return bl


def _optimize_branch_lengths(programs, cfgs, models, branch_lengths,
                             tipchars, pattern_weights, invariant, scalers,
                             rounds, newton_iters, min_branch, max_branch):
    """optimize_branch_lengths over K partitions sharing one topology and
    one [E] length vector: K-sequences of per-partition inputs, `scalers`
    None or the [K] multipliers s_k.  Each colour class's Newton work (its
    sumtables, steps and keep) is one launch of the Newton kernel where
    `newton_choice` takes the case, else the plain path below, which
    computes the same.  Returns (lengths, summed logL)."""
    parts = _parts(programs, cfgs, models, tipchars, pattern_weights,
                   invariant, scalers)
    program = programs[0]               # the edge layout is shared
    device = tipchars[0].device
    edge_rows = program.edge_rows_tensor(device)
    classes = program.color_members(device)
    kernel = newton_choice(parts, device)
    bl = branch_lengths
    if kernel:
        p = parts[0]
        dtype = p.cfg.dtype
        constants = edge_score_ops.block_constants(p.model, p.cfg, dtype)
        pw = p.pattern_weights.to(dtype).contiguous()
        bl = branch_lengths.to(dtype, copy=True).contiguous()
    for _ in range(rounds):
        for members in classes:
            sweeps = _sweeps(parts, bl)
            with spans.span("newton"):
                if kernel:
                    newton_edges_ops.newton_edges(
                        sweeps[0][0], edge_rows, members, bl, *constants, pw,
                        newton_iters=newton_iters, min_branch=min_branch,
                        max_branch=max_branch)
                    newton_choice.kernel_classes += 1
                else:
                    bl = _newton_plain(parts, sweeps, edge_rows, members,
                                       bl, newton_iters, min_branch,
                                       max_branch)
                    newton_choice.plain_classes += 1
            del sweeps
    bl = bl.to(branch_lengths.dtype)

    # final logL across the root edge with the optimized lengths
    ra, rsa, rb, rsb = program.edge_rows[program.root_edge].tolist()
    slot = int(program.pmatrix_indices[program.root_edge])
    return bl, _summed([likelihood_ops.edge_loglikelihood(
        clv[ra], scals[rsa], clv[rb], scals[rsb], pmatrix[slot],
        p.model.cat_freqs, p.model.rate_weights, p.model.cat_pinv,
        p.invariant, p.pattern_weights, p.cfg)
        for p, (clv, scals, pmatrix) in zip(parts, _sweeps(parts, bl))])


def optimize_branch_lengths(program: FullTreeProgram, cfg: PartitionConfig,
                            model: Model, branch_lengths, tipchars,
                            pattern_weights, invariant, rounds: int = 3,
                            newton_iters: int = 10, min_branch: float = 1e-8,
                            max_branch: float = 100.0):
    """Newton-optimize ALL branch lengths (batched smoothing).

    Per round and per colour class of the proper edge colouring (all
    program.n_colors of them): one message sweep, then `newton_iters`
    guarded Newton steps from analytic (d1, d2) on that class's branches
    (no two share a node, so each sees up-to-date CLVs); a branch whose
    logL is not finite where its steps end keeps its start length
    (_finite_or_start: f32 only).  The JAX package computes a proposal for
    every branch and keeps the class's; this computes only the class's,
    with the same values.  The body is _optimize_branch_lengths, with one
    partition; on the card at f32 a class's Newton work is one launch of
    the Newton kernel (ops/newton_edges.py, `newton_choice`).

    Returns (optimized_branch_lengths, logl_after)."""
    return _optimize_branch_lengths(
        (program,), (cfg,), (model,), branch_lengths, (tipchars,),
        (pattern_weights,), (invariant,), None, rounds, newton_iters,
        min_branch, max_branch)


def score_placements(program: FullTreeProgram, cfg: PartitionConfig,
                     model: Model, branch_lengths, tipchars,
                     pattern_weights, invariant, sub_clv, sub_scaler,
                     sub_branch_length):
    """Log-likelihood of regrafting a pruned subtree onto EVERY edge of
    the remainder tree ([E]).

    `program` is compile_tree_full of the REMAINDER tree (after
    moves.prune_subtree); `sub_clv` [R, S, T] / `sub_scaler` ([T], or
    [R, T] under per_rate_scalers) is the pruned subtree's CLV directed at
    the cut and `sub_branch_length` its attachment branch.  Placement at
    edge e follows SPR semantics (utree_moves.c:119-254): the edge splits
    in half, the subtree keeps its branch, so score_placements[e] equals
    the full-tree logL after spr(...) onto e.  The batched inner loop of
    SPR rounds and EPA-style placement."""
    dtype = cfg.dtype
    device = tipchars.device
    clv, scalers, _ = _sweep_all(program, cfg, model, branch_lengths,
                                 tipchars)

    def pmats(lengths):
        return pmatrix_ops.compute_pmatrices(
            lengths, model.eigenvals, model.eigenvecs, model.inv_eigenvecs,
            model.rates, model.prop_invar, model.params_indices, dtype=dtype)

    halves = pmats(branch_lengths * 0.5)                      # [E, R, S, S]
    p3 = pmats(torch.as_tensor(sub_branch_length, dtype=dtype,
                               device=device).reshape(1))[0]
    sub_term = torch.einsum("rij,rjt->rit", p3, sub_clv.to(dtype))
    edge_rows = program.edge_rows_tensor(device)
    out = []
    for chunk in _edge_chunks((cfg,),
                              torch.arange(len(edge_rows), device=device)):
        rows, ph = edge_rows[chunk], halves[chunk]
        ta = torch.einsum("erij,erjt->erit", ph, clv[rows[:, 0]])
        tb = torch.einsum("erij,erjt->erit", ph, clv[rows[:, 2]])
        scal = scalers[rows[:, 1]] + scalers[rows[:, 3]] + sub_scaler
        out.append(likelihood_ops.root_loglikelihood(
            ta * tb * sub_term, scal, model.cat_freqs, model.rate_weights,
            model.cat_pinv, invariant, pattern_weights, cfg))
    return torch.cat(out)


def _branch_derivatives(programs, cfgs, models, branch_lengths, tipchars,
                        pattern_weights, invariant, scalers=None,
                        group=None):
    """branch_derivatives over K partitions sharing one topology and one
    [E] length vector (inputs as in _optimize_branch_lengths): the summed
    (d1, d2), [E] each."""
    parts = _parts(programs, cfgs, models, tipchars, pattern_weights,
                   invariant, scalers)
    device = tipchars[0].device
    edge_rows = programs[0].edge_rows_tensor(device)
    sweeps = _sweeps(parts, branch_lengths)
    d1s, d2s = [], []
    for chunk in _edge_chunks(cfgs, torch.arange(len(edge_rows),
                                                 device=device)):
        d1, d2 = _derivatives(parts, _sumtables(parts, sweeps,
                                                edge_rows[chunk]),
                              branch_lengths[chunk], group)
        d1s.append(d1)
        d2s.append(d2)
    return torch.cat(d1s), torch.cat(d2s)


def branch_derivatives(program: FullTreeProgram, cfg: PartitionConfig,
                       model: Model, branch_lengths, tipchars,
                       pattern_weights, invariant, group=None):
    """(d1, d2) of -lnL w.r.t. EVERY branch length from one message sweep
    ([E], [E]).  The reference computes these one branch at a time
    (pll_update_sumtable + pll_compute_likelihood_derivatives).
    `group`: as in loglikelihood."""
    return _branch_derivatives(
        (program,), (_local(cfg, group, tipchars),), (model,),
        branch_lengths, (tipchars,), (pattern_weights,), (invariant,),
        group=group)


# --------------------------------------------------------------------------
# Analytic reverse pass for the fast forward path
# --------------------------------------------------------------------------
#
# The tree-sweep kernels have no graph autograd could walk, so gradient-
# based fitting (fit.py) through them needs a hand-written backward.  The
# message machinery supplies one: with all directional messages of one
# sweep at hand,
#
#     dlogL/dP_e[r,i,j] = sum_t bar[r,t] pi[r,i] msg_a[r,i,t] msg_b[r,j,t]
#
# where bar is the cotangent of the cheap [R, T] reduction tail of the
# edge-e factorization (ordinary autograd of likelihood_ops.edge_reduce
# with the messages held fixed).  Branch-length and model gradients follow
# by autograd through compute_pmatrices (a tiny closed-form function), and
# the reduction-side gradients (frequencies, rate weights, prop_invar,
# pattern weights) by autograd of the root-edge reduction with messages
# and P held fixed.
#
# Cost: forward = the fast path (the CUDA sweep on CUDA tensors); backward
# = one message sweep (the kernel on CUDA tensors) + per-edge einsums in
# chunks.


class _LoglikelihoodAnalytic(torch.autograd.Function):
    """loglikelihood() with the message-based reverse pass.  The model's
    tensors are explicit arguments so that gradients reach them."""

    MODEL_FLOATS = ("eigenvals", "eigenvecs", "inv_eigenvecs", "frequencies",
                    "rates", "rate_weights", "prop_invar")

    @staticmethod
    def forward(ctx, program, full, cfg, params_indices, tipchars, invariant,
                branch_lengths, pattern_weights, *model_floats):
        fields = dict(zip(_LoglikelihoodAnalytic.MODEL_FLOATS, model_floats))
        model = Model(params_indices=params_indices, **fields)
        ctx.static = (full, cfg)
        ctx.save_for_backward(params_indices, tipchars, invariant,
                              branch_lengths, pattern_weights, *model_floats)
        return loglikelihood(program, cfg, model, branch_lengths, tipchars,
                             pattern_weights, invariant)

    @staticmethod
    def backward(ctx, g):
        full, cfg = ctx.static
        (params_indices, tipchars, inv, bl, pw,
         *model_floats) = ctx.saved_tensors
        fields = dict(zip(_LoglikelihoodAnalytic.MODEL_FLOATS, model_floats))
        model = Model(params_indices=params_indices, **fields)
        dtype = cfg.dtype
        device = tipchars.device
        idx = params_indices.long()

        clv, scalers, pmatrix = _sweep_all(full, cfg, model, bl, tipchars)
        edge_rows = full.edge_rows_tensor(device)
        pmat_slots = torch.as_tensor(full.pmatrix_indices, dtype=torch.int64,
                                     device=device)
        freqs = model.cat_freqs.to(dtype)                         # [R, S]

        # dlogL/dP_e by the belief-propagation identity: the edge-e
        # factorization L_t = reduce(sum_ij pi_i msg_a,i P_ij msg_b,j)
        # holds for EVERY edge with messages held fixed, so the true
        # partial derivative in P_e is the VJP of that form.  The reduction
        # tail (scaler undo, +I mixing, asc-bias corrections) is a cheap
        # [R, T] function; autograd of it yields the per-(rate, site)
        # cotangent `bar`, and the expensive message factors stay analytic
        # (core_derivatives.c:321-471 is this factorization specialized to
        # d/dt).
        pmat_bar = torch.empty((len(edge_rows),) + pmatrix.shape[1:],
                               dtype=dtype, device=device)
        for chunk in _edge_chunks((cfg,), torch.arange(len(edge_rows),
                                                       device=device)):
            rows = edge_rows[chunk]
            msg_b = clv[rows[:, 2]]                               # [e,R,S,T]
            A = freqs[None, :, :, None] * clv[rows[:, 0]]
            apb = torch.einsum("erit,erij,erjt->ert", A,
                               pmatrix[pmat_slots[chunk]].to(dtype), msg_b)
            with torch.enable_grad():
                apb = apb.requires_grad_()
                red = likelihood_ops.edge_reduce(
                    apb, scalers[rows[:, 1]], scalers[rows[:, 3]],
                    model.cat_freqs, model.rate_weights, model.cat_pinv, inv,
                    pw, cfg)
                # one logL per edge, each a function of its own apb only
                bar, = torch.autograd.grad(red.sum(), apb)
            pmat_bar[chunk] = torch.einsum("ert,erit,erjt->erij", bar * g, A,
                                           msg_b)
            del msg_b, A, apb, bar

        def leaf(x):
            return x.detach().requires_grad_()

        with torch.enable_grad():
            bl_l, evals, evecs, ivecs, rates, pinv = (
                leaf(x) for x in (bl, model.eigenvals, model.eigenvecs,
                                  model.inv_eigenvecs, model.rates,
                                  model.prop_invar))
            pm = pmatrix_ops.compute_pmatrices(
                bl_l, evals, evecs, ivecs, rates, pinv, params_indices,
                dtype=dtype)
            (bl_bar, evals_bar, evecs_bar, ivecs_bar, rates_bar,
             pinv_bar_pm) = torch.autograd.grad(
                pm, (bl_l, evals, evecs, ivecs, rates, pinv),
                grad_outputs=pmat_bar.to(pm.dtype))

            # reduction-side gradients (messages and P held fixed);
            # pattern weights enter the likelihood only through the
            # reduction, so pw_bar is exact here too (including the
            # asc-bias correction terms)
            frequencies, rate_weights, prop_invar, pw_l = (
                leaf(x) for x in (model.frequencies, model.rate_weights,
                                  model.prop_invar, pw))
            ra, rsa, rb, rsb = full.edge_rows[full.root_edge].tolist()
            red = likelihood_ops.edge_loglikelihood(
                clv[ra], scalers[rsa], clv[rb], scalers[rsb],
                pmatrix[int(full.pmatrix_indices[full.root_edge])],
                frequencies[idx], rate_weights, prop_invar[idx], inv, pw_l,
                cfg)
            freqs_bar, rw_bar, pinv_bar_red, pw_bar = torch.autograd.grad(
                red, (frequencies, rate_weights, prop_invar, pw_l),
                grad_outputs=g.to(red.dtype))

        model_bar = dict(
            eigenvals=evals_bar, eigenvecs=evecs_bar, inv_eigenvecs=ivecs_bar,
            frequencies=freqs_bar, rates=rates_bar, rate_weights=rw_bar,
            prop_invar=pinv_bar_pm + pinv_bar_red)
        return (None, None, None, None, None, None, bl_bar, pw_bar,
                *(model_bar[f] for f in _LoglikelihoodAnalytic.MODEL_FLOATS))


def loglikelihood_analytic(program: TreeProgram, full: FullTreeProgram,
                           cfg: PartitionConfig, model: Model,
                           branch_lengths, tipchars, pattern_weights,
                           invariant):
    """loglikelihood() with an analytic (message-based) reverse pass.

    Differentiable in (the model's floating tensors, branch_lengths,
    pattern_weights) on ANY forward path, including the CUDA tree sweep.
    Supports per-site and per-rate scalers, +I, and every
    ascertainment-bias correction (the per-edge reduction tail is
    differentiated by ordinary autograd)."""
    return _LoglikelihoodAnalytic.apply(
        program, full, cfg, model.params_indices, tipchars, invariant,
        branch_lengths, pattern_weights,
        *(getattr(model, f) for f in _LoglikelihoodAnalytic.MODEL_FLOATS))


def build_case(n_tips: int, sites: int, rate_cats: int = 4,
               dtype=torch.float32, device="cuda", site_block: int = 128,
               seed: int = 0, use_kernel: Optional[bool] = None,
               states: int = 4, aa_model_name: str = "lg",
               newick: Optional[str] = None,
               sweep_mode: Optional[str] = None, subst=None, freqs=None):
    """The bench's forward case: a balanced n_tips tree (or `newick`),
    Gamma(alpha=1) rates, one-hot random tips from numpy's generator at
    `seed` (libpll2_tpu's bench.py and __graft_entry__.py build the same
    inputs).  states=4: GTR(1,2,1,1,2,1) with equal frequencies.
    states=20: the empirical model `aa_model_name` (models/aa.py); a
    four-matrix mixture (lg4m, lg4x) gets one matrix per rate category.
    Any state count from 2 to 64 with `subst` and `freqs` given: that GTR
    model (a codon model's, models/codon.py, at 61), len(freqs) == states.

    Returns (cfg, program, model, branch_lengths, tipchars,
    pattern_weights, invariant), tensors on `device`."""
    from . import tree as T
    from .models.gamma import compute_gamma_cats
    from .tree.generate import balanced_newick, random_tipchars

    tree = T.parse_newick_string(newick or balanced_newick(n_tips))
    if tree.tip_count != n_tips:
        raise ValueError(f"newick has {tree.tip_count} tips, not {n_tips}")
    rates = compute_gamma_cats(1.0, rate_cats)
    if freqs is not None:
        if len(freqs) != states:
            raise ValueError(f"{len(freqs)} frequencies for {states} states")
        subst, freqs = [subst], [freqs]
    elif states == 20:
        from .models.aa import aa_model
        subst, freqs = (np.atleast_2d(x) for x in aa_model(aa_model_name))
    elif states == 4:
        subst, freqs = [[1.0, 2.0, 1.0, 1.0, 2.0, 1.0]], [[0.25] * 4]
    else:
        raise ValueError(f"build_case builds DNA (4) or protein (20) "
                         f"cases, or takes subst and freqs, got "
                         f"states={states}")
    n_matrices = len(subst)
    if n_matrices not in (1, rate_cats):
        raise ValueError(f"{aa_model_name} has {n_matrices} matrices, "
                         f"needs rate_cats={n_matrices}")
    cfg = PartitionConfig(
        tips=n_tips, clv_buffers=tree.inner_count, states=states,
        sites=sites, rate_matrices=n_matrices, prob_matrices=2 * n_tips - 3,
        rate_cats=rate_cats, scale_buffers=tree.inner_count, dtype=dtype,
        site_block=site_block, use_kernel=use_kernel, sweep_mode=sweep_mode)
    program = compile_tree(tree, cfg)
    model = make_model(
        subst, freqs, rates, dtype=dtype, device=device,
        params_indices=None if n_matrices == 1 else np.arange(rate_cats))

    rng = np.random.default_rng(seed)
    raw = random_tipchars(n_tips, sites, rng, states=states)
    tipchars = torch.as_tensor(pad_tipchars(raw, cfg), device=device)
    pattern_weights = np.zeros(cfg.sites_padded)
    pattern_weights[:sites] = 1.0
    invariant = np.full(cfg.sites_padded, -1, dtype=np.int32)
    branch_lengths = torch.as_tensor(program.default_branch_lengths,
                                     dtype=dtype, device=device)
    return (cfg, program, model, branch_lengths, tipchars,
            torch.as_tensor(pattern_weights, dtype=dtype, device=device),
            torch.as_tensor(invariant, device=device))


def entry(device="cuda"):
    """Single-device forward step (counterpart of __graft_entry__.entry):
    full-tree log-likelihood of a 64-taxon balanced tree x 4096 sites,
    GTR+Gamma4, f32.  Returns (forward, example_args)."""
    (cfg, program, model, branch_lengths, tipchars, pattern_weights,
     invariant) = build_case(n_tips=64, sites=4096, rate_cats=4,
                             dtype=torch.float32, device=device,
                             site_block=128)

    def forward(model, branch_lengths, tipchars, pattern_weights, invariant):
        return loglikelihood(program, cfg, model, branch_lengths,
                             tipchars, pattern_weights, invariant)

    return forward, (model, branch_lengths, tipchars, pattern_weights,
                     invariant)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The sharded training step on `n_devices` ranks (counterpart of
    __graft_entry__.dryrun_multichip), launched by parallel.launcher:
    on each rank optimize_root_branch and loglikelihood on its site slice
    of a 12-taxon case, then one SPR round (search_fast._spr_round_device,
    the plain scorer) on a 10-taxon random tree at radius 2.  The ranks
    share one group over `device` ("cuda": rank r on card r mod the card
    count; "cpu": gloo on the CPU).  Raises unless every result is finite
    and equal on every rank; returns the ranks' results."""
    from .parallel.launcher import launch
    results = launch(f"{__name__}:_dryrun_rank", n_devices, device=device)
    for key, value in results[0].items():
        if not bool(torch.isfinite(value).all()):
            raise RuntimeError(f"sharded training step: non-finite {key}")
        for rank, other in enumerate(results[1:], 1):
            if not torch.equal(value, other[key]):
                raise RuntimeError(f"sharded training step: {key} of rank "
                                   f"{rank} differs from rank 0's")
    return results


def _dryrun_rank(mesh) -> dict:
    """One rank of dryrun_multichip.  The case has 32 sites a rank (the
    JAX dryrun's 8 a device is below the sweep kernel's smallest site
    block); the SPR round keeps the JAX dryrun's 8 a rank."""
    from . import search_fast as sf
    from . import tree as T
    from .parallel import shard_site_arrays
    from .tree.generate import random_newick, random_tipchars

    n, group, dev = mesh.size, mesh.group, mesh.device
    (cfg, program, model, branch_lengths, tipchars, pattern_weights,
     invariant) = build_case(n_tips=12, sites=32 * n, rate_cats=4,
                             dtype=torch.float32, device=dev,
                             site_block=32 * n)
    tip_s, pw_s, inv_s = shard_site_arrays(mesh, tipchars, pattern_weights,
                                           invariant)
    new_bl, logl = optimize_root_branch(program, cfg, model, branch_lengths,
                                        tip_s, pw_s, inv_s, group=group)
    logl2 = loglikelihood(program, cfg, model, new_bl, tip_s, pw_s, inv_s,
                          group=group)

    rng = np.random.default_rng(0)
    tree = T.parse_newick_string(random_newick(10, rng))
    raw = random_tipchars(10, 8 * n, rng)
    chars = {nd.label: raw[nd.clv_index].astype(np.uint64)
             for nd in tree.nodes[:10]}
    scfg = PartitionConfig(
        tips=10, clv_buffers=tree.inner_count, states=4, sites=8 * n,
        rate_matrices=1, prob_matrices=17, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=torch.float32,
        site_block=8 * n)
    prog = sf.compile_spr(tree, scfg, radius=2)
    tip2s, pw2s, inv2s = shard_site_arrays(
        mesh, sf._tipchars_for(prog, chars, dev), *sf._aux_arrays(prog, dev))
    smodel = make_model([[1.0, 2.0, 1.0, 1.0, 2.0, 1.0]], [[0.25] * 4],
                        [0.5, 0.8, 1.2, 1.5], dtype=torch.float32,
                        device=dev)
    lops, pslots, bl, root_rows, root_slot, gdev = sf._round_args(prog, dev)
    logl3, outs = sf._spr_round_device(
        prog.cfg_ext, smodel, lops, pslots, bl, tip2s, pw2s, inv2s,
        root_rows, root_slot, gdev, ball_slots=prog.ball_slots,
        newton_iters=2, use_kernel=False, group=group)
    return {"new_bl": new_bl, "logl": logl, "logl2": logl2,
            "spr_logl": logl3,
            "spr_scores": torch.cat([s.flatten() for s, _ in outs])
            .nan_to_num(neginf=0.0)}
