"""Multi-partition models: K per-gene partitions sharing ONE topology.

Counterpart of libpll2_tpu/multipartition.py.  Reference clients (RAxML-NG
/ ModelTest-NG) drive one partition per gene over its site range
(SURVEY.md §2.6) and combine log-likelihoods and derivative sums branch by
branch.  This module's own code is the grouped forward (below), whose
total log-likelihood is a single scalar.  The derivatives and the Newton
smoothing of the SHARED branch lengths are engine's all-edge body
(engine._branch_derivatives, engine._optimize_branch_lengths), which runs
one or K partitions against the summed (d1, d2).

Partitions may differ in everything but the topology: states (mixed DNA +
protein runs), rate categories, models, site counts, asc-bias, scaler
mode.  Branch-length linkage (the RAxML-NG brlen modes):

  * linked  — one branch-length vector shared by all partitions
              (scalers=None);
  * scaled  — shared vector, per-partition multiplier (pass `scalers`,
              shape [K]; d/dt folds the chain rule into the Newton sums);
  * unlinked — K independent engines (search_fast.hill_climb_multi).

The forward (`loglikelihood`).  Partitions that share the states, rate
categories, dtype, scaler mode and asc-bias mode (and the kernel settings
use_kernel and sweep_mode) form a `Group`, compiled once: one topology
whose site axis is the concatenation of its partitions, each at its own
sites_padded, so that a site block of the sweep never spans two.  A call
computes, for each group:

  * the P-matrices of all its partitions at once, [Kg, E, R, S, S] in
    branch order, each at t * s_k (ops/pmatrix.compute_pmatrices_batched);
  * one sweep over the concatenated sites (ops/partials_tree.sweep: the
    kernel `partials_tree.choose` picks for the group's shape on CUDA
    tensors, its plain version elsewhere), each site block reading its
    partition's P-matrices through a per-block table (`p_base`);
  * the reduction across the root edge with each block's frequencies, rate
    weights, p-inv and asc-bias correction, summed per partition in f64
    (ops/likelihood.edge_loglikelihood_blocks).

The total is the f64 sum of the per-partition sums.  On the card, from a
key's second call on, the three stages of all groups replay as CUDA graphs
(forward_graph.py), one key an evaluation: the key is the compiled object,
the identity of every model buffer and site tensor the call reads, and the
shape of the lengths (with the scalers); new lengths or scalers are copied
into the graphs' input.  A tensor whose storage is swapped in place (set_)
is not seen by the key; a model changed in place is read at replay.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import operator
from typing import Optional, Sequence

import numpy as np
import torch

from . import engine, forward_graph, spans
from .config import PartitionConfig
from .constants import AB_NONE
from .ops import likelihood as likelihood_ops
from .ops import partials_tree
from .ops import pmatrix as pmatrix_ops
from .tree.utree import UTree


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """Partitions compiled into one forward: `members` (partition indices,
    in order), concatenated along the site axis, each at its own
    sites_padded (`columns`)."""
    members: tuple                   # partition indices
    cfg: PartitionConfig             # the sweep's: sites = sum(columns)
    member_cfg: PartitionConfig      # members[0]'s (scalers, asc, dtype)
    program: engine.TreeProgram      # P columns of the schedule: branches
    root_branch: int                 # position of the root edge's branch
    columns: tuple                   # sites_padded of each member
    sites: tuple                     # real sites of each member
    alloc: tuple                     # sites_alloc (asc phantoms) of each
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def block(self) -> int:
        """The largest site block that never spans two members."""
        return math.gcd(*self.columns)

    @property
    def pad_columns(self) -> int:
        return sum(c - a for c, a in zip(self.columns, self.alloc))

    def layout(self, device: torch.device, tb: int) -> "Layout":
        """The group's per-block tables at site block tb on `device`
        (made once, before any capture reads them)."""
        key = (str(device), tb)
        if key not in self._device:
            self._device[key] = _layout(self, device, tb)
        return self._device[key]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where each site block of a group's sweep lies, on one device."""
    tb: int
    p_base: torch.Tensor             # [NT] int32: member * branches
    block_segment: torch.Tensor      # [NT] int64: member of each block
    segment_blocks: torch.Tensor     # [Kg, B] int64: blocks, NT-padded
    members: torch.Tensor            # [Kg] int64: partition indices
    real: Optional[torch.Tensor]     # [NT, tb] bool (asc bias only)
    phantom: Optional[torch.Tensor]  # [NT, tb] bool (asc bias only)


def _layout(group: Group, device: torch.device, tb: int) -> Layout:
    n_branches = group.program.num_branches
    counts = np.asarray(group.columns) // tb
    segment = np.repeat(np.arange(len(counts)), counts)
    nt = len(segment)
    blocks = np.full((len(counts), int(counts.max())), nt, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for k, (start, n) in enumerate(zip(starts, counts)):
        blocks[k, :n] = np.arange(start, start + n)
    real = phantom = None
    if group.member_cfg.asc_bias != AB_NONE:
        local = np.concatenate([np.arange(c) for c in group.columns])
        site = np.repeat(np.asarray(group.sites), group.columns)
        real = torch.as_tensor((local < site).reshape(nt, tb), device=device)
        phantom = torch.as_tensor(
            ((local >= site) & (local < np.repeat(np.asarray(group.alloc),
                                                  group.columns)))
            .reshape(nt, tb), device=device)

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Layout(tb, put(segment * n_branches, torch.int32),
                  put(segment, torch.int64), put(blocks, torch.int64),
                  put(group.members, torch.int64), real, phantom)


@dataclasses.dataclass(frozen=True, eq=False)
class MultiPartition:
    """Static compiled form: one topology, K partition configs, and the
    groups the forward runs them in."""
    programs: tuple                  # TreeProgram per partition
    fulls: tuple                     # FullTreeProgram per partition
    cfgs: tuple                      # PartitionConfig per partition
    groups: tuple = ()               # Group, in order of first member
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_partitions(self) -> int:
        return len(self.cfgs)


def _group_key(cfg: PartitionConfig) -> tuple:
    return (cfg.states, cfg.rate_cats, cfg.dtype, cfg.per_rate_scalers,
            cfg.asc_bias, cfg.use_kernel, cfg.sweep_mode)


def _branch_schedule(program: engine.TreeProgram) -> engine.TreeProgram:
    """`program` with the schedule's P-matrix columns turned from pmatrix
    slots into branch positions, so that a P buffer in branch order (the
    batched P-matrices) is the buffer the sweep reads."""
    branch_of = np.full(int(program.pmatrix_indices.max()) + 1, -1, np.int32)
    branch_of[program.pmatrix_indices] = np.arange(program.num_branches)
    ops = program.vmem_prog.ops.copy()
    ops[:, 7:9] = branch_of[ops[:, 7:9]]
    vmem = dataclasses.replace(program.vmem_prog, ops=ops, _device={})
    return dataclasses.replace(program, vmem_prog=vmem, _device={})


def _group(tree_program: engine.TreeProgram, cfgs, members) -> Group:
    first = cfgs[members[0]]
    columns = tuple(cfgs[k].sites_padded for k in members)
    block = math.gcd(*columns)
    cfg = dataclasses.replace(first, sites=sum(columns), site_block=block,
                              asc_bias=AB_NONE, asc_bias_flag=False,
                              site_repeats=False)
    root_branch = int(np.nonzero(tree_program.pmatrix_indices
                                 == tree_program.root_pmatrix)[0][0])
    return Group(tuple(members), cfg, first, _branch_schedule(tree_program),
                 root_branch, columns, tuple(cfgs[k].sites for k in members),
                 tuple(cfgs[k].sites_alloc for k in members))


def compile_multipartition(tree: UTree, cfgs: Sequence[PartitionConfig]
                           ) -> MultiPartition:
    """Compile one topology against K partition configs.

    All cfgs must agree on `tips` (same taxa); everything else may vary.
    The topology is compiled once per distinct row layout (clv and scale
    buffers): the edge layout (edge_rows order, colors, pmatrix indices)
    depends on the topology only, so it is identical across the K
    programs, and the shared branch vector indexes all of them
    consistently.
    """
    cfgs = tuple(cfgs)
    tips = {c.tips for c in cfgs}
    if len(tips) != 1 or tips.pop() != tree.tip_count:
        raise ValueError("all partitions must cover the same taxa as the "
                         "shared topology")
    compiled: dict = {}
    full = engine.compile_tree_full(tree, cfgs[0])
    n_msgs = full.cfg_ext.clv_buffers
    programs, fulls = [], []
    for c in cfgs:
        rows = (c.clv_buffers, c.scale_buffers)
        if rows not in compiled:
            compiled[rows] = engine.compile_tree(tree, c)
        programs.append(compiled[rows])
        fulls.append(dataclasses.replace(full, cfg_ext=dataclasses.replace(
            c, clv_buffers=n_msgs, scale_buffers=n_msgs), _device={}))
    members: dict = {}
    for k, c in enumerate(cfgs):
        members.setdefault(_group_key(c), []).append(k)
    groups = tuple(_group(programs[m[0]], cfgs, m) for m in members.values())
    return MultiPartition(programs=tuple(programs), fulls=tuple(fulls),
                          cfgs=cfgs, groups=groups)


def _scalers_tensor(scalers, device):
    """Optional [K] per-partition multipliers as an f64 tensor."""
    if scalers is None:
        return None
    return torch.as_tensor(scalers, dtype=torch.float64, device=device)


def _choice(group: Group, device: torch.device) -> Optional[tuple]:
    """(site block, mode) of the group's sweep kernel on `device`, or None
    for the plain sweep: engine.kernel_choice on the group's shape, at a
    block that divides every member's columns (cached per device)."""
    key = ("choice", str(device))
    if key not in group._device:
        choice = engine.kernel_choice(group.program, group.cfg, device)
        if choice is not None and group.block % choice[0]:
            from . import _build
            limit = _build.max_shared_memory(device) \
                if device.type == "cuda" else partials_tree.SMEM_LIMIT
            fits = [tb for tb in partials_tree.fitting_blocks(
                group.program.vmem_prog, group.cfg, limit, choice[1])
                if group.block % tb == 0]
            if not fits:
                raise ValueError(
                    f"no site block of the {choice[1]!r} sweep divides the "
                    f"partitions' padded widths ({group.block})")
            choice = (fits[0], choice[1])
        group._device[key] = choice
    return group._device[key]


_BUFFERS = operator.attrgetter("_buffers")
_NEEDS_GRAD = operator.attrgetter("requires_grad")


def _model_rows(models, group: Group, device) -> torch.Tensor:
    """[Kg, R] int64: each member's rate categories as rows of its models'
    rate matrices concatenated in member order."""
    sizes = tuple(models[k].eigenvals.shape[0] for k in group.members)
    key = ("rows", str(device), sizes)
    if key not in group._device:
        group._device[key] = torch.as_tensor(
            np.cumsum((0,) + sizes[:-1]), dtype=torch.int64, device=device)
    base = group._device[key]
    return torch.stack([models[k].params_indices for k in group.members]
                       ).long() + base[:, None]


def _stacked(models, group: Group, rows, field: str):
    """A Model field of every member, per rate category: [Kg, R, ...]."""
    return torch.cat([getattr(models[k], field)
                      for k in group.members])[rows]


class _BlockView:
    """Row accessors over a group's sweep rows in site blocks: an exported
    row [NT, R, S, TB], a tip's rows from its packed states, a scaler row
    [NT, TB] (per-rate [NT, R, TB]), zeros where none was exported."""

    def __init__(self, clv_rows, scal_rows, tip_blocked, group: Group):
        self.clv, self.scal, self.tips = clv_rows, scal_rows, tip_blocked
        self.prog = group.program.vmem_prog
        self.cfg = group.cfg

    def clv_row(self, index: int):
        cfg = self.cfg
        if index < cfg.tips:
            codes = self.tips[:, index]                           # [NT, TB]
            shifts = torch.arange(cfg.states, dtype=codes.dtype,
                                  device=codes.device)[None, :, None]
            bits = ((codes[:, None, :] >> shifts) & 1).to(cfg.dtype)
            return bits[:, None].expand(-1, cfg.rate_cats, -1, -1)
        return self.clv[self.prog.export_clv_map[index]]

    def scaler_row(self, index: int):
        if index in self.prog.export_scaler_map:
            row = self.scal[self.prog.export_scaler_map[index]]
            return row if self.cfg.per_rate_scalers else row[:, 0]
        nt, _, tb = self.tips.shape
        shape = (nt, self.cfg.rate_cats, tb) if self.cfg.per_rate_scalers \
            else (nt, tb)
        return torch.zeros(shape, dtype=torch.int32, device=self.tips.device)


def _stages(mp: MultiPartition, models, tipchars, pattern_weights,
            invariant, choices, device):
    """The forward's three stages over every group (forward_graph.capture's
    contract): packed lengths -> P-matrices; P-matrices -> sweep rows;
    (rows, P-matrices) -> per-partition logL [K] f64."""
    n_branches = mp.programs[0].num_branches
    layouts = [g.layout(device, c[0] if c else g.block)
               for g, c in zip(mp.groups, choices)]
    key = ("order", str(device))        # group order -> partition order
    if key not in mp._device:
        members = np.concatenate([g.members for g in mp.groups])
        mp._device[key] = torch.as_tensor(np.argsort(members), device=device)
    order = mp._device[key]

    def pmatrices(packed):
        out = []
        for g, lay in zip(mp.groups, layouts):
            dtype = g.cfg.dtype
            lengths = packed[:n_branches].to(dtype)[None, :]
            if packed.shape[0] > n_branches:
                lengths = lengths * packed[n_branches:][lay.members].to(
                    dtype)[:, None]
            else:
                lengths = lengths.expand(len(g.members), -1)
            rows = _model_rows(models, g, device)
            out.append(pmatrix_ops.compute_pmatrices_batched(
                lengths, _stacked(models, g, rows, "eigenvals"),
                _stacked(models, g, rows, "eigenvecs"),
                _stacked(models, g, rows, "inv_eigenvecs"),
                torch.stack([models[k].rates for k in g.members]),
                _stacked(models, g, rows, "prop_invar"), dtype=dtype))
        return out

    def sweeps(pmats):
        out = []
        for g, lay, choice, pm in zip(mp.groups, layouts, choices, pmats):
            tips = engine.block_tips(torch.cat(
                [tipchars[k] for k in g.members], dim=1), g.cfg, lay.tb)
            flat = pm.view(-1, *pm.shape[2:])
            prog = g.program.vmem_prog
            if choice is not None:
                rows = partials_tree.sweep(tips, flat, prog, g.cfg, lay.tb,
                                           mode=choice[1], p_base=lay.p_base)
            else:
                with spans.span("sweep"):
                    rows = partials_tree.sweep_reference(
                        tips, flat, prog, g.cfg, lay.tb, p_base=lay.p_base)
            out.append((*rows, tips))
        return out

    def root(rows, pmats):
        parts = []
        for g, lay, (clv, scal, tips), pm in zip(mp.groups, layouts, rows,
                                                 pmats):
            view = _BlockView(clv, scal, tips, g)
            prog, cfg = g.program, g.cfg
            nt, tb = tips.shape[0], lay.tb
            model_rows = _model_rows(models, g, device)
            parts.append(likelihood_ops.edge_loglikelihood_blocks(
                view.clv_row(prog.root_clv),
                view.scaler_row(prog.root_scaler if prog.root_scaler >= 0
                                else cfg.scaler_zero),
                view.clv_row(prog.root_back_clv),
                view.scaler_row(prog.root_back_scaler
                                if prog.root_back_scaler >= 0
                                else cfg.scaler_zero),
                pm[:, g.root_branch],
                _stacked(models, g, model_rows, "frequencies"),
                torch.stack([models[k].rate_weights for k in g.members]),
                _stacked(models, g, model_rows, "prop_invar"),
                torch.cat([invariant[k] for k in g.members]).view(nt, tb),
                torch.cat([pattern_weights[k]
                           for k in g.members]).view(nt, tb),
                lay.block_segment, lay.segment_blocks, g.member_cfg,
                lay.real, lay.phantom))
        return torch.cat(parts)[order]

    return pmatrices, sweeps, root


_graphs = forward_graph.Cache()


def _packed(mp: MultiPartition, branch_lengths, scalers):
    """The call's lengths as one f64 vector: the [E] shared lengths, then
    the [K] multipliers where given."""
    n = mp.programs[0].num_branches
    if tuple(branch_lengths.shape) != (n,):
        raise ValueError(f"branch_lengths {tuple(branch_lengths.shape)} is "
                         f"not [{n}]")
    bl = branch_lengths.to(torch.float64)
    scalers = _scalers_tensor(scalers, branch_lengths.device)
    if scalers is None:
        return bl
    if tuple(scalers.shape) != (mp.n_partitions,):
        raise ValueError(f"scalers {tuple(scalers.shape)} is not "
                         f"[{mp.n_partitions}]")
    return torch.cat([bl, scalers])


def _forward(mp: MultiPartition, models, branch_lengths, tipchars,
             pattern_weights, invariant, scalers):
    """Per-partition logL [K] f64 of one call (module docstring)."""
    device = branch_lengths.device
    packed = _packed(mp, branch_lengths, scalers)
    choices = [_choice(g, device) for g in mp.groups]
    stages = _stages(mp, models, tipchars, pattern_weights, invariant,
                     choices, device)
    pm_stage, sweep_stage, root_stage = stages

    def eager():
        pmats = pm_stage(packed)
        return root_stage(sweep_stage(pmats), pmats)

    buffers = tuple(itertools.chain.from_iterable(
        map(dict.values, map(_BUFFERS, models))))
    capturing = device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()
    grad = torch.is_grad_enabled()
    if not forward_graph.eligible(
            device, None, None if None in choices else choices, [packed],
            grad, capturing) or (grad and any(map(_NEEDS_GRAD, buffers))):
        _counters.eager_calls += 1
        return eager()
    sites = (tuple(tipchars), tuple(pattern_weights), tuple(invariant))
    key = (mp, device, tuple(map(id, buffers)),
           tuple(tuple(map(id, s)) for s in sites),
           (tuple(packed.shape), packed.dtype))
    parts, how = _graphs.call(
        key, (mp, buffers) + sites, eager,
        lambda: forward_graph.capture(stages, eager, device, packed),
        lambda graphs: graphs.replay(packed))
    setattr(_counters, how, getattr(_counters, how) + 1)
    return parts


def loglikelihood(mp: MultiPartition, models, branch_lengths, tipchars,
                  pattern_weights, invariant, scalers=None):
    """Total log-likelihood over all partitions, [] f64: the sum of the
    partitions' own sums, each taken in f64.

    models / tipchars / pattern_weights / invariant: K-sequences (one
    entry per partition, shaped for that partition's cfg); branch_lengths:
    the SHARED [E] vector; scalers: optional [K] per-partition multipliers.
    One sweep a group (module docstring); on the card repeated calls
    replay CUDA graphs.  Counters on the function, since the process
    started: .groups, .real_columns (alignment sites) and .pad_columns
    (padding) of the calls' sweeps; .graph_captures, .graph_replays and
    .eager_calls as engine.loglikelihood's.
    """
    with spans.span("multi.forward"):
        parts = _forward(mp, models, branch_lengths, tipchars,
                         pattern_weights, invariant, scalers)
        _counters.groups += len(mp.groups)
        _counters.real_columns += sum(sum(g.sites) for g in mp.groups)
        _counters.pad_columns += sum(g.pad_columns for g in mp.groups)
        return parts.sum()


# the function holds its counters, and counts on itself under a wrapper
# that takes its name in the module
loglikelihood.groups = 0
loglikelihood.real_columns = 0
loglikelihood.pad_columns = 0
loglikelihood.graph_captures = 0
loglikelihood.graph_replays = 0
loglikelihood.eager_calls = 0
_counters = loglikelihood


def branch_derivatives(mp: MultiPartition, models, branch_lengths, tipchars,
                       pattern_weights, invariant, scalers=None):
    """Summed (d1, d2) of -lnL w.r.t. every SHARED branch length ([E], [E],
    f64), chain-ruled through the optional per-partition scaler: engine's
    all-edge body over the K partitions."""
    d1, d2 = engine._branch_derivatives(
        mp.fulls, mp.cfgs, models, branch_lengths, tipchars,
        pattern_weights, invariant,
        _scalers_tensor(scalers, branch_lengths.device))
    return d1.double(), d2.double()


def optimize_branch_lengths(mp: MultiPartition, models, branch_lengths,
                            tipchars, pattern_weights, invariant,
                            scalers=None, rounds: int = 3,
                            newton_iters: int = 10,
                            min_branch: float = 1e-8,
                            max_branch: float = 100.0):
    """Newton-optimize the SHARED branch lengths against the summed
    multi-partition likelihood: engine.optimize_branch_lengths's body over
    the K partitions.

    Returns (optimized_branch_lengths, total_logl_after [] f64).
    """
    bl, logl = engine._optimize_branch_lengths(
        mp.fulls, mp.cfgs, models, branch_lengths, tipchars,
        pattern_weights, invariant,
        _scalers_tensor(scalers, branch_lengths.device), rounds,
        newton_iters, min_branch, max_branch)
    return bl, logl.double()
