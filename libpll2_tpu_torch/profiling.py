"""Profiles of the port on torch.profiler: one script in place of the JAX
package's eight timing tools (tools/profile_{engine,kernels,round,ball,
scatter,search}.py, tools/kbench.py, tools/repeats_quantify.py).

    python -m libpll2_tpu_torch.profiling <target> [--tips N] [--sites N]
        [--radius K] [--reps N] [--rounds N] [--device {cuda,cpu}]

Each target prints one JSON line: the card's name and power limit (as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
them), and for every phase of its work the host seconds of one call and
the profile of `reps` calls (wall ms, kernel ms and idle share of a call,
the top kernels as (name, ms, count)); the line's own wall ms, kernel ms,
idle share and top kernels are those of its headline phase, the call a
user makes.

  engine   (profile_engine.py)  compute_pmatrices, the tree sweep in each
           form ("fma", "mma"), the root reduction, and
           optimize_root_branch's sumtable and Newton steps, then the
           loglikelihood and optimize_root_branch calls; tips x sites.
  sweep    (profile_kernels.py, kbench.py)  both sweep forms at every
           site block that fits (`fitting_blocks`, the candidates of
           `pick_site_block`), the block each form picks and the form
           `choose` picks, and nvcc's seconds for each csrc/*.cu where
           _build.build compiled them in this process (nvcc takes the
           place of the Mosaic compile).
  round    (profile_round.py, profile_ball.py, profile_scatter.py)  one
           spr_round on the search inputs: the base message sweep, the
           recursion and scoring of every ball group as the round runs
           them (search_fast._score_group) under each edge-scorer form,
           with the scorer's rows (`matched_ms`), the ball recursion
           (`recurse_ms`: the stream ms of its `libpll2.ball_recursion`
           spans, spans.py, in `reps` calls more under spans.recording()
           without the profiler), and the rows of the gathers (`gather_ms`,
           aten::index) and scatters (`scatter_ms`, aten::index_put_);
           the whole round with its `timings` phases, and the host's
           compile_spr.
  search   (profile_search.py)  hill_climb for `rounds` rounds: seconds
           of each round, the logL trace, and the profile of the climb.
  repeats  (repeats_quantify.py)  on a gappy alignment (each taxon covers
           about 40 % of 16 site blocks): the share of CLV columns site
           repeats skip (repeats.Repeats over the tree's operations),
           Partition.update_partials dense and with repeats (f64), the
           host's levelize_operations_repeats, the gather overhead of one
           take_along_dim a child, and the forward step at the full and
           at the class-equivalent site count (the optimistic bound of a
           class-gather kernel).

**Idle share** (the one method of the port): idle share = 1 - U / W,
where U is the union of the intervals of the device rows of a
torch.profiler trace of the work (CUDA kernels, and the memcpy and memset
rows the card runs; not the CUDA row that each host range, such as a
span's, also leaves) and W the host wall time between a
torch.cuda.synchronize() before the same work and one after it, run
without the profiler (whose host cost would inflate W: 37.3 ms against
19.9 ms for one optimize_root_branch call at 256 x 65,536 on an H100
80GB HBM3 at 700 W).  The sum of the rows'
durations is printed beside U as `kernel_sum_ms`; it differs only where
rows overlap (several streams).  The wall time under the profiler is
printed as `profiled_wall_ms`.  A trace can lose device rows: where it
holds fewer rows of this package's kernels than their wrappers counted
launches (`own_rows` against `own_launches`), U would understate the
device time, and the kernel time and idle share are null with the reason
in `kernel_null_reason`.

On `--device cpu` no kernel runs: the kernel fields are null and
`kernel_null_reason` says why; the host seconds are still timed.  With no
card and no `--device cpu` the script raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import engine, spans
from .config import PartitionConfig
from .models.gamma import compute_gamma_cats

KERNEL_NULL = ("device cpu: no CUDA kernel runs, so the trace has no "
               "device rows to time")
TOP = 8
NAME_CHARS = 160        # a kernel's name as printed (templates run longer)
# names of this package's kernels whose wrappers count their launches
# (tree_sweep.cu, tree_sweep_mma.cu, edge_score.cu)
OWN_KERNELS = ("tree_sweep", "edge_score")
GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather",
              "aten::take_along_dim")
SCATTER_OPS = ("aten::_index_put_impl_", "aten::index_put_",
               "aten::index_copy_", "aten::scatter_")
SEARCH_SEED = 20260820          # bench.py measure_search_round
SEARCH_SUBST = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
SEARCH_FREQS = [0.28, 0.24, 0.22, 0.26]
SEARCH_ALPHA = 0.9
NT_CHARS = np.array(list("?ACMGRSVTWYHKDBN"))  # MAP_NT's code -> character


@dataclasses.dataclass
class KernelProfile:
    """The device rows of one profiled piece of work, in ms."""
    wall_ms: float          # host wall time of the work without the profiler
    profiled_wall_ms: float  # the same under the profiler
    kernel_ms: float        # union of the device rows' intervals
    kernel_sum_ms: float    # sum of their durations
    rows: list              # [(name, ms, count)], by summed ms
    ops: dict               # {aten op: ms of the device rows it launched}

    @property
    def idle_share(self) -> float:
        return 1.0 - self.kernel_ms / self.wall_ms

    def top(self, n: int = TOP) -> list:
        return [(name[:NAME_CHARS], ms, count)
                for name, ms, count in self.rows[:n]]


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in ns, in ms."""
    total, end = 0, -float("inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e6


def _wall_ms(fn: Callable[[], object]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_kernels(fn: Callable[[], object],
                    wall_ms: Optional[float] = None
                    ) -> Optional[KernelProfile]:
    """The device rows of one call of `fn` under torch.profiler, and the
    idle share of the module docstring: `wall_ms` is the host wall time of
    the same work without the profiler between two synchronizes (when
    None, one call of `fn` is timed so first).  None where the trace holds
    no device row.  The rows are read from the profiler's raw events
    (each device row's launching CPU op by its correlation id), which
    costs a small part of building the profiler's event tree.  The spans
    recorded so far are cleared first, so that spans.records() then holds
    those of this profile alone."""
    from torch.profiler import ProfilerActivity, profile

    if wall_ms is None:
        wall_ms = _wall_ms(fn)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = _wall_ms(fn)
    return read_events(prof.profiler.kineto_results.events(), wall_ms,
                       profiled)


def read_events(events, wall_ms: float,
                profiled: float) -> Optional[KernelProfile]:
    """profile_kernels' walk of the profiler's raw events.  A host range
    (a span of this package's, spans.py, or any record_function) also
    shows as a CUDA row spanning the device work launched inside it: such
    a row is no device work and is left out."""
    from torch.autograd import DeviceType

    ranges = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    op_of = {e.correlation_id(): e.name() for e in events
             if e.device_type() == DeviceType.CPU
             and e.linked_correlation_id() == 0
             and e.name().startswith("aten::")}
    by_name: dict = {}
    ops: dict = {}
    intervals = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() in ranges \
                or e.name().startswith(spans.PREFIX):
            continue
        start, ns = e.start_ns(), e.duration_ns()
        intervals.append((start, start + ns))
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + ns / 1e6, n + 1)
        op = op_of.get(e.linked_correlation_id())
        if op is not None:
            ops[op] = ops.get(op, 0.0) + ns / 1e6
    if not by_name:
        return None
    rows = sorted(((k,) + v for k, v in by_name.items()),
                  key=lambda r: -r[1])
    return KernelProfile(wall_ms, profiled, _union_ms(intervals),
                         sum(r[1] for r in rows), rows,
                         dict(sorted(ops.items(), key=lambda kv: -kv[1])))


def _own_launches() -> int:
    from .ops import edge_score, partials_tree
    return partials_tree.sweep.launches + edge_score.edge_scores.launches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_fields(prof: Optional[KernelProfile], own_launches: int,
                reps: int, match: Optional[str] = None) -> dict:
    """The kernel fields of a phase, per call, from the profile of `reps`
    calls during which this package's wrappers counted `own_launches`
    launches.  `own_rows` counts their rows in the trace.  Where the trace
    holds fewer (it lost device rows) or no device row at all, the union
    of its rows would understate the device time: kernel_ms,
    kernel_sum_ms, idle_share and matched_ms are then None, and
    `kernel_null_reason` says why; the rows it holds are still listed."""
    out = {"profiled_wall_ms": None, "kernel_ms": None,
           "kernel_sum_ms": None, "idle_share": None, "top": [],
           "ops": None, "matched_ms": None, "gather_ms": None,
           "scatter_ms": None, "own_launches": own_launches / reps,
           "own_rows": 0.0,
           "kernel_null_reason": "the trace holds no device row"}
    if prof is None:
        return out
    own_rows = sum(n for name, _, n in prof.rows
                   if any(k in name for k in OWN_KERNELS))
    out.update(profiled_wall_ms=prof.profiled_wall_ms / reps,
               top=[(name, ms / reps, n / reps)
                    for name, ms, n in prof.top()],
               ops={k: v / reps for k, v in list(prof.ops.items())[:TOP]},
               gather_ms=sum(prof.ops.get(k, 0.0) for k in GATHER_OPS) / reps,
               scatter_ms=sum(prof.ops.get(k, 0.0)
                              for k in SCATTER_OPS) / reps,
               own_rows=own_rows / reps, kernel_null_reason=None)
    if own_rows < own_launches:
        out["kernel_null_reason"] = (
            f"the trace lost device rows: it holds {own_rows} rows of this "
            f"package's kernels for {own_launches} launches, so its device "
            f"time would be a lower bound")
        return out
    out.update(kernel_ms=prof.kernel_ms / reps,
               kernel_sum_ms=prof.kernel_sum_ms / reps,
               idle_share=prof.idle_share)
    if match is not None:
        out["matched_ms"] = sum(ms for name, ms, _ in prof.rows
                                if match in name) / reps
    return out


def measure(fn: Callable[[], object], device: torch.device,
            reps: int = 1, warm: bool = True,
            match: Optional[str] = None) -> dict:
    """One phase: after one call to warm up (unless warm is False), the
    host seconds of a call (the mean of `reps` calls between two
    synchronizes), then on the card the kernel fields of `reps` calls
    more under the profiler (card_fields; with `match`, `matched_ms`
    sums the device rows whose name holds it; `gather_ms` and
    `scatter_ms` the rows launched by index gathers and scatters).  On
    the CPU wall_ms is the host time of a call and the kernel fields are
    None, with KERNEL_NULL as their reason."""
    if warm:
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    host_s = (time.perf_counter() - t0) / reps
    out = {"host_s": host_s, "wall_ms": host_s * 1e3}
    if device.type != "cuda":
        out.update({k: None for k in card_fields(None, 0, 1)},
                   kernel_null_reason=KERNEL_NULL)
        return out
    launches = _own_launches()
    prof = profile_kernels(lambda: [fn() for _ in range(reps)],
                           wall_ms=host_s * reps * 1e3)
    out.update(card_fields(prof, _own_launches() - launches, reps, match))
    return out


def span_ms(name: str, reps: int) -> Optional[float]:
    """The summed stream ms of the spans named `name` recorded since the
    last spans.clear(), per call of `reps`; None where there is none, or
    one has no CUDA events (the CPU)."""
    recs = [r for r in spans.records() if r.name == name]
    if not recs or any(r.stream_ms is None for r in recs):
        return None
    return sum(r.stream_ms for r in recs) / reps


def card_row(smi: str, uuid: str) -> str:
    """`name, power limit` from the output of nvidia-smi
    --query-gpu=uuid,name,power.limit --format=csv,noheader: the row of
    the card whose UUID is `uuid` (torch's, with or without nvidia-smi's
    "GPU-" prefix).  nvidia-smi lists every card of the host, whatever
    CUDA_VISIBLE_DEVICES hides, and in its own order."""
    want = uuid.lower().removeprefix("gpu-")
    for row in smi.strip().splitlines():
        smi_uuid, name_power = row.split(", ", 1)
        if smi_uuid.strip().lower().removeprefix("gpu-") == want:
            return name_power.strip()
    raise RuntimeError(f"nvidia-smi lists no card of UUID {uuid}:\n{smi}")


def card(device: torch.device) -> Optional[str]:
    """`name, power limit` of the card as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, found
    by the card's UUID; None on the CPU."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return card_row(smi.stdout,
                    str(torch.cuda.get_device_properties(index).uuid))


def _result(target: str, device: torch.device, shape: dict, phases: dict,
            headline: str, **extra) -> dict:
    head = phases[headline]
    out = {"target": target, "device": str(device), "card": card(device),
           "shape": shape, "headline": headline,
           "wall_ms": head["wall_ms"],
           "profiled_wall_ms": head["profiled_wall_ms"],
           "kernel_ms": head["kernel_ms"],
           "kernel_sum_ms": head["kernel_sum_ms"],
           "idle_share": head["idle_share"], "top_kernels": head["top"],
           "own_launches": head["own_launches"],
           "own_rows": head["own_rows"],
           "kernel_null_reason": head["kernel_null_reason"],
           "phases": phases}
    out.update(extra)
    return out


# --------------------------------------------------------------------------
# engine / sweep
# --------------------------------------------------------------------------


def _sweep_limits(device: torch.device):
    """(shared-memory limit, SM count) of the card, or the defaults on the
    CPU (no SM count: the largest block that fits)."""
    from .ops import partials_tree
    if device.type != "cuda":
        return partials_tree.SMEM_LIMIT, None
    from . import _build
    return (_build.max_shared_memory(device),
            torch.cuda.get_device_properties(device).multi_processor_count)


def target_engine(tips: int = 256, sites: int = 65536, reps: int = 10,
                  device="cuda") -> dict:
    from .ops import derivatives as derivatives_ops
    from .ops import likelihood as likelihood_ops
    from .ops import partials_tree
    device = torch.device(device)
    cfg, program, model, bl, tipchars, pw, inv = engine.build_case(
        tips, sites, dtype=torch.float32, device=device)
    limit, sm_count = _sweep_limits(device)
    prog = program.vmem_prog
    pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
    phases = {"pmatrices": measure(
        lambda: engine.pmatrix_buffer(program, cfg, model, bl), device,
        reps)}
    for mode in partials_tree.MODES:
        reason = partials_tree.unsupported(prog, cfg, limit, mode)
        if reason is not None:
            phases[f"sweep[{mode}]"] = {"skipped": reason}
            continue
        tb = partials_tree.pick_site_block(prog, cfg, limit, mode, sm_count)
        blocked = engine.block_tips(tipchars, cfg, tb)
        phases[f"sweep[{mode}]"] = dict(measure(
            lambda: partials_tree.sweep(blocked, pmatrix, prog, cfg, tb,
                                        mode=mode), device, reps),
            site_block=tb)
    view, _ = engine._sweep(program, cfg, model, bl, tipchars, pw)
    rs = view.scaler_row(program.root_scaler if program.root_scaler >= 0
                         else cfg.scaler_zero)
    rbs = view.scaler_row(program.root_back_scaler
                          if program.root_back_scaler >= 0
                          else cfg.scaler_zero)
    root, back = view.clv_row(program.root_clv), \
        view.clv_row(program.root_back_clv)
    phases["root_reduction"] = measure(
        lambda: likelihood_ops.edge_loglikelihood(
            root, rs, back, rbs, pmatrix[program.root_pmatrix],
            model.cat_freqs, model.rate_weights, model.cat_pinv, inv, pw,
            cfg), device, reps)
    idx = model.params_indices.long()

    def sumtable():
        return derivatives_ops.update_sumtable(
            root, back, rs, rbs, model.eigenvecs[idx],
            model.inv_eigenvecs[idx], model.cat_freqs, cfg,
            asc_scalers=rs + rbs)
    phases["sumtable"] = measure(sumtable, device, reps)
    st = sumtable()
    root_pos = int(np.nonzero(
        program.pmatrix_indices == program.root_pmatrix)[0][0])

    def newton():
        t = bl[root_pos]
        for _ in range(10):
            d1, d2 = derivatives_ops.likelihood_derivatives(
                st, t, model.rates, model.eigenvals[idx], model.cat_pinv,
                model.rate_weights, model.cat_freqs, inv, pw, cfg)
            t = derivatives_ops.newton_update(t, d1, d2,
                                              hold_nonfinite=False)
        return t
    phases["newton[10]"] = measure(newton, device, reps)
    phases["loglikelihood"] = measure(
        lambda: engine.loglikelihood(program, cfg, model, bl, tipchars, pw,
                                     inv), device, reps)
    phases["optimize_root_branch"] = measure(
        lambda: engine.optimize_root_branch(program, cfg, model, bl,
                                            tipchars, pw, inv), device, reps)
    choice = engine.kernel_choice(program, cfg, device)
    return _result(
        "engine", device, {"tips": tips, "sites": sites}, phases,
        "optimize_root_branch", reps=reps,
        forward_form=None if choice is None else
        {"site_block": choice[0], "mode": choice[1]},
        site_updates_per_s=(tips - 2) * sites
        / phases["loglikelihood"]["host_s"])


def _build_seconds(device: torch.device) -> dict:
    """nvcc's seconds for each source, where _build.build compiled them in
    this process."""
    from . import _build
    if device.type != "cuda":
        return {"seconds": None, "source_seconds": None,
                "reason": "device cpu: the plain versions run, nothing is "
                          "built"}
    info = _build.build()
    if not info.source_seconds:
        return {"seconds": 0.0, "source_seconds": None,
                "reason": f"{info.path.name} existed before this process: "
                          f"no nvcc ran"}
    return {"seconds": info.seconds, "source_seconds": info.source_seconds,
            "reason": None}


def target_sweep(tips: int = 256, sites: int = 65536, reps: int = 10,
                 device="cuda") -> dict:
    from .ops import partials_tree
    device = torch.device(device)
    cfg, program, model, bl, tipchars, _, _ = engine.build_case(
        tips, sites, dtype=torch.float32, device=device)
    limit, sm_count = _sweep_limits(device)
    prog = program.vmem_prog
    pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
    phases, picked = {}, {}
    for mode in partials_tree.MODES:
        if partials_tree.unsupported(prog, cfg, limit, mode) is not None:
            continue
        picked[mode] = partials_tree.pick_site_block(prog, cfg, limit, mode,
                                                     sm_count)
        for tb in partials_tree.fitting_blocks(prog, cfg, limit, mode):
            blocked = engine.block_tips(tipchars, cfg, tb)
            phases[f"{mode}@{tb}"] = measure(
                lambda: partials_tree.sweep(blocked, pmatrix, prog, cfg,
                                            tb, mode=mode), device, reps)
    tb, mode = partials_tree.choose(prog, cfg, limit, sm_count)
    return _result("sweep", device, {"tips": tips, "sites": sites}, phases,
                   f"{mode}@{tb}", reps=reps, picked_blocks=picked,
                   choose={"mode": mode, "site_block": tb},
                   build=_build_seconds(device))


# --------------------------------------------------------------------------
# round / search
# --------------------------------------------------------------------------


def search_case(device, tips: int = 256, sites: int = 4096,
                seed: int = SEARCH_SEED, dtype=torch.float32,
                subst=SEARCH_SUBST, freqs=SEARCH_FREQS):
    """The JAX bench's search_round case (bench.py measure_search_round):
    a random truth tree, a GTR+Gamma(0.9) alignment simulated down it, a
    random start tree over the same labels.  The GTR model is `subst`,
    `freqs`, the state count len(freqs).  Returns (truth, start, chars,
    cfg, model)."""
    from . import tree as T
    from .tree.generate import random_newick, simulate_alignment
    rng = np.random.default_rng(seed)
    rates = compute_gamma_cats(SEARCH_ALPHA, 4)
    truth = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.02, max_bl=0.35))
    chars = simulate_alignment(truth, sites, rng, subst, freqs, rates)
    start = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.05, max_bl=0.3))
    ren = dict(zip(sorted(n.label for n in start.nodes[:tips]),
                   sorted(chars)))
    for n in start.nodes[:tips]:
        n.label = ren[n.label]
    cfg = PartitionConfig(
        tips=tips, clv_buffers=start.inner_count, states=len(freqs),
        sites=sites, rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=dtype)
    model = engine.make_model([subst], [freqs], rates, dtype=dtype,
                              device=device)
    return truth, start, chars, cfg, model


def _score_groups(prog, model, site, base, group_args, use_kernel: bool,
                  form: Optional[str], newton_iters: int = 3) -> None:
    """Every ball group's recursion and scoring of one round, as
    spr_round runs them (search_fast._score_group), with the edge
    scorer's form forced where `form` is given."""
    from . import search_fast as sf
    _, pw_d, inv_d = site
    base_clv, base_scal, pmatrix, halves = base
    bl = group_args[0]
    for lvls, sops, srows, epos, medges in group_args[1]:
        sf._score_group(prog.cfg_ext, model, base_clv, base_scal, pmatrix,
                        halves, bl, pw_d, inv_d, lvls, sops, srows, epos,
                        medges, ball_slots=prog.ball_slots,
                        newton_iters=newton_iters, use_kernel=use_kernel,
                        form=form)


def target_round(tips: int = 256, sites: int = 4096, radius: int = 5,
                 reps: int = 3, device="cuda") -> dict:
    from . import search_fast as sf
    from .ops import edge_score
    device = torch.device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    _, start, chars, cfg, model = search_case(device, tips, sites,
                                              dtype=dtype)
    t0 = time.perf_counter()
    for _ in range(reps):
        prog = sf.compile_spr(start, cfg, radius=radius)
    compile_s = (time.perf_counter() - t0) / reps
    site = sf._site_arrays(prog, chars, device, None, None)
    level_ops, pslots, bl, _, _, groups = sf._round_args(prog, device)
    cfgx = prog.cfg_ext
    base = sf._spr_base(cfgx, model, level_ops, pslots, bl, site[0])
    phases = {
        "compile_spr": {"host_s": compile_s},
        "base_sweep": measure(
            lambda: sf._spr_base(cfgx, model, level_ops, pslots, bl,
                                 site[0]), device, reps),
    }
    kernel_on = sf.use_edge_kernel(cfgx, site[2], device)
    for form in edge_score.FORMS if kernel_on else (None,):
        def score():
            _score_groups(prog, model, site, base, (bl, groups), kernel_on,
                          form)
        phase = measure(score, device, reps, match="edge_score")
        phase["recurse_ms"] = None
        if device.type == "cuda":
            # the spans' own pass, without the profiler's host cost
            spans.clear()
            with spans.recording():
                for _ in range(reps):
                    score()
            phase["recurse_ms"] = span_ms("libpll2.ball_recursion", reps)
            spans.clear()
        phases[f"score[{form or 'plain'}]"] = phase
    timings: list = []

    def one_round():
        tm: dict = {}
        sf.spr_round(prog, model, chars, timings=tm)
        timings.append({k: v for k, v in tm.items()
                        if isinstance(v, (int, float, str))})
    phases["spr_round"] = measure(one_round, device, reps)
    phases["spr_round"]["timings"] = timings[-1]
    return _result("round", device,
                   {"tips": tips, "sites": sites, "radius": radius}, phases,
                   "spr_round", reps=reps, ball_groups=len(prog.ball_groups),
                   scorer="kernel" if kernel_on else "plain")


def target_search(tips: int = 256, sites: int = 4096, radius: int = 5,
                  rounds: int = 3, device="cuda") -> dict:
    from . import search_fast as sf
    device = torch.device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    _, start, chars, cfg, model = search_case(device, tips, sites,
                                              dtype=dtype)
    runs: list = []

    def climb():
        runs.append(sf.hill_climb(start, cfg, model, chars,
                                  max_rounds=rounds, radius=radius,
                                  smooth_every=2))
    # no warm-up call: the climb's first round is in round_secs
    phases = {"hill_climb": measure(climb, device, 1, warm=False)}
    _, logl, stats = runs[0]
    return _result("search", device,
                   {"tips": tips, "sites": sites, "radius": radius,
                    "rounds": rounds}, phases, "hill_climb",
                   round_secs=stats["round_secs"],
                   logl_trace=stats["logl_trace"], logl=logl,
                   moves=stats["moves"], init_smooth_s=stats["init_smooth_s"])


# --------------------------------------------------------------------------
# repeats
# --------------------------------------------------------------------------


def gappy_alignment(tips: int, sites: int, seed: int = 11):
    """tools/repeats_quantify.py's alignment: a random tree, GTR+Gamma(0.9)
    sites simulated down it, then each taxon keeps about 40 % of 16
    contiguous site blocks and the rest is gap (code 15).  Returns (tree,
    chars)."""
    from . import tree as T
    from .tree.generate import random_newick, simulate_alignment
    rng = np.random.default_rng(seed)
    tree = T.parse_newick_string(
        random_newick(tips, rng, min_bl=0.02, max_bl=0.3))
    chars = simulate_alignment(tree, sites, rng, SEARCH_SUBST, SEARCH_FREQS,
                               compute_gamma_cats(SEARCH_ALPHA, 4))
    n_blocks = 16
    width = sites // n_blocks
    for lab in chars:
        covered = rng.random(n_blocks) < 0.4
        for b in range(n_blocks):
            if not covered[b]:
                chars[lab][b * width:(b + 1) * width] = 15
    return tree, chars


def class_share(tree, chars, sites: int) -> dict:
    """The class structure of site repeats over the tree's post-order
    operations (repeats.Repeats, the reference's rules): CLV columns
    computed dense and with repeats, and their ratio."""
    from .repeats import Repeats
    from .tree import create_operations, traverse
    ops, _, _ = create_operations(traverse(tree.vroot))
    tips = tree.tip_count
    rep = Repeats(2 * tips, 2 * tips, sites, additional_sites=0)
    for n in tree.nodes[:tips]:
        rep.update_tip(n.clv_index, np.asarray(chars[n.label], np.uint32))
    total = classes = 0
    for op in ops:
        nc = sites
        if rep.enable(op.child1_clv_index, op.child2_clv_index):
            rep.update(op.parent_clv_index, op.child1_clv_index,
                       op.child2_clv_index, parent_scaler=-1)
            nc = rep.sites_number(op.parent_clv_index) or sites
        total += sites
        classes += nc
    return {"ops": len(ops), "dense_columns": total,
            "class_columns": classes, "compute_fraction": classes / total,
            "skipped_share": 1.0 - classes / total}


def _partition(tree, chars, sites: int, device, site_repeats: bool):
    """Partition over the gappy alignment, f64, GTR+Gamma(0.9), its
    P-matrices set: (partition, operations)."""
    from . import tree as T
    from .constants import MAP_NT
    from .partition import Partition
    tips = tree.tip_count
    p = Partition(tips, tree.inner_count, 4, sites, 1, 2 * tips - 3, 4,
                  tree.inner_count, site_repeats=site_repeats,
                  device=device)
    p.set_frequencies(0, SEARCH_FREQS)
    p.set_subst_params(0, SEARCH_SUBST)
    p.set_category_rates(compute_gamma_cats(SEARCH_ALPHA, 4))
    for n in tree.nodes[:tips]:
        p.set_tip_states(n.clv_index, MAP_NT,
                         "".join(NT_CHARS[np.asarray(chars[n.label])]))
    ops, branches, pmat_idx = T.create_operations(T.traverse(tree.vroot))
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    return p, ops


def target_repeats(tips: int = 256, sites: int = 65536, reps: int = 2,
                   device="cuda") -> dict:
    from .ops import partials as partials_ops
    from .partition import levelize_operations_repeats
    device = torch.device(device)
    tree, chars = gappy_alignment(tips, sites)
    t0 = time.perf_counter()
    share = class_share(tree, chars, sites)
    share["host_s"] = time.perf_counter() - t0
    phases = {}
    dense, ops = _partition(tree, chars, sites, device, False)
    phases["update_partials[dense]"] = measure(
        lambda: dense.update_partials(ops), device, reps)
    del dense
    rep, ops = _partition(tree, chars, sites, device, True)
    phases["update_partials[repeats]"] = measure(
        lambda: rep.update_partials(ops), device, reps)
    t0 = time.perf_counter()
    level_ops, gathers = levelize_operations_repeats(ops, rep.cfg,
                                                     rep.repeats)
    phases["levelize_operations_repeats"] = {
        "host_s": time.perf_counter() - t0}
    phases["update_partials_repeats[prebuilt]"] = measure(
        lambda: partials_ops.update_partials_repeats(
            rep.clv, rep.scalers, rep.pmatrix, level_ops, gathers,
            rep.cfg), device, reps)
    child = rep.clv[tips]                                     # [R, S, T]
    index = torch.as_tensor(
        np.random.default_rng(0).integers(0, child.shape[-1],
                                          child.shape[-1]),
        device=device)[None, None].expand_as(child)
    gather = measure(lambda: torch.take_along_dim(child, index, dim=-1),
                     device, max(reps, 10))
    per_sweep = 2 * share["ops"]
    gather["gathers_a_sweep"] = per_sweep
    gather["host_s_a_sweep"] = gather["host_s"] * per_sweep
    gather["kernel_ms_a_sweep"] = None if gather["kernel_ms"] is None \
        else gather["kernel_ms"] * per_sweep
    phases["gather[one child]"] = gather
    del rep, level_ops, gathers, child, index
    eq_sites = max(256, int(np.ceil(share["compute_fraction"] * sites
                                    / 256)) * 256)
    for label, n in (("forward[dense sites]", sites),
                     ("forward[class sites]", eq_sites)):
        fcfg, program, model, bl, tipchars, pw, inv = engine.build_case(
            tips, n, dtype=torch.float32 if device.type == "cuda"
            else torch.float64, device=device)
        phases[label] = measure(
            lambda: engine.loglikelihood(program, fcfg, model, bl, tipchars,
                                         pw, inv), device, max(reps, 10))
    return _result("repeats", device, {"tips": tips, "sites": sites},
                   phases, "update_partials[repeats]", reps=reps,
                   classes=share, class_equivalent_sites=eq_sites)


TARGETS = {"engine": target_engine, "sweep": target_sweep,
           "round": target_round, "search": target_search,
           "repeats": target_repeats}


def run(target: str, device="cuda", **kw) -> dict:
    """The JSON object of one target (keyword arguments: its shape)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the profiler runs on the card and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to profile the host")
    return TARGETS[target](device=device, **kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    ap.add_argument("target", choices=sorted(TARGETS))
    ap.add_argument("--tips", type=int)
    ap.add_argument("--sites", type=int)
    ap.add_argument("--radius", type=int)
    ap.add_argument("--reps", type=int)
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import inspect
    params = inspect.signature(TARGETS[args.target]).parameters
    kw = {k: v for k, v in vars(args).items()
          if k in params and k != "device" and v is not None}
    out = run(args.target, args.device, **kw)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
