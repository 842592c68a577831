#!/usr/bin/env python3
"""Smoke run of libpll2_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: name, power limit, CUDA versions; TF32 off;
  2. build the CUDA kernels from libpll2_tpu_torch/csrc with nvcc (sm_90a);
  3. the tree-sweep kernel against its plain PyTorch version on the card,
     on several trees and at the main path's full-width shape;
  4. the forward path (engine.loglikelihood) at full width: 256 balanced
     taxa x 65,536 sites and 1024 taxa x 16,384 sites, GTR+Gamma4 f32,
     through the tree-sweep kernel, checked against the dense f64 path;
  5. times of loglikelihood through the kernel and through the dense f32
     path, CUDA events;
  6. the training step (engine.optimize_root_branch) at 256 x 65,536
     through the tree-sweep kernel, against the dense f64 path;
  7. the edge-scorer kernel against its plain version on every ball group
     of one full-width search round (256 taxa x 4096 sites, radius 5) and
     on a 20-state case, with CUDA-event times of both;
  8. the SPR search (search_fast.hill_climb) on the JAX bench's
     search_round inputs through the edge scorer: logL trace, round and
     phase times, RF distance and delta logL against the truth tree, final
     logL against the dense f64 path;
  9. the tensor-core sweep (mode "mma") against the plain version and
     against the "fma" kernel on the cases of phase 3 it takes, on an
     8,192-taxon random tree and on a 4,098-taxon caterpillar with branch
     lengths x 30;
 10. the large-tree path at full width: loglikelihood and
     optimize_root_branch on a random 8,192-taxon tree x 8,192 sites,
     through `choose` (which must pick "fma") and with mode "mma", against
     the dense f64 path (summed over site slices);
 11. the protein path at full width: loglikelihood at 128 taxa x 16,384
     sites, LG + Gamma4, both modes, and LG4X at a smaller width, against
     the dense f64 path;
 12. the all-edge entry points: optimize_branch_lengths on the search
     inputs, score_placements on a pruned tip, branch_derivatives against
     central differences;
 13. the matrix-unit probe (probes/mma.py) at one site block: 21 rows
     (eight variants, P on M through FFMA and mma.sync, sites on M through
     wgmma), every accumulator slot against its plain version, a line a
     row with its form, bound and share, and its time before the redesign;
 14. times of both sweep forms at four shapes, as single calls and as
     calls back to back, with the register carry on and off; the plain
     version at a fixed site block; the form `choose` picks beside the
     faster one;
 15. linked and scaled multi-partition likelihoods (multipartition.py) at
     full width: a random 256-taxon tree, three partitions (GTR DNA 16,384
     sites, another GTR DNA 8,192 sites, LG protein 4,096 sites):
     loglikelihood against the sum of single-partition calls and the dense
     f64 path, branch_derivatives against central differences,
     optimize_branch_lengths;
 16. the multi-partition SPR search (search_fast.hill_climb_multi,
     unlinked lengths) on the search inputs with a second partition
     simulated down the same truth tree;
 17. gradient model fitting (fit.fit_model) at 256 x 65,536 with the CUDA
     sweep in the forward pass and the analytic reverse pass, its first
     gradient against autograd of the dense f64 path;
 18. the build-cache probe (probes/cache.py): cold build, warm reload in a
     process with no nvcc, rebuild after an edit, each with a timeout; the
     host cost of each piece of a launch from Python; the kernel, its plain
     version and x * 2 + 1 timed as calls back to back, as single calls and
     as one CUDA graph;
 19. the construct probe (probes/constructs.py): tools/static2probe.py's
     k0-k3 over 65,536 distinct sites and 128 ops on wgmma with the site
     tile in registers, each against its plain version, timed back to back
     and in one CUDA graph, per op and against one torch.mm at equal work;
     the same kernel with the tile in shared memory (probes/variants.py's
     static2_smem_a, built beside the package's library in phase 2) in
     turns with it; then the five variants c0-c4 of the tensor-core
     sweep's inner loop, each against its plain version.
 20. the one-call journey (infer.infer_ml_tree) on the search inputs
     (256 taxa x 4,096 sites, GTR+Gamma(0.9)) written as FASTA and read
     back by io.load_fasta_msa through the native binding, at the JAX
     package's defaults (radius 5, 30 rounds, 4 of them warm-up, 150 fit
     steps, seed 42): first call of a new process (cold, a subprocess),
     then a call here (warm); infer.parsimony_start on the card against
     the same call on the host CPU (cost and splits, both timed), the
     tree sweep and the edge scorer launched inside the warm call, the
     final logL against the dense f64 path under the fitted model, a
     monotone trace, alpha, RF and delta logL against the truth tree, the
     phase times; then the fit's function on the final tree through the
     sweep kernels the fit ran: its logL against dense f64 and its
     gradient against dense f64 autograd;
 21. the partition API at full width: Partition(256, 254, 4, 65536, ...)
     in f64 on the search inputs' truth tree with 65,536 sites simulated
     down it, site repeats on and off: tip states, P-matrices,
     update_partials (timed, with its peak memory against
     memory.dense_clv_bytes), the root edge's logL and per-site values,
     sumtable and (d1, d2), ancestral rows; repeats against dense (bit for
     bit, else within 1e-12), the logL against the dense f64 engine and
     against engine.loglikelihood at f32 through tree_sweep.cu, (d1, d2)
     against central differences, the tree rooted on its root edge
     (pulley principle); a 1,024-taxon caterpillar x 4,096 sites that
     rescues, per-site and per-rate scalers, repeats on and off, against
     the dense f64 engine; hardware_probe and the max-sites table of the
     card's memory;
 22. the sharded training step (parallel/, engine.dryrun_multichip): the
     256 x 65,536 forward case on 2 ranks of 32,768 sites that share the
     card over gloo, launched by parallel.launcher.launch: loglikelihood
     and optimize_root_branch through the tree sweep on each slice, the
     dense f64 logL and all-branch (d1, d2), and one SPR round on the
     search inputs (radius 5, the plain scorer), each against the same
     work alone in this process and bit-identical across the ranks; the
     forward's CUDA-event and wall times sharded and alone; then
     engine.dryrun_multichip(2);
 23. the demos (libpll2_tpu_torch.examples), each run here through its
     main(argv) with its output captured: the 15 f64 demos on the card
     and on the host CPU, their outputs equal in text and within 1e-9 in
     every number; large_search at its defaults (256 x 4,096, radius 5,
     12 rounds, f32 through the tree-sweep and edge-scorer kernels): a
     monotone trace and a final logL within LOGL_RTOL of the dense f64
     path on its tree; infer_demo at its defaults, RF to the truth at most
     INFER_RF; an [examples] line a run with its seconds;
 24. the profiler (libpll2_tpu_torch.profiling): its five targets at the
     main path's shapes (engine and sweep at 256 x 65,536, round and
     search on the search inputs, repeats at 256 x 65,536 f64), each
     printed as a [profile] JSON line whose headline trace must hold a
     kernel;
 25. the generic-state forms of the tree sweep and the edge scorer (the
     state counts without an instantiation of their own) against their
     plain versions (the sweep's row-group form,
     csrc/tree_sweep_generic.cu, and the scorer's with pass 0's columns in
     registers): the sweep at 3, 5, 6, 7, 8, 12 and 32 states, with
     per-rate scalers and a scale-heavy case at 5 and 32, and where a
     site's row groups span warps at 9 states x 32 rates, 12 x 20, 17 x 16,
     32 x 12 and 32 x 32 (f32 and bf16); the scorer over a round at 5 and
     32 states ([generic] lines);
 26. 5 states at full width: GTR-5 + Gamma4 f32 at 256 x 65,536,
     loglikelihood against dense f64, 10 optimize_root_branch steps, the
     generic sweep's times; one SPR round at 256 x 4,096, radius 5, with
     5-state tips, its scores held to the plain scorer's and timed, then
     spr_round on the kernel against dense f64;
 27. 32 states at full width: Mk-32 + Gamma4 f32 at 128 x 16,384 and
     Mk-32 + Gamma12 (a site's row groups over two warps), loglikelihood
     against dense f64, the generic sweep's times;
 28. bf16 CLV storage (`[bf16]` lines): both sweep forms with a bf16 pool
     against the plain version at bf16 ("fma" at 2, 4, 5, 10, 16, 20 and
     32 states, per-rate and per-site scalers, "mma" at its two cases, on
     a scale-heavy caterpillar, the carry on and off bit-equal); then at
     bf16 the forward step through `choose` and with the other form forced
     at dna_256 (with 10 optimize_root_branch steps), dna_1024,
     large_8192, protein_128, the two smaller 20-state cases, 5 and 32
     states (phases 26-27's cases),
     each against the port's dense bf16 path on the card and beside the
     dense f64 path; both forms' times at bf16 at the four shapes of
     phase 14, at phase 11's LG4X case and at LG 128 x 4,096 (`[choose]`
     lines at bf16);
 29. the default config on the card (f64, use_kernel None, which the
     tree-sweep kernel does not take): engine.loglikelihood,
     optimize_root_branch, the forward of loglikelihood_analytic,
     fit.loglikelihood_fn without a FullTreeProgram and
     multipartition.loglikelihood on two partitions at 256 taxa (one plain
     sweep of both), each on the plain path, equal to the explicit
     use_kernel=False call, warned, and with
     no tree-sweep launch (`[default]` lines);
 30. the message-sweep kernel (csrc/message_sweep.cu) against its plain
     version at dna_smooth's message program (256 x 4,096 DNA, 762 ops)
     and at LG 128 x 16,384: rows and scalers, one launch a sweep, times
     back to back and single beside the plain version's, the dense
     path's and the byte bounds (least bytes, and with every op's reads
     of its children); then the main path, optimize_branch_lengths at
     the DNA shape, on the kernel against the dense path, its kernel
     launches counted from 0 (the kernels line's count; `[message]`
     lines);
 31. the Newton kernel (csrc/newton_edges.cu) on the largest colour class
     of dna_smooth's program (256 x 4,096 DNA): lengths and keep decisions
     against its plain version summing in the cluster's stripes, its time
     back to back and in single calls beside the plain version's, the
     all-edge body's plain path's and its bytes roof (two message rows an
     edge, read once); then optimize_branch_lengths at that shape on the
     kernels against the plain paths, the Newton launches counted from 0
     (the kernels line's count; `[newton]` lines);
 32. the wide sweep (csrc/tree_sweep_wide.cu) at codon_eval's shape (128
     random taxa x 16,384 codons, GY94 + F3x4 + Gamma4, 61 states, f32):
     rows and scalers against its plain version, its time back to back and
     in single calls beside the plain version's and the dense path's (the
     sweep the engine runs without a form: level-batched products, every
     CLV in device memory), which it must beat, its share of the roof
     (operations at TF32, int64 tips), then engine.loglikelihood through
     it against dense f64, one launch, no warning (`[wide]` lines).

The edge scorer's two forms (the sumtable resident in a thread-block
cluster's shared memory, or re-read from the rows in every pass) are both
held against the plain version and timed over the same round; both sweep
forms run with their register carry on and off (bit-equal rows) at the site
block that fills the card.

Prints a {"kernels": [...]} JSON line, then the result line
{"ok": true, "device": {...}} last.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

SCALE_BITS = 30          # f32 scale factor is 2^30 (config.scale_factor)
CLV_RTOL = 1e-5          # kernel vs plain: f32 sums in another order
LOGL_RTOL = 5e-6         # kernel f32 vs dense f64 logL (bench.py's budget)
BL_RTOL = 1e-4           # Newton root branch, f32 kernel path vs dense f64
SCORE_RTOL = 2e-5        # edge scorer kernel vs plain, on max(1, |score|)
T3_RTOL, T3_ATOL = 2e-3, 2e-5   # its refined branch (the JAX test's bounds)
SEARCH_SEED = 20260820   # bench.py measure_search_round
SEARCH_TIPS, SEARCH_SITES, SEARCH_RADIUS = 256, 4096, 5
SEARCH_ROUNDS = 30       # the JAX bench's climb depth
INFER_ROUNDS, INFER_WARMUP, INFER_STEPS = 30, 4, 150   # infer_ml_tree's
INFER_SEED = 42          # defaults (libpll2_tpu/infer.py:80-88)
INFER_RF = 0.15          # normalised RF to the truth: tests/test_infer.py
MULTI_ROUNDS = 12        # depth of the two-partition climb (cut: 30 at most
#                          in the single-partition climb above)
MULTI_TIPS = 256         # the linked / scaled three-partition case:
MULTI_SITES = (16384, 8192, 4096)   # GTR DNA, another GTR DNA, LG protein
MULTI_SCALERS = (1.0, 0.7, 1.6)
FIT_STEPS, FIT_LR = 30, 0.02
FIT_START_SUBST = [1.5, 1.5, 0.8, 1.2, 2.5, 1.0]   # a model away from the
FIT_START_FREQS = [0.3, 0.2, 0.3, 0.2]             # optimum and from the
FIT_START_ALPHA = 0.7                              # degenerate unit rates
GRAD_RTOL = 1e-4         # analytic f32 gradient vs dense f64 autograd, of
#                          each leaf's largest entry
D1_RTOL = 2e-3           # f32 branch derivatives vs f64 central differences
# "mma" rows against the plain version, relative to each site's largest
# entry, where the scalers agree: 2e-5 plus 1.5e-7 per op.  A root row
# carries the summed relative error of every op below it, and the tensor
# cores round each product toward zero (about half an f32 ulp, 4e-8, per
# child and op), so the gap grows with the op count.  Relative to the
# site: TF32 flushes subnormal inputs, so entries 2^-96 below their
# site's largest differ while carrying no likelihood.
MMA_RTOL, MMA_RTOL_PER_OP = 2e-5, 1.5e-7
COMP_RTOL = 2e-3         # scaling-compensated, where a rescue flipped
LARGE_TIPS, LARGE_SITES = 8192, 8192
# Earlier measurements on an NVIDIA H100 80GB HBM3 at 700.00 W, printed
# beside this run's: the edge scorer over the full-width round while the
# re-reading form was the only one, and the "mma" sweep before the register
# carry and the SM-fill site block (PERF.md).
EDGE_MS_BEFORE = 16.3053
SEARCH_BEFORE = "RF 0.0198 in 19 rounds, 1,063 moves, delta logL -89.125"
MMA_MS_BEFORE = {"dna_256": 1.2908, "dna_1024": 2.5914,
                 "large_8192": 21.3937, "protein_128": 2.4378}
# the "fma" sweep before its redesign (one thread per site, operands loaded
# when the op starts; single calls in two runs), and the plain version's
# single calls at 256-site blocks in the two runs before this one's timer
FMA_MS_BEFORE = {"dna_256": (1.8123, 1.6223), "dna_1024": (3.5945,),
                 "large_8192": (26.1673,), "protein_128": (6.56,)}
PLAIN_MS_BEFORE = {"dna_256": "154.06 and 137.65 ms",
                   "dna_1024": "632.79 and 309.72 ms",
                   "large_8192": "4079.04 and 2447.35 ms",
                   "protein_128": "not timed"}
# the matrix-unit probe before its redesign (two buffers summed into one
# accumulator a tile; 15 rows at TB 128): ms of one probes/mma.py call of
# 512 products over 65,536 sites, its operand packing inside the events as
# that probe timed it, on an NVIDIA H100 80GB HBM3 at 700.00 W
PROBE_MS_BEFORE = {
    ("span16", "fma"): 1.238, ("span16", "tf32"): 0.298,
    ("span16", "bf16"): 0.146, ("stacked3", "fma"): 3.631,
    ("stacked3", "tf32"): 0.630, ("stacked3", "bf16"): 0.317,
    ("span80", "fma"): 30.270, ("span80", "tf32"): 2.442,
    ("span80", "bf16"): 1.260, ("pack2", "fma"): 13.560,
    ("pack2", "tf32"): 1.579, ("pack2", "bf16"): 0.668,
    ("pack4", "fma"): 55.574, ("pack4", "tf32"): 6.972,
    ("pack4", "bf16"): 2.438}
PLAIN_BLOCK = 64         # the plain sweep's fixed site block in its timings
CACHE_REPS = 200         # cache-probe calls back to back in one timing
CACHE_TURNS = 11         # runs of CACHE_REPS back to back, in turns
CACHE_HOST_CALLS = 10000  # calls of each launch piece in its host timing
CHOOSE_SLACK = 1.25      # choose's form against the faster one, same run
STATIC2_REPS = 50        # k0-k3 launches back to back and in one CUDA graph
PROTEIN_TIPS, PROTEIN_SITES = 128, 16384
# published peaks of one H100 SXM (dense): HBM bytes/s, f32 FMA FLOP/s,
# TF32 and bf16 tensor FLOP/s; shared memory at 128 B/clk/SM x 132 SMs x
# 1.98 GHz
HBM_RATE, F32_RATE, TF32_RATE, BF16_RATE = 3.35e12, 67e12, 495e12, 989e12
SMEM_RATE = 128 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int):
    """Per-call device times of `reps` calls (ms), CUDA events."""
    import torch
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def cuda_ms_back_to_back(fn, n: int) -> float:
    """Device time (ms) of one call: after one call to warm up, `n` calls
    launched back to back between one pair of CUDA events, divided by n.
    The host time of a wrapper overlaps the device work of the calls
    before it, so this is the kernel's time where the kernel is longer than
    its launch, and the launch rate where it is not."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0 (just before a path
    is driven)."""
    from libpll2_tpu_torch.ops import (edge_score, message_sweep,
                                       newton_edges, partials_tree)
    from libpll2_tpu_torch.probes import cache, constructs
    from libpll2_tpu_torch.probes import mma as probe
    partials_tree.sweep.launches = 0
    for mode in partials_tree.sweep.launches_by_mode:
        partials_tree.sweep.launches_by_mode[mode] = 0
    partials_tree.sweep.launches_generic = 0
    for mode in partials_tree.sweep.launches_bf16:
        partials_tree.sweep.launches_bf16[mode] = 0
    edge_score.edge_scores.launches = 0
    edge_score.edge_scores.launches_generic = 0
    for form in edge_score.edge_scores.launches_by_form:
        edge_score.edge_scores.launches_by_form[form] = 0
    probe.chain.launches = 0
    for form in probe.chain.launches_by_form:
        probe.chain.launches_by_form[form] = 0
    cache.scale_shift.launches = 0
    constructs.constructs.launches = 0
    constructs.static2.launches = 0
    message_sweep.sweep_messages.launches = 0
    newton_edges.newton_edges.launches = 0


def read_counts() -> dict:
    """Launches per kernel since reset_counts (just after a path).  The
    generic-state forms' launches are also within "tree_sweep" and
    "edge_score", the bf16 forms' within "tree_sweep" and
    "tree_sweep_mma"."""
    from libpll2_tpu_torch.ops import (edge_score, message_sweep,
                                       newton_edges, partials_tree)
    from libpll2_tpu_torch.probes import cache, constructs
    from libpll2_tpu_torch.probes import mma as probe
    by_mode = partials_tree.sweep.launches_by_mode
    return {"tree_sweep": by_mode["fma"], "tree_sweep_mma": by_mode["mma"],
            "tree_sweep_generic": partials_tree.sweep.launches_generic,
            "tree_sweep_bf16": partials_tree.sweep.launches_bf16["fma"],
            "tree_sweep_mma_bf16": partials_tree.sweep.launches_bf16["mma"],
            "edge_score": edge_score.edge_scores.launches,
            "edge_score_generic": edge_score.edge_scores.launches_generic,
            "mma_probe": probe.chain.launches,
            "cache_probe": cache.scale_shift.launches,
            "construct_probe": constructs.static2.launches,
            "construct_probe_c0_c4": constructs.constructs.launches,
            "message_sweep": message_sweep.sweep_messages.launches,
            "newton_edges": newton_edges.newton_edges.launches,
            "tree_sweep_wide": by_mode[partials_tree.WIDE]}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    from libpll2_tpu_torch.profiling import card as card_of
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_of(torch.device("cuda", 0))
    log(card)
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"[device] {torch.cuda.get_device_name(0)}  torch "
        f"{torch.__version__}  torch.version.cuda {torch.version.cuda}  "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else '?'}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    """Build the kernels, and beside them the construct probe's
    static2_smem_a variant (a patched copy of csrc/, probes/variants.py)
    for phase 19, both at once; print each entry function's registers and
    spills as ptxas -v reports them, and any ptxas line about wgmma.
    Returns the variant's library."""
    import concurrent.futures

    from libpll2_tpu_torch import _build
    from libpll2_tpu_torch.probes import variants
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        smem_a = pool.submit(variants.variant_library, "static2_smem_a")
        info = _build.build()
        _build.library()
        smem_a_lib, smem_a_info = smem_a.result()
    log(f"[build] {info.path.name} from {[str(s.name) for s in _build.SOURCES]}"
        f" flags {' '.join(_build.NVCC_FLAGS)}: nvcc {info.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s); static2_smem_a variant "
        f"nvcc {smem_a_info.seconds:.2f} s alongside")
    log_ptxas(info.log)
    log_ptxas(smem_a_info.log, only="static2_kernel", tag="static2_smem_a ")
    return smem_a_lib


def log_ptxas(text: str, only: str = "", tag: str = "") -> None:
    """[build] lines of an nvcc log: each entry function's registers and
    spills (of the entries whose name holds `only`), and ptxas's lines
    about wgmma."""
    source, entry, spills = "", "", ""
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("[") and line.endswith("]"):
            source = line[1:-1]
        elif "(C75" in line or ("wgmma" in line and "warn" in line.lower()):
            if only in line or not only:
                log(f"[build] {tag}{source}: {line}")    # ptxas on wgmma
        elif "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif "registers" in line and only in entry:
            log(f"[build] {tag}{source} {entry}: "
                f"{line.split(':', 1)[-1].strip()}; {spills}")


def sweep_inputs(newick, sites, seed, device, states=4, per_rate=False,
                 bl_scale=1.0, random_model=False, rates=4, dtype=None,
                 tb=None):
    """(cfg, program, pmatrix, tip_blocked, tb) for one sweep case; tb is
    the site block `choose` gives the "fma" form (the "mma" form's
    footprint is no larger, so it can run at the same block) unless given.
    dtype: the pool's type (f32 by default; the P buffer is made at it)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.generate import random_tipchars

    tree = T.parse_newick_string(newick)
    n = tree.tip_count
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=states, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=rates,
        scale_buffers=tree.inner_count, per_rate_scalers=per_rate,
        dtype=dtype or torch.float32, use_kernel=True)
    program = engine.compile_tree(tree, cfg)
    rng = np.random.default_rng(seed)
    if random_model:
        subst = rng.uniform(0.2, 3.0, states * (states - 1) // 2)
        freqs = rng.dirichlet(np.full(states, 5.0))
    else:
        subst, freqs = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0], [0.3, 0.25, 0.2, 0.25]
    model = engine.make_model([subst], [freqs],
                              compute_gamma_cats(0.8, rates),
                              dtype=torch.float32, device=device)
    tipchars = torch.as_tensor(engine.pad_tipchars(
        random_tipchars(n, sites, rng, states=states), cfg), device=device)
    bl = torch.as_tensor(program.default_branch_lengths * bl_scale,
                         dtype=torch.float32, device=device)
    pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
    if tb is None:
        tb, _ = kernel_form(program, dataclasses.replace(
            cfg, sweep_mode="fma"), tipchars.device)
    return cfg, program, pmatrix, engine.block_tips(tipchars, cfg, tb), tb


def kernel_form(program, cfg, device):
    """(site block, mode) the tree sweep takes for this case: kernel_choice
    under use_kernel=True, which raises with the reason where no form
    takes it.  (Under the default use_kernel=None such a case runs the
    dense path on the card, warned, and kernel_choice gives None.)"""
    from libpll2_tpu_torch import engine
    return engine.kernel_choice(
        program, dataclasses.replace(cfg, use_kernel=True), device)


def compare_rows(got, want, got_s, want_s):
    """Kernel vs plain rows: (max abs err, scaler mismatches, max rel err
    of scaling-compensated values).  Where a site's rescue decision flips
    (its CLV within an ulp of the threshold), CLV x 2^(30k) and scaler + k
    compensate exactly, so compare compensated values in f64."""
    import torch
    g, w = got.double(), want.double()
    # scaler rows [E, NT, SR, TB] -> per CLV entry [E, NT, R|1, 1, TB]
    gs = got_s.double()[:, :, :, None, :]
    ws = want_s.double()[:, :, :, None, :]
    if gs.shape[2] == 1:
        gs, ws = gs.expand(-1, -1, g.shape[2], -1, -1), \
            ws.expand(-1, -1, g.shape[2], -1, -1)
    gc = g * torch.exp2(-SCALE_BITS * gs)
    wc = w * torch.exp2(-SCALE_BITS * ws)
    rel = ((gc - wc).abs() / wc.abs().clamp_min(1e-300)).max().item()
    same = (got_s == want_s).all(dim=2, keepdim=True)[:, :, :, None, :]
    abs_err = ((g - w).abs() * same).max().item()
    mismatches = int((got_s != want_s).sum().item())
    return abs_err, mismatches, rel


def caterpillar(n):
    s = "(t0:0.1,t1:0.2)"
    for i in range(2, n - 2):
        s = f"({s}:0.05,t{i}:0.1)"
    return f"({s}:0.05,t{n - 2}:0.1,t{n - 1}:0.1);"


@functools.cache
def large_newick():
    """The random LARGE_TIPS-taxon tree of the large-tree checks."""
    from libpll2_tpu_torch.tree.generate import random_newick
    return random_newick(LARGE_TIPS, np.random.default_rng(8192))


def sweep_cases():
    """(name, newick, sites, sweep_inputs keywords) of the sweep checks."""
    from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

    rng = np.random.default_rng(2024)
    return [
        ("random40", random_newick(40, rng), 4096, {}),
        ("caterpillar64", caterpillar(64), 4096, {}),
        ("scale_heavy48", random_newick(48, rng), 4096, {"bl_scale": 30.0}),
        ("per_rate40", random_newick(40, rng), 4096,
         {"bl_scale": 30.0, "per_rate": True}),
        ("protein24_S20", random_newick(24, rng), 2048,
         {"states": 20, "random_model": True}),
        ("balanced1024_1022ops", balanced_newick(1024), 16384, {}),
        ("balanced256_full", balanced_newick(256), 65536, {}),
    ]


def site_errors(got, want, got_s, want_s):
    """[E, NT, TB] f64: each site's largest error of scaling-compensated
    values, relative to the site's largest entry (rows [E, NT, R, S, TB];
    where the scalers agree, the error of the values themselves)."""
    import torch
    g, w = got.double(), want.double()
    gs = got_s.double()[:, :, :, None, :]      # [E, NT, 1, 1, TB]
    ws = want_s.double()[:, :, :, None, :]
    mag = w.amax(dim=(2, 3), keepdim=True).clamp_min(1e-300)
    # compensate by the scalers' difference: 2^(-30 k) itself underflows
    # f64 on a large tree (k in the hundreds)
    gc = g * torch.exp2(-SCALE_BITS * (gs - ws))
    return ((gc - w).abs() / mag).amax(dim=(2, 3))


def compare_rows_site(got, want, got_s, want_s):
    """As compare_rows, relative to each site's largest entry: (max err
    where the scalers agree, scaler mismatches, max err of
    scaling-compensated values, max abs err where the scalers agree)."""
    g, w = got.double(), want.double()
    mag = w.amax(dim=(2, 3), keepdim=True).clamp_min(1e-300)
    same = (got_s == want_s)[:, :, :, None, :]
    rel = (((g - w).abs() / mag) * same).max().item()
    comp = site_errors(got, want, got_s, want_s).max().item()
    abs_err = ((g - w).abs() * same).max().item()
    return rel, int((got_s != want_s).sum().item()), comp, abs_err


def tip_adds(prog, cfg, tips):
    """f32 adds a sweep needs for its tip children: P's columns that a
    child's mask selects, summed, R*S adds a site for each set bit past
    the first (a resolved state is one column read).  tips: the blocked
    tip masks [NT, tips, TB] of this run."""
    import torch
    bits = torch.zeros(tips.shape[1], dtype=torch.int64, device=tips.device)
    for k in range(cfg.states):
        bits += ((tips >> k) & 1).sum(dim=(0, 2))
    child = np.concatenate([prog.ops[prog.ops[:, 3] > 0, 1],
                            prog.ops[prog.ops[:, 6] > 0, 4]])
    extra = (bits.cpu().numpy()[child] - cfg.sites_padded).clip(0).sum()
    return cfg.rate_cats * cfg.states * int(extra)


def sweep_bound(prog, cfg, mode, tips):
    """Least time (ms) the card could take for one sweep: the larger of
    the bytes it must move through device memory (tip masks, op table and
    P-matrices read once, exported rows written once) over the HBM rate,
    and its operations over the peak of the unit that does them.  For
    "fma" the f32 work the function needs: a product P . c for each inner
    child, `tip_adds` for the tip children of this run's masks, and the
    elementwise work.  For "mma" the TF32 products of the compensated
    split (three per inner child, two per tip child, which the form
    multiplies as one-hot rows) plus the f32 elementwise work; with a bf16
    pool one bf16 product per child at the bf16 tensor rate.  P is read in
    the pool's type, tips once and the exported rows written once in f32
    whatever the pool's type.  Also the time of its shared-memory traffic
    (two children read, one parent written per op) at the shared-memory
    rate.  Returns (bound_ms, bound_by, bytes_ms, ops_ms, smem_ms)."""
    from libpll2_tpu_torch.ops import partials_tree
    sites, R, S = cfg.sites_padded, cfg.rate_cats, cfg.states
    item = partials_tree.pool_itemsize(cfg)
    sr = R if (cfg.per_rate_scalers and mode == "fma") else 1
    slots = int(prog.ops[:, [7, 8]].max()) + 1
    nbytes = (cfg.tips * sites * 4 + prog.ops.size * 4
              + slots * R * S * S * item
              + len(prog.exports) * sites * (cfg.span + sr) * 4)
    tip_children = int(prog.ops[:, 3].sum() + prog.ops[:, 6].sum())
    inner_children = 2 * prog.n_ops - tip_children
    product = 2 * R * S * S * sites                # FLOPs of one P . child
    elementwise = 2 * cfg.span * sites * prog.n_ops
    if mode == "mma" and item == 2:
        ops_s = (2 * prog.n_ops * product / BF16_RATE
                 + elementwise / F32_RATE)
    elif mode == "mma":
        ops_s = ((3 * inner_children + 2 * tip_children) * product
                 / TF32_RATE + elementwise / F32_RATE)
    else:
        ops_s = (inner_children * product + tip_adds(prog, cfg, tips)
                 + elementwise) / F32_RATE
    bytes_s = nbytes / HBM_RATE
    smem_s = (prog.n_ops * sites * 3 * (cfg.span * item + sr * 4)
              / SMEM_RATE)
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations",
            bytes_s * 1e3, ops_s * 1e3, smem_s * 1e3)


def phase_kernel_vs_plain(device):
    import torch

    from libpll2_tpu_torch.ops import partials_tree

    for i, (name, newick, sites, kw) in enumerate(sweep_cases()):
        cfg, program, pmatrix, tip_b, tb = sweep_inputs(
            newick, sites, i, device, **kw)
        prog = program.vmem_prog
        got = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
        want = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
        if device.type == "cuda":
            torch.cuda.synchronize()
        abs_err, mism, rel = compare_rows(got[0], want[0], got[1], want[1])
        rescues = int(want[1].max().item())
        log(f"[kernel] {name}: ops={prog.n_ops} pool={prog.pool_size} "
            f"tb={tb} sites={sites} S={cfg.states} per_rate="
            f"{cfg.per_rate_scalers} max_abs_err={abs_err:.3e} "
            f"compensated_rel_err={rel:.3e} scaler_mismatches={mism} "
            f"max_scaler={rescues}")
        check(rel <= CLV_RTOL, f"{name}: CLV rel err {rel} > {CLV_RTOL}")
        if "bl_scale" in kw:
            check(rescues > 0, f"{name}: scale-heavy case did not rescue")


def phase_main_path(device, card):
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    shapes = ((256, 65536), (1024, 16384))
    cases = {s: engine.build_case(*s, dtype=torch.float32, device=device)
             for s in shapes}
    torch.cuda.synchronize()

    reset_counts()
    logls = {}
    for s in shapes:
        t0 = time.perf_counter()
        (cfg, program, model, *args) = cases[s]
        logls[s] = engine.loglikelihood(program, cfg, model, *args)
        torch.cuda.synchronize()
        logls[s] = (logls[s].item(), (time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    log(f"[main] sweep launches during the main path: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']}")
    check(counts["tree_sweep"] + counts["tree_sweep_mma"] >= len(shapes),
          "the main path did not launch the kernel")

    for s in shapes:
        logl, cold_ms = logls[s]
        (cfg, program, model, *args) = engine.build_case(
            *s, dtype=torch.float64, device=device, use_kernel=False)
        ref = engine.loglikelihood(program, cfg, model, *args).item()
        del args
        torch.cuda.empty_cache()
        gap = abs(logl - ref) / abs(ref)
        log(f"[main] {s[0]} taxa x {s[1]} sites: logL kernel f32 {logl!r} "
            f"dense f64 {ref!r} rel gap {gap:.3e} (first call, cold: "
            f"{cold_ms:.3f} ms, {card})")
        check(np.isfinite(logl), f"{s}: non-finite logL")
        check(gap < LOGL_RTOL, f"{s}: rel gap {gap} >= {LOGL_RTOL}")
    return cases, logls[shapes[0]][1], counts


def phase_times(full_case, cold_ms, card):
    """loglikelihood through the kernel and through the dense f32 path
    (the sweep alone is timed in phase_sweep_times)."""
    import torch

    from libpll2_tpu_torch import engine

    cfg, program, model, *args = full_case
    updates = (cfg.tips - 2) * cfg.sites
    for label, c in (("kernel", cfg),
                     ("dense_f32", dataclasses.replace(cfg,
                                                       use_kernel=False))):
        def call(c=c):
            return engine.loglikelihood(program, c, model, *args)
        if label == "dense_f32":
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
        else:
            first = cold_ms
        for _ in range(3):
            call()
        med = statistics.median(cuda_ms(call, 25))
        log(f"[time] loglikelihood {label} {cfg.tips}x{cfg.sites}: warm "
            f"median {med:.4f} ms over 25 calls, first call (cold) "
            f"{first:.3f} ms, {updates / (med * 1e-3):.4e} site-updates/s "
            f"({card})")


def phase_training(full_case, card):
    """engine.optimize_root_branch (one training step) at the forward
    path's full width through the tree-sweep kernel, against the dense f64
    path on the same card."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    cfg, program, model, *args = full_case
    reset_counts()
    new_bl, logl = engine.optimize_root_branch(program, cfg, model, *args)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[train] sweep launches during optimize_root_branch: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']}")
    check(counts["tree_sweep"] + counts["tree_sweep_mma"] >= 1,
          "the training step did not launch the kernel")

    root_pos = int(np.nonzero(
        program.pmatrix_indices == program.root_pmatrix)[0][0])
    ms = statistics.median(cuda_ms(
        lambda: engine.optimize_root_branch(program, cfg, model, *args), 10))
    cfg64, program64, model64, *args64 = engine.build_case(
        cfg.tips, cfg.sites, dtype=torch.float64, device=args[0].device,
        use_kernel=False)
    new64, logl64 = engine.optimize_root_branch(program64, cfg64, model64,
                                                *args64)
    del args64
    torch.cuda.empty_cache()
    logl, logl64 = logl.item(), logl64.item()
    t, t64 = new_bl[root_pos].item(), new64[root_pos].item()
    t_before = args[0][root_pos].item()
    gap = abs(logl - logl64) / abs(logl64)
    t_gap = abs(t - t64) / abs(t64)
    log(f"[train] {cfg.tips} taxa x {cfg.sites} sites: logl_before f32 "
        f"{logl!r} dense f64 {logl64!r} rel gap {gap:.3e}; root branch "
        f"{t_before!r} -> f32 {t!r}, f64 {t64!r} (rel gap {t_gap:.3e}); "
        f"warm median {ms:.4f} ms over 10 calls ({card})")
    check(np.isfinite(logl) and gap < LOGL_RTOL,
          f"training step logL gap {gap} >= {LOGL_RTOL}")
    check(np.isfinite(t) and t_gap < BL_RTOL,
          f"root branch gap {t_gap} >= {BL_RTOL}")
    return counts


def search_inputs(device, tips=SEARCH_TIPS, sites=SEARCH_SITES,
                  seed=SEARCH_SEED):
    """The JAX bench's search_round case (bench.py measure_search_round,
    profiling.search_case): random truth tree, GTR+Gamma(0.9) alignment
    simulated down it, a random start tree over the same labels; f32.
    Returns (truth, start, chars, cfg, model)."""
    from libpll2_tpu_torch.profiling import search_case
    return search_case(device, tips, sites, seed)


def protein_search_inputs(device, tips=20, sites=512, seed=7):
    """A small 20-state case for the edge scorer: random exchangeabilities
    and frequencies, random tips.  Returns (start, chars, cfg, model)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.generate import random_newick

    rng = np.random.default_rng(seed)
    start = T.parse_newick_string(random_newick(tips, rng))
    chars = {n.label: np.uint64(1) << rng.integers(0, 20, sites,
                                                   dtype=np.uint64)
             for n in start.nodes[:tips]}
    cfg = PartitionConfig(
        tips=tips, clv_buffers=start.inner_count, states=20, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=torch.float32)
    model = engine.make_model([rng.uniform(0.2, 3.0, 190)],
                              [rng.dirichlet(np.full(20, 5.0))],
                              compute_gamma_cats(0.8, 4),
                              dtype=torch.float32, device=device)
    return start, chars, cfg, model


def compare_scores(got, want, valid):
    """Edge scorer kernel vs plain on one chunk: (-inf patterns equal,
    finite slots, max abs err, max rel err on max(1, |s|), t3 excess over
    its bound, t3 max rel err)."""
    (s_k, t_k), (s_p, t_p) = got, want
    s_k, t_k, s_p, t_p = (x.double().cpu().numpy()
                          for x in (s_k, t_k, s_p, t_p))
    same_inf = bool(np.array_equal(np.isneginf(s_k), np.isneginf(s_p)))
    fin = valid & np.isfinite(s_k) & np.isfinite(s_p)
    if not fin.any():
        return same_inf, 0, 0.0, 0.0, 0.0, 0.0
    err = np.abs(s_k[fin] - s_p[fin])
    rel = err / np.maximum(1.0, np.abs(s_p[fin]))
    t_err = np.abs(t_k[fin] - t_p[fin])
    excess = t_err - (T3_ATOL + T3_RTOL * np.abs(t_p[fin]))
    return (same_inf, int(fin.sum()), float(err.max()), float(rel.max()),
            float(excess.max()), float((t_err / np.abs(t_p[fin])).max()))


def edge_score_work(score_ops, sub_rows, valid, R, S, T, newton_iters):
    """(bytes, f32 FLOPs) one edge-scorer launch needs for these slots:
    every distinct message row and scaler row a valid slot names read
    once (its away row, its base row, its candidate's subtree row), the
    half-P matrices of its edges, two f32 results written; per valid slot
    and site three S x S products per rate and the elementwise products,
    one more product per candidate for the subtree term, and per Newton
    pass three sums over span (one in the last pass)."""
    from libpll2_tpu_torch import search_fast as sf
    span = R * S
    cand = np.nonzero(valid.any(axis=1))[0]
    away = {(c, int(v)) for c in cand
            for v in score_ops[c, valid[c], sf.BOP_PARENT]}
    base = set(score_ops[..., sf.BOP_SC_ROW][valid].tolist()) \
        | set(sub_rows[cand, 0].tolist())
    scal = set(score_ops[..., sf.BOP_SC_SCAL][valid].tolist()) \
        | set(sub_rows[cand, 1].tolist())
    edges = set(score_ops[..., sf.BOP_EDGE][valid].tolist())
    n = int(valid.sum())
    nbytes = ((len(away) + len(base)) * span * T * 4
              + (len(away) + len(scal)) * T * 4
              + len(edges) * R * S * S * 4 + n * 8)
    product = 2 * R * S * S * T
    flops = (n * (3 * product + 2 * span * T)
             + len(cand) * product
             + n * (newton_iters * 3 + 1) * 2 * span * T)
    return nbytes, flops


def score_round_both(prog, model, chars, timed: bool):
    """Every ball group of one round through the edge scorer kernel (the
    form `plan` picks for the shape and, where that is the resident form,
    the re-reading form too) and its plain version, chunk by chunk on the
    same recursion scratch.  Returns a dict of the worst agreement of each
    form and, if timed, the summed CUDA event times of all over the round
    (`launches` counts the chunks, one launch of the planned form each)."""
    import torch

    from libpll2_tpu_torch import _build
    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch.ops import edge_score

    cfgx = prog.cfg_ext
    dev = model.eigenvals.device
    tip, pw, inv = sf._site_arrays(prog, chars, dev)
    bl = torch.as_tensor(prog.branch_lengths, dtype=cfgx.dtype, device=dev)
    base_clv, base_scal, pmatrix, halves = sf._spr_base(
        cfgx, model, sf._long(prog.level_ops, dev),
        sf._long(prog.pmatrix_slots, dev), bl, tip)
    halves = halves.contiguous()
    consts = edge_score.model_constants(model, cfgx)
    R, S, T = cfgx.rate_cats, cfgx.states, tip.shape[-1]
    form, cluster = edge_score.plan(R, S, T, _build.max_shared_memory(dev))
    forms = (form,) if form == "reread" else (form, "reread")
    out = dict(same_inf=True, finite=0, slots=0, max_abs_err=0.0,
               max_rel_err=0.0, t3_excess=-1.0, t3_rel=0.0, kernel_ms=0.0,
               plain_ms=0.0, launches=0, bytes=0, flops=0, form=form,
               cluster=cluster, forms=forms,
               smem=edge_score.resident_smem_bytes(R, S, T, cluster)
               if cluster else 0)
    for f in forms:
        out[f"{f}_ms"] = 0.0
    kw = dict(newton_iters=3, log_thresh=cfgx.log_scale_threshold)
    for g in prog.ball_groups:
        lvls = tuple(sf._long(a, dev) for a in g.ball_levels)
        medges = sf._long(g.merge_edges, dev)
        ops32 = torch.as_tensor(g.score_ops, device=dev)
        rows32 = torch.as_tensor(g.sub_rows, device=dev)
        Cg, Vg = g.score_ops.shape[:2]
        cb = min(sf.CAND_BATCH, Cg)
        while Cg % cb:
            cb -= 1
        scratch = torch.empty((cb, prog.ball_slots, R, S, T),
                              dtype=torch.float32, device=dev)
        sscr = torch.empty((cb, prog.ball_slots, T), dtype=torch.int32,
                           device=dev)
        for cs in range(0, Cg, cb):
            cands = torch.arange(cs, cs + cb, device=dev)
            sf._recurse(cfgx, model, base_clv, base_scal, pmatrix, bl, lvls,
                        medges, cands, scratch, sscr)
            t0 = torch.clamp(bl[sf._long(g.edge_pos[cs:cs + cb], dev)],
                             1e-8, 100.0)
            args = (scratch, sscr, base_clv, base_scal, halves,
                    ops32[cs:cs + cb].contiguous(),
                    rows32[cs:cs + cb].contiguous(), t0, *consts, pw)
            calls = {f: functools.partial(edge_score.edge_scores, *args,
                                          form=f, **kw) for f in forms}
            calls["plain"] = functools.partial(
                edge_score.edge_scores_reference, *args, **kw)
            # a form's time is the kernel's own: the median of three
            # launches back to back after one that is not timed, so that no
            # launch waits for the host (a single timed call after a
            # synchronise holds 0.1-0.2 ms of the wrapper's host time)
            runs = {}
            for name, fn in calls.items():
                runs[name] = fn()
                if timed:
                    reps = 1 if name == "plain" else 3
                    out[f"{name}_ms"] += statistics.median(cuda_ms(fn, reps))
            out["launches"] += 1
            valid = g.score_ops[cs:cs + cb, :, sf.BOP_VALID] == 1
            nbytes, flops = edge_score_work(
                g.score_ops[cs:cs + cb], g.sub_rows[cs:cs + cb], valid,
                R, S, T, kw["newton_iters"])
            out["bytes"] += nbytes
            out["flops"] += flops
            out["slots"] += int(valid.sum())
            for f in forms:         # every form held to the same bounds
                same, fin, err, rel, excess, t_rel = compare_scores(
                    runs[f], runs["plain"], valid)
                out["same_inf"] &= same
                out["finite"] += fin if f == form else 0
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["max_rel_err"] = max(out["max_rel_err"], rel)
                out["t3_excess"] = max(out["t3_excess"], excess)
                out["t3_rel"] = max(out["t3_rel"], t_rel)
    out["kernel_ms"] = out[f"{form}_ms"]
    return out


def check_scores(name, r):
    """The checks made of one score_round_both result: -inf patterns
    equal, finite scores within SCORE_RTOL, t3 within its bound."""
    check(r["same_inf"], f"{name}: -inf patterns differ")
    check(r["finite"] > 0, f"{name}: no finite score compared")
    check(r["max_rel_err"] <= SCORE_RTOL,
          f"{name}: score rel err {r['max_rel_err']} > {SCORE_RTOL}")
    check(r["t3_excess"] <= 0.0, f"{name}: t3 outside its bound")


def log_scores(tag, name, r):
    """One line of a score_round_both result, opened by `tag`."""
    log(f"{tag} {name}: form={r['form']} cluster={r['cluster']} "
        f"({r['smem']} bytes of shared memory per CTA; forms held "
        f"against the plain version: {', '.join(r['forms'])}); "
        f"{r['launches']} launches, {r['slots']} valid "
        f"slots, {r['finite']} finite in both; -inf pattern equal "
        f"{r['same_inf']}; score max abs err {r['max_abs_err']:.3e}, "
        f"rel {r['max_rel_err']:.3e} (bound {SCORE_RTOL}); t3 max rel "
        f"{r['t3_rel']:.3e} (bound rtol {T3_RTOL} atol {T3_ATOL})")


def phase_edge_scorer(device, card):
    from libpll2_tpu_torch import search_fast as sf

    _truth, start, chars, cfg, model = search_inputs(device)
    full = score_round_both(sf.compile_spr(start, cfg, radius=SEARCH_RADIUS),
                            model, chars, timed=True)
    pstart, pchars, pcfg, pmodel = protein_search_inputs(device)
    small = score_round_both(sf.compile_spr(pstart, pcfg, radius=3), pmodel,
                             pchars, timed=False)
    for name, r in ((f"S={cfg.states} {cfg.tips}x{cfg.sites} radius "
                     f"{SEARCH_RADIUS}", full),
                    (f"S={pcfg.states} {pcfg.tips}x{pcfg.sites} radius 3",
                     small)):
        log_scores("[edge]", name, r)
        check_scores(name, r)
    log(f"[time] edge scorer over one full-width round ({full['launches']} "
        f"launches of up to {sf.CAND_BATCH} candidates): " + ", ".join(
            f"{f} form {full[f + '_ms']:.4f} ms" for f in full["forms"])
        + f", medians of 3 launches back to back per chunk (the search runs "
        f"the {full['form']} form; the re-reading form took {EDGE_MS_BEFORE} "
        f"ms as the only form, one timed launch per chunk), plain "
        f"edge_scores_reference {full['plain_ms']:.4f} ms ({card})")
    return full


def placement_inputs(newick, raw, cfg, device):
    """Inputs of engine.score_placements for pruning the tip with CLV
    index 0 from `newick` (raw: packed tip states [tips, sites] by CLV
    index; cfg: the full tree's config).  Returns (full_r, cfg_r,
    tipchars_r, sub_clv, sub_scaler, sub_len, origin, halved): the
    remainder tree's message program, config and tips, the pruned tip's
    CLV directed at the cut with zero scalers, its branch, the position of
    the remainder edge the tip came from, and the original tree (CLV
    indices as in `raw`) with that edge's two halves made equal.  SPR
    semantics split the target edge in half, so score_placements[origin]
    equals the logL of `halved`."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.tree import moves
    from libpll2_tpu_torch.tree.utree import traverse_subtree

    tree = T.parse_newick_string(newick)
    n = tree.tip_count
    tip0 = next(x for x in tree.nodes[:n] if x.clv_index == 0)
    p = tip0.back
    sub_len = float(p.length)
    merged = float(p.next.length) + float(p.next.next.length)
    behind_a = frozenset(x.label for x in traverse_subtree(p.next.back)
                         if x.next is None)
    row_of = {x.label: x.clv_index for x in tree.nodes[:n]}

    halved = T.parse_newick_string(newick)
    p2 = next(x for x in halved.nodes[:n] if x.clv_index == 0).back
    for g in (p2.next, p2.next.next):
        g.length = g.back.length = merged / 2

    u = moves.prune_subtree(p)
    root_r = u if u.next is not None else u.back
    T.reset_template_indices(root_r, n - 1)
    rtree = T.wrap_tree(root_r)
    cfg_r = dataclasses.replace(
        cfg, tips=n - 1, clv_buffers=rtree.inner_count,
        prob_matrices=2 * (n - 1) - 3, scale_buffers=rtree.inner_count)
    full_r = engine.compile_tree_full(rtree, cfg_r)
    raw_r = np.zeros((n - 1, raw.shape[1]), dtype=np.uint64)
    for x in rtree.nodes[:n - 1]:
        raw_r[x.clv_index] = raw[row_of[x.label]]
    tip_r = torch.as_tensor(engine.pad_tipchars(raw_r, cfg_r), device=device)
    sub_tip = torch.as_tensor(engine.pad_tipchars(
        raw[:1], dataclasses.replace(cfg, tips=1)), device=device)
    sub_clv = engine.expand_tipchars(sub_tip, cfg.states, cfg.dtype)[0]
    sub_clv = sub_clv[None].expand(cfg.rate_cats, -1, -1)
    shape = ((cfg.rate_cats, cfg.sites_padded) if cfg.per_rate_scalers
             else (cfg.sites_padded,))
    sub_scaler = torch.zeros(shape, dtype=torch.int32, device=device)

    # the merged edge of the remainder: splits the tips as p.next did
    by_pmatrix = {}
    for x in rtree.nodes:
        for g in ([x] if x.next is None else list(x.roundabout())):
            by_pmatrix.setdefault(int(g.back.pmatrix_index), g)
    rest = frozenset(row_of) - {tip0.label} - behind_a
    origin = None
    for i, pm in enumerate(full_r.pmatrix_indices.tolist()):
        g = by_pmatrix[pm]
        side = frozenset(x.label for x in traverse_subtree(g)
                         if x.next is None)
        if side in (behind_a, rest) and abs(float(g.length) - merged) < 1e-12:
            origin = i
            break
    check(origin is not None, "the merged edge was not found")
    return (full_r, cfg_r, tip_r, sub_clv, sub_scaler, sub_len, origin,
            halved)


def engine_logl(tree, chars, sites, device, dtype, use_kernel, sweep_mode=None,
                subst=(1.2, 2.7, 0.8, 1.1, 3.0, 1.0),
                freqs=(0.28, 0.24, 0.22, 0.26), alpha=0.9):
    """logL of `tree` (its own branch lengths) by engine.loglikelihood on
    the data of search_inputs, under its model unless another is given
    (of as many states as `freqs` has):
    the dense path (use_kernel False) or the tree-sweep kernel (True, f32;
    `sweep_mode` forces a form)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats

    n = tree.tip_count
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=len(freqs), sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=dtype,
        use_kernel=use_kernel, sweep_mode=sweep_mode)
    program = engine.compile_tree(tree, cfg)
    model = engine.make_model([list(subst)], [list(freqs)],
                              compute_gamma_cats(alpha, 4),
                              dtype=dtype, device=device)
    raw = np.zeros((n, sites), dtype=np.uint64)
    for node in tree.nodes[:n]:
        raw[node.clv_index] = chars[node.label][:sites]
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0

    def t(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)
    return engine.loglikelihood(
        program, cfg, model, t(program.default_branch_lengths, dtype),
        t(engine.pad_tipchars(raw, cfg)), t(pw, dtype),
        t(np.full(cfg.sites_padded, -1, np.int32))).item()


def dense_f64_logl(tree, chars, sites, device, **model):
    """logL of `tree` by the dense f64 forward path (engine_logl)."""
    import torch
    return engine_logl(tree, chars, sites, device, torch.float64, False,
                       **model)


def phase_search(device, card):
    import torch

    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch.ops import edge_score
    from libpll2_tpu_torch.tree.compare import rf_distance_normalized

    truth, start, chars, cfg, model = search_inputs(device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, logl, stats = sf.hill_climb(
        start, cfg, model, chars, max_rounds=SEARCH_ROUNDS,
        radius=SEARCH_RADIUS, smooth_every=2)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_counts()["edge_score"]
    by_form = dict(edge_score.edge_scores.launches_by_form)
    from libpll2_tpu_torch import _build
    planned = edge_score.plan(
        cfg.rate_cats, cfg.states,
        sf.compile_spr(start, cfg, radius=SEARCH_RADIUS).cfg_ext.sites_padded,
        _build.max_shared_memory(device))
    log(f"[search] edge_score launches during hill_climb: {launches}, by "
        f"form {by_form}; plan says form={planned[0]} cluster={planned[1]}")
    check(launches > 0, "the search did not launch the edge scorer")
    check(by_form[planned[0]] == launches,
          f"the search ran another form than the planned {planned[0]}")

    trace = stats["logl_trace"]
    rs = stats["round_secs"]
    steady = statistics.median(rs[1:]) if len(rs) > 1 else rs[0]
    tms = stats["phase_timings"][1:] or stats["phase_timings"]
    phases = {k: statistics.median(tm[k] for tm in tms
                                   if isinstance(tm.get(k), float))
              for k in sorted({k for tm in tms for k, v in tm.items()
                               if isinstance(v, float)})}
    scorers = sorted({tm.get("scorer") for tm in stats["phase_timings"]})
    log(f"[search] {cfg.tips} taxa x {cfg.sites} sites radius "
        f"{SEARCH_RADIUS}: rounds={stats['rounds']} moves={stats['moves']} "
        f"scorer={scorers} per-round launches="
        f"{[tm.get('edge_score_launches') for tm in stats['phase_timings']]}")
    log(f"[search] logL trace {trace!r}")
    log(f"[time] search first round {rs[0]:.3f} s, steady median "
        f"{steady:.3f} s over {len(rs) - 1} rounds, initial smoothing "
        f"{stats['init_smooth_s']:.3f} s, whole climb {total:.3f} s "
        f"({card})")
    log("[time] search median phases (steady rounds): " + " ".join(
        f"{k}={v:.4f}s" for k, v in phases.items()) + f" ({card})")
    check(all(np.isfinite(trace)), "non-finite logL in the trace")
    check(all(b >= a for a, b in zip(trace, trace[1:])),
          "the logL trace decreased")

    rf_start = rf_distance_normalized(start, truth)
    rf_final = rf_distance_normalized(final, truth)
    logl_true, _ = sf.evaluate_tree(truth, cfg, model, chars)
    logl64 = dense_f64_logl(final, chars, cfg.sites, device)
    gap = abs(logl - logl64) / abs(logl64)
    log(f"[search] quality: RF {rf_start:.4f} -> {rf_final:.4f} in "
        f"{stats['rounds']} rounds ({SEARCH_BEFORE} with the re-reading form "
        f"as the only one); logL "
        f"final {logl!r}, truth tree (smoothed) {logl_true!r}, delta "
        f"{logl - logl_true!r}; final tree by dense f64 {logl64!r} (rel gap "
        f"{gap:.3e})")
    check(gap < LOGL_RTOL, f"final logL gap {gap} >= {LOGL_RTOL}")
    return launches


def mma_bound(n_ops: int) -> float:
    return MMA_RTOL + MMA_RTOL_PER_OP * n_ops


def phase_mma_vs_plain(device):
    """sweep(mode="mma") against sweep_reference and against
    sweep(mode="fma"), on the cases of phase_kernel_vs_plain the form takes
    and on two large trees.  On the large trees the plain version also
    runs in f64 arithmetic (same f32 inputs and rescue rule), to hold the
    "mma" form's distance from the exact rows against the "fma" form's."""
    import torch

    from libpll2_tpu_torch.ops import partials_tree

    # the newick parser and traversals recurse once per level of the tree
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    cases = [c + (False,) for c in sweep_cases()] + [
        (f"random{LARGE_TIPS}", large_newick(), 512, {}, True),
        ("caterpillar4098_scaled", caterpillar(4098), 256,
         {"bl_scale": 30.0}, True)]
    limit = None
    for i, (name, newick, sites, kw, large) in enumerate(cases):
        cfg, program, pmatrix, tip_b, tb = sweep_inputs(
            newick, sites, i, device, **kw)
        prog = program.vmem_prog
        if limit is None:
            from libpll2_tpu_torch import _build
            limit = _build.max_shared_memory(device)
        reason = partials_tree.unsupported(prog, cfg, limit, "mma")
        if reason is not None:
            log(f"[mma] {name}: not taken by the form ({reason})")
            check(cfg.per_rate_scalers, f"{name}: refused: {reason}")
            continue
        mma = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="mma")
        fma = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="fma")
        plain = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
        off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="mma",
                                  carry=False)
        torch.cuda.synchronize()
        check(torch.equal(off[0], mma[0]) and torch.equal(off[1], mma[1]),
              f"{name}: mma rows differ between carry on and off")
        # the kernel's P operand: the split-and-layout prologue kernel
        # against its plain version, bit for bit
        check(torch.equal(
            partials_tree.pmatrix_fragments(pmatrix, cfg),
            partials_tree.pmatrix_fragments_reference(pmatrix, cfg)),
            f"{name}: P fragments differ from their plain version")
        rel, mism, comp, abs_err = compare_rows_site(mma[0], plain[0],
                                                     mma[1], plain[1])
        rel_f, mism_f, comp_f, _ = compare_rows_site(mma[0], fma[0], mma[1],
                                                     fma[1])
        bound = mma_bound(prog.n_ops)
        line = (f"[mma] {name}: ops={prog.n_ops} pool={prog.pool_size} "
                f"tb={tb} sites={sites} S={cfg.states} max_scaler="
                f"{int(plain[1].max().item())}; against plain: site-rel "
                f"{rel:.3e} (bound {bound:.3e}) abs {abs_err:.3e} scaler "
                f"mismatches {mism} compensated {comp:.3e}; against fma: "
                f"site-rel {rel_f:.3e} mismatches {mism_f} compensated "
                f"{comp_f:.3e}")
        check(rel <= bound and rel_f <= bound,
              f"{name}: mma rows off by {rel} / {rel_f} > {bound}")
        check(comp <= COMP_RTOL and comp_f <= COMP_RTOL,
              f"{name}: compensated err {comp} / {comp_f} > {COMP_RTOL}")
        if "bl_scale" in kw:
            check(int(plain[1].max().item()) > 0, f"{name}: no rescue fired")
        if large:
            exact = partials_tree.sweep_reference(tip_b, pmatrix.double(),
                                                  prog, cfg, tb)
            e_mma = compare_rows_site(mma[0], exact[0], mma[1], exact[1])[2]
            e_fma = compare_rows_site(fma[0], exact[0], fma[1], exact[1])[2]
            line += (f"; against the plain version in f64 arithmetic "
                     f"(compensated): mma {e_mma:.3e} fma {e_fma:.3e}")
            check(e_mma <= COMP_RTOL, f"{name}: mma {e_mma} from f64 rows")
        log(line)


def dense_sliced(case, device, slice_sites=1024, dtype=None):
    """logL of a case by the dense path in `dtype` (f64 by default; the
    case's parameters widened or narrowed to it), summed over site slices
    (logL is a sum over sites; the dense CLV buffer of all sites at once
    would be tens of GB on a large tree)."""
    import torch

    from libpll2_tpu_torch import engine

    dtype = dtype or torch.float64
    cfg, program, model, bl, tipchars, pw, inv = case
    model_d = engine.Model(*(getattr(model, f).to(dtype)
                             if getattr(model, f).is_floating_point()
                             else getattr(model, f)
                             for f in engine.Model.FIELDS))
    total = 0.0
    for start in range(0, cfg.sites_padded, slice_sites):
        stop = min(start + slice_sites, cfg.sites_padded)
        cfg_d = dataclasses.replace(
            cfg, sites=stop - start, site_block=stop - start,
            dtype=dtype, use_kernel=False, sweep_mode=None)
        total += engine.loglikelihood(
            program, cfg_d, model_d, bl.to(dtype), tipchars[:, start:stop],
            pw[start:stop].to(dtype), inv[start:stop]).item()
        torch.cuda.empty_cache()
    return total


def phase_wide_path(name, case, expect_mode, device, card, train):
    """loglikelihood (and optimize_root_branch if `train`) of one case
    through `choose` and with the other mode forced, each against the dense
    f64 path.  Returns the launches {kernel: n} of the path."""
    import torch

    from libpll2_tpu_torch import engine

    cfg, program, model, *args = case
    choice = kernel_form(program, cfg, device)
    log(f"[{name}] {cfg.tips} taxa x {cfg.sites} sites S={cfg.states}: "
        f"ops={program.vmem_prog.n_ops} pool={program.vmem_prog.pool_size}; "
        f"choose picks site block {choice[0]}, mode {choice[1]!r}")
    check(choice[1] == expect_mode, f"{name}: choose picked {choice[1]}, "
          f"expected {expect_mode}")
    other = "fma" if expect_mode == "mma" else "mma"
    reset_counts()
    got, warm = {}, {}
    configs = ((expect_mode, cfg),
               (other, dataclasses.replace(cfg, sweep_mode=other)))
    for mode, c in configs:
        t0 = time.perf_counter()
        logl = engine.loglikelihood(program, c, model, *args)
        torch.cuda.synchronize()
        got[mode] = (logl.item(), (time.perf_counter() - t0) * 1e3, None)
        if train:
            new_bl, before = engine.optimize_root_branch(program, c, model,
                                                         *args)
            root = int(np.nonzero(program.pmatrix_indices
                                  == program.root_pmatrix)[0][0])
            got[mode] = got[mode][:2] + ((before.item(),
                                          new_bl[root].item()),)
    counts = read_counts()
    log(f"[{name}] launches during the path: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']}")
    per_mode = 2 if train else 1
    check(counts["tree_sweep"] == counts["tree_sweep_mma"] == per_mode,
          f"{name}: expected {per_mode} launches of each form")
    for mode, c in configs:       # timed after the counted path
        warm[mode] = statistics.median(cuda_ms(
            lambda: engine.loglikelihood(program, c, model, *args), 10))
    ref = dense_sliced(case, device)
    for mode, (logl, first_ms, trained) in got.items():
        gap = abs(logl - ref) / abs(ref)
        line = (f"[{name}] mode {mode!r}: logL f32 {logl!r} dense f64 "
                f"(summed over slices of 1024 sites) {ref!r} rel gap "
                f"{gap:.3e} (first call, cold: {first_ms:.3f} ms, warm "
                f"median of 10 calls {warm[mode]:.4f} ms, {card})")
        check(np.isfinite(logl) and gap < LOGL_RTOL,
              f"{name} {mode}: rel gap {gap} >= {LOGL_RTOL}")
        if trained is not None:
            gap_b = abs(trained[0] - ref) / abs(ref)
            line += (f"; optimize_root_branch logl_before {trained[0]!r} "
                     f"(rel gap {gap_b:.3e}), root branch -> {trained[1]!r}")
            check(gap_b < LOGL_RTOL and np.isfinite(trained[1]),
                  f"{name} {mode}: training step gap {gap_b}")
        log(line)
    if train:
        t_a, t_b = (got[m][2][1] for m in (expect_mode, other))
        check(abs(t_a - t_b) <= BL_RTOL * abs(t_b),
              f"{name}: root branch differs between modes: {t_a} {t_b}")
    return counts


def phase_large_tree(device, card):
    import torch

    from libpll2_tpu_torch import engine

    case = engine.build_case(LARGE_TIPS, LARGE_SITES, dtype=torch.float32,
                             device=device, newick=large_newick())
    torch.cuda.synchronize()
    counts = phase_wide_path("large", case, "fma", device, card, train=True)
    return case, counts


def phase_protein(device, card):
    import torch

    from libpll2_tpu_torch import engine

    case = engine.build_case(PROTEIN_TIPS, PROTEIN_SITES, states=20,
                             dtype=torch.float32, device=device)
    counts = phase_wide_path("protein", case, "fma", device, card,
                             train=False)
    small = engine.build_case(64, 2048, states=20, aa_model_name="lg4x",
                              dtype=torch.float32, device=device)
    extra = phase_wide_path("protein_lg4x", small, "fma", device, card,
                            train=False)
    return case, {k: counts[k] + extra[k] for k in counts}


def phase_all_edge(device, card):
    """The all-edge entry points (their message sweeps on the
    message-sweep kernel) on the search inputs."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T

    _truth, start, chars, cfg, model = search_inputs(device)
    n = cfg.tips
    raw = np.zeros((n, cfg.sites), dtype=np.uint64)
    for node in start.nodes[:n]:
        raw[node.clv_index] = chars[node.label][:cfg.sites]
    tipchars = torch.as_tensor(engine.pad_tipchars(raw, cfg), device=device)
    pw = torch.zeros(cfg.sites_padded, device=device)
    pw[:cfg.sites] = 1.0
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=device)
    full = engine.compile_tree_full(start, cfg)
    bl = torch.as_tensor(full.default_branch_lengths, dtype=cfg.dtype,
                         device=device)
    program = engine.compile_tree(start, cfg)
    before = engine.loglikelihood(program, cfg, model, bl, tipchars, pw,
                                  inv).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_bl, logl = engine.optimize_branch_lengths(
        full, cfg, model, bl, tipchars, pw, inv, rounds=3)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    again = engine.loglikelihood(program, cfg, model, new_bl, tipchars, pw,
                                 inv).item()
    gap = abs(logl.item() - again) / abs(again)
    log(f"[alledge] optimize_branch_lengths {n} x {cfg.sites}, 3 rounds, "
        f"{full.n_colors} colour classes: logL {before!r} -> {logl.item()!r}"
        f"; loglikelihood at the returned lengths {again!r} (rel gap "
        f"{gap:.3e}); first call {secs:.3f} s ({card})")
    check(logl.item() >= before, "smoothing lowered the logL")
    check(gap < LOGL_RTOL, f"smoothed logL gap {gap}")

    # prune on a copy: the tree parsed back from its newick, tips by label
    newick = T.export_newick(start.vroot, precision=None)
    raw = np.zeros((n, cfg.sites), dtype=np.uint64)
    for node in T.parse_newick_string(newick).nodes[:n]:
        raw[node.clv_index] = chars[node.label][:cfg.sites]
    tipchars = torch.as_tensor(engine.pad_tipchars(raw, cfg), device=device)
    (full_r, cfg_r, tip_r, sub_clv, sub_scaler, sub_len, origin,
     halved) = placement_inputs(newick, raw, cfg, device)
    bl_r = torch.as_tensor(full_r.default_branch_lengths, dtype=cfg.dtype,
                           device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = engine.score_placements(full_r, cfg_r, model, bl_r, tip_r, pw,
                                     inv, sub_clv, sub_scaler, sub_len)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prog2 = engine.compile_tree(halved, cfg)
    want = engine.loglikelihood(
        prog2, cfg, model, torch.as_tensor(prog2.default_branch_lengths,
                                           dtype=cfg.dtype, device=device),
        tipchars, pw, inv).item()
    gap = abs(scores[origin].item() - want) / abs(want)
    log(f"[alledge] score_placements: {len(scores)} edges; at the edge the "
        f"tip came from {scores[origin].item()!r}, logL of that tree "
        f"{want!r} (rel gap {gap:.3e}); best edge {int(scores.argmax())}, "
        f"origin {origin}; first call {secs:.3f} s ({card})")
    check(bool(torch.isfinite(scores).all()), "non-finite placement score")
    check(gap < LOGL_RTOL, f"placement at the origin edge off by {gap}")

    # branch_derivatives against central differences, f64, a small case
    c64 = engine.build_case(48, 2048, dtype=torch.float64, device=device,
                            use_kernel=False)
    cfg64, prog64, model64, bl64, *rest = c64
    from libpll2_tpu_torch.tree.generate import balanced_newick
    full64 = engine.compile_tree_full(
        T.parse_newick_string(balanced_newick(48)), cfg64)
    d1, d2 = engine.branch_derivatives(full64, cfg64, model64, bl64, *rest)
    worst, h = 0.0, 1e-6
    for e in range(0, len(bl64), 7):
        up, down = bl64.clone(), bl64.clone()
        up[e] += h
        down[e] -= h
        fd = (engine.loglikelihood(prog64, cfg64, model64, up, *rest)
              - engine.loglikelihood(prog64, cfg64, model64, down, *rest)
              ).item() / (2 * h)
        worst = max(worst, abs(d1[e].item() + fd) / abs(fd))
    log(f"[alledge] branch_derivatives 48 x 2048 f64: d1 against central "
        f"differences of loglikelihood, worst rel gap {worst:.3e} over "
        f"{len(range(0, len(bl64), 7))} branches; all d2 finite "
        f"{bool(torch.isfinite(d2).all())}")
    check(worst < 1e-5, f"d1 off central differences by {worst}")


def phase_probe(card):
    """The matrix-unit probe's 21 rows (probes/mma.py) at TB 128, each slot
    against its plain version; a line a row with its form, time a product,
    bound, share of the unit's peak and the time before the redesign."""
    from libpll2_tpu_torch.probes import mma as probe

    reset_counts()
    rows = probe.run_probe(128, emit=lambda line: log(f"[probe] {line} "
                                                      f"({card})"))
    launches = read_counts()["mma_probe"]
    by_form = dict(probe.chain.launches_by_form)
    check(len(rows) == 21 and launches > 0, "the probe launched nothing")
    for r in rows:
        name = r["variant"].split()[0]
        before = PROBE_MS_BEFORE.get((name, r["unit"]))
        log(f"[probe] {name:10s} {r['unit']:4s} form {r['form']:8s} TB "
            f"{r['tb']:3d}: {r['us_per_product']:.3f} us a product, "
            f"{r['ms']:.4f} ms back to back against a bound of "
            f"{r['bound_ms']:.4f} ms ({r['share']:.3f} of the {r['unit']} "
            f"peak); a call with its operand packing {r['call_ms']:.4f} ms, "
            f"before " + (f"{before:.4f} ms (timed so)" if before
                          else "no such row")
            + f"; worst slot rel err {r['rel_err']:.2e} ({card})")
    wgmma_rows = [r for r in rows if r["variant"].startswith("t_")]
    check(len(wgmma_rows) == 6
          and all(r["form"] == "wgmma" for r in wgmma_rows)
          and by_form["wgmma"] >= 6, f"the sites-on-M rows did not all run "
          f"wgmma: {[(r['variant'], r['form']) for r in wgmma_rows]}, "
          f"launches by form {by_form}")
    check(by_form["mma_sync"] >= 10 and by_form["ffma"] >= 5,
          f"launches by form {by_form}")
    p_on_m = [r for r in rows if r["form"] != "wgmma"]
    log(f"[probe] launches by form: {by_form}; all 21 rows "
        f"{sum(r['ms'] for r in rows):.4f} ms back to back; the 15 P-on-M "
        f"rows {sum(r['ms'] for r in p_on_m):.4f} ms back to back, "
        f"{sum(r['call_ms'] for r in p_on_m):.4f} ms as calls with packing "
        f"(before {sum(PROBE_MS_BEFORE.values()):.4f} ms, timed so) ({card})")
    bound = 0.0
    ops_total = bytes_total = 0.0
    for r in rows:
        grid = probe.SITES // r["tb"]
        nbytes = (r["M"] * r["K"] + probe.NBUF * r["K"] * r["tb"]
                  + grid * probe.NBUF * r["M"] * r["tb"]) * 4
        ops_s = r["bound_ms"] * 1e-3
        bytes_s = nbytes / HBM_RATE
        ops_total += ops_s
        bytes_total += bytes_s
        bound += max(ops_s, bytes_s) * 1e3
    return dict(launches=launches, launches_by_form=by_form,
                max_abs_err=max(r["abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=bound,
                bound_by="bytes" if bytes_total >= ops_total
                else "operations")


def phase_sweep_times(cases, card, f32_times=None):
    """Both sweep forms alone at the main paths' shapes, each at the site
    block `engine.kernel_choice` gives that form: first call, warm median
    of 20 single calls (CUDA events around each, the wrapper's host time
    inside), and 30 calls launched back to back (the kernel's time), with
    the register carry on and off (rows bit-equal).  The plain version at
    a fixed block of PLAIN_BLOCK sites and at the forms' blocks.  A
    `[choose]` line per shape: the form `choose` picks and the faster one,
    which must be within CHOOSE_SLACK of each other.  Returns
    {(name, mode): (ms back to back, plain_ms, bound tuple, max_abs_err,
    single-call ms)}.

    f32_times: this function's result for the f32 cases, given when
    `cases` are bf16 ones: each bf16 line prints the f32 pool's time of
    the same run beside its own where it has one, and the plain version
    is timed at PLAIN_BLOCK only.  At bf16 "fma" rows are held to the
    plain version within BF16_ROW_BOUND of each site's largest entry, as
    on the small cases.  "mma" rows are held by a count
    (`bf16_mma_flips`): the tensor cores truncate their f32 sums, so now
    and then a stored parent rounds to the neighbouring bf16 value (2^-8)
    and the flip carries up the tree, and at a thousand ops a site can
    lie several flips off.  So at most one site in BF16_FLIP_SITES beyond
    BF16_ROW_BOUND, none beyond BF16_SITE_MAX.  The distance of both
    forms and of the plain version from the plain version in f64
    arithmetic on the same bf16 P-matrices is printed beside (bf16
    storage itself)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    out = {}
    for name, case in cases.items():
        cfg, program, model, bl, tipchars, *_ = case
        bf16 = cfg.dtype == torch.bfloat16
        tag = "bf16 " if bf16 else ""
        prog = program.vmem_prog
        pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
        blocks = {mode: kernel_form(
            program, dataclasses.replace(cfg, sweep_mode=mode),
            tipchars.device)[0] for mode in partials_tree.MODES}
        chosen_tb, chosen = kernel_form(program, cfg, tipchars.device)
        tips = {tb: engine.block_tips(tipchars, cfg, tb)
                for tb in set(blocks.values()) | {PLAIN_BLOCK, 256}
                if cfg.sites_padded % tb == 0}
        # the plain version: a Python loop of small launches, timed at one
        # fixed block, at the forms' blocks and at the 256-site block of the
        # earlier timings (PLAIN_MS_BEFORE)
        def site_order(rows):
            """rows in site order, whatever the block: [E, R, S, sites]"""
            return (rows[0].permute(0, 2, 3, 1, 4).flatten(3),
                    rows[1].permute(0, 2, 1, 3).flatten(2))

        p_ms, want = {}, None
        for tb in [PLAIN_BLOCK] if bf16 else sorted(tips):
            plain = {}
            p_ms[tb] = statistics.median(cuda_ms(lambda: plain.__setitem__(
                "v", partials_tree.sweep_reference(tips[tb], pmatrix, prog,
                                                   cfg, tb)), 2))
            if tb == PLAIN_BLOCK:
                want = site_order(plain["v"])
            del plain
        if bf16:
            exact = site_order(partials_tree.sweep_reference(
                tips[PLAIN_BLOCK], pmatrix.double(), prog, cfg, PLAIN_BLOCK))
            plain_exact = compare_rows_site(
                want[0][:, None], exact[0][:, None], want[1][:, None],
                exact[1][:, None])[2]
        log(f"[time] plain sweep_reference {tag}{name}: "
            + ", ".join(f"{p_ms[tb]:.2f} ms at site block {tb}"
                        for tb in sorted(p_ms))
            + (" (median of 2 calls)" if bf16 else
               f" (median of 2 calls; earlier single calls at 256 sites: "
               f"{PLAIN_MS_BEFORE[name]})") + f" ({card})")
        updates = (cfg.tips - 2) * cfg.sites
        for mode in partials_tree.MODES:
            tb = blocks[mode]

            def call(carry=True, mode=mode, tb=tb):
                clv, scal = partials_tree.sweep(tips[tb], pmatrix, prog, cfg,
                                                tb, mode=mode, carry=carry)
                return (clv.permute(0, 2, 3, 1, 4).flatten(3),
                        scal.permute(0, 2, 1, 3).flatten(2))
            got = {}
            first = cuda_ms(lambda: got.setdefault("v", call()), 1)[0]
            # compare_rows_site takes [E, NT, R, S, TB]: one block of all
            # the sites
            rel, mism, comp, abs_err = compare_rows_site(
                got["v"][0][:, None], want[0][:, None], got["v"][1][:, None],
                want[1][:, None])
            if bf16:
                kernel_exact = compare_rows_site(
                    got["v"][0][:, None], exact[0][:, None],
                    got["v"][1][:, None], exact[1][:, None])[2]
                errs = site_errors(got["v"][0][:, None], want[0][:, None],
                                   got["v"][1][:, None], want[1][:, None])
                over, allowed = bf16_mma_flips(errs)
                accuracy = (f"; {over} of {errs.numel()} root-row sites "
                            f"beyond {BF16_ROW_BOUND:.3e} of plain; against "
                            f"the plain version in f64 arithmetic "
                            f"(compensated): kernel {kernel_exact:.3e}, "
                            f"plain {plain_exact:.3e}")
                if mode == "fma":
                    check(rel <= BF16_ROW_BOUND and comp <= BF16_ROW_BOUND,
                          f"{tag}{name} fma: rows off plain by {rel}, "
                          f"compensated {comp} > {BF16_ROW_BOUND}")
                else:
                    check(over <= allowed and comp <= BF16_SITE_MAX,
                          f"{tag}{name} mma: {over} sites beyond "
                          f"{BF16_ROW_BOUND} of plain (at most {allowed}), "
                          f"the worst {comp} (at most {BF16_SITE_MAX})")
            else:
                accuracy = ""
                bound_rel = mma_bound(prog.n_ops) if mode == "mma" \
                    else CLV_RTOL
                check(rel <= bound_rel and comp <= COMP_RTOL,
                      f"{name} {mode}: rows off plain by {rel} (bound "
                      f"{bound_rel}), compensated {comp}")
            off = call(carry=False)
            torch.cuda.synchronize()
            check(torch.equal(off[0], got["v"][0])
                  and torch.equal(off[1], got["v"][1]),
                  f"{name} {mode}: rows differ between carry on and off")
            del off
            single = statistics.median(cuda_ms(call, 20))
            b2b = [cuda_ms_back_to_back(call, 30) for _ in range(3)]
            off_b2b = cuda_ms_back_to_back(lambda: call(carry=False), 30)
            med = statistics.median(b2b)
            b = sweep_bound(prog, cfg, mode, tips[tb])
            flags = partials_tree.carry_flags(prog)
            carried = int((flags[:, 0] > 0).sum())
            if mode == "mma" and (cfg.states, cfg.rate_cats) not in \
                    partials_tree.MMA_CARRY_CASES:
                carried = 0
            if bf16 and (name, mode) in f32_times:
                before = (f"f32 pool in this run: "
                          f"{f32_times[(name, mode)][0]:.4f} ms back to "
                          f"back, {f32_times[(name, mode)][4]:.4f} single")
            elif bf16:
                before = "f32 pool not timed at this shape"
            elif mode == "fma":
                before = (f"before the redesign: "
                          f"{' / '.join(map(str, FMA_MS_BEFORE[name]))} ms")
            else:
                before = (f"before the register carry and SM-fill site "
                          f"block: {MMA_MS_BEFORE[name]} ms")
            log(f"[time] sweep {tag}{mode} {name} {cfg.tips}x{cfg.sites} "
                f"S={cfg.states} ops={prog.n_ops} tb={tb} "
                f"ctas={cfg.sites_padded // tb} smem/cta="
                f"{partials_tree.smem_bytes(prog, cfg, tb, mode)}: "
                f"{med:.4f} ms a call in 30 launched back to back (3 runs: "
                f"{', '.join(f'{t:.4f}' for t in b2b)}), warm median of 20 "
                f"single calls {single:.4f} ms, first call (cold for this "
                f"shape and form) {first:.3f} ms, "
                f"{updates / (med * 1e-3):.4e} site-updates/s; carry off "
                f"{off_b2b:.4f} ms back to back, rows and scalers bit-equal;"
                f" {carried} of {prog.n_ops} ops take a child from registers; "
                f"{before}; rows against plain: site-rel {rel:.3e}, {mism} "
                f"scaler mismatches{accuracy}; bound {b[0]:.4f} ms by {b[1]} "
                f"(HBM bytes "
                f"{b[2]:.4f}, operations {b[3]:.4f}; shared-memory traffic "
                f"{b[4]:.4f}) ({card})")
            out[(name, mode)] = (med, p_ms[PLAIN_BLOCK if bf16 else tb], b,
                                 abs_err, single)
        times = {mode: out[(name, mode)][0] for mode in partials_tree.MODES}
        fastest = min(times, key=times.get)
        log(f"[choose] {tag}{name}: choose picks {chosen!r} (site block "
            f"{chosen_tb}), {times[chosen]:.4f} ms; faster in this run: "
            f"{fastest!r}, {times[fastest]:.4f} ms ("
            + ", ".join(f"{m} {t:.4f}" for m, t in times.items())
            + f", back to back) ({card})")
        check(times[chosen] <= CHOOSE_SLACK * times[fastest],
              f"{name}: choose picked {chosen} at {times[chosen]} ms, "
              f"{fastest} took {times[fastest]} ms")
        if name == "large_8192":
            for mode in partials_tree.MODES:
                check(cfg.sites_padded // blocks[mode] >= 124,
                      f"{name}: the {mode!r} form runs on "
                      f"{cfg.sites_padded // blocks[mode]} CTAs")
        del want, pmatrix, tips
        if bf16:
            del exact
        torch.cuda.empty_cache()
    return out


def multi_inputs(device):
    """The three-partition case of phase_multi_linked: (tree, mp, cases)
    with cases[k] = (cfg, program, model, bl, tipchars, pw, inv) as
    engine.build_case returns them; f32, four Gamma categories."""
    import torch

    from libpll2_tpu_torch import engine, multipartition
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.aa import aa_model
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.generate import (random_newick,
                                                 random_tipchars)

    rng = np.random.default_rng(4)
    tree = T.parse_newick_string(random_newick(MULTI_TIPS, rng))
    lg_rates, lg_freqs = aa_model("lg")
    specs = [
        (4, MULTI_SITES[0], [1.2, 2.1, 0.7, 1.3, 2.5, 1.0],
         [0.3, 0.25, 0.2, 0.25], 0.8),
        (4, MULTI_SITES[1], [0.8, 1.9, 1.2, 0.9, 2.4, 1.0],
         [0.21, 0.27, 0.31, 0.21], 1.4),
        (20, MULTI_SITES[2], lg_rates, lg_freqs, 0.75)]
    cfgs, parts = [], []
    for states, sites, subst, freqs, alpha in specs:
        cfg = PartitionConfig(
            tips=MULTI_TIPS, clv_buffers=tree.inner_count, states=states,
            sites=sites, rate_matrices=1, prob_matrices=2 * MULTI_TIPS - 3,
            rate_cats=4, scale_buffers=tree.inner_count,
            dtype=torch.float32)
        model = engine.make_model([subst], [freqs],
                                  compute_gamma_cats(alpha, 4),
                                  dtype=torch.float32, device=device)
        tipchars = torch.as_tensor(engine.pad_tipchars(
            random_tipchars(MULTI_TIPS, sites, rng, states=states), cfg),
            device=device)
        pw = torch.zeros(cfg.sites_padded, device=device)
        pw[:sites] = 1.0
        inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                         device=device)
        cfgs.append(cfg)
        parts.append((model, tipchars, pw, inv))
    mp = multipartition.compile_multipartition(tree, cfgs)
    bl = torch.as_tensor(mp.programs[0].default_branch_lengths,
                         dtype=torch.float32, device=device)
    cases = [(cfgs[k], mp.programs[k], parts[k][0], bl) + parts[k][1:]
             for k in range(3)]
    return tree, mp, cases


def phase_multi_linked(device, card):
    """multipartition.loglikelihood, branch_derivatives and
    optimize_branch_lengths at full width.  Returns the launches of the
    path."""
    import torch

    from libpll2_tpu_torch import engine, multipartition

    _tree, mp, cases = multi_inputs(device)
    models, tips, pws, invs = ([c[i] for c in cases] for i in (2, 4, 5, 6))
    bl = cases[0][3]
    args = (mp, models, bl, tips, pws, invs)
    torch.cuda.synchronize()
    for k, (cfg, program, *_rest) in enumerate(cases):
        tb, mode = kernel_form(program, cfg, device)
        log(f"[multi] partition {k}: S={cfg.states} {cfg.tips} taxa x "
            f"{cfg.sites} sites, ops={program.vmem_prog.n_ops}: choose picks "
            f"site block {tb}, mode {mode!r}")

    reset_counts()
    t0 = time.perf_counter()
    total = multipartition.loglikelihood(*args)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    n_sweeps = counts["tree_sweep"] + counts["tree_sweep_mma"]
    log(f"[multi] launches during loglikelihood: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']}")
    check(n_sweeps == len(mp.groups),
          f"expected one sweep per group of partitions ({len(mp.groups)}), "
          f"got {n_sweeps}")
    warm = statistics.median(cuda_ms(
        lambda: multipartition.loglikelihood(*args), 10))
    total = total.item()
    singles = [engine.loglikelihood(c[1], c[0], *c[2:]).item()
               for c in cases]
    ref = sum(dense_sliced(c, device) for c in cases)
    gap_sum = abs(total - sum(singles)) / abs(total)
    gap = abs(total - ref) / abs(ref)
    log(f"[multi] linked total {total!r}; sum of three engine.loglikelihood "
        f"calls {sum(singles)!r} (rel gap {gap_sum:.3e}); dense f64 {ref!r} "
        f"(rel gap {gap:.3e}); first call (cold) {cold_ms:.3f} ms, warm "
        f"median of 10 calls {warm:.4f} ms ({card})")
    check(np.isfinite(total) and gap_sum < 1e-6,
          f"total differs from the sum of its parts by {gap_sum}")
    check(gap < LOGL_RTOL, f"linked total gap {gap} >= {LOGL_RTOL}")

    # scaled lengths: summed derivatives against central differences of
    # the dense f64 total on eight edges
    scalers = torch.tensor(MULTI_SCALERS, dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    d1, d2 = multipartition.branch_derivatives(*args, scalers)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    def scaled_f64(lengths):
        return sum(dense_sliced(
            c[:3] + (lengths * MULTI_SCALERS[k],) + c[4:], device)
            for k, c in enumerate(cases))

    worst, h = 0.0, 1e-4
    edges = list(range(3, len(bl), len(bl) // 8))[:8]
    fds = []
    for e in edges:
        up, down = bl.double(), bl.double()
        up[e] += h
        down[e] -= h
        fds.append((scaled_f64(up) - scaled_f64(down)) / (2 * h))
    scale = max(abs(x) for x in fds)
    for e, fd in zip(edges, fds):
        worst = max(worst, abs(d1[e].item() + fd) / scale)
    log(f"[multi] branch_derivatives, scalers {MULTI_SCALERS}: d1 against "
        f"central differences of the dense f64 total on edges {edges}: "
        f"worst gap {worst:.3e} of the largest |d1| {scale:.4e}; all d2 "
        f"finite {bool(torch.isfinite(d2).all())}; first call {secs:.3f} s "
        f"({card})")
    check(worst < D1_RTOL, f"summed d1 off central differences by {worst}")
    check(bool(torch.isfinite(d1).all() and torch.isfinite(d2).all()),
          "non-finite summed derivative")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_bl, logl = multipartition.optimize_branch_lengths(*args, rounds=3)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    again = multipartition.loglikelihood(mp, models, new_bl, tips, pws,
                                         invs).item()
    gap = abs(logl.item() - again) / abs(again)
    log(f"[multi] optimize_branch_lengths, 3 rounds, "
        f"{mp.fulls[0].n_colors} colour classes: total {total!r} -> "
        f"{logl.item()!r}; loglikelihood at the returned lengths {again!r} "
        f"(rel gap {gap:.3e}); first call {secs:.3f} s ({card})")
    check(logl.item() > total, "joint smoothing did not raise the total")
    check(gap < LOGL_RTOL, f"smoothed total gap {gap}")
    return counts


def phase_multi_search(device, card):
    """hill_climb_multi (unlinked lengths) on the search inputs with a
    second partition simulated down the same truth tree.  Returns the
    launches of the path."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.compare import rf_distance_normalized
    from libpll2_tpu_torch.tree.generate import simulate_alignment

    truth, start, chars, cfg, model = search_inputs(device)
    subst2, freqs2 = [0.8, 1.9, 1.2, 0.9, 2.4, 1.0], [0.21, 0.27, 0.31, 0.21]
    rates = compute_gamma_cats(0.9, 4)
    sites2 = cfg.sites // 2
    chars2 = simulate_alignment(truth, sites2,
                                np.random.default_rng(SEARCH_SEED + 1),
                                subst2, freqs2, rates)
    cfgs = [cfg, dataclasses.replace(cfg, sites=sites2)]
    models = [model, engine.make_model([subst2], [freqs2], rates,
                                       dtype=torch.float32, device=device)]
    chars_list = [chars, chars2]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, logl, stats = sf.hill_climb_multi(
        start, cfgs, models, chars_list, max_rounds=MULTI_ROUNDS,
        radius=SEARCH_RADIUS, smooth_every=2)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    per_round = [tm.get("edge_score_launches")
                 for tm in stats["phase_timings"]]
    log(f"[msearch] edge_score launches during hill_climb_multi: "
        f"{counts['edge_score']}; per round and partition {per_round}")
    check(counts["edge_score"] > 0 and all(
        n > 0 for row in per_round for n in row),
        "a partition's score phase did not launch the edge scorer")

    trace, rs = stats["logl_trace"], stats["round_secs"]
    steady = statistics.median(rs[1:]) if len(rs) > 1 else rs[0]
    log(f"[msearch] {cfg.tips} taxa, partitions of {cfgs[0].sites} and "
        f"{cfgs[1].sites} sites, radius {SEARCH_RADIUS}, at most "
        f"{MULTI_ROUNDS} rounds: rounds={stats['rounds']} "
        f"moves={stats['moves']} scorers="
        f"{sorted({s for tm in stats['phase_timings'] for s in tm['scorer']})}")
    log(f"[msearch] summed logL trace {trace!r}")
    log(f"[time] multi search first round {rs[0]:.3f} s, steady median "
        f"{steady:.3f} s over {len(rs) - 1} rounds, whole climb "
        f"{total_s:.3f} s ({card})")
    check(all(np.isfinite(trace)), "non-finite total in the trace")
    check(all(b >= a for a, b in zip(trace, trace[1:])),
          "the summed logL trace decreased")

    # the total against engine.loglikelihood of each partition's final tree
    # at its own lengths
    parts = []
    for k, prog in enumerate(stats["programs"]):
        t = T.parse_newick_string(T.export_newick(prog.tree.vroot,
                                                  precision=None))
        program = engine.compile_tree(t, cfgs[k])
        raw = np.zeros((t.tip_count, cfgs[k].sites), dtype=np.uint64)
        for node in t.nodes[:t.tip_count]:
            raw[node.clv_index] = chars_list[k][node.label][:cfgs[k].sites]
        pw = torch.zeros(cfgs[k].sites_padded, device=device)
        pw[:cfgs[k].sites] = 1.0
        parts.append(engine.loglikelihood(
            program, cfgs[k], models[k],
            torch.as_tensor(program.default_branch_lengths,
                            dtype=torch.float32, device=device),
            torch.as_tensor(engine.pad_tipchars(raw, cfgs[k]),
                            device=device), pw,
            torch.full((cfgs[k].sites_padded,), -1, dtype=torch.int32,
                       device=device)).item())
    gap = abs(logl - sum(parts)) / abs(logl)
    bl0, bl1 = (p.branch_lengths for p in stats["programs"])
    differ = float(np.abs(bl0 - bl1).max())
    logl_true = sum(sf.evaluate_tree(truth, cfgs[k], models[k],
                                     chars_list[k])[0] for k in range(2))
    log(f"[msearch] final total {logl!r}; engine.loglikelihood of each "
        f"partition's final tree at its own lengths {parts!r}, sum "
        f"{sum(parts)!r} (rel gap {gap:.3e}); the partitions' lengths differ "
        f"by up to {differ:.4f}")
    log(f"[msearch] quality: RF {rf_distance_normalized(start, truth):.4f} "
        f"-> {rf_distance_normalized(final, truth):.4f}; truth tree "
        f"(smoothed per partition) {logl_true!r}, delta "
        f"{logl - logl_true!r}")
    check(gap < LOGL_RTOL, f"final total gap {gap} >= {LOGL_RTOL}")
    check(differ > 1e-4, "unlinked lengths came out equal")
    return counts


INFER_COLD_SRC = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
from libpll2_tpu_torch import infer_ml_tree
from libpll2_tpu_torch.io import load_fasta_msa
t1 = time.perf_counter()
radius, rounds, warmup, steps, seed = map(int, sys.argv[2:])
res = infer_ml_tree(load_fasta_msa(sys.argv[1]), radius=radius,
                    max_rounds=rounds, warmup_rounds=warmup,
                    fit_steps=steps, smooth_every=2, seed=seed,
                    device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
print(json.dumps(dict(
    import_s=t1 - t0, call_s=t2 - t1, logl=res.logl,
    parsimony_cost=res.stats["parsimony_cost"],
    **{k: res.stats[k] for k in ("parsimony_secs", "warmup_secs",
                                 "fit_secs", "search_secs")})))
"""


def infer_cold_call(path, timeout=600):
    """The first infer_ml_tree call of a new process (its kernels already
    built, as after phase_build): the file read and the call, apart from
    the imports, as a user's script pays them.  A dict of seconds and the
    result's logL and parsimony cost."""
    proc = subprocess.run(
        [sys.executable, "-c", INFER_COLD_SRC, path, str(SEARCH_RADIUS),
         str(INFER_ROUNDS), str(INFER_WARMUP), str(INFER_STEPS),
         str(INFER_SEED)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=timeout)
    check(proc.returncode == 0, f"the cold infer_ml_tree call failed "
                                f"(rc {proc.returncode}): "
                                f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_infer(device, card, tips=SEARCH_TIPS, sites=SEARCH_SITES):
    """infer_ml_tree, the one-call journey, on the search inputs written
    as FASTA and read back through the native binding, at the JAX
    package's defaults: first in a new process (cold), then here (warm).
    The fit's function is then held against dense f64 on the final tree
    through the sweep kernels the fit ran.  Returns the launches of the
    warm call."""
    import tempfile

    import torch

    from libpll2_tpu_torch import (convert, engine, fit, infer, infer_ml_tree,
                                   native)
    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch.io import load_fasta_msa
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.compare import rf_distance_normalized, splits

    truth, _start, chars, cfg, _model = search_inputs(device, tips, sites)
    nt = np.array(list("?ACMGRSVTWYHKDBN"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "search.fa")
        with open(path, "w") as f:
            for label in sorted(chars):
                seq = "".join(nt[chars[label].astype(np.int64)])
                f.write(f">{label}\n" + "\n".join(
                    seq[i:i + 80] for i in range(0, len(seq), 80)) + "\n")
        native._lib, native._tried = None, False
        check(native.available(), "the native library did not build")
        t0 = time.perf_counter()
        msa = load_fasta_msa(path)
        load_s = time.perf_counter() - t0
        check(native.fasta_load(path) == (msa.labels, msa.sequences),
              "load_fasta_msa did not return what the native reader read")
        torch.cuda.empty_cache()
        cold = infer_cold_call(path)
    check(msa.labels == sorted(chars) and msa.length == sites,
          "the FASTA round trip changed the alignment")

    # infer_ml_tree's own start, on the card and on the host
    labels, pchars, weights, _ = infer.site_patterns(msa)
    start = {}
    for where in (torch.device("cpu"), device):
        t0 = time.perf_counter()
        tree, cost = infer.parsimony_start(labels, pchars, 4, INFER_SEED,
                                           where)
        torch.cuda.synchronize()
        start[where.type] = (tree, cost, time.perf_counter() - t0)
    (cpu_tree, cpu_cost, cpu_s), (dev_tree, dev_cost, dev_s) = \
        start["cpu"], start[device.type]
    log(f"[infer] stepwise start ({tips} taxa): cost {dev_cost} on "
        f"{device.type}, {dev_s:.3f} s; cost {cpu_cost} on the host CPU, "
        f"{cpu_s:.3f} s ({card})")
    check(dev_cost == cpu_cost and splits(dev_tree) == splits(cpu_tree),
          "the stepwise start on the card differs from the host's")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = infer_ml_tree(msa, radius=SEARCH_RADIUS, max_rounds=INFER_ROUNDS,
                        warmup_rounds=INFER_WARMUP, fit_steps=INFER_STEPS,
                        smooth_every=2, seed=INFER_SEED, device=device)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    st = res.stats
    log(f"[infer] launches during infer_ml_tree: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']}, "
        f"edge_score {counts['edge_score']}")
    log(f"[infer] {tips} taxa x {sites} sites -> {st['sites_patterns']} "
        f"patterns; FASTA load {load_s:.3f} s (native); parsimony cost "
        f"{st['parsimony_cost']}; warm-up {st['warmup']}, search "
        f"{st['search']}; alpha {res.alpha!r} (truth 0.9); rates "
        f"{res.subst_params.tolist()} freqs {res.frequencies.tolist()}")
    log(f"[infer] logL trace {st['logl_trace']!r}; fit trace "
        f"{st['fit_logl_trace']!r}")
    log(f"[time] infer_ml_tree, first call of a new process (cold): "
        f"imports {cold['import_s']:.3f} s, then FASTA load and call "
        f"{cold['call_s']:.3f} s: parsimony {cold['parsimony_secs']:.3f} s, "
        f"warm-up {cold['warmup_secs']:.3f} s, fit {cold['fit_secs']:.3f} s, "
        f"search {cold['search_secs']:.3f} s; logL {cold['logl']!r} "
        f"({card})")
    log(f"[time] infer_ml_tree, a later call in this process (warm): "
        f"parsimony {st['parsimony_secs']:.3f} s, warm-up "
        f"{st['warmup_secs']:.3f} s, fit {st['fit_secs']:.3f} s "
        f"({INFER_STEPS} steps), search {st['search_secs']:.3f} s, total "
        f"{total_s:.3f} s ({card})")
    check(counts["tree_sweep"] > 0, "infer_ml_tree launched no tree sweep")
    check(counts["edge_score"] > 0, "infer_ml_tree launched no edge scorer")
    check(st["parsimony_cost"] == cpu_cost == cold["parsimony_cost"],
          "infer_ml_tree's start cost differs from the host's stepwise")
    check(np.isfinite(cold["logl"]), "the cold call's logL is not finite")
    trace = st["logl_trace"]
    check(all(np.isfinite(trace)) and all(
        b >= a for a, b in zip(trace, trace[1:])),
        "the logL trace decreased or is not finite")
    check(0.3 < res.alpha < 2.5, f"fitted alpha {res.alpha}")

    fitted = dict(subst=res.subst_params.tolist(),
                  freqs=res.frequencies.tolist(), alpha=res.alpha)
    logl64 = dense_f64_logl(res.tree, chars, sites, device, **fitted)
    gap = abs(res.logl - logl64) / abs(logl64)
    model = engine.make_model([fitted["subst"]], [fitted["freqs"]],
                              compute_gamma_cats(res.alpha, 4),
                              dtype=torch.float32, device=device)
    logl_true, _ = sf.evaluate_tree(truth, cfg, model, chars)
    rf = rf_distance_normalized(res.tree, truth)
    log(f"[infer] quality: RF to the truth {rf:.4f}; logL {res.logl!r}, "
        f"truth tree under the fitted model (smoothed) {logl_true!r}, delta "
        f"{res.logl - logl_true!r}; final tree by dense f64 {logl64!r} (rel "
        f"gap {gap:.3e})")
    check(gap < LOGL_RTOL, f"final logL gap {gap} >= {LOGL_RTOL}")
    check(rf <= INFER_RF, f"RF to the truth {rf} > {INFER_RF}")

    # the fit's function (fit.loglikelihood_fn with the FullTreeProgram, as
    # infer_ml_tree's step 4 builds it) on the final tree: its logL at the
    # fitted model against dense f64, and its logL and gradient at
    # phase_fit's starting model against dense f64 autograd (at unit rates,
    # infer's own start, the f32 eigensystem's derivative is degenerate)
    fcfg = infer.likelihood_config(res.tree, 4, len(weights), 4,
                                   torch.float32)
    program, full, tipchars = infer.fit_inputs(res.tree, fcfg, pchars,
                                               device)
    pw = torch.zeros(fcfg.sites_padded, device=device)
    pw[:len(weights)] = torch.as_tensor(weights, device=device)
    inv = torch.full((fcfg.sites_padded,), -1, dtype=torch.int32,
                     device=device)
    bl = np.asarray(program.default_branch_lengths)
    at_fit = fit.pack([fitted["subst"]], [fitted["freqs"]], bl,
                      alpha=res.alpha, dtype=torch.float32, device=device)
    at_start = fit.pack([FIT_START_SUBST], [FIT_START_FREQS], bl,
                        alpha=FIT_START_ALPHA, dtype=torch.float32,
                        device=device)
    rates = compute_gamma_cats(1.0, 4)
    reset_counts()
    fit_logl = fit.loglikelihood_fn(
        program, fcfg, at_fit, rates, tipchars, pw, inv, fit_alpha=True,
        full_program=full).item()
    leaves = fit.FitParams(*(x.clone().requires_grad_() for x in at_start))
    start_logl = fit.loglikelihood_fn(
        program, fcfg, leaves, rates, tipchars, pw, inv, fit_alpha=True,
        full_program=full)
    start_logl.backward()
    torch.cuda.synchronize()
    held = read_counts()
    ref_logl, ref_grads = dense_f64_gradient(
        (fcfg, program, None, None, tipchars, pw, inv), at_start, rates,
        device)
    fit_gap = abs(fit_logl - logl64) / abs(logl64)
    start_gap = abs(start_logl.item() - ref_logl) / abs(ref_logl)
    worst = 0.0
    for name, leaf, ref in zip(convert.FIT_FIELDS, leaves, ref_grads):
        err = ((leaf.grad.double() - ref).abs().max()
               / ref.abs().max()).item()
        worst = max(worst, err)
        log(f"[infer] the fit's gradient on the final tree at phase_fit's "
            f"starting model, {name} {tuple(ref.shape)}: f32 kernel path against "
            f"dense f64 autograd, max gap {err:.3e} of the largest entry "
            f"{ref.abs().max().item():.4e}")
    log(f"[infer] the fit's logL on the final tree ({len(weights)} patterns, "
        f"launches: tree_sweep {held['tree_sweep']}, tree_sweep_mma "
        f"{held['tree_sweep_mma']}): fitted model {fit_logl!r} against dense "
        f"f64 {logl64!r} (rel gap {fit_gap:.3e}); phase_fit's starting model "
        f"{start_logl.item()!r} against {ref_logl!r} (rel gap "
        f"{start_gap:.3e})")
    log(f"[infer] card {card}")
    for form in ("tree_sweep", "tree_sweep_mma"):
        check((held[form] > 0) == (counts[form] > 0),
              f"the check of the fit's function launched {form} "
              f"{held[form]} times, the fit {counts[form]}")
    check(fit_gap < LOGL_RTOL, f"the fit's logL gap {fit_gap}")
    check(start_gap < LOGL_RTOL, f"the fit's starting logL gap {start_gap}")
    check(worst < GRAD_RTOL, f"the fit's gradient off the dense f64 "
                             f"gradient by {worst} >= {GRAD_RTOL}")
    return counts


def dense_f64_gradient(case32, params, rates, device, slice_sites=1024):
    """(logL, gradient per FitParams field) of fit.loglikelihood_fn by
    autograd of the dense f64 plain path, summed over site slices."""
    import torch

    from libpll2_tpu_torch import fit

    cfg, program, _model, _bl, tipchars, pw, inv = case32
    leaves = fit.FitParams(*(x.detach().double().requires_grad_()
                             for x in params))
    total = 0.0
    for start in range(0, cfg.sites_padded, slice_sites):
        stop = min(start + slice_sites, cfg.sites_padded)
        cfg64 = dataclasses.replace(
            cfg, sites=stop - start, site_block=stop - start,
            dtype=torch.float64, use_kernel=False, sweep_mode=None)
        logl = fit.loglikelihood_fn(
            program, cfg64, leaves, rates, tipchars[:, start:stop],
            pw[start:stop].double(), inv[start:stop], fit_alpha=True)
        logl.backward()
        total += logl.item()
        del logl
        torch.cuda.empty_cache()
    return total, [x.grad for x in leaves]


def gamma_cats_ms(device, alpha=0.7, categories=4, reps=7):
    """Median host-clock ms of compute_gamma_cats_torch and its backward
    pass with alpha on `device` (what one fit step pays for the
    discretization), each call ended by a synchronise."""
    import torch

    from libpll2_tpu_torch.models.gamma import compute_gamma_cats_torch

    times = []
    for _ in range(reps + 1):
        a = torch.tensor(alpha, dtype=torch.float64, device=device,
                         requires_grad=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rates = compute_gamma_cats_torch(a, categories)
        (rates * torch.arange(categories, device=rates.device)).sum() \
            .backward()
        a.grad.cpu()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_fit(full_case, device, card):
    """fit.fit_model at the main path's shape with the CUDA sweep in the
    forward pass and the analytic reverse pass.  Returns the launches of
    the path."""
    import torch

    from libpll2_tpu_torch import convert, engine, fit
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.generate import balanced_newick

    cfg, program, _model, bl, tipchars, pw, inv = full_case
    full = engine.compile_tree_full(
        T.parse_newick_string(balanced_newick(cfg.tips)), cfg)
    rates = compute_gamma_cats(1.0, cfg.rate_cats)
    params0 = fit.pack([FIT_START_SUBST], [FIT_START_FREQS], bl,
                       alpha=FIT_START_ALPHA, dtype=torch.float32,
                       device=device)
    site = (tipchars, pw, inv)

    # the first gradient against the dense f64 path
    leaves = fit.FitParams(*(x.clone().requires_grad_() for x in params0))
    fwd, bwd, logl = [], [], None
    for _ in range(3):
        for x in leaves:
            x.grad = None
        res = {}
        fwd.append(cuda_ms(lambda: res.setdefault("v", fit.loglikelihood_fn(
            program, cfg, leaves, rates, *site, fit_alpha=True,
            full_program=full)), 1)[0])
        logl = res["v"]
        bwd.append(cuda_ms(logl.backward, 1)[0])
    ref_logl, ref_grads = dense_f64_gradient(full_case, params0, rates,
                                             device)
    gap = abs(logl.item() - ref_logl) / abs(ref_logl)
    worst = 0.0
    for name, leaf, ref in zip(convert.FIT_FIELDS, leaves, ref_grads):
        err = ((leaf.grad.double() - ref).abs().max()
               / ref.abs().max()).item()
        worst = max(worst, err)
        log(f"[fit] step-0 gradient, {name} {tuple(ref.shape)}: analytic f32 "
            f"against dense f64 autograd, max gap {err:.3e} of the largest "
            f"entry {ref.abs().max().item():.4e}")
    log(f"[fit] step-0 logL kernel f32 {logl.item()!r} dense f64 "
        f"{ref_logl!r} (rel gap {gap:.3e}); forward {fwd[-1]:.3f} ms "
        f"(first, cold: {fwd[0]:.3f}), backward {bwd[-1]:.3f} ms (first: "
        f"{bwd[0]:.3f}) per step ({card})")
    log(f"[time] gamma discretization with its backward pass, alpha on the "
        f"card (what a fit step runs) {gamma_cats_ms(device):.3f} ms, "
        f"alpha on the host {gamma_cats_ms(torch.device('cpu')):.3f} ms, "
        f"host clock, medians of 7 ({card})")
    check(gap < LOGL_RTOL, f"fit logL gap {gap}")
    check(worst < GRAD_RTOL, f"analytic gradient off the dense f64 "
                             f"gradient by {worst} >= {GRAD_RTOL}")
    del leaves, logl, res, ref_grads
    torch.cuda.empty_cache()
    # without a FullTreeProgram: the dense path on the card under
    # use_kernel=None, with one warning (R13); use_kernel=True raises
    dense_value, msgs, counts = default_call(lambda: fit.loglikelihood_fn(
        program, cfg, params0, rates, *site, fit_alpha=True))
    asked = fit.loglikelihood_fn(
        program, dataclasses.replace(cfg, use_kernel=False), params0, rates,
        *site, fit_alpha=True)
    check(len(msgs) == 1 and "autograd" in msgs[0]
          and counts["tree_sweep"] + counts["tree_sweep_mma"] == 0
          and torch.equal(dense_value.detach(), asked.detach()),
          f"a fit on the card with no FullTreeProgram: warnings {msgs}, "
          f"launches {counts}, {dense_value.item()} against the dense "
          f"call's {asked.item()}")
    del dense_value, asked
    try:
        fit.loglikelihood_fn(program, dataclasses.replace(cfg,
                                                          use_kernel=True),
                             params0, rates, *site, fit_alpha=True)
        refused = False
    except ValueError:
        refused = True
    check(refused, "use_kernel=True with no FullTreeProgram did not raise")
    log(f"[fit] without a FullTreeProgram: use_kernel None ran the dense "
        f"path on the card with one warning, equal to use_kernel=False; "
        f"use_kernel=True raised")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fit.fit_model(program, cfg, params0, rates, *site,
                        steps=FIT_STEPS, lr=FIT_LR, fit_alpha=True,
                        full_program=full)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    trace = out.logl.tolist()
    subst, freqs, _bl = fit.unpack(out.params)
    log(f"[fit] sweep launches during fit_model: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']} "
        f"for {FIT_STEPS} steps and the final gradient")
    log(f"[fit] {cfg.tips} taxa x {cfg.sites} sites, {FIT_STEPS} Adam steps "
        f"at lr {FIT_LR}: logL {trace[0]!r} -> {trace[-1]!r}, "
        f"{sum(b > a for a, b in zip(trace, trace[1:]))} of "
        f"{FIT_STEPS - 1} steps rose; final gradient norm "
        f"{out.grad_norm.item():.4e}; rates {subst[0].tolist()} freqs "
        f"{freqs[0].tolist()} alpha "
        f"{out.params.log_alpha.exp().item():.4f}; {secs:.3f} s, "
        f"{secs / FIT_STEPS * 1e3:.1f} ms per step ({card})")
    check(counts["tree_sweep"] + counts["tree_sweep_mma"] >= FIT_STEPS,
          "the fit's forward passes did not launch the CUDA sweep")
    check(all(np.isfinite(trace)) and trace[-1] > trace[0],
          "the fit's logL trace did not rise or is not finite")
    return counts


def phase_cache_probe(device, card):
    """probes/cache.py's stages, then times of the kernel, its plain
    version and the one torch expression that computes the same: as calls
    back to back (the numbers of the kernels line), as single calls, and
    as one CUDA graph of the same calls (device time alone)."""
    import torch

    from libpll2_tpu_torch.probes import cache

    reset_counts()
    results = cache.run_probe(emit=lambda line: log(f"[cache] {line}"))
    launches = read_counts()["cache_probe"]
    check(launches >= 1, "the cache probe launched no kernel here")
    log(f"[cache] cold build nvcc {results['cold']['nvcc_seconds']:.2f} s "
        f"(stage {results['cold']['wall_s']:.1f} s); warm reload without "
        f"nvcc {results['warm']['wall_s']:.1f} s, nvcc "
        f"{results['warm']['nvcc_seconds']:.2f} s; edited source rebuilt in "
        f"{results['edited']['nvcc_seconds']:.2f} s ({card})")
    x = cache.probe_input(device=device)
    got = cache.scale_shift(x)
    err = (got - cache.scale_shift_reference(x)).abs().max().item()
    check(err == 0.0, f"cache kernel differs from its plain version: {err}")
    view = x.flatten()[1:4094]      # not 16-byte aligned, n % 4 != 0
    check(torch.equal(cache.scale_shift(view),
                      cache.scale_shift_reference(view)),
          "cache kernel differs on an unaligned view with a tail")
    costs = cache.host_costs(x, CACHE_HOST_CALLS)
    for label, us in costs.items():
        log(f"[cache] host us a call, {CACHE_HOST_CALLS} calls: {label} "
            f"{us:.3f} ({card})")
    calls = {"kernel": lambda: cache.scale_shift(x),
             "plain": lambda: cache.scale_shift_reference(x),
             "library": lambda: x * 2 + 1}
    # N calls back to back between one pair of events, CACHE_TURNS runs
    # each, then single calls (the wrapper's host time inside each window),
    # both in turns, so that the three meet the same host
    runs = {label: [] for label in calls}
    for _ in range(CACHE_TURNS):
        for label, fn in calls.items():
            runs[label].append(cuda_ms_back_to_back(fn, CACHE_REPS))
    b2b = {label: statistics.median(t) for label, t in runs.items()}
    singles = {label: [] for label in calls}
    for _ in range(CACHE_REPS):
        for label, fn in calls.items():
            singles[label] += cuda_ms(fn, 1)
    single = {label: statistics.median(t) for label, t in singles.items()}
    # the device alone: the same N calls captured in one CUDA graph, replayed
    graph_ms = {}
    for label, fn in calls.items():
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
            with torch.cuda.graph(graph, stream=stream):
                for _ in range(CACHE_REPS):
                    fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph_ms[label] = statistics.median(
            cuda_ms(graph.replay, 5)) / CACHE_REPS
        del graph
    nbytes = 2 * x.numel() * 4
    flops = 2 * x.numel()
    log(f"[time] cache_probe, {CACHE_REPS} calls launched back to back "
        f"between one pair of CUDA events, a call (median of {CACHE_TURNS} "
        f"runs in turns): kernel {b2b['kernel']:.4f} ms, plain "
        f"scale_shift_reference {b2b['plain']:.4f} ms, torch x * 2 + 1 "
        f"{b2b['library']:.4f} ms at {tuple(x.shape)} f32 (runs: "
        + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}"
                    for k, v in runs.items()) + f") ({card})")
    quartiles = {label: statistics.quantiles(t, n=4)
                 for label, t in singles.items()}
    log(f"[time] cache_probe, single calls (one pair of events around each, "
        f"the wrapper's host time inside; {CACHE_REPS} each, in turns; "
        f"median, quartiles): " + ", ".join(
            f"{name} {single[label]:.4f} ({quartiles[label][0]:.4f}-"
            f"{quartiles[label][2]:.4f}) ms" for label, name in
            (("kernel", "kernel"), ("plain", "plain"),
             ("library", "x * 2 + 1"))) + f" ({card})")
    log(f"[time] cache_probe, the same {CACHE_REPS} calls captured in one "
        f"CUDA graph and replayed (device time, no host launch), a call: "
        f"kernel {graph_ms['kernel']:.4f} ms, plain {graph_ms['plain']:.4f} "
        f"ms, x * 2 + 1 {graph_ms['library']:.4f} ms ({card})")
    slower = [label for label, t in (("back to back", b2b),
                                     ("single calls", single))
              if t["kernel"] > t["library"]]
    path = ("torch.empty_like", "torch.cuda.current_device()",
            "current_stream(device).cuda_stream", "two data_ptr()",
            "ctypes call (the launch)")
    log(f"[cache] the kernel against x * 2 + 1 (one launch against two): "
        + ("no slower back to back or in single calls" if not slower else
           f"slower {' and '.join(slower)}; its launch path, host us: "
           + ", ".join(f"{k} {costs[k]:.3f}" for k in path)
           + f"; the largest piece: {max(path, key=costs.get)}")
        + f" ({card})")
    return dict(launches=launches, max_abs_err=err, ms=b2b["kernel"],
                plain_ms=b2b["plain"], library_ms=b2b["library"],
                single_call_ms=single["kernel"],
                graph_ms=graph_ms["kernel"],
                bound_ms=max(nbytes / HBM_RATE, flops / F32_RATE) * 1e3,
                bound_by="bytes" if nbytes / HBM_RATE >= flops / F32_RATE
                else "operations")


def static2_operands(variant, pcm, pool, n_ops):
    """The operands of one torch.mm that computes `variant` at equal work:
    [16, sum K] and [sum K, sites] bf16, pcm's column groups and the pool's
    prefixes of every op side by side in w order (K = 16, 48, 96, 96 an op
    for k0-k3)."""
    import torch

    from libpll2_tpu_torch.probes import constructs
    w = torch.arange(n_ops, device=pool.device)
    pm = (w * 7) % constructs.P_ROWS
    x = pool[w % constructs.N_SLOTS]                    # [n_ops, 48, sites]
    if variant in ("k0", "k1"):
        depth = 16 if variant == "k0" else 48
        p, x = pcm[pm][:, :, :depth], x[:, :depth]
    else:
        # the groups' columns lie side by side in a row: 0-15, 16-47, 48-95
        p = pcm[torch.zeros_like(pm) if variant == "k2" else pm]
        x = torch.cat([x[:, :16], x[:, :32], x[:, :48]], dim=1)
    return (p.permute(1, 0, 2).reshape(constructs.SPAN, -1).contiguous(),
            x.reshape(-1, x.shape[-1]).contiguous())


def static2_library_ms(pcm, pool, n_ops, card):
    """One PyTorch call per variant at the kernel's work: torch.mm of the
    gathered operands (static2_operands, built before the events) with an
    f32 output from the bf16 operands (torch.mm(..., out_dtype=
    torch.float32)), held against static2_reference.  Returns {variant: ms
    back to back}."""
    import torch

    from libpll2_tpu_torch.probes import constructs
    times = {}
    for variant in constructs.K_VARIANTS:
        a, b = static2_operands(variant, pcm, pool, n_ops)

        def call():
            return torch.mm(a, b, out_dtype=torch.float32)
        want = constructs.static2_reference(variant, pcm, pool, n_ops)
        err = constructs.static2_error(call(), want)
        check(err <= constructs.static2_tolerance(n_ops),
              f"torch.mm differs from the plain {variant}: {err}")
        times[variant] = cuda_ms_back_to_back(call, 10)
        log(f"[time] construct_probe {variant}, one torch.mm(bf16 "
            f"{list(a.shape)}, bf16 {list(b.shape)}, out_dtype=f32) at the "
            f"kernel's work: {times[variant]:.4f} ms back to back (the "
            f"gathered pool {b.numel() * 2 / 1e9:.3f} GB, against "
            f"{pool[:, :16 if variant == 'k0' else 48].numel() * 2 / 1e9:.3f}"
            f" GB the kernel reads once), rel err {err:.2e} ({card})")
        del a, b, want
    torch.cuda.empty_cache()
    return times


def phase_construct_probe(device, card, smem_a_lib):
    """tools/static2probe.py's k0-k3 (the row's kernel): each against its
    plain version, timed back to back and in one CUDA graph; one torch.mm
    a variant at equal work; the register tile against static2_smem_a in
    turns.  Then c0-c4, the tensor-core sweep's constructs, against their
    plain versions (outside the row)."""
    import torch

    from libpll2_tpu_torch.probes import constructs, variants

    n_ops, tb = 128, 128
    reset_counts()
    rows = constructs.run_static2(
        n_ops, constructs.STATIC2_SITES, STATIC2_REPS, device=device,
        emit=lambda line: log(f"[static2] {line} ({card})"))
    launches = read_counts()["construct_probe"]
    check(len(rows) == 4 and launches > 0, "the probe launched nothing")
    pcm, pool = constructs.static2_inputs(constructs.STATIC2_SITES,
                                          device=device)
    library = static2_library_ms(pcm, pool, n_ops, card)
    del pcm, pool
    forms = variants.static2_forms(device, card, emit=log, lib=smem_a_lib,
                                   n_ops=n_ops, reps=STATIC2_REPS)
    bound = sum(r["bound_ms"] for r in rows)
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    graph = sum(r["graph_ms"] for r in rows)
    log(f"[time] construct_probe k0-k3, {n_ops} ops, "
        f"{constructs.STATIC2_SITES} sites, a launch of each summed: "
        f"{sum(r['ms'] for r in rows):.4f} ms back to back, {graph:.4f} ms "
        f"in CUDA graphs (device time, no host launch); bound {bound:.4f} "
        f"ms ({by_ops:.4f} of it by operations): {bound / graph:.4f} of it "
        f"in the graphs; per op in the graphs "
        + ", ".join(f"{r['variant']} {r['graph_us_per_op']:.4f}"
                    for r in rows)
        + " us; increments k1-k0, k2-k1, k3-k2 "
        + ", ".join(f"{b['graph_us_per_op'] - a['graph_us_per_op']:+.4f}"
                    for a, b in zip(rows, rows[1:]))
        + f" us/op; plain static2_reference "
        f"{sum(r['plain_ms'] for r in rows):.3f} ms; torch.mm at equal work "
        f"{sum(library.values()):.4f} ms; register tile against "
        f"static2_smem_a in graphs: "
        + ", ".join(f"{v} {f['registers']:.4f}/"
                    + (f"{f['shared memory']:.4f}" if "shared memory" in f
                       else "does not fit")
                    for v, f in forms.items()) + f" ms ({card})")

    # c0-c4: this port's study of its own tensor-core sweep
    reset_counts()
    c_rows = constructs.run_probe(n_ops, tb, emit=lambda line: log(
        f"[constructs] {line} ({card})"))
    check(len(c_rows) == 5 and read_counts()["construct_probe_c0_c4"] > 0,
          "the c0-c4 probe launched nothing")
    return dict(launches=launches,
                max_abs_err=max(r["abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows), graph_ms=graph,
                plain_ms=sum(r["plain_ms"] for r in rows),
                library_ms=sum(library.values()),
                library_ms_by_variant=library,
                ms_by_variant={r["variant"]: r["ms"] for r in rows},
                graph_ms_by_variant={r["variant"]: r["graph_ms"]
                                     for r in rows},
                us_per_op={r["variant"]: r["graph_us_per_op"] for r in rows},
                smem_a_graph_ms={v: f.get("shared memory")
                                 for v, f in forms.items()},
                bound_ms=bound,
                bound_by="operations" if 2 * by_ops >= bound else "bytes")


PART_TIPS, PART_SITES = 256, 65536      # the JAX bench's primary width
PART_SCALED = (1024, 4096, 10.0)        # caterpillar taxa, sites, bl x
PART_RTOL = 1e-10        # Partition f64 vs dense f64 engine; pulley
REPEATS_RTOL = 1e-12     # repeats vs dense where the card breaks bit-equality
DERIV_RTOL = 1e-5        # (d1, d2) vs central differences of the edge logL
ANC_ATOL = 1e-12         # ancestral rows sum to 1
PART_TIMING_CALLS = 3
NT_CHARS = np.array(list("?ACMGRSVTWYHKDBN"))  # MAP_NT's code -> character


def partition_sequences(chars, sites):
    """{label: ASCII sequence} of bitmask codes (MAP_NT's characters)."""
    return {label: "".join(NT_CHARS[np.asarray(codes[:sites], np.int64)])
            for label, codes in chars.items()}


def rooted_newick(tree):
    """The unrooted `tree` rooted on its root edge (vroot, vroot.back),
    the edge split in halves; lengths at full precision."""
    def sub(node, length):
        if node.next is None:
            return f"{node.label}:{length!r}"
        return (f"({sub(node.next.back, node.next.back.length)},"
                f"{sub(node.next.next.back, node.next.next.back.length)})"
                f":{length!r}")
    r = tree.vroot
    half = r.length / 2
    return f"({sub(r, half)},{sub(r.back, half)});"


def make_partition(tree, seqs, device, rooted=False, **kw):
    """A port Partition for `tree` (unrooted, or an RTree when `rooted`)
    under search_inputs' model, f64, tips set from `seqs` with MAP_NT and
    P-matrices of the tree's branch lengths.  Returns (partition, ops,
    the bytes the constructor allocated on the card)."""
    import torch

    from libpll2_tpu_torch import MAP_NT, Partition
    from libpll2_tpu_torch import tree as T

    if rooted:
        ops, branches, pmat_idx = T.rtree_create_operations(
            T.rtree_traverse(tree.root))
        n_pmat = max(pmat_idx) + 1
    else:
        ops, branches, pmat_idx = T.create_operations(T.traverse(tree.vroot))
        n_pmat = 2 * tree.tip_count - 3
    n = tree.tip_count
    before = torch.cuda.memory_allocated(device)
    p = Partition(n, tree.inner_count, 4, len(next(iter(seqs.values()))), 1,
                  n_pmat, 4, tree.inner_count, device=device, **kw)
    held = torch.cuda.memory_allocated(device) - before
    p.set_frequencies(0, [0.28, 0.24, 0.22, 0.26])
    p.set_subst_params(0, [1.2, 2.7, 0.8, 1.1, 3.0, 1.0])
    p.set_gamma_rates(0.9)
    for node in tree.nodes[:n]:
        p.set_tip_states(node.clv_index, MAP_NT, seqs[node.label])
    p.update_prob_matrices([0] * 4, pmat_idx, branches)
    return p, ops, held


def root_edge(tree):
    r = tree.vroot
    return (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)


def partition_results(p, tree, fd: bool):
    """Edge logL with per-site values, (d1, d2) at twice the root edge's
    length (off the optimum, so d1 is not near 0), ancestral rows at the
    root pair and at a tip pair; with `fd`, (d1, d2) by central
    differences of compute_edge_loglikelihood."""
    from libpll2_tpu_torch import SCALE_BUFFER_NONE
    cp, sp, cc, sc, pm = root_edge(tree)
    logl, persite = p.compute_edge_loglikelihood(cp, sp, cc, sc, pm,
                                                 [0] * 4,
                                                 return_persite=True)
    t1 = 2.0 * tree.vroot.length
    sumtable = p.update_sumtable(cp, cc, sp, sc, [0] * 4)
    derivs = p.compute_likelihood_derivatives(sumtable, t1, [0] * 4)
    del sumtable
    tip = tree.nodes[0]
    anc = [p.compute_node_ancestral(cp, sp, cc, sc, pm, [0] * 4),
           p.compute_node_ancestral(tip.back.clv_index,
                                    tip.back.scaler_index, tip.clv_index,
                                    SCALE_BUFFER_NONE, tip.pmatrix_index,
                                    [0] * 4)]
    out = {"logl": logl, "persite": persite, "derivs": derivs, "anc": anc}
    if fd:
        h = 1e-3 * t1
        vals = []
        for t in (t1 - h, t1, t1 + h):
            p.update_prob_matrices([0] * 4, [pm], [t])
            vals.append(p.compute_edge_loglikelihood(cp, sp, cc, sc, pm,
                                                     [0] * 4))
        p.update_prob_matrices([0] * 4, [pm], [tree.vroot.length])
        out["fd"] = (-(vals[2] - vals[0]) / (2 * h),
                     -(vals[2] - 2 * vals[1] + vals[0]) / h ** 2)
    return out


def log_profile(label, prof, card):
    """A [partition] line of one profiling.profile_kernels result: wall,
    kernel time (the union of the device rows; their sum beside it where
    the two differ), idle share and the top five kernels."""
    if prof is None:
        log(f"[partition] profile of {label}: the trace holds no kernel "
            f"(device time not measured)")
        return
    summed = "" if abs(prof.kernel_sum_ms - prof.kernel_ms) < 1e-6 else \
        f", summed {prof.kernel_sum_ms:.4f} ms"
    log(f"[partition] profile of {label}: wall {prof.wall_ms:.4f} ms "
        f"({prof.profiled_wall_ms:.4f} under the profiler), kernels "
        f"{prof.kernel_ms:.4f} ms{summed} (idle share "
        f"{prof.idle_share:.4f}); top kernels: " + "; ".join(
            f"{name[:60]} {ms:.4f} ms x {n}" for name, ms, n in prof.top(5))
        + f" ({card})")


def time_update_partials(p, ops, card, label):
    """Device time of Partition.update_partials (CUDA events, median of
    PART_TIMING_CALLS calls after the first); with repeats also the host
    seconds of levelize_operations_repeats and the device time of the
    update on its prebuilt gathers.  Returns the peak of
    max_memory_allocated over the first call above what was allocated
    before it."""
    import torch

    from libpll2_tpu_torch import partition
    from libpll2_tpu_torch.ops import partials as partials_ops
    from libpll2_tpu_torch.profiling import profile_kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    p.update_partials(ops)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    ms = statistics.median(cuda_ms(lambda: p.update_partials(ops),
                                   PART_TIMING_CALLS))
    prof = profile_kernels(lambda: p.update_partials(ops))
    line = (f"[partition] update_partials ({label}, {p.cfg.tips} taxa x "
            f"{p.cfg.sites} sites, f64): {ms:.4f} ms (median of "
            f"{PART_TIMING_CALLS} calls, CUDA events)")
    if p.repeats is not None:
        t0 = time.perf_counter()
        level_ops, level_gathers = partition.levelize_operations_repeats(
            ops, p.cfg, p.repeats)
        host_s = time.perf_counter() - t0
        def prebuilt():
            partials_ops.update_partials_repeats(
                p.clv, p.scalers, p.pmatrix, level_ops, level_gathers, p.cfg)
        dev_ms = statistics.median(cuda_ms(prebuilt, PART_TIMING_CALLS))
        log_profile("the repeats update on prebuilt gathers",
                    profile_kernels(prebuilt), card)
        line += (f"; levelize_operations_repeats {host_s:.4f} s on the host "
                 f"({level_ops.shape[0]} levels x {level_ops.shape[1]}); "
                 f"the update on prebuilt gathers {dev_ms:.4f} ms")
    log(line + f" ({card})")
    log_profile(f"update_partials ({label})", prof, card)
    return peak


def compare_repeats(rep, den):
    """'bit-equal' or the largest relative difference of repeats against
    dense over logL, per-site values, (d1, d2) and ancestral rows."""
    pairs = [(np.array([rep["logl"]]), np.array([den["logl"]])),
             (rep["persite"], den["persite"]),
             (np.array(rep["derivs"]), np.array(den["derivs"]))] + \
        list(zip(rep["anc"], den["anc"]))
    if all(np.array_equal(a, b) for a, b in pairs):
        return "bit-equal", 0.0
    worst = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
                for a, b in pairs)
    return "not bit-equal", worst


def phase_partition(device, card, tips=PART_TIPS, sites=PART_SITES,
                    scaled=PART_SCALED):
    """Phase 21: the partition API at full width.  Returns the launches
    of the phase's path (one tree sweep through tree_sweep.cu)."""
    import torch

    from libpll2_tpu_torch import compute_gamma_cats
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.tree.generate import simulate_alignment
    from libpll2_tpu_torch.utils import memory, output

    t_phase = time.perf_counter()
    truth, _, chars, _, _ = search_inputs(device, tips, sites)
    seqs = partition_sequences(chars, sites)
    reset_counts()
    res, stats = {}, {}
    for repeats in (False, True):
        label = "repeats" if repeats else "dense"
        p, ops, held = make_partition(truth, seqs, device,
                                      site_repeats=repeats)
        peak = time_update_partials(p, ops, card, label)
        res[label] = partition_results(p, truth, fd=not repeats)
        clv_bytes = memory.dense_clv_bytes(p.cfg)
        log(f"[partition] {label}: CLVs + scalers {clv_bytes:,} B "
            f"(memory.dense_clv_bytes), the partition holds {held:,} B on "
            f"the card (P-matrices {p.pmatrix.nbytes:,} B); peak of "
            f"max_memory_allocated over update_partials {peak:,} B above "
            f"it ({peak / clv_bytes:.4f} of dense_clv_bytes) ({card})")
        check(held == clv_bytes + p.pmatrix.nbytes,
              f"{label} partition holds {held} B, not dense_clv_bytes "
              f"{clv_bytes} + P-matrices {p.pmatrix.nbytes}")
        if repeats:
            ids = p.repeats.pernode_ids[tips:p.cfg.num_clvs]
            indexed = ids[ids > 0]
            stats = {"class_indexed": int(indexed.size),
                     "inner": int(ids.size),
                     "tips_indexed": int(np.count_nonzero(
                         p.repeats.pernode_ids[:tips])),
                     "mean_ratio": float(np.mean(indexed / sites))
                     if indexed.size else 0.0}
        del p
        torch.cuda.empty_cache()
    rep, den = res["repeats"], res["dense"]
    verdict, worst = compare_repeats(rep, den)
    log(f"[partition] repeats against dense: {verdict} (largest relative "
        f"difference {worst:.3e}; logL, {sites} per-site values, (d1, d2), "
        f"ancestral rows at the root and a tip pair); class-indexed inner "
        f"nodes {stats['class_indexed']} of {stats['inner']}, tips "
        f"{stats['tips_indexed']} of {tips}, mean classes / sites "
        f"{stats['mean_ratio']:.4f}")
    check(verdict == "bit-equal" or worst < REPEATS_RTOL,
          f"repeats against dense {worst} >= {REPEATS_RTOL}")
    check(stats["class_indexed"] > 0, "no inner node was class-indexed")

    logl = den["logl"]
    logl64 = dense_f64_logl(truth, chars, sites, device)
    gap64 = abs(logl - logl64) / abs(logl64)
    logl32 = engine_logl(truth, chars, sites, device, torch.float32, True,
                         sweep_mode="fma")
    gap32 = abs(logl32 - logl) / abs(logl)
    (d1, d2), (f1, f2) = den["derivs"], den["fd"]
    g1, g2 = abs(d1 - f1) / abs(f1), abs(d2 - f2) / abs(f2)
    sums = max(float(np.max(np.abs(a.sum(axis=1) - 1.0))) for a in den["anc"])
    log(f"[partition] edge logL {logl!r}: dense f64 engine {logl64!r} (rel "
        f"{gap64:.3e}); engine.loglikelihood f32 through tree_sweep.cu "
        f"{logl32!r} (rel {gap32:.3e}); (d1, d2) at 2x the root edge "
        f"({d1!r}, {d2!r}) against central differences ({f1!r}, {f2!r}): "
        f"rel {g1:.3e}, {g2:.3e}; ancestral rows sum to 1 within "
        f"{sums:.3e}")
    check(np.isfinite(logl) and gap64 < PART_RTOL,
          f"partition logL against dense f64 {gap64} >= {PART_RTOL}")
    check(np.isfinite(logl32) and gap32 < LOGL_RTOL,
          f"partition logL against the tree sweep {gap32} >= {LOGL_RTOL}")
    check(g1 < DERIV_RTOL and g2 < DERIV_RTOL,
          f"(d1, d2) against central differences {g1}, {g2} >= "
          f"{DERIV_RTOL}")
    check(sums < ANC_ATOL, f"ancestral rows sum to 1 within {sums}")

    rt = T.parse_rtree_string(rooted_newick(truth))
    p, ops, _ = make_partition(rt, seqs, device, rooted=True)
    p.update_partials(ops)
    rooted = p.compute_root_loglikelihood(rt.root.clv_index,
                                          rt.root.scaler_index, [0] * 4)
    del p
    torch.cuda.empty_cache()
    gap_r = abs(rooted - logl) / abs(logl)
    log(f"[partition] pulley principle: rooted on the root edge "
        f"(rtree_create_operations, compute_root_loglikelihood) {rooted!r} "
        f"against the unrooted edge logL: rel {gap_r:.3e}")
    check(gap_r < PART_RTOL, f"pulley principle {gap_r} >= {PART_RTOL}")
    counts = read_counts()

    n, s, scale = scaled
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    cat = T.parse_newick_string(caterpillar(n))
    for node in cat.nodes:
        node.length *= scale
    rng = np.random.default_rng(SEARCH_SEED)
    cchars = simulate_alignment(cat, s, rng, [1.2, 2.7, 0.8, 1.1, 3.0, 1.0],
                                [0.28, 0.24, 0.22, 0.26],
                                compute_gamma_cats(0.9, 4))
    cseqs = partition_sequences(cchars, s)
    want = dense_f64_logl(cat, cchars, s, device)
    for per_rate in (False, True):
        for repeats in (False, True):
            p, ops, _ = make_partition(cat, cseqs, device,
                                    per_rate_scalers=per_rate,
                                    site_repeats=repeats)
            p.update_partials(ops)
            got = p.compute_edge_loglikelihood(*root_edge(cat), [0] * 4)
            top = int(p.scalers[:p.cfg.scale_buffers].max())
            del p
            torch.cuda.empty_cache()
            gap = abs(got - want) / abs(want)
            log(f"[partition] scaled caterpillar {n} x {s} (branches x "
                f"{scale}), {'per-rate' if per_rate else 'per-site'} "
                f"scalers, repeats {'on' if repeats else 'off'}: logL "
                f"{got!r} against dense f64 {want!r} (rel {gap:.3e}); "
                f"largest scaler {top}")
            check(gap < PART_RTOL, f"scaled case {gap} >= {PART_RTOL}")
            check(top > 0, "no scaler entry was set in the scaled case")
    log(f"[partition] hardware_probe {output.hardware_probe()}")
    hbm = memory.device_memory_bytes(device)
    log(f"[partition] max sites on this card ({hbm:,} B, "
        f"memory.max_sites_table) ({card}):")
    for row in memory.max_sites_table(hbm).splitlines():
        log(f"[partition]   {row}")
    log(f"[time] phase 21 (the partition API) "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


SHARD_RANKS = 2          # ranks of phase 22, both on the one card (gloo)
SHARD_LOGL_RTOL = 1e-6   # sharded kernel logL vs single-process kernel logL
SHARD_DERIV_RTOL = 1e-9  # sharded f64 (d1, d2) vs single-process f64
SHARD_SCORE_RTOL = 1e-5  # sharded f32 SPR scores vs single-process f32
SHARD_TIMED_CALLS = 20   # forward calls timed in each rank and alone


def sharded_step(mesh, tips, sites, search_tips, search_sites, reps):
    """Phase 22's work on one rank of `mesh` (or alone, on a one-process
    mesh): the forward case of build_case at tips x sites, f32, through
    the tree sweep on this rank's site slice (loglikelihood, then
    optimize_root_branch), the launches of both read just after them;
    the forward timed (CUDA events where the mesh is on a card, and the
    host clock); the dense f64 logL and all-branch (d1, d2); one SPR round
    (search_fast._spr_round_device, the plain scorer) on search_inputs
    at search_tips x search_sites, radius SEARCH_RADIUS."""
    import torch
    import torch.distributed as dist

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.parallel import sharding, shard_engine_inputs
    from libpll2_tpu_torch.tree.generate import balanced_newick

    dev, g = mesh.device, mesh.group
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg, program, model, bl, *site = engine.build_case(
        tips, sites, dtype=torch.float32, device=dev)
    site = shard_engine_inputs(mesh, *site)
    sync()
    reset_counts()
    logl = engine.loglikelihood(program, cfg, model, bl, *site, group=g)
    new_bl, logl_before = engine.optimize_root_branch(
        program, cfg, model, bl, *site, group=g)
    sync()
    root_pos = int(np.nonzero(
        program.pmatrix_indices == program.root_pmatrix)[0][0])
    out = {"counts": read_counts(), "logl": logl, "new_bl": new_bl,
           "root_t": new_bl[root_pos], "logl_before": logl_before,
           "mode": engine.kernel_choice(
               program, sharding.local_config(cfg, g), dev),
           "device": str(dev),
           "backend": None if g is None else dist.get_backend(g)}

    def forward():
        return engine.loglikelihood(program, cfg, model, bl, *site, group=g)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        forward()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["wall_ms"] = statistics.median(walls)
    out["event_ms"] = (statistics.median(cuda_ms(forward, reps))
                       if on_card else None)
    del site

    cfg64, program64, model64, bl64, *site64 = engine.build_case(
        tips, sites, dtype=torch.float64, device=dev, use_kernel=False)
    site64 = shard_engine_inputs(mesh, *site64)
    out["logl64"] = engine.loglikelihood(program64, cfg64, model64, bl64,
                                         *site64, group=g)
    full = engine.compile_tree_full(
        T.parse_newick_string(balanced_newick(tips)), cfg64)
    out["d1"], out["d2"] = engine.branch_derivatives(
        full, cfg64, model64, torch.as_tensor(
            full.default_branch_lengths, dtype=torch.float64, device=dev),
        *site64, group=g)
    del site64

    _, start, chars, scfg, smodel = search_inputs(
        dev, tips=search_tips, sites=search_sites)
    prog = sf.compile_spr(start, scfg, radius=SEARCH_RADIUS)
    ssite = shard_engine_inputs(mesh, sf._tipchars_for(prog, chars, dev),
                                *sf._aux_arrays(prog, dev))
    lops, pslots, sbl, rows, slot, gdev = sf._round_args(prog, dev)
    out["spr_logl"], outs = sf._spr_round_device(
        prog.cfg_ext, smodel, lops, pslots, sbl, *ssite, rows, slot, gdev,
        ball_slots=prog.ball_slots, newton_iters=3, use_kernel=False,
        group=g)
    out["spr_scores"] = torch.cat([s.flatten() for s, _ in outs])
    sync()
    return out


def phase_sharded(device, card, tips=PART_TIPS, sites=PART_SITES,
                  search_tips=SEARCH_TIPS, search_sites=SEARCH_SITES,
                  reps=SHARD_TIMED_CALLS):
    """Phase 22, the sharded training step: sharded_step on SHARD_RANKS
    ranks sharing the card over gloo (parallel.launcher.launch), against
    the same work alone in this process, then engine.dryrun_multichip.
    Every result must be bit-identical across the ranks.  Returns the
    ranks' summed launches of the path's kernels."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.parallel import launcher, make_mesh

    t_phase = time.perf_counter()
    kwargs = dict(tips=tips, sites=sites, search_tips=search_tips,
                  search_sites=search_sites, reps=reps)
    alone = sharded_step(make_mesh([device]), **kwargs)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launcher.launch("chip_smoke:sharded_step", SHARD_RANKS, kwargs,
                            device=device.type)
    log(f"[shard] {SHARD_RANKS} ranks launched, ran and joined in "
        f"{time.perf_counter() - t0:.3f} s")

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x
    alone = {k: host(v) for k, v in alone.items()}
    timed = ("counts", "wall_ms", "event_ms", "device")
    for key, value in ranks[0].items():
        if key not in timed:
            for r, other in enumerate(ranks[1:], 1):
                same = (torch.equal(value, other[key])
                        if isinstance(value, torch.Tensor)
                        else value == other[key])
                check(same, f"sharded {key}: rank {r} differs from rank 0")
    got = ranks[0]
    counts = {k: sum(r["counts"][k] for r in ranks)
              for k in ("tree_sweep", "tree_sweep_mma", "edge_score")}
    log(f"[shard] launches in the ranks' forward and training step: "
        f"{[r['counts']['tree_sweep'] for r in ranks]} tree_sweep, "
        f"{[r['counts']['tree_sweep_mma'] for r in ranks]} tree_sweep_mma; "
        f"(site block, form) {got['mode']} a rank, {alone['mode']} alone")
    check(counts["tree_sweep"] + counts["tree_sweep_mma"]
          >= 2 * SHARD_RANKS, "the ranks did not launch the tree sweep")

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))
    gaps = {"logl vs alone": rel(got["logl"], alone["logl"]),
            "logl vs dense f64": rel(got["logl"], alone["logl64"]),
            "dense f64 logl vs alone": rel(got["logl64"], alone["logl64"]),
            "logl_before vs alone": rel(got["logl_before"],
                                        alone["logl_before"])}
    t_gap = rel(got["root_t"], alone["root_t"])
    d_gaps = [float(((got[k] - alone[k]).abs()
                     / alone[k].abs().clamp_min(1e-300)).max())
              for k in ("d1", "d2")]
    a, b = got["spr_scores"], alone["spr_scores"]
    finite = torch.isfinite(b)
    s_gap = float(((a[finite] - b[finite]).abs()
                   / b[finite].abs().clamp_min(1.0)).max())
    log(f"[shard] {tips} taxa x {sites} sites over {SHARD_RANKS} ranks of "
        f"{sites // SHARD_RANKS}: logL {float(got['logl'])!r} (alone "
        f"{float(alone['logl'])!r}, dense f64 {float(alone['logl64'])!r}); "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; root branch {float(got['root_t'])!r} (alone "
        f"{float(alone['root_t'])!r}), rel gap {t_gap:.3e}; f64 (d1, d2) over {got['d1'].numel()} branches, max "
        f"rel gap {d_gaps[0]:.3e}, {d_gaps[1]:.3e}; bit-identical across "
        f"the ranks")
    log(f"[shard] SPR round {search_tips} x {search_sites}, radius "
        f"{SEARCH_RADIUS}, plain scorer: logL {float(got['spr_logl'])!r} "
        f"(alone {float(alone['spr_logl'])!r}); {int(finite.sum())} finite "
        f"of {b.numel()} slots, max rel gap {s_gap:.3e} on max(1, |s|)")
    check(all(np.isfinite(float(got[k])) for k in ("logl", "logl64",
                                                   "spr_logl")),
          "non-finite sharded logL")
    check(gaps["logl vs alone"] < SHARD_LOGL_RTOL,
          f"sharded logL gap {gaps['logl vs alone']}")
    check(gaps["logl vs dense f64"] < LOGL_RTOL,
          f"sharded logL vs dense f64 {gaps['logl vs dense f64']}")
    check(gaps["dense f64 logl vs alone"] < 1e-12,
          f"sharded f64 logL gap {gaps['dense f64 logl vs alone']}")
    check(gaps["logl_before vs alone"] < SHARD_LOGL_RTOL,
          f"sharded training-step logL gap {gaps['logl_before vs alone']}")
    check(t_gap < BL_RTOL, f"sharded root branch gap {t_gap}")
    check(max(d_gaps) < SHARD_DERIV_RTOL, f"sharded (d1, d2) gap {d_gaps}")
    check(bool((torch.isfinite(a) == finite).all()),
          "sharded SPR scores: another finite mask")
    check(s_gap < SHARD_SCORE_RTOL, f"sharded SPR score gap {s_gap}")
    check(rel(got["spr_logl"], alone["spr_logl"]) < SHARD_LOGL_RTOL,
          "sharded SPR round logL")

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"
    cards = len({r["device"] for r in ranks})
    log(f"[time] sharded forward {tips}x{sites}, {SHARD_RANKS} ranks on "
        f"{cards} card(s) over {got['backend']} (each rank's sweep on its "
        f"slice, then the logL all-reduced): CUDA events "
        f"{[fmt(r['event_ms']) for r in ranks]}, wall "
        f"{[fmt(r['wall_ms']) for r in ranks]}; alone in one process: "
        f"CUDA events {fmt(alone['event_ms'])}, wall "
        f"{fmt(alone['wall_ms'])}; medians of {reps} calls"
        + (".  The ranks share a card, so this is no speed-up"
           if cards < SHARD_RANKS else ", one card a rank")
        + f" ({card})")

    t0 = time.perf_counter()
    results = engine.dryrun_multichip(SHARD_RANKS, device=device.type)
    log(f"[shard] engine.dryrun_multichip({SHARD_RANKS}): logL "
        f"{float(results[0]['logl'])!r} -> {float(results[0]['logl2'])!r}, "
        f"SPR round logL {float(results[0]['spr_logl'])!r}, equal on every "
        f"rank, {time.perf_counter() - t0:.3f} s; phase 22 "
        f"{time.perf_counter() - t_phase:.3f} s")
    return counts


EXAMPLES_F64 = ("rooted", "rooted_tacg", "unrooted", "partial_traversal",
                "newton", "lg4", "protein_list", "heterotachy",
                "newick_fasta_unrooted", "newick_phylip_unrooted",
                "load_utree", "newick_export", "parsimony_demo",
                "stepwise_demo", "optimize_demo")
EXAMPLES_RTOL = 1e-9     # an f64 demo's numbers, card against host CPU


def run_example(name, argv, card):
    """libpll2_tpu_torch.examples.<name>.main(argv) in this process, its
    standard output captured: (output, main's return value).  Prints an
    [examples] line with its wall seconds."""
    import contextlib
    import importlib
    import io

    import torch
    module = importlib.import_module(f"libpll2_tpu_torch.examples.{name}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = module.main(argv)
    torch.cuda.synchronize()
    where = "host CPU" if "cpu" in argv else "card"
    log(f"[examples] {name} {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.3f} s on the {where} ({card})")
    return buf.getvalue(), ret


def compare_outputs(name, want, got, rtol=EXAMPLES_RTOL):
    """The largest relative difference of the numbers of two outputs of
    one demo; fails where the text between the numbers differs."""
    from libpll2_tpu_torch.examples._common import split_numbers
    want_lines, got_lines = want.splitlines(), got.splitlines()
    check(len(want_lines) == len(got_lines) and want_lines,
          f"{name}: {len(got_lines)} lines on the card, {len(want_lines)} "
          f"on the host CPU")
    worst = 0.0
    for w, g in zip(want_lines, got_lines):
        (wt, wn), (gt, gn) = split_numbers(w), split_numbers(g)
        check(wt == gt, f"{name}: text differs: {w!r} (host CPU) {g!r} "
                        f"(card)")
        for a, b in zip(wn, gn):
            if a != b:
                worst = max(worst, abs(a - b) / max(abs(a), abs(b)))
    check(worst <= rtol, f"{name}: numbers differ by {worst:.3e} > {rtol}")
    return worst


def phase_examples(device, card):
    """Phase 23: every demo of libpll2_tpu_torch.examples, in this process.
    The f64 demos on the card and on the host CPU, their outputs compared;
    large_search at its defaults (256 x 4,096, radius 5, 12 rounds, f32
    through the kernels): a monotone trace and a final logL within
    LOGL_RTOL of the dense f64 path on the final tree; infer_demo at its
    defaults: RF to the truth at most INFER_RF.  Returns the launches of
    the demos on the card."""
    import torch

    from libpll2_tpu_torch.tree.compare import rf_distance_normalized
    t_phase = time.perf_counter()
    reset_counts()
    worst = {}
    for name in EXAMPLES_F64:
        on_card, _ = run_example(name, [], card)
        on_host, _ = run_example(name, ["--device", "cpu"], card)
        worst[name] = compare_outputs(name, on_host, on_card)
    log(f"[examples] {len(EXAMPLES_F64)} f64 demos, card against host CPU: "
        f"text equal, largest relative difference of a number "
        f"{max(worst.values()):.3e} ({max(worst, key=worst.get)}; bound "
        f"{EXAMPLES_RTOL})")

    out, res = run_example("large_search", [], card)
    for line in out.splitlines():
        log(f"[examples]   {line}")
    trace = res["stats"]["logl_trace"]
    check(all(np.isfinite(trace)), "large_search: non-finite logL")
    check(all(b >= a for a, b in zip(trace, trace[1:])),
          "large_search: the logL trace decreased")
    logl64 = dense_f64_logl(res["tree"], res["chars"], SEARCH_SITES, device)
    gap = abs(res["logl"] - logl64) / abs(logl64)
    rf = rf_distance_normalized(res["tree"], res["truth"])
    log(f"[examples] large_search: {res['stats']['rounds']} rounds, final "
        f"logL {res['logl']!r}, dense f64 on its tree {logl64!r} (rel gap "
        f"{gap:.3e}), RF to the truth {rf:.4f}")
    check(gap < LOGL_RTOL, f"large_search: final logL gap {gap} >= "
                           f"{LOGL_RTOL}")

    out, res = run_example("infer_demo", [], card)
    for line in out.splitlines():
        log(f"[examples]   {line}")
    check(np.isfinite(res["result"].logl), "infer_demo: non-finite logL")
    check(res["rf"] <= INFER_RF, f"infer_demo: RF {res['rf']} > {INFER_RF}")
    counts = read_counts()
    log(f"[examples] launches on the card: tree_sweep "
        f"{counts['tree_sweep']}, tree_sweep_mma {counts['tree_sweep_mma']}, "
        f"edge_score {counts['edge_score']}; phase 23 "
        f"{time.perf_counter() - t_phase:.3f} s ({card})")
    check(counts["tree_sweep"] + counts["tree_sweep_mma"] > 0
          and counts["edge_score"] > 0,
          "the demos on the card launched no tree sweep or edge scorer")
    torch.cuda.empty_cache()
    return counts


PROFILE_TARGETS = (
    ("engine", dict(tips=256, sites=65536)),
    ("sweep", dict(tips=256, sites=65536)),
    ("round", dict(tips=SEARCH_TIPS, sites=SEARCH_SITES,
                   radius=SEARCH_RADIUS, reps=2)),
    ("search", dict(tips=SEARCH_TIPS, sites=SEARCH_SITES,
                    radius=SEARCH_RADIUS, rounds=3)),
    ("repeats", dict(tips=256, sites=65536, reps=1)),
)


def phase_profiling(device, card):
    """Phase 24: the five targets of libpll2_tpu_torch.profiling at the
    main path's shapes, each printed as a [profile] JSON line; each
    headline's trace must hold a kernel."""
    import torch

    from libpll2_tpu_torch import profiling
    t_phase = time.perf_counter()
    for target, kw in PROFILE_TARGETS:
        t0 = time.perf_counter()
        out = profiling.run(target, device, **kw)
        log("[profile] " + json.dumps(out))
        check(out["card"] == card, f"{target}: card {out['card']!r}")
        check(bool(out["top_kernels"]),
              f"profiling {target}: the headline's trace holds no kernel")
        if out["kernel_ms"] is None:
            kernels = f"kernels and idle share null: " \
                      f"{out['kernel_null_reason']}"
        else:
            summed = "" if abs(out["kernel_sum_ms"] - out["kernel_ms"]) \
                < 1e-6 else f" (rows summed {out['kernel_sum_ms']:.4f} ms)"
            kernels = f"kernels {out['kernel_ms']:.4f} ms{summed}, idle " \
                      f"share {out['idle_share']:.4f}"
        lost = [f"{name} {ph['own_rows']:g} of {ph['own_launches']:g}"
                for name, ph in out["phases"].items()
                if ph.get("own_rows") is not None
                and ph["own_rows"] < ph["own_launches"]]
        log(f"[profile] {target} {out['headline']}: wall "
            f"{out['wall_ms']:.4f} ms ({out['profiled_wall_ms']:.4f} under "
            f"the profiler), {kernels}; phases whose trace lost rows of "
            f"this package's kernels (rows of launches a call): "
            f"{'; '.join(lost) or 'none'}; "
            f"{time.perf_counter() - t0:.3f} s ({card})")
        torch.cuda.empty_cache()
    log(f"[profile] phase 24 {time.perf_counter() - t_phase:.3f} s ({card})")


# Phases 25-27: the generic-state forms of the tree sweep and the edge
# scorer, at state counts without an instantiation of their own (2, 4, 10,
# 16 and 20 have theirs).  Small cases against the plain versions, then the
# paths at full width: 5 states at dna_256's size, 32 at protein_128's.
ODD_STATES = (3, 5, 6, 7, 8, 12, 32)
ODD_TIPS, ODD_SITES = 40, 2048          # the small sweep cases, random trees
ODD_SEARCH_TIPS, ODD_SEARCH_SITES = 20, 512   # the small scorer cases
ODD5_TIPS, ODD5_SITES = 256, 65536      # GTR-5 + Gamma4, dna_256's size
ODD32_TIPS, ODD32_SITES = 128, 16384    # Mk-32 + Gamma4, protein_128's size
ODD32_WARPS_RATES = 12                  # phase 27's second case
ODD_TRAIN_STEPS = 10
ODD_SEED = 5


def odd_model(states, seed=ODD_SEED):
    """(exchangeabilities, frequencies): at 5 states GTR drawn from `seed`
    (gap as a fifth state), at any other count Mk (all equal, as RAxML-NG's
    MULTIx_MK)."""
    if states == 5:
        rng = np.random.default_rng(seed)
        return (rng.uniform(0.5, 2.0, 10).tolist(),
                rng.dirichlet(np.full(5, 5.0)).tolist())
    return [1.0] * (states * (states - 1) // 2), [1.0 / states] * states


def odd_case(tips, sites, states, device, dtype, use_kernel=None,
             seed=ODD_SEED, rates=4):
    """engine.build_case's forward case at `states` states under
    odd_model: a balanced tree, Gamma(1) `rates` rates, one-hot random
    tips from `seed`.  Returns (cfg, program, model, branch_lengths,
    tipchars, pattern_weights, invariant)."""
    from libpll2_tpu_torch import engine
    subst, freqs = odd_model(states, seed)
    return engine.build_case(tips, sites, rate_cats=rates, dtype=dtype,
                             device=device, seed=seed, use_kernel=use_kernel,
                             states=states, subst=subst, freqs=freqs)


def odd_search_inputs(device, states, tips=SEARCH_TIPS, sites=SEARCH_SITES,
                      seed=SEARCH_SEED):
    """search_inputs' case (profiling.search_case) at `states` states
    under odd_model; f32.  Returns (truth, start, chars, cfg, model)."""
    from libpll2_tpu_torch.profiling import search_case
    subst, freqs = odd_model(states)
    return search_case(device, tips, sites, seed, subst=subst, freqs=freqs)


# phase 25's cases where a site's row groups span warps (G * lanes > 32:
# many rates at many states), the per-site rescue an AND across them
# (partials_tree.generic_spans_warps): (name, states, sweep_inputs
# keywords)
WARPS_CASES = (
    ("S12_R20_per_rate_warps", 12, {"rates": 20, "per_rate": True,
                                    "bl_scale": 30.0}),
    ("S32_R12_scale_heavy_warps", 32, {"rates": 12, "bl_scale": 30.0}),
    ("S32_R32_warps", 32, {"rates": 32}),
    ("S32_R32_bf16_scale_heavy_warps", 32, {"rates": 32, "bl_scale": 30.0,
                                            "dtype": "bf16"}),
    ("S17_R16_bf16_per_rate_warps", 17, {"rates": 16, "per_rate": True,
                                         "bl_scale": 30.0, "dtype": "bf16"}),
    ("S9_R32_scale_heavy_warps", 9, {"rates": 32, "bl_scale": 30.0}))


def phase_generic_vs_plain(device):
    """Phase 25: the generic-state forms against their plain versions at
    small sizes.  The tree sweep at every count of ODD_STATES on a random
    ODD_TIPS-taxon tree x ODD_SITES sites under a random model, and per-rate
    scalers and a scale-heavy case (branch lengths x 30) at 5 and 32
    states, and WARPS_CASES (a site's row groups over two or four warps,
    f32 and bf16, the carry on and off bit-equal): f32 rows at CLV_RTOL
    and no scaler mismatch, bf16 rows within BF16_ROW_BOUND of each site's
    largest entry, one launch of the generic sweep a call.  The edge
    scorer at 5 and 32 states over every ball group of a radius-3 round of
    ODD_SEARCH_TIPS x ODD_SEARCH_SITES, both forms where the resident one
    is planned.  Returns the sweep's max abs err."""
    import torch

    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch.ops import edge_score, partials_tree
    from libpll2_tpu_torch.tree.generate import random_newick

    rng = np.random.default_rng(2614)
    cases = [(f"S{s}", s, {}) for s in ODD_STATES]
    for s in (5, 32):
        cases += [(f"S{s}_per_rate", s, {"per_rate": True,
                                          "bl_scale": 30.0}),
                  (f"S{s}_scale_heavy", s, {"bl_scale": 30.0})]
    cases += list(WARPS_CASES)
    worst = 0.0
    for i, (name, states, kw) in enumerate(cases):
        kw = dict(kw, dtype=torch.bfloat16 if kw.get("dtype") == "bf16"
                  else torch.float32)
        cfg, program, pmatrix, tip_b, tb = sweep_inputs(
            random_newick(ODD_TIPS, rng), ODD_SITES, 100 + i, device,
            states=states, random_model=True, **kw)
        prog = program.vmem_prog
        groups = partials_tree.generic_groups(cfg)
        warps = groups * partials_tree.rate_lanes(cfg.rate_cats) > 32
        check(warps == name.endswith("_warps"),
              f"{name}: {groups} row groups at {cfg.rate_cats} rates")
        before = partials_tree.sweep.launches_generic
        got = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
        off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb,
                                  carry=False) if warps else got
        want = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
        torch.cuda.synchronize()
        launched = partials_tree.sweep.launches_generic - before
        same = torch.equal(got[0], off[0]) and torch.equal(got[1], off[1])
        if cfg.dtype == torch.bfloat16:
            rel, mism, comp, abs_err = compare_rows_site(got[0], want[0],
                                                         got[1], want[1])
            err = f"site-rel {rel:.3e} compensated {comp:.3e}"
            close = rel <= BF16_ROW_BOUND and comp <= BF16_ROW_BOUND
        else:
            abs_err, mism, rel = compare_rows(got[0], want[0], got[1],
                                              want[1])
            err = f"compensated_rel_err={rel:.3e}"
            close = mism == 0 and rel <= CLV_RTOL
        rescues = int(want[1].max().item())
        calls = 2 if warps else 1
        log(f"[generic] sweep {name}: ops={prog.n_ops} pool={prog.pool_size} "
            f"tb={tb} threads={partials_tree.fma_threads(cfg, tb)} smem/cta="
            f"{partials_tree.smem_bytes(prog, cfg, tb)} sites={ODD_SITES} "
            f"rates={cfg.rate_cats} {str(cfg.dtype).replace('torch.', '')} "
            f"per_rate={cfg.per_rate_scalers} groups={groups} rescue across "
            f"warps {partials_tree.generic_spans_warps(cfg)}; generic "
            f"launches {launched}; max_abs_err={abs_err:.3e} {err} "
            f"scaler_mismatches={mism} max_scaler={rescues}"
            + (f"; carry on and off bit-equal: {same}" if warps else ""))
        check(launched == calls,
              f"{name}: the generic sweep ran {launched} times")
        check(same, f"{name}: rows differ between carry on and off")
        check(close, f"{name}: rows off plain ({err}, {mism} scaler "
                     f"mismatches)")
        if "bl_scale" in kw:
            check(rescues > 0, f"{name}: scale-heavy case did not rescue")
        worst = max(worst, abs_err)
        del got, off, want, pmatrix, tip_b
    for states in (5, 32):
        _truth, start, chars, cfg, model = odd_search_inputs(
            device, states, ODD_SEARCH_TIPS, ODD_SEARCH_SITES)
        before = edge_score.edge_scores.launches_generic
        r = score_round_both(sf.compile_spr(start, cfg, radius=3), model,
                             chars, timed=False)
        launched = edge_score.edge_scores.launches_generic - before
        name = f"S={states} {cfg.tips}x{cfg.sites} radius 3"
        log_scores("[generic] edge scorer", name, r)
        check(launched == r["launches"] * len(r["forms"]),
              f"{name}: {launched} generic scorer launches for "
              f"{r['launches']} chunks")
        check_scores(name, r)
    return worst


def generic_sweep_times(name, case, card):
    """The generic sweep alone at a full-width case, at the block
    `engine.kernel_choice` gives: rows against the plain version (at a
    bf16 pool within BF16_ROW_BOUND of each site's largest entry), the
    kernel as 30 calls back to back (3 runs), single calls, the plain
    version (median of 2 calls), and the bound.  Returns a kernels-line
    dict."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    cfg, program, model, bl, tipchars, *_ = case
    prog = program.vmem_prog
    pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
    tb, mode = kernel_form(program, cfg, tipchars.device)
    check(mode == "fma" and partials_tree.generic(cfg),
          f"{name}: kernel_choice gave {mode!r} at {cfg.states} states")
    tips = engine.block_tips(tipchars, cfg, tb)

    def call():
        return partials_tree.sweep(tips, pmatrix, prog, cfg, tb)
    got = {}
    first = cuda_ms(lambda: got.setdefault("v", call()), 1)[0]
    plain = {}
    plain_ms = statistics.median(cuda_ms(lambda: plain.__setitem__(
        "v", partials_tree.sweep_reference(tips, pmatrix, prog, cfg, tb)),
        2))
    if cfg.dtype == torch.bfloat16:
        rel, mism, comp, abs_err = compare_rows_site(
            got["v"][0], plain["v"][0], got["v"][1], plain["v"][1])
        check(rel <= BF16_ROW_BOUND and comp <= BF16_ROW_BOUND,
              f"{name}: generic rows off plain by {rel}, compensated "
              f"{comp}")
    else:
        abs_err, mism, rel = compare_rows(got["v"][0], plain["v"][0],
                                          got["v"][1], plain["v"][1])
        check(mism == 0 and rel <= CLV_RTOL,
              f"{name}: generic rows off plain by {rel}, {mism} scaler "
              f"mismatches")
    del got, plain
    single = statistics.median(cuda_ms(call, 10))
    b2b = [cuda_ms_back_to_back(call, 30) for _ in range(3)]
    med = statistics.median(b2b)
    b = sweep_bound(prog, cfg, "fma", tips)
    updates = (cfg.tips - 2) * cfg.sites
    log(f"[time] sweep generic {name} {cfg.tips}x{cfg.sites} S={cfg.states} "
        f"ops={prog.n_ops} pool={prog.pool_size} tb={tb} threads="
        f"{partials_tree.fma_threads(cfg, tb)} ctas={cfg.sites_padded // tb} "
        f"smem/cta={partials_tree.smem_bytes(prog, cfg, tb)}: {med:.4f} ms a "
        f"call in 30 launched back to back (3 runs: "
        f"{', '.join(f'{t:.4f}' for t in b2b)}), warm median of 10 single "
        f"calls {single:.4f} ms, first call {first:.3f} ms, "
        f"{updates / (med * 1e-3):.4e} site-updates/s; plain sweep_reference "
        f"{plain_ms:.2f} ms (median of 2); rows against plain: compensated "
        f"rel {rel:.3e}, abs {abs_err:.3e}, {mism} scaler mismatches; bound "
        f"{b[0]:.4f} ms by {b[1]} (HBM bytes {b[2]:.4f}, operations "
        f"{b[3]:.4f}; shared-memory traffic {b[4]:.4f}) ({card})")
    del pmatrix, tips
    torch.cuda.empty_cache()
    return dict(ms=med, runs=b2b, single_call_ms=single, plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1], smem_ms=b[4],
                max_abs_err=abs_err)


def forward_vs_dense(name, case, tips, sites, states, device, card,
                     rates=4):
    """engine.loglikelihood at full width through the kernel (by launch
    count, the generic sweep), against the dense f64 path on the same
    inputs; the dense f32 path's time beside the kernel path's.  Returns
    the launch counts."""
    import torch

    from libpll2_tpu_torch import engine

    cfg, program, model, *args = case
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logl = engine.loglikelihood(program, cfg, model, *args).item()
    cold = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(counts["tree_sweep_generic"] >= 1 and counts["tree_sweep_generic"]
          == counts["tree_sweep"] + counts["tree_sweep_mma"],
          f"{name}: the forward step did not run on the generic sweep "
          f"({counts})")
    ms = {}
    for label, c in (("kernel", cfg), ("dense_f32", dataclasses.replace(
            cfg, use_kernel=False))):
        def call(c=c):
            return engine.loglikelihood(program, c, model, *args)
        call()
        ms[label] = statistics.median(cuda_ms(call, 5))
    cfg64, program64, model64, *args64 = odd_case(
        tips, sites, states, device, torch.float64, use_kernel=False,
        rates=rates)
    ref = engine.loglikelihood(program64, cfg64, model64, *args64).item()
    del args64
    torch.cuda.empty_cache()
    gap = abs(logl - ref) / abs(ref)
    log(f"[generic] forward {name} {tips}x{sites} S={states} R={rates}: logL "
        f"kernel f32 {logl!r} dense f64 {ref!r} rel gap {gap:.3e} (bound "
        f"{LOGL_RTOL}); generic sweep launches {counts['tree_sweep_generic']}"
        f"; first call {cold:.3f} ms")
    log(f"[time] loglikelihood {name} {tips}x{sites} S={states}: kernel "
        f"{ms['kernel']:.4f} ms, dense f32 path {ms['dense_f32']:.4f} ms "
        f"(warm medians of 5 single calls) ({card})")
    check(np.isfinite(logl) and gap < LOGL_RTOL,
          f"{name}: rel gap {gap} >= {LOGL_RTOL}")
    return counts


def phase_generic_5(device, card):
    """Phase 26: 5 states at full width.  GTR-5 + Gamma4 f32 at
    ODD5_TIPS x ODD5_SITES: loglikelihood against dense f64,
    ODD_TRAIN_STEPS optimize_root_branch steps (the logL they reach
    against dense f64 at the same lengths), the generic sweep's times; one
    SPR round on search_inputs' shape (radius 5) with 5-state tips through
    the edge scorer, its scores held to the plain scorer's on every chunk
    and timed, then spr_round itself on the kernel.  Returns (launch
    counts of the path, the sweep's times, the scorer's results)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch.profiling import SEARCH_ALPHA

    t_phase = time.perf_counter()
    case = odd_case(ODD5_TIPS, ODD5_SITES, 5, device, torch.float32)
    counts = forward_vs_dense("odd5", case, ODD5_TIPS, ODD5_SITES, 5,
                              device, card)
    cfg, program, model, bl, *args = case
    reset_counts()
    trace = []
    for _ in range(ODD_TRAIN_STEPS):
        bl, logl = engine.optimize_root_branch(program, cfg, model, bl,
                                               *args)
        trace.append(logl.item())
    final = engine.loglikelihood(program, cfg, model, bl, *args).item()
    torch.cuda.synchronize()
    train = read_counts()
    cfg64, program64, model64, _bl64, *args64 = odd_case(
        ODD5_TIPS, ODD5_SITES, 5, device, torch.float64, use_kernel=False)
    final64 = engine.loglikelihood(program64, cfg64, model64, bl.double(),
                                   *args64).item()
    del args64
    torch.cuda.empty_cache()
    gap = abs(final - final64) / abs(final64)
    log(f"[generic] train odd5: {ODD_TRAIN_STEPS} optimize_root_branch "
        f"steps, logL before each {trace}; after the last f32 {final!r}, "
        f"dense f64 at the same lengths {final64!r} (rel gap {gap:.3e}); "
        f"generic sweep launches {train['tree_sweep_generic']}")
    check(train["tree_sweep_generic"] >= ODD_TRAIN_STEPS,
          "the training steps did not run on the generic sweep")
    check(np.isfinite(final) and gap < LOGL_RTOL,
          f"odd5 training: rel gap {gap} >= {LOGL_RTOL}")
    check(final >= trace[0] - LOGL_RTOL * abs(trace[0]),
          f"odd5 training: logL fell from {trace[0]} to {final}")
    times = generic_sweep_times("odd5", case, card)
    del case
    torch.cuda.empty_cache()

    truth, start, chars, scfg, smodel = odd_search_inputs(device, 5)
    prog = sf.compile_spr(start, scfg, radius=SEARCH_RADIUS)
    name = f"S=5 {scfg.tips}x{scfg.sites} radius {SEARCH_RADIUS}"
    edge = score_round_both(prog, smodel, chars, timed=True)
    log_scores("[generic] edge scorer", name, edge)
    check_scores(name, edge)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    new, logl, applied = sf.spr_round(prog, smodel, chars)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    spr = read_counts()
    subst, freqs = odd_model(5)
    logl64 = dense_f64_logl(new.tree, chars, scfg.sites, device,
                            subst=subst, freqs=freqs, alpha=SEARCH_ALPHA)
    start64 = dense_f64_logl(start, chars, scfg.sites, device, subst=subst,
                             freqs=freqs, alpha=SEARCH_ALPHA)
    gap = abs(logl - logl64) / abs(logl64)
    log(f"[generic] spr_round {name}: {applied} moves applied, logL "
        f"{start64!r} -> {logl!r} (dense f64 of the new tree {logl64!r}, rel "
        f"gap {gap:.3e}); edge scorer launches {spr['edge_score']}, of the "
        f"generic form {spr['edge_score_generic']}; tree sweep launches "
        f"{spr['tree_sweep']}; {round_s:.3f} s ({card})")
    log(f"[time] edge scorer generic over one full-width 5-state round "
        f"({edge['launches']} chunks): " + ", ".join(
            f"{f} form {edge[f + '_ms']:.4f} ms" for f in edge["forms"])
        + f" (medians of 3 launches back to back per chunk; the round runs "
        f"the {edge['form']} form), plain edge_scores_reference "
        f"{edge['plain_ms']:.4f} ms ({card})")
    check(spr["edge_score_generic"] > 0
          and spr["edge_score_generic"] == spr["edge_score"],
          "the 5-state round did not run on the generic edge scorer")
    check(applied > 0, "the 5-state round applied no move")
    check(np.isfinite(logl) and gap < LOGL_RTOL,
          f"odd5 round: rel gap {gap} >= {LOGL_RTOL}")
    log(f"[generic] phase 26 {time.perf_counter() - t_phase:.3f} s")
    path = {k: counts[k] + train[k] + spr[k]
            for k in ("tree_sweep_generic", "edge_score_generic")}
    return path, times, edge


def phase_generic_32(device, card):
    """Phase 27: 32 states at full width, ODD32_TIPS x ODD32_SITES f32:
    Mk-32 + Gamma4 and Mk-32 + Gamma(ODD32_WARPS_RATES) (a site's row
    groups over two warps, its rescue an AND across them), each
    loglikelihood against dense f64 and the generic sweep's times.
    Returns (launch counts, the times at four rates, at
    ODD32_WARPS_RATES)."""
    import torch

    from libpll2_tpu_torch.ops import partials_tree

    t_phase = time.perf_counter()
    found = {}
    for name, rates in (("odd32", 4), (f"odd32_r{ODD32_WARPS_RATES}",
                                       ODD32_WARPS_RATES)):
        case = odd_case(ODD32_TIPS, ODD32_SITES, 32, device, torch.float32,
                        rates=rates)
        check(partials_tree.generic_spans_warps(case[0]) == (rates > 8),
              f"{name}: the rescue spans warps "
              f"{partials_tree.generic_spans_warps(case[0])}")
        counts = forward_vs_dense(name, case, ODD32_TIPS, ODD32_SITES, 32,
                                  device, card, rates=rates)
        found[rates] = counts, generic_sweep_times(name, case, card)
        del case
        torch.cuda.empty_cache()
    log(f"[generic] phase 27 {time.perf_counter() - t_phase:.3f} s")
    (c4, times), (cw, warps_times) = found[4], found[ODD32_WARPS_RATES]
    return {"tree_sweep_generic": c4["tree_sweep_generic"]
            + cw["tree_sweep_generic"], "edge_score_generic": 0}, times, \
        warps_times


DEFAULT_TIPS, DEFAULT_SITES = 256, 16384   # phase 29's f64 cases
DEFAULT_MULTI_SITES = (8192, 4096)


def default_call(fn):
    """Run fn() under the default config's gate: (result, the UserWarning
    messages it raised, the launch counts of the call)."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, UserWarning)], counts


def phase_default_f64(device, card):
    """Phase 29: the default config on the card (f64, use_kernel None,
    which the tree-sweep kernel does not take): engine.loglikelihood,
    optimize_root_branch, the forward of loglikelihood_analytic,
    fit.loglikelihood_fn without a FullTreeProgram, and
    multipartition.loglikelihood on two partitions (one plain sweep of
    both) each run the plain path on the card: equal to the explicit call
    with use_kernel=False bit for bit, one UserWarning naming the reason,
    no tree-sweep launch."""
    import torch

    from libpll2_tpu_torch import engine, fit, multipartition
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.tree.generate import balanced_newick

    t_phase = time.perf_counter()
    newick = balanced_newick(DEFAULT_TIPS)
    case = engine.build_case(DEFAULT_TIPS, DEFAULT_SITES,
                             dtype=torch.float64, device=device,
                             newick=newick)
    cfg, program, model, bl, *site = case
    check(cfg.use_kernel is None and cfg.dtype == torch.float64,
          f"phase 29 wants the default config, got {cfg}")
    dense = dataclasses.replace(cfg, use_kernel=False)
    tree = T.parse_newick_string(newick)
    full = engine.compile_tree_full(tree, cfg)
    params = fit.pack([[1.0, 2.0, 1.0, 1.0, 2.0, 1.0]], [[0.25] * 4], bl,
                      dtype=torch.float64, device=device)
    rates = model.rates
    calls = {
        "loglikelihood": lambda c: engine.loglikelihood(
            program, c, model, bl, *site),
        "optimize_root_branch": lambda c: torch.cat(
            [x.reshape(-1) for x in engine.optimize_root_branch(
                program, c, model, bl, *site)]),
        "loglikelihood_analytic": lambda c: engine.loglikelihood_analytic(
            program, full, c, model, bl, *site),
        "fit.loglikelihood_fn": lambda c: fit.loglikelihood_fn(
            program, c, params, rates, *site)}
    # two DNA partitions on one topology, the default config each
    mcases = [engine.build_case(DEFAULT_TIPS, sites, dtype=torch.float64,
                                device=device, newick=newick, seed=k)
              for k, sites in enumerate(DEFAULT_MULTI_SITES)]
    mp = multipartition.compile_multipartition(tree, [c[0] for c in mcases])
    margs = ([c[2] for c in mcases], mcases[0][3], [c[4] for c in mcases],
             [c[5] for c in mcases], [c[6] for c in mcases])
    mp_dense = multipartition.compile_multipartition(
        tree, [dataclasses.replace(c[0], use_kernel=False) for c in mcases])
    calls["multipartition.loglikelihood"] = lambda c: \
        multipartition.loglikelihood(mp if c is cfg else mp_dense, *margs)
    for name, fn in calls.items():
        got, msgs, counts = default_call(lambda: fn(cfg))
        want, dense_msgs, _ = default_call(lambda: fn(dense))
        sweeps = counts["tree_sweep"] + counts["tree_sweep_mma"]
        same = torch.equal(got.detach(), want.detach())
        log(f"[default] {name} f64 {DEFAULT_TIPS}x{DEFAULT_SITES} "
            f"(use_kernel=None) on {device}: "
            f"{got.detach().reshape(-1)[-1].item()!r} "
            f"equal to the dense call {same}; tree-sweep launches {sweeps}; "
            f"warnings {len(msgs)} (dense call {len(dense_msgs)}): "
            f"{msgs[:1]}")
        check(same, f"{name}: the default f64 call differs from dense")
        check(sweeps == 0, f"{name}: the default f64 call launched {sweeps} "
                           f"tree sweeps")
        check(len(msgs) >= 1 and not dense_msgs,
              f"{name}: warnings {msgs}, dense {dense_msgs}")
        check(all("f32 or bf16" in m or "autograd" in m for m in msgs),
              f"{name}: a warning without the reason: {msgs}")
    log(f"[default] phase 29 {time.perf_counter() - t_phase:.3f} s ({card})")


BF16_ROW_BOUND = 2.0 ** -7   # bf16 kernel rows against plain, of each site's
#                              largest entry: two bf16 sweeps can differ by
#                              one rounding of a stored parent (2^-8)
BF16_FLIP_SITES = 4096       # "mma" at full width: at most one root-row site
BF16_SITE_MAX = 2.0 ** -5    # in this many beyond BF16_ROW_BOUND, none
#                              beyond BF16_SITE_MAX (bf16_mma_flips)
BF16_SLICE_RTOL = 1e-6       # bf16 kernel logL against the dense bf16 path
BF16_STATES = (2, 4, 5, 10, 16, 20, 32)
BF16_TRAIN_STEPS = 10
BF16_TIMED = ("dna_256", "dna_1024", "large_8192", "protein_128",
              "protein_lg4x", "protein_128_4k")


def bf16_mma_flips(errs):
    """(sites beyond BF16_ROW_BOUND, the most allowed) of site_errors'
    [E, NT, TB] of "mma" rows against plain at bf16: one in
    BF16_FLIP_SITES, at least one."""
    over = int((errs > BF16_ROW_BOUND).sum().item())
    return over, max(1, errs.numel() // BF16_FLIP_SITES)


def bf16_cases():
    """(name, engine.build_case keywords) of phase 28's forward cases:
    phase 14's four shapes, phase 11's LG4X case (64 x 2,048) and LG at
    128 x 4,096 (the 20-state choice at fewer sites), and phases 26-27's
    5- and 32-state cases."""
    s5, f5 = odd_model(5)
    s32, f32 = odd_model(32)
    return [
        ("dna_256", dict(n_tips=256, sites=65536)),
        ("dna_1024", dict(n_tips=1024, sites=16384)),
        ("large_8192", dict(n_tips=LARGE_TIPS, sites=LARGE_SITES,
                            newick=large_newick())),
        ("protein_128", dict(n_tips=PROTEIN_TIPS, sites=PROTEIN_SITES,
                             states=20)),
        ("protein_lg4x", dict(n_tips=64, sites=2048, states=20,
                              aa_model_name="lg4x")),
        ("protein_128_4k", dict(n_tips=PROTEIN_TIPS, sites=4096,
                                states=20)),
        ("odd5", dict(n_tips=ODD5_TIPS, sites=ODD5_SITES, states=5,
                      subst=s5, freqs=f5, seed=ODD_SEED)),
        ("odd32", dict(n_tips=ODD32_TIPS, sites=ODD32_SITES, states=32,
                       subst=s32, freqs=f32, seed=ODD_SEED))]


def phase_bf16_vs_plain(device):
    """Phase 28, first part: both sweep forms with a bf16 pool against the
    plain version at bf16 on a 64-taxon caterpillar x ODD_SITES with branch
    lengths x 30 under a random model: "fma" at every count of BF16_STATES
    with per-rate and per-site scalers, "mma" where it takes the case; each
    with the carry on and off (bit-equal); rows within BF16_ROW_BOUND of
    each site's largest entry where the scalers agree and, compensated,
    where a rescue flipped; the "mma" form's bf16 P fragments bit-equal to
    their plain version.  Returns the largest abs err where the scalers
    agree."""
    import torch

    from libpll2_tpu_torch.ops import partials_tree

    worst = 0.0
    for i, states in enumerate(BF16_STATES):
        for per_rate in (True, False):
            cfg, program, pmatrix, tip_b, tb = sweep_inputs(
                caterpillar(64), ODD_SITES, 300 + i, device, states=states,
                per_rate=per_rate, bl_scale=30.0, random_model=True,
                dtype=torch.bfloat16)
            prog = program.vmem_prog
            f32 = dataclasses.replace(cfg, dtype=torch.float32)
            want = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg,
                                                 tb)
            rescues = int(want[1].max().item())
            name = f"S{states}{'_per_rate' if per_rate else ''}"
            modes = [m for m in partials_tree.MODES
                     if partials_tree.unsupported(prog, cfg, mode=m) is None]
            for mode in modes:
                before = partials_tree.sweep.launches_bf16[mode]
                on = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb,
                                         mode=mode)
                off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb,
                                          mode=mode, carry=False)
                torch.cuda.synchronize()
                launched = partials_tree.sweep.launches_bf16[mode] - before
                rel, mism, comp, abs_err = compare_rows_site(
                    on[0], want[0], on[1], want[1])
                same = torch.equal(on[0], off[0]) \
                    and torch.equal(on[1], off[1])
                smem = partials_tree.smem_bytes(prog, cfg, tb, mode)
                smem32 = partials_tree.smem_bytes(prog, f32, tb, mode)
                log(f"[bf16] sweep {mode} {name}: ops={prog.n_ops} "
                    f"pool={prog.pool_size} tb={tb} sites={ODD_SITES} "
                    f"smem/cta={smem} (f32 pool {smem32}); bf16 launches "
                    f"{launched}; against plain: site-rel {rel:.3e} (bound "
                    f"{BF16_ROW_BOUND:.3e}) abs {abs_err:.3e} scaler "
                    f"mismatches {mism} compensated {comp:.3e}; max_scaler="
                    f"{rescues}; carry on and off bit-equal: {same}")
                check(launched == 2, f"{name} {mode}: {launched} bf16 "
                                     f"launches for 2 calls")
                check(same, f"{name} {mode}: rows differ between carry on "
                            f"and off")
                check(on[0].dtype == torch.float32,
                      f"{name} {mode}: exported rows are {on[0].dtype}")
                check(rel <= BF16_ROW_BOUND and comp <= BF16_ROW_BOUND,
                      f"{name} {mode}: rows off plain by {rel}, "
                      f"compensated {comp} > {BF16_ROW_BOUND}")
                worst = max(worst, abs_err)
            check(rescues > 0, f"{name}: the scale-heavy case did not rescue")
            if "mma" in modes:
                check(torch.equal(
                    partials_tree.pmatrix_fragments(pmatrix, cfg),
                    partials_tree.pmatrix_fragments_reference(pmatrix, cfg)),
                    f"{name}: bf16 P fragments differ from their plain "
                    f"version")
    return worst


def phase_bf16_path(device, card):
    """Phase 28, second part: the forward step at bf16 at full width on
    bf16_cases(), through `choose` and with the other form forced where it
    takes the case (so both bf16 forms run on the path), and at dna_256
    BF16_TRAIN_STEPS optimize_root_branch steps; every logL against the
    port's dense bf16 path on the card at the same inputs (within
    BF16_SLICE_RTOL: the same P-matrices and storage type, the kernel's
    share of the error) and beside the dense f64 path of the same case
    (the gap of bf16 storage and bf16 P-matrices together, printed).
    The generic form's times at bf16 at the 5- and 32-state cases
    (generic_sweep_times).  Returns (bf16 launches of the path, {name:
    case} of BF16_TIMED for the times, {name: generic_sweep_times dict}
    at 5 and 32 states)."""
    import torch

    from libpll2_tpu_torch import _build, engine
    from libpll2_tpu_torch.ops import partials_tree

    t_phase = time.perf_counter()
    limit = _build.max_shared_memory(device)
    totals = {"tree_sweep_bf16": 0, "tree_sweep_mma_bf16": 0}
    timed, generic_times = {}, {}
    for name, kw in bf16_cases():
        case = engine.build_case(**kw, dtype=torch.bfloat16, device=device)
        cfg, program, model, bl, *args = case
        prog = program.vmem_prog
        chosen = kernel_form(program, cfg, device)[1]
        modes = [chosen] + [m for m in partials_tree.MODES if m != chosen
                            and partials_tree.unsupported(prog, cfg, limit,
                                                          m) is None]
        configs = {m: cfg if m == chosen
                   else dataclasses.replace(cfg, sweep_mode=m) for m in modes}
        blocks = {m: kernel_form(program, c, device)[0]
                  for m, c in configs.items()}
        torch.cuda.synchronize()
        reset_counts()
        got = {}
        for mode, c in configs.items():
            t0 = time.perf_counter()
            logl = engine.loglikelihood(program, c, model, bl, *args).item()
            got[mode] = (logl, (time.perf_counter() - t0) * 1e3)
        trace, trained = [], bl
        if name == "dna_256":
            for _ in range(BF16_TRAIN_STEPS):
                trained, logl = engine.optimize_root_branch(
                    program, cfg, model, trained, *args)
                trace.append(logl.item())
            final = engine.loglikelihood(program, cfg, model, trained,
                                         *args).item()
        torch.cuda.synchronize()
        counts = read_counts()
        for k in totals:
            totals[k] += counts[k]
        runs = len(modes) + (BF16_TRAIN_STEPS + 1 if trace else 0)
        check(counts["tree_sweep_bf16"] + counts["tree_sweep_mma_bf16"]
              == counts["tree_sweep"] + counts["tree_sweep_mma"] == runs,
              f"{name}: the bf16 path ran {counts}, not {runs} bf16 sweeps")
        dense = dataclasses.replace(cfg, use_kernel=False)
        ref16 = dense_sliced(case, device, dtype=torch.bfloat16)
        case64 = engine.build_case(**kw, dtype=torch.float64, device=device,
                                   use_kernel=False)
        ref64 = dense_sliced(case64, device)
        for mode, (logl, first_ms) in got.items():
            gap16 = abs(logl - ref16) / abs(ref16)
            gap64 = abs(logl - ref64) / abs(ref64)
            log(f"[bf16] forward {name} {cfg.tips}x{cfg.sites} "
                f"S={cfg.states} mode {mode!r}"
                f"{' (choose)' if mode == chosen else ''}, site block "
                f"{blocks[mode]}: logL kernel bf16 {logl!r}, dense bf16 "
                f"{ref16!r} (rel gap {gap16:.3e}, bound {BF16_SLICE_RTOL}), "
                f"dense f64 {ref64!r} (rel gap {gap64:.3e}; dense bf16 to "
                f"f64 {abs(ref16 - ref64) / abs(ref64):.3e}); first call "
                f"{first_ms:.3f} ms ({card})")
            check(np.isfinite(logl) and gap16 <= BF16_SLICE_RTOL,
                  f"bf16 {name} {mode}: rel gap to dense bf16 {gap16} > "
                  f"{BF16_SLICE_RTOL}")
        if trace:
            final16 = engine.loglikelihood(program, dense, model, trained,
                                           *args).item()
            final64 = dense_sliced(case64[:3] + (trained.double(),)
                                   + case64[4:], device)
            gap16 = abs(final - final16) / abs(final16)
            gap64 = abs(final - final64) / abs(final64)
            log(f"[bf16] train {name}: {BF16_TRAIN_STEPS} "
                f"optimize_root_branch steps, logL before each {trace}; "
                f"after the last bf16 {final!r}, dense bf16 at the same "
                f"lengths {final16!r} (rel gap {gap16:.3e}), dense f64 "
                f"{final64!r} (rel gap {gap64:.3e})")
            check(np.isfinite(final) and gap16 <= BF16_SLICE_RTOL,
                  f"bf16 training: rel gap to dense bf16 {gap16}")
            check(final >= trace[0] - BF16_SLICE_RTOL * abs(trace[0]),
                  f"bf16 training: logL fell from {trace[0]} to {final}")
        del case64
        if name in BF16_TIMED:
            timed[name] = case
        elif partials_tree.generic(cfg):
            generic_times[name] = generic_sweep_times(f"{name}_bf16", case,
                                                      card)
        del case
        torch.cuda.empty_cache()
    log(f"[bf16] bf16 launches on the path {totals}; phase 28 forward "
        f"{time.perf_counter() - t_phase:.3f} s")
    return totals, timed, generic_times


MSG_TIPS, MSG_SITES = 256, 4096       # dna_smooth's message program
MSG_PROTEIN_TIPS, MSG_PROTEIN_SITES = 128, 16384
MSG_REPS = 50                          # kernel launches back to back


def message_inputs(newick, sites, seed, device, states=4, rates=4,
                   per_rate=False, bl_scale=1.0, dtype=None,
                   use_kernel=None):
    """(cfg, full, model, bl, tipchars, pmatrix) of one message sweep: the
    FullTreeProgram of `newick`, a model drawn from the seed (random
    exchangeabilities and frequencies, Gamma 0.8), random single-state
    tips, the program's lengths x bl_scale and their P-matrix buffer (as
    engine._sweep_all makes it)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.ops import pmatrix as pmatrix_ops
    from libpll2_tpu_torch.tree.generate import random_tipchars

    dtype = dtype or torch.float32
    tree = T.parse_newick_string(newick)
    n = tree.tip_count
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=states, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=rates,
        scale_buffers=tree.inner_count, per_rate_scalers=per_rate,
        dtype=dtype, use_kernel=use_kernel)
    full = engine.compile_tree_full(tree, cfg)
    rng = np.random.default_rng(seed)
    subst = rng.uniform(0.2, 3.0, states * (states - 1) // 2)
    freqs = rng.dirichlet(np.full(states, 5.0))
    model = engine.make_model([subst], [freqs],
                              compute_gamma_cats(0.8, rates), dtype=dtype,
                              device=device)
    tipchars = torch.as_tensor(engine.pad_tipchars(
        random_tipchars(n, sites, rng, states=states), cfg), device=device)
    bl = torch.as_tensor(full.default_branch_lengths * bl_scale,
                         dtype=dtype, device=device)
    pmats = pmatrix_ops.compute_pmatrices(
        bl, model.eigenvals, model.eigenvecs, model.inv_eigenvecs,
        model.rates, model.prop_invar, model.params_indices, dtype=dtype)
    pmatrix = torch.zeros((int(full.pmatrix_indices.max()) + 1,)
                          + pmats.shape[1:], dtype=dtype, device=device)
    pmatrix[torch.as_tensor(full.pmatrix_indices, dtype=torch.int64,
                            device=device)] = pmats
    return cfg, full, model, bl, tipchars, pmatrix


def compare_messages(got, want, got_s, want_s, cfg_ext):
    """Kernel vs plain message sweep: (max rel err of the message rows,
    scaling-compensated in f64 as compare_rows does, scaler mismatches,
    whether the tip rows and the reserved rows are equal)."""
    import torch
    t, n = cfg_ext.tips, cfg_ext.clv_buffers
    g, w = got[t:t + n].double(), want[t:t + n].double()
    gs, ws = got_s[:n].double(), want_s[:n].double()
    # scaler rows [n, T] or per-rate [n, R, T] -> per entry [n, R|1, 1, T]
    gs = gs[:, None, None] if gs.dim() == 2 else gs[:, :, None]
    ws = ws[:, None, None] if ws.dim() == 2 else ws[:, :, None]
    gc = g * torch.exp2(-SCALE_BITS * gs)
    wc = w * torch.exp2(-SCALE_BITS * ws)
    rel = ((gc - wc).abs() / wc.abs().clamp_min(1e-300)).max().item()
    mismatches = int((got_s[:n] != want_s[:n]).sum().item())
    reserved = (bool(torch.equal(got[:t], want[:t]))
                and bool((got[cfg_ext.clv_scratch] == 0).all())
                and bool((got_s[cfg_ext.scaler_zero:] == 0).all()))
    return rel, mismatches, reserved


def phase_message_sweep(device, card):
    """Phase 30: the message-sweep kernel (csrc/message_sweep.cu) against
    its plain version at dna_smooth's message program (256 taxa x 4,096
    sites, 4 states, 762 ops) and at LG's shape (128 taxa x 16,384, 20
    states): rows and scalers, one launch a sweep; its time back to back
    and in single calls beside the plain version's, the dense path's (the
    same sweep before the kernel) and the byte bounds (least: each input
    read and each output written once; traffic: with every op's reads of
    its children); then the main path, optimize_branch_lengths at the DNA
    shape, on the kernel and on the dense path, with the kernel's launches
    counted from 0 over the kernel call ([message] lines).
    Returns the kernels-line entry, its launches the main path's."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import message_sweep as ms
    from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

    row = {}
    cases = (("dna", random_newick(MSG_TIPS, np.random.default_rng(1)),
              MSG_SITES, 4),
             ("lg", balanced_newick(MSG_PROTEIN_TIPS), MSG_PROTEIN_SITES, 20))
    for name, newick, sites, states in cases:
        cfg, full, model, bl, tipchars, pmatrix = message_inputs(
            newick, sites, 5, device, states=states)
        cfg_ext = full.cfg_ext
        ops = full.level_ops_tensor(device)
        n_ops = int((ops[..., 0] != cfg_ext.clv_scratch).sum())

        def run():
            return ms.sweep_messages(ops, pmatrix, tipchars, cfg_ext)

        reset_counts()
        got, got_s = run()
        torch.cuda.synchronize()
        launches = read_counts()["message_sweep"]
        want, want_s = ms.sweep_messages_reference(ops, pmatrix, tipchars,
                                                   cfg_ext)
        rel, mismatches, reserved = compare_messages(got, want, got_s,
                                                     want_s, cfg_ext)
        del got, got_s, want, want_s
        torch.cuda.empty_cache()
        kernel_ms = cuda_ms_back_to_back(run, MSG_REPS)
        single = statistics.median(cuda_ms(run, 11))
        plain = statistics.median(cuda_ms(
            lambda: ms.sweep_messages_reference(ops, pmatrix, tipchars,
                                                cfg_ext), 3))
        dense_cfg = dataclasses.replace(cfg_ext, use_kernel=False)
        dense = statistics.median(cuda_ms(
            lambda: engine.message_sweep(dense_cfg, model, full.level_ops,
                                         pmatrix, tipchars), 3))
        nbytes, traffic = ms.sweep_bytes(full.level_ops, cfg_ext, sites)
        bound = nbytes / HBM_RATE * 1e3
        traffic_bound = traffic / HBM_RATE * 1e3
        tb, groups = ms.plan(cfg.rate_cats, states, sites, torch.cuda.
                             get_device_properties(device)
                             .multi_processor_count)
        log(f"[message] {name} {cfg.tips} x {sites}, {states} states, "
            f"{n_ops} ops in {ops.shape[0]} levels of {ops.shape[1]}: "
            f"{launches} launch; "
            f"rows rel err {rel:.3e} (compensated), scaler mismatches "
            f"{mismatches}, tip and reserved rows equal {reserved}; "
            f"{kernel_ms:.4f} ms back to back, single {single:.4f}, plain "
            f"{plain:.4f}, dense path {dense:.4f}; least-bytes bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s): "
            f"{bound / kernel_ms:.4f} of the roof; traffic bound "
            f"{traffic_bound:.4f} ms ({traffic / 1e6:.1f} MB): "
            f"{traffic_bound / kernel_ms:.4f}; site block {tb}, {groups} "
            f"groups ({card})")
        check(launches == 1, f"{name}: {launches} launches for one sweep")
        check(mismatches == 0 and reserved and rel < CLV_RTOL,
              f"{name}: message sweep off its plain version: rel {rel}, "
              f"{mismatches} scaler mismatches, reserved rows {reserved}")
        row[name] = {"ms": kernel_ms, "single_call_ms": single,
                     "plain_ms": plain, "dense_ms": dense, "bound_ms": bound,
                     "traffic_bound_ms": traffic_bound, "max_rel_err": rel}
        del ops, pmatrix, tipchars
        torch.cuda.empty_cache()

    # the smoothing call of dna_smooth's shape, kernel against dense
    cfg, full, model, bl, tipchars, _ = message_inputs(
        random_newick(MSG_TIPS, np.random.default_rng(1)), MSG_SITES, 5,
        device)
    pw = torch.ones(cfg.sites_padded, device=device)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=device)
    results = {}
    for label, c in (("kernel", cfg),
                     ("dense", dataclasses.replace(cfg, use_kernel=False))):
        engine.optimize_branch_lengths(full, c, model, bl, tipchars, pw, inv)
        torch.cuda.synchronize()
        k0 = engine.message_sweep.kernel_sweeps
        reset_counts()
        t0 = time.perf_counter()
        new_bl, logl = engine.optimize_branch_lengths(full, c, model, bl,
                                                      tipchars, pw, inv)
        logl = logl.item()
        results[label] = (time.perf_counter() - t0, new_bl, logl,
                          engine.message_sweep.kernel_sweeps - k0,
                          read_counts()["message_sweep"])
    (ks, kbl, klogl, ksweeps, klaunches), (ds, dbl, dlogl, dsweeps,
                                           dlaunches) = \
        results["kernel"], results["dense"]
    gap = abs(klogl - dlogl) / abs(dlogl)
    bl_gap = ((kbl - dbl).abs() / dbl.abs()).max().item()
    sweeps = 3 * full.n_colors + 1
    log(f"[message] optimize_branch_lengths {cfg.tips} x {cfg.sites}: "
        f"kernel {ks * 1e3:.2f} ms ({ksweeps} kernel sweeps, {klaunches} "
        f"launches), dense {ds * 1e3:.2f} ms ({dsweeps} kernel sweeps, "
        f"{dlaunches} launches); logL {klogl!r} vs {dlogl!r} (rel gap "
        f"{gap:.3e}), lengths max rel gap {bl_gap:.3e} ({card})")
    check(klaunches == ksweeps == sweeps and dlaunches == dsweeps == 0,
          f"smoothing on the kernel: {klaunches} launches and {ksweeps} "
          f"kernel sweeps for {sweeps} sweeps; on the dense path "
          f"{dlaunches} and {dsweeps}")
    check(gap < LOGL_RTOL, f"smoothing logL kernel vs dense: {gap}")
    dna = row["dna"]
    return {
        "name": "message_sweep", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/message_sweep.cu",
        "replaces": "none (the JAX package's message sweep is XLA)",
        "launches": klaunches,
        "max_abs_err": max(r["max_rel_err"] for r in row.values()),
        "ms": dna["ms"], "single_call_ms": dna["single_call_ms"],
        "plain_ms": dna["plain_ms"], "dense_ms": dna["dense_ms"],
        "bound_ms": dna["bound_ms"], "bound_by": "bytes",
        "traffic_bound_ms": dna["traffic_bound_ms"],
        "library_ms": None,
        "shape": f"{MSG_TIPS} x {MSG_SITES} DNA, all directed messages",
        **{f"{k}_lg_{MSG_PROTEIN_TIPS}x{MSG_PROTEIN_SITES}": row["lg"][k]
           for k in ("ms", "plain_ms", "dense_ms", "bound_ms",
                     "traffic_bound_ms")},
    }


NEWTON_REPS = 50                       # Newton launches back to back


def newton_bytes(n_edges: int, rates: int, states: int, sites: int) -> int:
    """The least device-memory bytes of one Newton launch: each edge's two
    message rows read once (the constants, weights and lengths are a few
    KB)."""
    return n_edges * 2 * rates * states * sites * 4


def phase_newton_edges(device, card):
    """Phase 31: the Newton kernel (csrc/newton_edges.cu) on the largest
    colour class of dna_smooth's program (256 taxa x 4,096 sites, 4
    states, 4 rates) from one message sweep: its lengths against the plain
    version summing in the cluster's stripes (and the keep decisions), its
    time back to back and in single calls (CUDA events) beside the plain
    version's, the all-edge body's plain path's (what a class cost before
    the kernel) and the bytes roof; then the main path,
    optimize_branch_lengths at that shape on the kernels (a Newton launch
    a class) against the plain paths, its Newton launches counted from 0
    ([newton] lines).  Returns the kernels-line entry."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import edge_score
    from libpll2_tpu_torch.ops import message_sweep as ms
    from libpll2_tpu_torch.ops import newton_edges as ne
    from libpll2_tpu_torch.tree.generate import random_newick

    kw = dict(newton_iters=10, min_branch=1e-8, max_branch=100.0)
    newick = random_newick(MSG_TIPS, np.random.default_rng(1))
    cfg, full, model, bl, tipchars, pmatrix = message_inputs(
        newick, MSG_SITES, 5, device)
    clv, scalers = ms.sweep_messages(full.level_ops_tensor(device), pmatrix,
                                     tipchars, full.cfg_ext)
    rows = full.edge_rows_tensor(device)
    members = max(full.color_members(device), key=len)
    consts = edge_score.model_constants(model, cfg)
    pw = torch.ones(cfg.sites_padded, device=device)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=device)
    R, S, T = cfg.rate_cats, cfg.states, cfg.sites_padded
    cluster = ne.plan(R, S, T, edge_score.smem_limit_of(device))
    reset_counts()
    got = ne.newton_edges(clv, rows, members, bl.clone(), *consts, pw, **kw)
    torch.cuda.synchronize()
    launches = read_counts()["newton_edges"]
    want = ne.newton_edges_reference(clv, rows, members, bl.clone(), *consts,
                                     pw, stripes=cluster, **kw)
    start = bl[members]
    same_keep = bool(torch.equal(got[members] == start,
                                 want[members] == start))
    rel = ((got[members] - want[members]).abs()
           / want[members].abs()).max().item()
    work = bl.clone()

    def run():
        return ne.newton_edges(clv, rows, members, work, *consts, pw, **kw)

    kernel_ms = cuda_ms_back_to_back(run, NEWTON_REPS)
    single = statistics.median(cuda_ms(run, 11))
    plain = statistics.median(cuda_ms(
        lambda: ne.newton_edges_reference(clv, rows, members, bl.clone(),
                                          *consts, pw, **kw), 3))
    parts = engine._parts((full,), (cfg,), (model,), (tipchars,), (pw,),
                          (inv,), None)
    sweeps = [(clv, scalers, pmatrix)]
    path = statistics.median(cuda_ms(
        lambda: engine._newton_plain(parts, sweeps, rows, members, bl, 10,
                                     1e-8, 100.0), 3))
    nbytes = newton_bytes(len(members), R, S, T)
    bound = nbytes / HBM_RATE * 1e3
    log(f"[newton] class of {len(members)} edges, {MSG_TIPS} x {MSG_SITES} "
        f"DNA, clusters of {cluster} ({ne.smem_bytes(R, S, T, cluster)} "
        f"bytes a CTA): {launches} launch; lengths max rel gap {rel:.3e} "
        f"against the plain version in {cluster} stripes, keep decisions "
        f"equal {same_keep}; {kernel_ms:.4f} ms back to back, single "
        f"{single:.4f}, plain version {plain:.4f}, the body's plain path "
        f"{path:.4f}; bytes bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"3.35 TB/s): {bound / kernel_ms:.4f} of the roof ({card})")
    check(launches == 1, f"{launches} Newton launches for one class")
    check(same_keep and rel < 1e-4,
          f"Newton kernel off its plain version: rel {rel}, keep decisions "
          f"equal {same_keep}")
    del clv, scalers, pmatrix, sweeps, work
    torch.cuda.empty_cache()

    # the smoothing call of dna_smooth's shape, kernels against plain paths
    results = {}
    for label, c in (("kernel", cfg),
                     ("plain", dataclasses.replace(cfg, use_kernel=False))):
        engine.optimize_branch_lengths(full, c, model, bl, tipchars, pw, inv)
        torch.cuda.synchronize()
        k0 = engine.newton_choice.kernel_classes
        reset_counts()
        t0 = time.perf_counter()
        new_bl, logl = engine.optimize_branch_lengths(full, c, model, bl,
                                                      tipchars, pw, inv)
        logl = logl.item()
        results[label] = (time.perf_counter() - t0, new_bl, logl,
                          engine.newton_choice.kernel_classes - k0,
                          read_counts()["newton_edges"])
    (ks, kbl, klogl, kclasses, klaunches), (ps, pbl, plogl, pclasses,
                                            plaunches) = \
        results["kernel"], results["plain"]
    gap = abs(klogl - plogl) / abs(plogl)
    bl_gap = ((kbl - pbl).abs() / pbl.abs()).max().item()
    classes = 3 * full.n_colors
    log(f"[newton] optimize_branch_lengths {cfg.tips} x {cfg.sites}: "
        f"kernels {ks * 1e3:.2f} ms ({kclasses} kernel classes, {klaunches} "
        f"Newton launches), plain paths {ps * 1e3:.2f} ms ({pclasses}, "
        f"{plaunches}); logL {klogl!r} vs {plogl!r} (rel gap {gap:.3e}), "
        f"lengths max rel gap {bl_gap:.3e} ({card})")
    check(klaunches == kclasses == classes and plaunches == pclasses == 0,
          f"smoothing on the Newton kernel: {klaunches} launches and "
          f"{kclasses} kernel classes for {classes} classes; on the plain "
          f"path {plaunches} and {pclasses}")
    check(gap < LOGL_RTOL, f"smoothing logL kernels vs plain: {gap}")
    return {
        "name": "newton_edges", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/newton_edges.cu",
        "replaces": "none (the JAX package's Newton path is XLA)",
        "launches": klaunches, "max_abs_err": rel, "ms": kernel_ms,
        "single_call_ms": single, "plain_ms": plain, "plain_path_ms": path,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "shape": f"{len(members)} edges of {MSG_TIPS} x {MSG_SITES} DNA, "
                 f"10 Newton steps",
    }


WIDE_TIPS, WIDE_SITES = 128, 16384     # phase 32: codon_eval's shape
WIDE_KAPPA, WIDE_OMEGA = 2.5, 0.2
WIDE_F3X4 = ((0.26, 0.22, 0.33, 0.19), (0.31, 0.23, 0.17, 0.29),
             (0.18, 0.32, 0.30, 0.20))
WIDE_REPS = 20
WIDE_RTOL = 1e-5         # wide kernel vs plain rows, of a site's largest


def wide_work(tips, sites, states, rates):
    """(FLOP, bytes) of one sweep at the shape: each of the tips - 2 ops S
    products a (site, rate), each of tips - 4 inner children a dense S x S
    product (a tip child's message is a column of P, no product); the
    int64 tips, every branch's P (f32) and the two root rows read or
    written once (pllbench's wide_sweep_roofline.codon counts the same)."""
    flop = sites * rates * ((tips - 2) * states
                            + (tips - 4) * 2 * states * states)
    nbytes = 8 * tips * sites + 4 * ((2 * tips - 3) * rates * states ** 2
                                     + 2 * rates * states * sites)
    return flop, nbytes


def phase_wide_sweep(device, card):
    """Phase 32: the wide sweep at codon_eval's shape (module docstring).
    Returns the kernels-line entry."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.models import codon
    from libpll2_tpu_torch.ops import partials_tree
    from libpll2_tpu_torch.tree.generate import random_newick

    t_phase = time.perf_counter()
    subst = codon.gy94_exchangeabilities(WIDE_KAPPA, WIDE_OMEGA)
    freqs = codon.f3x4_frequencies(WIDE_F3X4)
    newick = random_newick(WIDE_TIPS, np.random.default_rng(61),
                           min_bl=0.02, max_bl=0.35)
    case = engine.build_case(WIDE_TIPS, WIDE_SITES, dtype=torch.float32,
                             device=device, seed=61, states=61,
                             newick=newick, subst=subst, freqs=freqs)
    cfg, program, model, bl, tipchars, pw, inv = case
    prog = program.vmem_prog
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        choice = engine.kernel_choice(program, cfg, device)
    check(choice is not None and choice[1] == partials_tree.WIDE,
          f"kernel_choice at 61 states: {choice}")
    tb = choice[0]
    n_slots = partials_tree.wide_device_table(prog)[1]
    pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
    tip_b = engine.block_tips(tipchars, cfg, tb)
    reset_counts()
    clv, scal = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb,
                                    mode=partials_tree.WIDE)
    torch.cuda.synchronize()
    launches = read_counts()["tree_sweep_wide"]
    want_clv, want_scal = partials_tree.sweep_reference(tip_b, pmatrix, prog,
                                                        cfg, tb)
    rel, flips, comp, err = compare_rows_site(clv, want_clv, scal,
                                              want_scal)
    rel = max(rel, comp)
    log(f"[wide] {WIDE_TIPS} x {WIDE_SITES} codons, 61 states, 4 rates: "
        f"block {tb}, pool {n_slots} slots (schedule {prog.pool_size}), "
        f"{partials_tree.smem_bytes(prog, cfg, tb, partials_tree.WIDE)} "
        f"bytes a CTA, {cfg.sites_padded // tb} CTAs; rows against plain: "
        f"max abs err {err:.3e}, scaler mismatches {flips}, max err of a "
        f"site's largest entry {rel:.3e}; scaled site rows "
        f"{int((want_scal > 0).sum())}")
    check(launches == 1 and rel < WIDE_RTOL and flips <= 4,
          f"wide kernel off its plain version: rel {rel}, {flips} scaler "
          f"mismatches, {launches} launches")
    del want_clv, want_scal

    def kernel():
        return partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb,
                                   mode=partials_tree.WIDE)

    dense_cfg = dataclasses.replace(cfg, use_kernel=False)

    def dense():
        return engine._tree_rows(program, dense_cfg, pmatrix, tipchars, None)

    def plain():
        return partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)

    kernel_ms = cuda_ms_back_to_back(kernel, WIDE_REPS)
    single = statistics.median(cuda_ms(kernel, 11))
    dense_ms = cuda_ms_back_to_back(dense, 3)
    dense_single = statistics.median(cuda_ms(dense, 3))
    plain_ms = statistics.median(cuda_ms(plain, 3))
    torch.cuda.empty_cache()
    flop, nbytes = wide_work(WIDE_TIPS, WIDE_SITES, 61, 4)
    ops_s, bytes_s = flop / TF32_RATE, nbytes / HBM_RATE
    bound = max(ops_s, bytes_s) * 1e3
    log(f"[wide] sweep {kernel_ms:.4f} ms back to back, single "
        f"{single:.4f}; dense path {dense_ms:.4f} back to back, single "
        f"{dense_single:.4f} (x{dense_ms / kernel_ms:.2f} the kernel's); "
        f"plain version {plain_ms:.4f}; bound {bound:.4f} ms by operations "
        f"at TF32 ({flop / 1e9:.2f} GFLOP; f32 FMA roof "
        f"{flop / F32_RATE * 1e3:.4f} ms, bytes {bytes_s * 1e3:.4f} ms for "
        f"{nbytes / 1e6:.1f} MB): {100 * bound / kernel_ms:.3f} % of the "
        f"roof, {flop / kernel_ms / 1e9:.2f} TFLOP/s ({card})")
    check(kernel_ms < dense_ms, f"the wide kernel ({kernel_ms} ms) is not "
                                f"faster than the dense path ({dense_ms})")

    # the main path: loglikelihood through the kernel against dense f64
    f64 = dataclasses.replace(cfg, dtype=torch.float64, use_kernel=False)
    model64 = engine.make_model([subst], [freqs], model.rates.double().cpu()
                                .numpy(), dtype=torch.float64,
                                device=device)
    want = engine.loglikelihood(program, f64, model64, bl.double(),
                                tipchars, pw.double(), inv).item()
    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [engine.loglikelihood(program, cfg, model, bl, tipchars, pw,
                                    inv).item() for _ in range(3)]
    counts = read_counts()
    gap = max(abs(g - want) / abs(want) for g in got)
    log(f"[wide] loglikelihood {got[0]!r} (3 calls: eager, capture, replay;"
        f" {counts['tree_sweep_wide']} wide launches) against dense f64 "
        f"{want!r}: rel gap {gap:.3e}; phase "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    check(gap < LOGL_RTOL and counts["tree_sweep_wide"] == 3,
          f"the codon forward: gap {gap}, launches {counts}")
    return {
        "name": "tree_sweep_wide", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep_wide.cu",
        "replaces": "none (the JAX package has no path above 32 states)",
        "launches": counts["tree_sweep_wide"],
        "max_abs_err": err, "ms": kernel_ms, "single_call_ms": single,
        "plain_ms": plain_ms, "dense_ms": dense_ms,
        "dense_single_call_ms": dense_single, "bound_ms": bound,
        "bound_by": "operations", "library_ms": None,
        "shape": f"{WIDE_TIPS} x {WIDE_SITES} codons, 61 states, 4 rates",
    }


def main() -> int:
    import torch
    card = phase_device()
    device = torch.device("cuda", 0)
    smem_a_lib = phase_build()
    phase_kernel_vs_plain(device)
    cases, cold_ms, main_counts = phase_main_path(device, card)
    full_case = cases[(256, 65536)]
    launches = {"tree_sweep": 0, "tree_sweep_mma": 0, "edge_score": 0,
                "mma_probe": 0, "tree_sweep_generic": 0,
                "edge_score_generic": 0}

    def add(counts):
        for k in ("tree_sweep", "tree_sweep_mma", "edge_score"):
            launches[k] += counts[k]
    add(main_counts)
    phase_times(full_case, cold_ms, card)
    add(phase_training(full_case, card))

    phase_mma_vs_plain(device)
    large_case, counts = phase_large_tree(device, card)
    protein_case, counts_p = phase_protein(device, card)
    for k in ("tree_sweep", "tree_sweep_mma"):
        launches[k] += counts[k] + counts_p[k]
    times = phase_sweep_times({
        "dna_256": full_case, "dna_1024": cases[(1024, 16384)],
        "large_8192": large_case, "protein_128": protein_case}, card)
    del cases, large_case, protein_case
    torch.cuda.empty_cache()
    add(phase_fit(full_case, device, card))
    del full_case
    torch.cuda.empty_cache()
    add(phase_multi_linked(device, card))
    torch.cuda.empty_cache()
    phase_all_edge(device, card)

    edge = phase_edge_scorer(device, card)
    launches["edge_score"] += phase_search(device, card)
    add(phase_multi_search(device, card))
    add(phase_infer(device, card))
    probe = phase_probe(card)
    launches["mma_probe"] = probe["launches"]
    cache_probe = phase_cache_probe(device, card)
    construct_probe = phase_construct_probe(device, card, smem_a_lib)
    torch.cuda.empty_cache()
    add(phase_partition(device, card))
    torch.cuda.empty_cache()
    add(phase_sharded(device, card))
    add(phase_examples(device, card))
    phase_profiling(device, card)
    torch.cuda.empty_cache()
    generic_err = phase_generic_vs_plain(device)
    odd5, odd5_times, odd5_edge = phase_generic_5(device, card)
    odd32, odd32_times, warps_times = phase_generic_32(device, card)
    for k in ("tree_sweep_generic", "edge_score_generic"):
        launches[k] = odd5[k] + odd32[k]
    bf16_err = phase_bf16_vs_plain(device)
    bf16_launches, bf16_timed, bf16_generic = phase_bf16_path(device, card)
    times16 = phase_sweep_times(bf16_timed, card, f32_times=times)
    del bf16_timed
    torch.cuda.empty_cache()
    phase_default_f64(device, card)
    message = phase_message_sweep(device, card)
    torch.cuda.empty_cache()
    newton = phase_newton_edges(device, card)
    torch.cuda.empty_cache()
    wide = phase_wide_sweep(device, card)
    torch.cuda.empty_cache()

    ppt = "libpll2_tpu/ops/partials_pallas_tree.py"
    fma_ms, fma_plain, fma_b, fma_err, fma_single = times[("dna_256", "fma")]
    mma_ms, mma_plain, mma_b, mma_err, mma_single = times[("large_8192",
                                                           "mma")]
    fma16 = times16[("dna_256", "fma")]
    mma16 = times16[("large_8192", "mma")]
    edge_bytes_s = edge["bytes"] / HBM_RATE
    edge_ops_s = edge["flops"] / F32_RATE
    kernels = [{
        "name": "tree_sweep", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep.cu",
        "replaces": f"{ppt}:808 (_tree_kernel_static); :1136 "
                    f"(_tree_kernel_static_seg); :410 (_tree_kernel, vpu)",
        "launches": launches["tree_sweep"], "max_abs_err": fma_err,
        "ms": fma_ms, "single_call_ms": fma_single, "plain_ms": fma_plain,
        "bound_ms": fma_b[0], "bound_by": fma_b[1], "smem_ms": fma_b[4],
        "library_ms": None,
        "shape": "256 x 65536 DNA",
    }, {
        "name": "tree_sweep_mma", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep_mma.cu",
        "replaces": f"{ppt}:547 (_tree_kernel_splitk); :410 (_tree_kernel, "
                    f"mxu)",
        "launches": launches["tree_sweep_mma"], "max_abs_err": mma_err,
        "ms": mma_ms, "single_call_ms": mma_single, "plain_ms": mma_plain,
        "bound_ms": mma_b[0], "bound_by": mma_b[1], "smem_ms": mma_b[4],
        "library_ms": None,
        "shape": "8192 x 8192 DNA",
    }, {
        "name": "edge_score", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/edge_score.cu",
        "replaces": "libpll2_tpu/ops/edge_score_pallas.py:54 (_kernel)",
        "launches": launches["edge_score"],
        "max_abs_err": edge["max_abs_err"], "ms": edge["kernel_ms"],
        "plain_ms": edge["plain_ms"],
        "bound_ms": max(edge_bytes_s, edge_ops_s) * 1e3,
        "bound_by": "bytes" if edge_bytes_s >= edge_ops_s else "operations",
        "library_ms": None,
        "shape": "one 256 x 4096 round, radius 5",
    }, {
        "name": "tree_sweep_generic", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep_generic.cu",
        "replaces": f"{ppt}:808 (_tree_kernel_static); :1136 "
                    f"(_tree_kernel_static_seg); :410 (_tree_kernel, vpu), "
                    f"at the state counts without an instantiation",
        "launches": launches["tree_sweep_generic"],
        "max_abs_err": max(generic_err, odd5_times["max_abs_err"],
                           odd32_times["max_abs_err"],
                           warps_times["max_abs_err"]),
        **{k: odd5_times[k] for k in ("ms", "single_call_ms", "plain_ms",
                                      "bound_ms", "bound_by", "smem_ms")},
        "library_ms": None,
        "shape": "256 x 65536, 5 states",
        "ms_32_states": odd32_times["ms"],
        "plain_ms_32_states": odd32_times["plain_ms"],
        "bound_ms_32_states": odd32_times["bound_ms"],
        **{f"{k}_32_states_{ODD32_WARPS_RATES}_rates": warps_times[k]
           for k in ("ms", "plain_ms", "bound_ms")},
    }, {
        "name": "edge_score_generic", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/edge_score.cu",
        "replaces": "libpll2_tpu/ops/edge_score_pallas.py:54 (_kernel), at "
                    "the state counts without an instantiation",
        "launches": launches["edge_score_generic"],
        "max_abs_err": odd5_edge["max_abs_err"],
        "ms": odd5_edge["kernel_ms"], "plain_ms": odd5_edge["plain_ms"],
        "bound_ms": max(odd5_edge["bytes"] / HBM_RATE,
                        odd5_edge["flops"] / F32_RATE) * 1e3,
        "bound_by": "bytes" if odd5_edge["bytes"] / HBM_RATE
        >= odd5_edge["flops"] / F32_RATE else "operations",
        "library_ms": None,
        "shape": "one 256 x 4096 round, radius 5, 5 states",
    }, {
        "name": "tree_sweep_bf16", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep.cu",
        "replaces": f"{ppt}:808 (_tree_kernel_static); :1136 "
                    f"(_tree_kernel_static_seg), at bf16 (parts=1)",
        "launches": bf16_launches["tree_sweep_bf16"],
        "max_abs_err": max(bf16_err, fma16[3]),
        "ms": fma16[0], "single_call_ms": fma16[4], "plain_ms": fma16[1],
        "bound_ms": fma16[2][0], "bound_by": fma16[2][1],
        "smem_ms": fma16[2][4], "library_ms": None,
        "shape": "256 x 65536 DNA, bf16 pool",
        **{f"{k}_generic_{s}_states": bf16_generic[name][k]
           for name, s in (("odd5", 5), ("odd32", 32))
           for k in ("ms", "single_call_ms", "plain_ms", "bound_ms")},
    }, {
        "name": "tree_sweep_mma_bf16", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep_mma.cu",
        "replaces": f"{ppt}:547 (_tree_kernel_splitk, parts=1)",
        "launches": bf16_launches["tree_sweep_mma_bf16"],
        "max_abs_err": max(bf16_err, mma16[3]),
        "ms": mma16[0], "single_call_ms": mma16[4], "plain_ms": mma16[1],
        "bound_ms": mma16[2][0], "bound_by": mma16[2][1],
        "smem_ms": mma16[2][4], "library_ms": None,
        "shape": "8192 x 8192 DNA, bf16 pool",
    }, {
        "name": "mma_probe", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/mma_probe.cu",
        "replaces": "tools/mxu_probe.py:36 (kernel)",
        "launches": probe["launches"], "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None, "launches_by_form": probe["launches_by_form"],
        "shape": "21 variant x unit rows at TB 128 (pack4 f32 and TF32 at "
                 "TB 64), 65536 sites, summed",
    }, {
        "name": "cache_probe", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/cache_probe.cu",
        "replaces": "tools/cacheprobe.py:43 (kern)",
        **cache_probe, "shape": "[256, 256] f32",
    }, {
        "name": "construct_probe", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/construct_probe.cu",
        "replaces": "tools/static2probe.py:41 (kernel)",
        **construct_probe,
        "shape": "k0-k3, 128 ops, 65536 sites, summed",
    }, message, newton, wide]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on its "
                                 f"main path")
        log(f"[bound] {k['name']} ({k['shape']}): {k['ms']:.4f} ms against "
            f"a bound of {k['bound_ms']:.4f} ms by {k['bound_by']}: "
            f"{k['bound_ms'] / k['ms']:.4f} of the roof; plain "
            f"{k['plain_ms']:.4f} ms; " + (
                "no single PyTorch call computes it"
                if k["library_ms"] is None else
                f"one PyTorch expression {k['library_ms']:.4f} ms")
            + f" ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
