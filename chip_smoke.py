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
  5. times of the kernel path and the dense f32 path, CUDA events;
  6. the training step (engine.optimize_root_branch) at 256 x 65,536
     through the tree-sweep kernel, against the dense f64 path;
  7. the edge-scorer kernel against its plain version on every ball group
     of one full-width search round (256 taxa x 4096 sites, radius 5) and
     on a 20-state case, with CUDA-event times of both;
  8. the SPR search (search_fast.hill_climb) on the JAX bench's
     search_round inputs through the edge scorer: logL trace, round and
     phase times, RF distance and delta logL against the truth tree, final
     logL against the dense f64 path.

Prints a {"kernels": [...]} JSON line, then the result line
{"ok": true, "device": {...}} last.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
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
    from libpll2_tpu_torch import _build
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    log(f"[build] {info.path.name} from {[str(s.name) for s in _build.SOURCES]}"
        f" flags {' '.join(_build.NVCC_FLAGS)}: nvcc {info.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def sweep_inputs(newick, sites, seed, device, states=4, per_rate=False,
                 bl_scale=1.0, random_model=False):
    """(cfg, program, pmatrix, tip_blocked, tb) for one sweep case."""
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
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
        scale_buffers=tree.inner_count, per_rate_scalers=per_rate,
        dtype=torch.float32, use_kernel=True)
    program = engine.compile_tree(tree, cfg)
    rng = np.random.default_rng(seed)
    if random_model:
        subst = rng.uniform(0.2, 3.0, states * (states - 1) // 2)
        freqs = rng.dirichlet(np.full(states, 5.0))
    else:
        subst, freqs = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0], [0.3, 0.25, 0.2, 0.25]
    model = engine.make_model([subst], [freqs], compute_gamma_cats(0.8, 4),
                              dtype=torch.float32, device=device)
    tipchars = torch.as_tensor(engine.pad_tipchars(
        random_tipchars(n, sites, rng, states=states), cfg), device=device)
    bl = torch.as_tensor(program.default_branch_lengths * bl_scale,
                         dtype=torch.float32, device=device)
    pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
    tb = engine.kernel_site_block(program, cfg, tipchars.device)
    return cfg, program, pmatrix, engine.block_tips(tipchars, cfg, tb), tb


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


def phase_kernel_vs_plain(device):
    import torch

    from libpll2_tpu_torch.ops import partials_tree
    from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

    def caterpillar(n):
        s = "(t0:0.1,t1:0.2)"
        for i in range(2, n - 2):
            s = f"({s}:0.05,t{i}:0.1)"
        return f"({s}:0.05,t{n - 2}:0.1,t{n - 1}:0.1);"

    rng = np.random.default_rng(2024)
    cases = [
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
    full = None
    for i, (name, newick, sites, kw) in enumerate(cases):
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
        if name == "balanced256_full":
            full = (cfg, program, pmatrix, tip_b, tb, abs_err)
    return full


def phase_main_path(device, card):
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    shapes = ((256, 65536), (1024, 16384))
    cases = {s: engine.build_case(*s, dtype=torch.float32, device=device)
             for s in shapes}
    torch.cuda.synchronize()

    partials_tree.sweep.launches = 0
    logls = {}
    for s in shapes:
        t0 = time.perf_counter()
        (cfg, program, model, *args) = cases[s]
        logls[s] = engine.loglikelihood(program, cfg, model, *args)
        torch.cuda.synchronize()
        logls[s] = (logls[s].item(), (time.perf_counter() - t0) * 1e3)
    launches = partials_tree.sweep.launches
    log(f"[main] tree_sweep launches during the main path: {launches}")
    check(launches >= len(shapes), "the main path did not launch the kernel")

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
    return cases[shapes[0]], logls[shapes[0]][1], launches


def phase_times(full_case, cold_ms, sweep_full, card):
    import dataclasses

    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    cfg, program, model, *args = full_case
    updates = (cfg.tips - 2) * cfg.sites
    rows = {}
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
        rows[label] = med
        log(f"[time] loglikelihood {label} {cfg.tips}x{cfg.sites}: warm "
            f"median {med:.4f} ms over 25 calls, first call (cold) "
            f"{first:.3f} ms, {updates / (med * 1e-3):.4e} site-updates/s "
            f"({card})")

    scfg, sprog, pmatrix, tip_b, tb, abs_err = sweep_full
    prog = sprog.vmem_prog
    k_ms = statistics.median(cuda_ms(
        lambda: partials_tree.sweep(tip_b, pmatrix, prog, scfg, tb), 25))
    p_ms = statistics.median(cuda_ms(
        lambda: partials_tree.sweep_reference(tip_b, pmatrix, prog, scfg,
                                              tb), 5))
    log(f"[time] tree sweep alone {scfg.tips}x{scfg.sites} tb={tb}: kernel "
        f"{k_ms:.4f} ms ({updates / (k_ms * 1e-3):.4e} site-updates/s), "
        f"plain sweep_reference {p_ms:.4f} ms ({card})")
    return k_ms, p_ms, abs_err


def phase_training(full_case, card):
    """engine.optimize_root_branch (one training step) at the forward
    path's full width through the tree-sweep kernel, against the dense f64
    path on the same card."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import partials_tree

    cfg, program, model, *args = full_case
    partials_tree.sweep.launches = 0
    new_bl, logl = engine.optimize_root_branch(program, cfg, model, *args)
    torch.cuda.synchronize()
    launches = partials_tree.sweep.launches
    log(f"[train] tree_sweep launches during optimize_root_branch: "
        f"{launches}")
    check(launches >= 1, "the training step did not launch the kernel")

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
    return launches


def search_inputs(device, tips=SEARCH_TIPS, sites=SEARCH_SITES,
                  seed=SEARCH_SEED):
    """The JAX bench's search_round case (bench.py measure_search_round):
    random truth tree, GTR+Gamma(0.9) alignment simulated down it, a
    random start tree over the same labels; f32.  Returns (truth, start,
    chars, cfg, model)."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch import tree as T
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    from libpll2_tpu_torch.tree.generate import (random_newick,
                                                 simulate_alignment)

    rng = np.random.default_rng(seed)
    rates = compute_gamma_cats(0.9, 4)
    subst = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
    freqs = [0.28, 0.24, 0.22, 0.26]
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
        tips=tips, clv_buffers=start.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=torch.float32)
    model = engine.make_model([subst], [freqs], rates, dtype=torch.float32,
                              device=device)
    return truth, start, chars, cfg, model


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


def score_round_both(prog, model, chars, timed: bool):
    """Every ball group of one round through the edge scorer kernel and
    its plain version, chunk by chunk on the same recursion scratch.
    Returns a dict of the worst agreement and, if timed, the summed CUDA
    event times of both over the round."""
    import torch

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
    out = dict(same_inf=True, finite=0, slots=0, max_abs_err=0.0,
               max_rel_err=0.0, t3_excess=-1.0, t3_rel=0.0, kernel_ms=0.0,
               plain_ms=0.0, launches=0)
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
            if timed and out["launches"] == 0:          # warm both up
                edge_score.edge_scores(*args, **kw)
                edge_score.edge_scores_reference(*args, **kw)
            runs = {}
            for name, fn in (("kernel", edge_score.edge_scores),
                             ("plain", edge_score.edge_scores_reference)):
                res = {}
                ms = cuda_ms(lambda: res.setdefault("v", fn(*args, **kw)),
                             1)[0]
                runs[name] = res["v"]
                out[f"{name}_ms"] += ms
            out["launches"] += 1
            valid = g.score_ops[cs:cs + cb, :, sf.BOP_VALID] == 1
            same, fin, err, rel, excess, t_rel = compare_scores(
                runs["kernel"], runs["plain"], valid)
            out["same_inf"] &= same
            out["finite"] += fin
            out["slots"] += int(valid.sum())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["max_rel_err"] = max(out["max_rel_err"], rel)
            out["t3_excess"] = max(out["t3_excess"], excess)
            out["t3_rel"] = max(out["t3_rel"], t_rel)
    return out


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
        log(f"[edge] {name}: {r['launches']} launches, {r['slots']} valid "
            f"slots, {r['finite']} finite in both; -inf pattern equal "
            f"{r['same_inf']}; score max abs err {r['max_abs_err']:.3e}, "
            f"rel {r['max_rel_err']:.3e} (bound {SCORE_RTOL}); t3 max rel "
            f"{r['t3_rel']:.3e} (bound rtol {T3_RTOL} atol {T3_ATOL})")
        check(r["same_inf"], f"{name}: -inf patterns differ")
        check(r["finite"] > 0, f"{name}: no finite score compared")
        check(r["max_rel_err"] <= SCORE_RTOL,
              f"{name}: score rel err {r['max_rel_err']} > {SCORE_RTOL}")
        check(r["t3_excess"] <= 0.0, f"{name}: t3 outside its bound")
    log(f"[time] edge scorer over one full-width round ({full['launches']} "
        f"launches of up to {sf.CAND_BATCH} candidates): kernel "
        f"{full['kernel_ms']:.4f} ms, "
        f"plain edge_scores_reference {full['plain_ms']:.4f} ms ({card})")
    return full


def dense_f64_logl(tree, chars, sites, device):
    """logL of `tree` (its own branch lengths) by the dense f64 forward
    path, model and data of search_inputs."""
    import torch

    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.config import PartitionConfig
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats

    n = tree.tip_count
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=torch.float64,
        use_kernel=False)
    program = engine.compile_tree(tree, cfg)
    model = engine.make_model(
        [[1.2, 2.7, 0.8, 1.1, 3.0, 1.0]], [[0.28, 0.24, 0.22, 0.26]],
        compute_gamma_cats(0.9, 4), dtype=torch.float64, device=device)
    raw = np.zeros((n, sites), dtype=np.uint64)
    for node in tree.nodes[:n]:
        raw[node.clv_index] = chars[node.label][:sites]
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0

    def t(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)
    return engine.loglikelihood(
        program, cfg, model, t(program.default_branch_lengths,
                               torch.float64),
        t(engine.pad_tipchars(raw, cfg)), t(pw, torch.float64),
        t(np.full(cfg.sites_padded, -1, np.int32))).item()


def phase_search(device, card):
    import torch

    from libpll2_tpu_torch import search_fast as sf
    from libpll2_tpu_torch.ops import edge_score
    from libpll2_tpu_torch.tree.compare import rf_distance_normalized

    truth, start, chars, cfg, model = search_inputs(device)
    torch.cuda.synchronize()
    edge_score.edge_scores.launches = 0
    t0 = time.perf_counter()
    final, logl, stats = sf.hill_climb(
        start, cfg, model, chars, max_rounds=SEARCH_ROUNDS,
        radius=SEARCH_RADIUS, smooth_every=2)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = edge_score.edge_scores.launches
    log(f"[search] edge_score launches during hill_climb: {launches}")
    check(launches > 0, "the search did not launch the edge scorer")

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
    log(f"[search] quality: RF {rf_start:.4f} -> {rf_final:.4f}; logL "
        f"final {logl!r}, truth tree (smoothed) {logl_true!r}, delta "
        f"{logl - logl_true!r}; final tree by dense f64 {logl64!r} (rel gap "
        f"{gap:.3e})")
    check(gap < LOGL_RTOL, f"final logL gap {gap} >= {LOGL_RTOL}")
    return launches


def main() -> int:
    import torch
    card = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    sweep_full = phase_kernel_vs_plain(device)
    full_case, cold_ms, launches = phase_main_path(device, card)
    k_ms, p_ms, abs_err = phase_times(full_case, cold_ms, sweep_full, card)
    launches += phase_training(full_case, card)
    del full_case, sweep_full
    torch.cuda.empty_cache()
    edge = phase_edge_scorer(device, card)
    search_launches = phase_search(device, card)
    print(json.dumps({"kernels": [{
        "name": "tree_sweep",
        "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/tree_sweep.cu",
        "replaces": "libpll2_tpu/ops/partials_pallas_tree.py:808 "
                    "(_tree_kernel_static); :1136 (_tree_kernel_static_seg)",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "edge_score",
        "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/edge_score.cu",
        "replaces": "libpll2_tpu/ops/edge_score_pallas.py:54 (_kernel)",
        "launches": search_launches,
        "max_abs_err": edge["max_abs_err"],
        "ms": edge["kernel_ms"],
        "plain_ms": edge["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
