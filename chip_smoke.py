#!/usr/bin/env python3
"""Smoke run of libpll2_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: name, power limit, CUDA versions; TF32 off;
  2. build the CUDA kernels from libpll2_tpu_torch/csrc with nvcc (sm_90a);
  3. the tree-sweep kernel against its plain PyTorch version on the card,
     on several trees and at the main path's full-width shape;
  4. the main path (engine.loglikelihood) at full width: 256 balanced taxa
     x 65,536 sites and 1024 taxa x 16,384 sites, GTR+Gamma4 f32, through
     the kernel, checked against the dense f64 path on the same card;
  5. times of the kernel path and the dense f32 path, CUDA events.

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
    log(smi.stdout.strip().splitlines()[0])
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"[device] {torch.cuda.get_device_name(0)}  torch "
        f"{torch.__version__}  torch.version.cuda {torch.version.cuda}  "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else '?'}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")


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


def phase_main_path(device):
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
            f"{cold_ms:.3f} ms)")
        check(np.isfinite(logl), f"{s}: non-finite logL")
        check(gap < LOGL_RTOL, f"{s}: rel gap {gap} >= {LOGL_RTOL}")
    return cases[shapes[0]], logls[shapes[0]][1], launches


def phase_times(full_case, cold_ms, sweep_full):
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
            f"{first:.3f} ms, {updates / (med * 1e-3):.4e} site-updates/s")

    scfg, sprog, pmatrix, tip_b, tb, abs_err = sweep_full
    prog = sprog.vmem_prog
    k_ms = statistics.median(cuda_ms(
        lambda: partials_tree.sweep(tip_b, pmatrix, prog, scfg, tb), 25))
    p_ms = statistics.median(cuda_ms(
        lambda: partials_tree.sweep_reference(tip_b, pmatrix, prog, scfg,
                                              tb), 5))
    log(f"[time] tree sweep alone {scfg.tips}x{scfg.sites} tb={tb}: kernel "
        f"{k_ms:.4f} ms ({updates / (k_ms * 1e-3):.4e} site-updates/s), "
        f"plain sweep_reference {p_ms:.4f} ms")
    return k_ms, p_ms, abs_err


def main() -> int:
    import torch
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    sweep_full = phase_kernel_vs_plain(device)
    full_case, cold_ms, launches = phase_main_path(device)
    k_ms, p_ms, abs_err = phase_times(full_case, cold_ms, sweep_full)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
