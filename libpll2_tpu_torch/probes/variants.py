"""Kernel experiments on the card: where the redesigned kernels spend
their time, and why their launch parameters are what they are.

    python -m libpll2_tpu_torch.probes.variants [blocks] [passes]
                                                [registers] [clocks]
                                                [fma_staging] [fma_clocks]
                                                [static2_smem_a]

(all seven with no argument; run from the repository root, beside
chip_smoke.py, whose search inputs and timers it uses).  Each experiment
prints its times beside the card's name and power limit:

  blocks     both sweep forms (csrc/tree_sweep.cu "fma",
             csrc/tree_sweep_mma.cu "mma") at chip_smoke.py's four shapes
             and every site block that fits, carry on and off, 30 launches
             back to back: what partials_tree.pick_site_block's rule rests
             on;
  passes     the edge scorer (csrc/edge_score.cu) over one full-width
             search round with 0, 1 and 3 Newton steps, for the re-reading
             form and the resident form on clusters of 2, 4 and 8 CTAs:
             what pass 0 costs, what every later pass costs, and what
             edge_score.plan's stripe budget rests on;
  registers  the resident form built under three register bounds
             (one, two and three CTAs an SM), timed over the same round;
  clocks     the small-span sweep built with clock reads in its op loop:
             cycles per op, by the kinds of the op's children, split into
             the stretch up to the products of the first tile, the rescue,
             the store or hand-on, and the loop's tail and head;
  fma_staging  the "fma" sweep (csrc/tree_sweep.cu) against four variants
             at the four shapes, all in 64-site blocks: operands copied one
             op ahead instead of two ("fma_ahead_1"), P rows read from
             device memory when the op starts instead of staged
             ("fma_p_direct"), one or four sites a thread instead of two
             ("fma_sites_1", "fma_sites_4");
  fma_clocks the "fma" sweep built with clock reads in its op loop: cycles
             per op of one warp, by the kinds of the op's children, split
             into the wait for the op's operands (with the start of the
             copies ahead) and the op;
  static2_smem_a  the construct probe's k0-k3 (csrc/construct_probe.cu)
             with the pool's site tile in shared memory, read by wgmma
             through descriptors, against the register tile, both in one
             CUDA graph of 50 launches each, in turns (registers, shared
             memory, shared memory, registers): what the register tile
             buys.  k3's 196,608 bytes of pcm leave no room for the A
             tiles, so it runs only in registers.

A variant of a kernel is a copy of csrc/ with a few exact text
replacements (`PATCHES`), built by `_build.library(build_dir, source_dir)`
into build/variants/.  A replacement that no longer matches the source
raises; tests/test_torch_probe.py checks on the CPU that every one still
applies.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import shutil
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _build

VARIANT_DIR = _build.BUILD_DIR.parent / "variants"
BOUND = "__global__ void __launch_bounds__(THREADS, V == 4 ? 2 : 1)"
CLOCK_SEGMENTS = ("loop top to the first tile's products", "rescue",
                  "store or hand-on, and the second tile", "loop tail and head")
FMA_CLOCK_SEGMENTS = ("wait for the op's operands, start the copies ahead",
                      "the op", "loop tail and head")
FMA_AHEAD = "constexpr int AHEAD = 2;"
FMA_SITES = "constexpr int SITES_A_THREAD = 2;"
FMA_STAGE_P = "constexpr int STAGE_P_MAX_STATES = 4;"
FMA_LOOP = "    wait_copies<AHEAD - 1>();\n"
FMA_OP = "    const int4 op = rows[ROW_INT4 * (w % ROW_SLOTS) + 1];"
STATIC2_A = "constexpr bool A_IN_REGISTERS = true;"
# name -> (source file, ((old, new), ...)); every `old` occurs exactly once
PATCHES = {
    "one_cta_an_sm": ("edge_score.cu", (
        (BOUND, "__global__ void __launch_bounds__(THREADS)"),)),
    "two_ctas_an_sm": ("edge_score.cu", ()),
    "three_ctas_an_sm": ("edge_score.cu", (
        (BOUND, BOUND.replace("? 2 :", "? 3 :")),)),
    "clocks": ("tree_sweep_mma.cu", (
        ("constexpr int M_SITES = 16;   // sites per m-tile",
         "constexpr int M_SITES = 16;\n"
         "__device__ long long dbg_clock[8192 * 4];\n"
         "__device__ int dbg_op;\n"
         "__device__ __forceinline__ long long tick(float& dep) {\n"
         "  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t), "
         "\"+f\"(dep));\n  return t;\n}"),
        ("    const OpRow after = load_row(ops, min(w + 2, last));",
         "    const bool dbg = blockIdx.x == 0 && threadIdx.x == 0 && "
         "w < 8192;\n"
         "    if (dbg) { dbg_op = w; dbg_clock[4 * w] = clock64(); }\n"
         "    const OpRow after = load_row(ops, min(w + 2, last));"),
        ("    // the rescue: a site's 16 entries sit in the four lanes of "
         "its quad",
         "    if (blockIdx.x == 0 && threadIdx.x == 0 && m == 0)\n"
         "      dbg_clock[4 * dbg_op + 1] = tick(y[0][0]);"),
        ("    // scalers, once per site: the quad's lane 0 carries sites g "
         "and g + 8",
         "    if (blockIdx.x == 0 && threadIdx.x == 0 && m == 0)\n"
         "      dbg_clock[4 * dbg_op + 2] = tick(y[0][0]);"),
        ("#undef LIBPLL_OP\n",
         "#undef LIBPLL_OP\n"
         "    if (dbg) dbg_clock[4 * w + 3] = tick(held[0][0][0]);\n"),
        ("extern \"C\" {\n",
         "extern \"C\" {\n"
         "int dbg_read(long long* out, int n) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, dbg_clock, (size_t)n * 8);"
         "\n}\n"))),
    "static2_smem_a": ("construct_probe.cu", (
        (STATIC2_A, STATIC2_A.replace("true", "false")),)),
    "fma_ahead_1": ("tree_sweep.cu", (
        (FMA_AHEAD, FMA_AHEAD.replace("= 2", "= 1")),)),
    "fma_sites_1": ("tree_sweep.cu", (
        (FMA_SITES, FMA_SITES.replace("= 2", "= 1")),)),
    "fma_sites_4": ("tree_sweep.cu", (
        (FMA_SITES, FMA_SITES.replace("= 2", "= 4")),)),
    "fma_p_direct": ("tree_sweep.cu", (
        (FMA_STAGE_P, FMA_STAGE_P.replace("= 4", "= 0")),)),
    "fma_clocks": ("tree_sweep.cu", (
        ("constexpr int ROW_INT4 = 2;",
         "constexpr int ROW_INT4 = 2;\n"
         "__device__ long long dbg_clock[8192 * 3];\n"
         "__device__ __forceinline__ long long tick(float dep) {\n"
         "  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) : "
         "\"f\"(dep) : \"memory\");\n  return t;\n}"),
        (FMA_LOOP,
         "    const bool dbg = blockIdx.x == 0 && threadIdx.x == 0 && "
         "w < 8192;\n"
         "    if (dbg) dbg_clock[3 * w] = clock64();\n" + FMA_LOOP),
        (FMA_OP,
         "    if (dbg) dbg_clock[3 * w + 1] = tick((float)w);\n" + FMA_OP),
        ("#undef LIBPLL_OP\n",
         "#undef LIBPLL_OP\n"
         "    if (dbg) dbg_clock[3 * w + 2] = tick(held[0][0]);\n"),
        ("extern \"C\" {\n",
         "extern \"C\" {\n"
         "int dbg_read(long long* out, int n) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, dbg_clock, (size_t)n * 8);"
         "\n}\n"))),
}


def patched_source(name: str, source_dir=None) -> str:
    """The text of variant `name`'s source file with its replacements made;
    raises where one does not occur exactly once."""
    file, patches = PATCHES[name]
    source_dir = _build.SOURCE_DIR if source_dir is None else Path(source_dir)
    text = (source_dir / file).read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} occurs "
                             f"{text.count(old)} times in {file}, not once")
        text = text.replace(old, new)
    return text


def variant_library(name: str):
    """(library, BuildInfo) of variant `name`, built into
    build/variants/<name>/ from a patched copy of csrc/."""
    root = VARIANT_DIR / name
    shutil.copytree(_build.SOURCE_DIR, root / "csrc", dirs_exist_ok=True)
    (root / "csrc" / PATCHES[name][0]).write_text(patched_source(name))
    return (_build.library(root / "lib", root / "csrc"),
            _build.build(root / "lib", root / "csrc"))


@contextlib.contextmanager
def launching_from(lib):
    """Inside the block the package's wrappers launch from `lib`."""
    real = _build.library
    _build.library = lambda build_dir=None, source_dir=None: lib
    try:
        yield
    finally:
        _build.library = real


def _chip_smoke():
    try:
        import chip_smoke
    except ImportError as err:
        raise RuntimeError("run from the repository root: chip_smoke.py "
                           "holds the search inputs and the timers") from err
    return chip_smoke


def _median_ms(fn, reps: int) -> float:
    fn()
    return statistics.median(_chip_smoke().cuda_ms(fn, reps))


def round_chunks(device):
    """The edge scorer's arguments for every chunk of one full-width search
    round (chip_smoke.search_inputs, radius 5), one chunk at a time on the
    same recursion scratch: yields (args, log_thresh)."""
    cs = _chip_smoke()
    from .. import search_fast as sf
    from ..ops import edge_score

    _truth, start, chars, cfg, model = cs.search_inputs(device)
    prog = sf.compile_spr(start, cfg, radius=cs.SEARCH_RADIUS)
    cfgx = prog.cfg_ext
    tip, pw, _inv = sf._site_arrays(prog, chars, device)
    bl = torch.as_tensor(prog.branch_lengths, dtype=cfgx.dtype, device=device)
    base_clv, base_scal, pmatrix, halves = sf._spr_base(
        cfgx, model, sf._long(prog.level_ops, device),
        sf._long(prog.pmatrix_slots, device), bl, tip)
    halves = halves.contiguous()
    consts = edge_score.model_constants(model, cfgx)
    R, S, T = cfgx.rate_cats, cfgx.states, tip.shape[-1]
    for g in prog.ball_groups:
        lvls = tuple(sf._long(a, device) for a in g.ball_levels)
        medges = sf._long(g.merge_edges, device)
        ops32 = torch.as_tensor(g.score_ops, device=device)
        rows32 = torch.as_tensor(g.sub_rows, device=device)
        n_cand = g.score_ops.shape[0]
        cb = min(sf.CAND_BATCH, n_cand)
        while n_cand % cb:
            cb -= 1
        scratch = torch.empty((cb, prog.ball_slots, R, S, T),
                              dtype=torch.float32, device=device)
        sscr = torch.empty((cb, prog.ball_slots, T), dtype=torch.int32,
                           device=device)
        for c0 in range(0, n_cand, cb):
            sf._recurse(cfgx, model, base_clv, base_scal, pmatrix, bl, lvls,
                        medges, torch.arange(c0, c0 + cb, device=device),
                        scratch, sscr)
            t0 = torch.clamp(bl[sf._long(g.edge_pos[c0:c0 + cb], device)],
                             1e-8, 100.0)
            yield ((scratch, sscr, base_clv, base_scal, halves,
                    ops32[c0:c0 + cb].contiguous(),
                    rows32[c0:c0 + cb].contiguous(), t0, *consts, pw),
                   cfgx.log_scale_threshold)


def round_ms(device, configs, libs=None, reps: int = 3) -> dict:
    """Summed medians (ms) of `reps` back-to-back launches per chunk of the
    round, for every (library name, form, cluster, newton_iters) in
    `configs`; cluster 0 leaves the size to edge_score.plan."""
    from ..ops import edge_score

    libs = {None: _build.library()} if libs is None else libs
    total = dict.fromkeys(configs, 0.0)
    real_plan = edge_score.plan
    try:
        for args, log_thresh in round_chunks(device):
            for config in configs:
                name, form, cluster, iters = config
                edge_score.plan = real_plan if not cluster else (
                    lambda R, S, T, limit=0, k=cluster: ("resident", k))
                with launching_from(libs[name]):
                    total[config] += _median_ms(
                        lambda: edge_score.edge_scores(
                            *args, newton_iters=iters, log_thresh=log_thresh,
                            form=form), reps)
    finally:
        edge_score.plan = real_plan
    return total


def sweep_shapes(device):
    """chip_smoke.py's four sweep shapes: {name: engine.build_case(...)}."""
    cs = _chip_smoke()
    from .. import engine

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    return {
        "dna_256": engine.build_case(256, 65536, dtype=torch.float32,
                                     device=device),
        "dna_1024": engine.build_case(1024, 16384, dtype=torch.float32,
                                      device=device),
        "large_8192": engine.build_case(
            cs.LARGE_TIPS, cs.LARGE_SITES, dtype=torch.float32,
            device=device, newick=cs.large_newick()),
        "protein_128": engine.build_case(
            cs.PROTEIN_TIPS, cs.PROTEIN_SITES, states=20,
            dtype=torch.float32, device=device)}


def run_blocks(device, card, emit=print):
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree

    limit = _build.max_shared_memory(device)
    for name, (cfg, program, model, bl, tipchars, *_) in \
            sweep_shapes(device).items():
        pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
        prog = program.vmem_prog
        for mode in partials_tree.MODES:
            if partials_tree.unsupported(prog, cfg, limit, mode):
                continue
            for tb in partials_tree.fitting_blocks(prog, cfg, limit, mode):
                tip_b = engine.block_tips(tipchars, cfg, tb)
                for carry in (True, False):
                    ms = cs.cuda_ms_back_to_back(lambda: partials_tree.sweep(
                        tip_b, pmatrix, prog, cfg, tb, mode=mode,
                        carry=carry), 30)
                    emit(f"[blocks] {mode} sweep {name}, pool "
                         f"{prog.pool_size}, site block {tb} "
                         f"({cfg.sites_padded // tb} CTAs), carry "
                         f"{'on' if carry else 'off'}: {ms:.4f} ms ({card})")
        del pmatrix
        torch.cuda.empty_cache()


def run_passes(device, card, emit=print):
    configs = [(None, form, cluster, iters)
               for form, cluster in (("reread", 0), ("resident", 2),
                                     ("resident", 4), ("resident", 8))
               for iters in (0, 1, 3)]
    for (_, form, cluster, iters), ms in round_ms(device, configs).items():
        emit(f"[passes] edge scorer, {form}"
             + (f" on clusters of {cluster}" if cluster else "")
             + f", {iters} Newton steps: {ms:.4f} ms over the round ({card})")


def run_registers(device, card, emit=print):
    names = ("one_cta_an_sm", "two_ctas_an_sm", "three_ctas_an_sm")
    libs = {}
    for name in names:
        libs[name], info = variant_library(name)
        entry = ""
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "resident_kernelILi4ELi4" in entry and (
                    "registers" in line or "spill" in line):
                emit(f"[registers] {name}: {line.strip()}")
    configs = [(name, "resident", 4, iters) for name in names
               for iters in (0, 3)]
    for (name, _, cluster, iters), ms in round_ms(device, configs,
                                                  libs).items():
        emit(f"[registers] edge scorer, resident on clusters of {cluster}, "
             f"{name}, {iters} Newton steps: {ms:.4f} ms over the round "
             f"({card})")


def run_clocks(device, card, emit=print):
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    lib, _info = variant_library("clocks")
    lib.dbg_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dbg_read.restype = ctypes.c_int
    tb = 64
    trees = {"random": cs.large_newick(),
             "caterpillar": cs.caterpillar(cs.LARGE_TIPS)}
    kinds = {v: k for k, v in partials_tree.KINDS.items()}
    for name, newick in trees.items():
        cfg, program, model, bl, tipchars, *_ = engine.build_case(
            cs.LARGE_TIPS, cs.LARGE_SITES, dtype=torch.float32,
            device=device, newick=newick)
        pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
        tip_b = engine.block_tips(tipchars, cfg, tb)
        prog = program.vmem_prog
        n = min(prog.n_ops, 8192)
        with launching_from(lib):
            ms = _median_ms(lambda: partials_tree.sweep(
                tip_b, pmatrix, prog, cfg, tb, mode="mma"), 8)
            torch.cuda.synchronize()
        buf = np.zeros(4 * n, dtype=np.int64)
        err = lib.dbg_read(buf.ctypes.data, 4 * n)
        if err != 0:
            raise RuntimeError(f"reading the clocks failed: CUDA error {err}")
        buf = buf.reshape(n, 4)
        seg = np.stack([buf[:-1, 1] - buf[:-1, 0], buf[:-1, 2] - buf[:-1, 1],
                        buf[:-1, 3] - buf[:-1, 2], buf[1:, 0] - buf[:-1, 3]],
                       axis=1)
        table = partials_tree.mma_device_table(prog)[:n - 1]
        emit(f"[clocks] {name} tree, {cs.LARGE_TIPS} taxa x {cs.LARGE_SITES} "
             f"sites, site block {tb}, with the clock reads {ms:.4f} ms; "
             f"cycles per op of warp 0 of CTA 0: median "
             f"{np.median(seg.sum(1)):.0f}, mean {seg.sum(1).mean():.0f} "
             f"({card})")
        for kind in sorted(set(table[:, 9].tolist())):
            for keep in (0, 1):
                sel = seg[(table[:, 9] == kind) & (table[:, 11] == keep)]
                if len(sel) < 8:
                    continue
                emit(f"[clocks]   children {kinds[kind]}, parent "
                     f"{'handed on' if keep else 'stored'}, {len(sel)} ops: "
                     + "; ".join(f"{label} {np.median(sel[:, i]):.0f}"
                                 for i, label in enumerate(CLOCK_SEGMENTS)))


def run_fma_staging(device, card, emit=print):
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree

    names = ("default", "fma_ahead_1", "fma_p_direct", "fma_sites_1",
             "fma_sites_4")
    libs = {name: _build.library() if name == "default"
            else variant_library(name)[0] for name in names}
    for shape, (cfg, program, model, bl, tipchars, *_) in \
            sweep_shapes(device).items():
        pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
        prog = program.vmem_prog
        tb = 64     # every variant's CTA fits at 64 sites
        tip_b = engine.block_tips(tipchars, cfg, tb)
        rows, times = {}, {name: [] for name in names}
        for name in names + names[::-1]:
            with launching_from(libs[name]):
                def call():
                    return partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb,
                                               mode="fma")
                rows[name] = call()
                times[name].append(cs.cuda_ms_back_to_back(call, 30))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for name in names[1:]
                   for a, b in zip(rows["default"], rows[name]))
        emit(f"[fma_staging] {shape}, site block {tb}: "
             + ", ".join(f"{name} {min(times[name]):.4f} ms"
                         for name in names)
             + f" (best of two turns of 30 launches back to back); rows "
               f"bit-equal {same} ({card})")
        del pmatrix
        torch.cuda.empty_cache()


def run_fma_clocks(device, card, emit=print):
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree

    lib, _info = variant_library("fma_clocks")
    lib.dbg_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dbg_read.restype = ctypes.c_int
    kinds = {v: k for k, v in partials_tree.KINDS.items()}
    shapes = sweep_shapes(device)
    for name in ("dna_256", "large_8192"):
        cfg, program, model, bl, tipchars, *_ = shapes[name]
        pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
        prog = program.vmem_prog
        tb, _ = engine.kernel_choice(
            program, dataclasses.replace(cfg, sweep_mode="fma"), device)
        tip_b = engine.block_tips(tipchars, cfg, tb)
        n = min(prog.n_ops, 8192)
        with launching_from(lib):
            ms = cs.cuda_ms_back_to_back(lambda: partials_tree.sweep(
                tip_b, pmatrix, prog, cfg, tb, mode="fma"), 8)
        buf = np.zeros(3 * n, dtype=np.int64)
        err = lib.dbg_read(buf.ctypes.data, 3 * n)
        if err != 0:
            raise RuntimeError(f"reading the clocks failed: CUDA error {err}")
        buf = buf.reshape(n, 3)
        seg = np.stack([buf[:-1, 1] - buf[:-1, 0], buf[:-1, 2] - buf[:-1, 1],
                        buf[1:, 0] - buf[:-1, 2]], axis=1)
        table = partials_tree.mma_device_table(prog)[:n - 1]
        emit(f"[fma_clocks] {name}, site block {tb}, with the clock reads "
             f"{ms:.4f} ms; cycles per op of warp 0 of CTA 0: median "
             f"{np.median(seg.sum(1)):.0f}, mean {seg.sum(1).mean():.0f} "
             f"({card})")
        for kind in sorted(set(table[:, 9].tolist())):
            for keep in (0, 1):
                sel = seg[(table[:, 9] == kind) & (table[:, 11] == keep)]
                if len(sel) < 8:
                    continue
                emit(f"[fma_clocks]   children {kinds[kind]}, parent "
                     f"{'handed on' if keep else 'stored'}, {len(sel)} ops: "
                     + "; ".join(f"{label} {np.median(sel[:, i]):.0f}"
                                 for i, label in
                                 enumerate(FMA_CLOCK_SEGMENTS)))
        del pmatrix
        torch.cuda.empty_cache()


def static2_forms(device, card, emit=print, lib=None, n_ops: int = 128,
                  reps: int = 50):
    """k0-k3 with the site tile in registers (the package's kernel) and in
    shared memory (`lib`, default: variant static2_smem_a built here), each
    first held against static2_reference, then timed as one CUDA graph of
    `reps` launches, in turns.  Returns
    {variant: {"registers": ms, "shared memory": ms}}, the fastest turn of
    each; no "shared memory" where the A tiles do not fit beside pcm."""
    from . import constructs

    if lib is None:
        lib = variant_library("static2_smem_a")[0]
    limit = _build.max_shared_memory(device)
    pcm, pool = constructs.static2_inputs(constructs.STATIC2_SITES,
                                          device=device)
    bound = constructs.static2_tolerance(n_ops)
    found = {}
    for variant in constructs.K_VARIANTS:
        smem = constructs.static2_smem_bytes(variant, a_in_registers=False)
        want = constructs.static2_reference(variant, pcm, pool, n_ops)
        b_cm, a_frag = constructs.pack_static2(variant, pcm, pool)
        out = torch.empty_like(want)
        forms = {"registers": None}
        if smem <= limit:
            forms["shared memory"] = lib
            got = constructs.static2(variant, pcm, pool, n_ops, lib)
            err = constructs.static2_error(got, want)
            if not err <= bound:
                raise RuntimeError(f"static2_smem_a {variant}: error {err} "
                                   f"> {bound} against the plain version")
        times = {form: [] for form in forms}
        for form in ("registers", "shared memory", "shared memory",
                     "registers"):
            if form not in forms:
                continue
            times[form].append(constructs.graph_ms(
                lambda: constructs.launch_static2(variant, b_cm, a_frag, out,
                                                  n_ops, forms[form]), reps))
        best = found[variant] = {form: min(t) for form, t in times.items()}
        emit(f"[static2_smem_a] {variant}, {n_ops} ops, "
             f"{constructs.STATIC2_SITES} sites, one CUDA graph of {reps} "
             f"launches, a launch: A in registers {best['registers']:.4f} ms"
             f" (turns {', '.join(f'{t:.4f}' for t in times['registers'])});"
             f" " + (f"A in shared memory {best['shared memory']:.4f} ms "
                     f"(turns "
                     f"{', '.join(f'{t:.4f}' for t in times['shared memory'])}"
                     f"), registers "
                     f"{best['shared memory'] / best['registers']:.3f}x "
                     f"faster" if "shared memory" in best else
                     f"A in shared memory does not fit ({smem} bytes, above "
                     f"the {limit}-byte limit)")
             + f" ({card})")
    return found


def run_static2_smem_a(device, card, emit=print):
    lib, info = variant_library("static2_smem_a")
    entry = ""
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "static2_kernel" in entry and ("registers" in line
                                            or "spill" in line):
            emit(f"[static2_smem_a] {entry}: {line.strip()}")
    static2_forms(device, card, emit, lib)


EXPERIMENTS = {"blocks": run_blocks, "passes": run_passes,
               "registers": run_registers, "clocks": run_clocks,
               "fma_staging": run_fma_staging, "fma_clocks": run_fma_clocks,
               "static2_smem_a": run_static2_smem_a}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    chosen = argv or list(EXPERIMENTS)
    unknown = [name for name in chosen if name not in EXPERIMENTS]
    if unknown:
        print(f"probes.variants: unknown experiment {unknown}, not one of "
              f"{list(EXPERIMENTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probes.variants: torch.cuda.is_available() is False; the "
              "experiments need a CUDA device", file=sys.stderr)
        return 1
    card = _chip_smoke().phase_device()
    device = torch.device("cuda", 0)
    for name in chosen:
        EXPERIMENTS[name](device, card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
