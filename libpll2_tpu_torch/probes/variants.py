"""Kernel experiments on the card: where the redesigned kernels spend
their time, and why their launch parameters are what they are.

    python -m libpll2_tpu_torch.probes.variants [blocks] [passes]
                                                [registers] [clocks]
                                                [fma_staging] [fma_clocks]
                                                [static2_smem_a]
                                                [generic_sweep]
                                                [generic_blocks]
                                                [generic_bounds]
                                                [generic_scorer]

(all eleven with no argument; run from the repository root, beside
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
  generic_sweep  the generic-state sweep (csrc/tree_sweep_generic.cu) at 5
             states (256 x 65,536) and 32 states (128 x 16,384), f32 and
             bf16: the first generic form (the scalar form) against the
             row-group form and its
             variants, in turns (generic_sweep_forms);
  generic_blocks  the generic sweep at its two shapes, f32 and bf16, at
             every site block that fits (run_generic_blocks);
  generic_bounds  the generic sweep's row-group form built with every
             shared-memory access and P read checked, staged and through
             L1, and with a CTA barrier in place of its warp barrier, at
             row-group and block edges (run_generic_bounds);
  generic_scorer  the edge scorer's generic-state form over a full-width
             5-state round and a 32-state round: its first form against the
             package's, each choice undone alone, and the variants dropped
             (run_generic_scorer);
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

import concurrent.futures
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
BOUND = ("__global__ void __launch_bounds__(THREADS, SMAX > 0 && SMAX <= 8\n"
         "                                               ? "
         "RESIDENT_CTAS_GENERIC\n"
         "                                           : V == 4 || SMAX > 0\n"
         "                                               ? RESIDENT_CTAS\n"
         "                                               : 1)")
CTAS = "constexpr int RESIDENT_CTAS = 2;"
CTAS_GENERIC = "constexpr int RESIDENT_CTAS_GENERIC = 4;"
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
GENERIC_STAGE = "constexpr int GENERIC_STAGE_BYTES = 73728;"
GENERIC_SITES = "constexpr int GROUP_SITES = 2;"
# forms of csrc/tree_sweep_generic.cu that the package never launches, for
# the variants that time them: the scalar form (the first generic form,
# probes/generic_scalar_form.cu, SMAX 8, 16 and 32 as it was), reached with
# groups = 0, and the row-group form reading P through L1 at up to 8 states
# (an op's P-matrices always fit the staging there)
SCALAR_FORM = (Path(__file__).resolve().parent /
               "generic_scalar_form.cu").read_text()
GENERIC_END = "\n}  // namespace\n\n// The generic-state sweep, called by"
GROUPS_ONLY = "  if (states < 2 || states > 32 || groups <= 0 ||"
GROUP_ARGS = "#define LIBPLL_GROUP_ARGS    "
SCALAR_DISPATCH = """\
#define LIBPLL_SCALAR_ARGS                                                    \\
  ops, n_ops, pmat, tip_blocked, tips, export_slots, n_exp, export_at,       \\
      clv_out, scal_out, nt, tb, rates, states, pool_size, per_rate, thresh, \\
      factor, s
#define LIBPLL_SCALAR(STORE)                                                  \\
  if (states <= 8) return launch_scalar<8>(STORE, LIBPLL_SCALAR_ARGS);        \\
  if (states <= 16) return launch_scalar<16>(STORE, LIBPLL_SCALAR_ARGS);      \\
  return launch_scalar<32>(STORE, LIBPLL_SCALAR_ARGS)
  if (groups == 0) {
    if (bf16) {
      LIBPLL_SCALAR(Store<__nv_bfloat16>{});
    }
    LIBPLL_SCALAR(Store<float>{});
  }
#undef LIBPLL_SCALAR
#undef LIBPLL_SCALAR_ARGS
"""
UNSTAGED = ("  if constexpr (SMAX > 8)\n"
            "    return launch_groups_kernel<SMAX, false, T>")
ALL_FORMS = (
    (GENERIC_END, "\n" + SCALAR_FORM + GENERIC_END),
    (GROUPS_ONLY, GROUPS_ONLY.replace("groups <= 0", "groups < 0")),
    (GROUP_ARGS, SCALAR_DISPATCH + GROUP_ARGS),
    (UNSTAGED, UNSTAGED.replace("SMAX > 8", "true")))
# the row-group form of csrc/tree_sweep_generic.cu with every access it
# makes to shared memory checked against the block's dynamic shared memory
# (%dynamic_smem_size), and every P read against the thread's block of a
# P-matrix; failures and checked ops are counted in dbg_bad (read and reset
# through dbg_bounds), not trapped, so that one run reports them all
BOUNDS = (
    ("constexpr int GROUP_THREADS = 1024;\n",
     "constexpr int GROUP_THREADS = 1024;\n"
     "// [0] shared-memory accesses outside the dynamic shared memory, [1] "
     "P reads\n// outside the thread's block, [2] ops checked\n"
     "__device__ unsigned long long dbg_bad[3];\n"
     "__device__ __forceinline__ void dbg_smem(const void* p, int bytes) {\n"
     "  extern __shared__ __align__(16) float smem[];\n"
     "  unsigned n;\n"
     "  asm volatile(\"mov.u32 %0, %%dynamic_smem_size;\" : \"=r\"(n));\n"
     "  const long long off = static_cast<const char*>(p) -\n"
     "                        reinterpret_cast<const char*>(smem);\n"
     "  if (off < 0 || off + bytes > (long long)n) "
     "atomicAdd(&dbg_bad[0], 1ull);\n"
     "}\n"),
    ("                      : widen(c1[h * hcol + (size_t)j * cols]);",
     "                      : (dbg_smem(c1 + h * hcol + (size_t)j * cols, "
     "sizeof(T)),\n"
     "                         widen(c1[h * hcol + (size_t)j * cols]));"),
    ("                      : widen(c2[h * hcol + (size_t)j * cols]);",
     "                      : (dbg_smem(c2 + h * hcol + (size_t)j * cols, "
     "sizeof(T)),\n"
     "                         widen(c2[h * hcol + (size_t)j * cols]));"),
    ("          const float4 x = load4<STAGED>(P1 + j * RP + 4 * q);",
     "          if (j * RP + 4 * q + 4 > group_block_floats(S, G))\n"
     "            atomicAdd(&dbg_bad[1], 1ull);\n"
     "          if (STAGED) dbg_smem(P1 + j * RP + 4 * q, 16);\n"
     "          if (STAGED) dbg_smem(P2 + j * RP + 4 * q, 16);\n"
     "          const float4 x = load4<STAGED>(P1 + j * RP + 4 * q);"),
    ("        put(par + h * hcol + (size_t)i * cols, v);",
     "        dbg_smem(par + h * hcol + (size_t)i * cols, sizeof(T));\n"
     "        put(par + h * hcol + (size_t)i * cols, v);"),
    ("      if (!K1_TIP) sc += s1[h * hs];",
     "      if (!K1_TIP) dbg_smem(s1 + h * hs, 4);\n"
     "      if (!K2_TIP) dbg_smem(s2 + h * hs, 4);\n"
     "      dbg_smem(sp + h * hs, 4);\n"
     "      if (!K1_TIP) sc += s1[h * hs];"),
    ("    if ((threadIdx.x & 31) == 0) words[warp] = below;",
     "    if ((threadIdx.x & 31) == 0) dbg_smem(words + warp, 4);\n"
     "    if ((threadIdx.x & 31) == 0) words[warp] = below;"),
    ("    for (int v = 0; v < width >> 5; ++v) below &= words[first + v];",
     "    for (int v = 0; v < width >> 5; ++v) dbg_smem(words + first + v, 4);"
     "\n"
     "    for (int v = 0; v < width >> 5; ++v) below &= words[first + v];"),
    ("      copy_async(dst + m * mat + off,",
     "      dbg_smem(dst + m * mat + off, 16);\n"
     "      copy_async(dst + m * mat + off,"),
    ("          if (i < S) dst[(size_t)i * tb] = src[(size_t)i * cols];",
     "          if (i < S) dbg_smem(src + (size_t)i * cols, 4);\n"
     "          if (i < S) dst[(size_t)i * tb] = src[(size_t)i * cols];"),
    ("    const T* c1 = pool + (size_t)op.y * slot_words + col;",
     "    if (p_thread + group_block_floats(S, G) > mat)\n"
     "      atomicAdd(&dbg_bad[1], 1ull);\n"
     "    if (t == 0) atomicAdd(&dbg_bad[2], 1ull);\n"
     "    const T* c1 = pool + (size_t)op.y * slot_words + col;"),
    ('extern "C" {\n',
     'extern "C" {\n\n'
     "int dbg_bounds(unsigned long long* out, int reset) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, dbg_bad, "
     "sizeof(dbg_bad));\n"
     "  if (err != cudaSuccess || !reset) return (int)err;\n"
     "  const unsigned long long zero[3] = {0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(dbg_bad, zero, sizeof(zero));\n"
     "}\n\n"))
# the unstaged row-group form orders a column's pool words by a warp
# barrier (its groups and a site's rate lanes are lanes of one warp); the
# race reference orders them by a CTA barrier
WARP_BARRIER = ("    } else {\n      __syncwarp();\n    }",
                "    } else {\n      __syncthreads();\n    }")
# the scorer's generic-state form with its later passes at four sites a
# thread where aligned (csrc/edge_score.cu:launch), and the first form's
# pass 0, which staged a site's columns in shared memory, 3 * S words a
# thread (scratch_floats), where the package's holds them in registers
PASSES_V4 = ("  if constexpr (SMAX > 0) {\n"
             "    const int stripe = (a.sites + cluster - 1) / cluster;")
REGS_HEAD = ("// The generic-state form of site_lk at one site with the "
             "site's columns in\n")
LK_ANY = """\
// The generic-state form of site_lk at one site (V = 1): the state count S
// at run time, up to SMAX, and registers O(1) in S.  Each thread stages its
// site's columns of a rate category in its own words of shared memory,
// scratch[k * THREADS] for k < 3 * S (the away and facing rows, then the
// sub row over the away row, and the product of the two half-branch
// messages), so that every sum over j reads them from there.  The sums run
// over j in the order site_lk's do.
template <int SMAX, bool KEEP>
__device__ __forceinline__ void site_lk_any(
    const float* __restrict__ away, const float* __restrict__ other,
    const float* __restrict__ sub, size_t T, int R, int S, const float* sH,
    const float* sL, const float* sE, const float4* se, bool derivs,
    float* scratch, float* st, int st_stride, float& lk0, float& lk1,
    float& lk2) {
  lk0 = lk1 = lk2 = 0.0f;
  float* A = scratch;                 // away, then sub
  float* O = scratch + S * THREADS;   // facing
  float* C = O + S * THREADS;         // (H away) * (H facing)
  for (int r = 0; r < R; ++r) {
    for (int j = 0; j < S; ++j) {
      const size_t off = (size_t)(r * S + j) * T;
      A[j * THREADS] = __ldg(away + off);
      O[j * THREADS] = __ldg(other + off);
    }
    const float* H = sH + r * S * S;
    for (int i = 0; i < S; ++i) {
      float ta = 0.0f, tb = 0.0f;
#pragma unroll
      for (int j = 0; j < SMAX; ++j) {
        if (j < S) {
          const float h = H[i * S + j];
          ta = fmaf(h, A[j * THREADS], ta);
          tb = fmaf(h, O[j * THREADS], tb);
        }
      }
      C[i * THREADS] = ta * tb;
    }
    for (int k = 0; k < S; ++k)
      A[k * THREADS] = __ldg(sub + (size_t)(r * S + k) * T);
    const float* L = sL + r * S * S;
    const float* E = sE + r * S * S;
    for (int j = 0; j < S; ++j) {
      float lef = 0.0f, rig = 0.0f;
#pragma unroll
      for (int k = 0; k < SMAX; ++k) {
        if (k < S) {
          lef = fmaf(L[j * S + k], C[k * THREADS], lef);
          rig = fmaf(E[j * S + k], A[k * THREADS], rig);
        }
      }
      const int q = r * S + j;
      const float4 e = se[q];
      const float val = lef * rig;
      lk0 = fmaf(val, e.x, lk0);
      if (derivs) {
        lk1 = fmaf(val, e.y, lk1);
        lk2 = fmaf(val, e.z, lk2);
      }
      if constexpr (KEEP) st[(size_t)q * st_stride] = val;
    }
  }
}

// The staging words of site_lk_any, after the head of either form: 3 * S
// a thread, none for the state counts with an instantiation of their own.
// A multiple of 4 floats.
__host__ __device__ constexpr int scratch_floats(int S) {
  return S == 2 || S == 4 || S == 10 || S == 16 || S == 20 ? 0
                                                           : 3 * S * THREADS;
}

"""
SCRATCH = (
    (REGS_HEAD, LK_ANY + REGS_HEAD),
    ("  float* sw = sx + span;\n  load_constants(a, op, sH, Sn);\n"
     "  const Rows rows = slot_rows(a, op, c, span);\n  if (tid == 0)",
     "  float* sw = sx + span;\n"
     "  float* scratch = smem + reread_floats(R, Sn) + tid;\n"
     "  load_constants(a, op, sH, Sn);\n"
     "  const Rows rows = slot_rows(a, op, c, span);\n  if (tid == 0)"),
    ("        site_lk_regs<SMAX, false>(rows.away + site, rows.other + site,\n"
     "                                  rows.sub + site, T, R, Sn, sH, sL, "
     "sE, se,\n"
     "                                  !last, nullptr, 0,",
     "        site_lk_any<SMAX, false>(rows.away + site, rows.other + site,\n"
     "                                 rows.sub + site, T, R, Sn, sH, sL, sE, "
     "se,\n"
     "                                 !last, scratch, nullptr, 0,"),
    ("  float* st = smem + resident_head_floats(R, Sn);\n",
     "  float* scratch = smem + resident_head_floats(R, Sn) + tid;\n"
     "  float* st = smem + resident_head_floats(R, Sn) + scratch_floats(Sn);"
     "\n"),
    ("          site_lk_regs<SMAX, true>(rows.away + site, rows.other + "
     "site,\n"
     "                                   rows.sub + site, T, R, Sn, sH, sL, "
     "sE, se,\n"
     "                                   !last, st + ls,",
     "          site_lk_any<SMAX, true>(rows.away + site, rows.other + site,\n"
     "                                  rows.sub + site, T, R, Sn, sH, sL, "
     "sE, se,\n"
     "                                  !last, scratch, st + ls,"),
    ("  return ((size_t)resident_head_floats(rates, S) +\n",
     "  return ((size_t)resident_head_floats(rates, S) + scratch_floats(S) +"
     "\n"),
    ("  return (size_t)reread_floats(rates, S) * sizeof(float);",
     "  return ((size_t)reread_floats(rates, S) + scratch_floats(S)) *\n"
     "         sizeof(float);"))
# the body of csrc/edge_score.cu:site_lk_regs as kept, and a version that
# loads the next rate category's rows while this one's products run
REGS_BODY = """  lk0 = lk1 = lk2 = 0.0f;
  for (int r = 0; r < R; ++r) {
    float a[SMAX], o[SMAX], c[SMAX];
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        const size_t off = (size_t)(r * S + j) * T;
        a[j] = __ldg(away + off);
        o[j] = __ldg(other + off);
      }
    }
    const float* H = sH + r * S * S;
#pragma unroll
    for (int i = 0; i < SMAX; ++i) {
      if (i < S) {
        float ta = 0.0f, tb = 0.0f;
#pragma unroll
        for (int j = 0; j < SMAX; ++j) {
          if (j < S) {
            const float h = H[i * S + j];
            ta = fmaf(h, a[j], ta);
            tb = fmaf(h, o[j], tb);
          }
        }
        c[i] = ta * tb;
      }
    }
#pragma unroll
    for (int k = 0; k < SMAX; ++k)
      if (k < S) a[k] = __ldg(sub + (size_t)(r * S + k) * T);
    const float* L = sL + r * S * S;
    const float* E = sE + r * S * S;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        float lef = 0.0f, rig = 0.0f;
#pragma unroll
        for (int k = 0; k < SMAX; ++k) {
          if (k < S) {
            lef = fmaf(L[j * S + k], c[k], lef);
            rig = fmaf(E[j * S + k], a[k], rig);
          }
        }
        const int q = r * S + j;
        const float4 e = se[q];
        const float val = lef * rig;
        lk0 = fmaf(val, e.x, lk0);
        if (derivs) {
          lk1 = fmaf(val, e.y, lk1);
          lk2 = fmaf(val, e.z, lk2);
        }
        if constexpr (KEEP) st[(size_t)q * st_stride] = val;
      }
    }
  }
}

"""
REGS_PREFETCH = """  // the next rate category's three rows load while this one's products run
  lk0 = lk1 = lk2 = 0.0f;
  float a[SMAX], o[SMAX], b[SMAX];
  auto load = [&](int r, float (&x)[SMAX], float (&y)[SMAX],
                  float (&z)[SMAX]) {
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        const size_t off = (size_t)(r * S + j) * T;
        x[j] = __ldg(away + off);
        y[j] = __ldg(other + off);
        z[j] = __ldg(sub + off);
      }
    }
  };
  load(0, a, o, b);
  for (int r = 0; r < R; ++r) {
    float na[SMAX], no[SMAX], nb[SMAX];
    if (r + 1 < R) load(r + 1, na, no, nb);
    float c[SMAX];
    const float* H = sH + r * S * S;
#pragma unroll
    for (int i = 0; i < SMAX; ++i) {
      if (i < S) {
        float ta = 0.0f, tb = 0.0f;
#pragma unroll
        for (int j = 0; j < SMAX; ++j) {
          if (j < S) {
            const float h = H[i * S + j];
            ta = fmaf(h, a[j], ta);
            tb = fmaf(h, o[j], tb);
          }
        }
        c[i] = ta * tb;
      }
    }
    const float* L = sL + r * S * S;
    const float* E = sE + r * S * S;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        float lef = 0.0f, rig = 0.0f;
#pragma unroll
        for (int k = 0; k < SMAX; ++k) {
          if (k < S) {
            lef = fmaf(L[j * S + k], c[k], lef);
            rig = fmaf(E[j * S + k], b[k], rig);
          }
        }
        const int q = r * S + j;
        const float4 e = se[q];
        const float val = lef * rig;
        lk0 = fmaf(val, e.x, lk0);
        if (derivs) {
          lk1 = fmaf(val, e.y, lk1);
          lk2 = fmaf(val, e.z, lk2);
        }
        if constexpr (KEEP) st[(size_t)q * st_stride] = val;
      }
    }
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      a[j] = na[j];
      o[j] = no[j];
      b[j] = nb[j];
    }
  }
}

"""
# name -> (source file, ((old, new), ...)); every `old` occurs exactly once
PATCHES = {
    "one_cta_an_sm": ("edge_score.cu", (
        (BOUND, "__global__ void __launch_bounds__(THREADS)"),)),
    "two_ctas_an_sm": ("edge_score.cu", (
        (CTAS_GENERIC, CTAS_GENERIC.replace("= 4", "= 2")),)),
    "three_ctas_an_sm": ("edge_score.cu", (
        (CTAS, CTAS.replace("= 2", "= 3")),)),
    # the scorer's generic-state form as first written: pass 0's columns
    # staged in shared memory, every pass one site a thread, no register
    # bound; then each of the three choices of its redesign undone alone
    "generic_scorer_first": ("edge_score.cu", SCRATCH + (
        (PASSES_V4, PASSES_V4.replace("SMAX > 0", "false")),
        (BOUND, "__global__ void __launch_bounds__(THREADS, V == 4 ? 2 : "
                "1)"))),
    "generic_scratch": ("edge_score.cu", SCRATCH),
    "generic_passes_v1": ("edge_score.cu", (
        (PASSES_V4, PASSES_V4.replace("SMAX > 0", "false")),)),
    "generic_three_ctas": ("edge_score.cu", (
        (CTAS_GENERIC, CTAS_GENERIC.replace("= 4", "= 3")),)),
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
    "generic_all_forms": ("tree_sweep_generic.cu", ALL_FORMS),
    "generic_one_site": ("tree_sweep_generic.cu", (
        (GENERIC_SITES, GENERIC_SITES.replace("= 2", "= 1")),) + ALL_FORMS),
    "generic_prefetch": ("edge_score.cu", ((REGS_BODY, REGS_PREFETCH),)),
    "generic_p_l1": ("tree_sweep_generic.cu", (
        (GENERIC_STAGE, GENERIC_STAGE.replace("73728", "0")),) + ALL_FORMS),
    "generic_bounds": ("tree_sweep_generic.cu", BOUNDS + ALL_FORMS),
    "generic_bounds_l1": ("tree_sweep_generic.cu", BOUNDS + ALL_FORMS + (
        (GENERIC_STAGE, GENERIC_STAGE.replace("73728", "0")),)),
    "generic_bounds_cta": ("tree_sweep_generic.cu", BOUNDS + ALL_FORMS + (
        (GENERIC_STAGE, GENERIC_STAGE.replace("73728", "0")),
        WARP_BARRIER)),
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


def variant_libraries(names) -> dict:
    """{name: (library, BuildInfo)} of `variant_library` for each name,
    built side by side (each build runs its own nvcc processes)."""
    with concurrent.futures.ThreadPoolExecutor(max(len(names), 1)) as pool:
        futures = {name: pool.submit(variant_library, name)
                   for name in names}
        return {name: future.result() for name, future in futures.items()}


@contextlib.contextmanager
def launching_from(lib):
    """Inside the block the package's wrappers launch from `lib`."""
    real = _build.library
    _build.library = lambda build_dir=None, source_dir=None: lib
    try:
        yield
    finally:
        _build.library = real


@contextlib.contextmanager
def scratch_on_host(on: bool):
    """Inside the block (where `on`) ops/edge_score.py sizes the scorer's
    shared memory as a library built with SCRATCH needs it: 3 * S words a
    thread more at the generic state counts (the patch's scratch_floats)."""
    from ..ops import edge_score
    from ..ops.partials_tree import FMA_STATES

    real = edge_score.resident_smem_bytes, edge_score.reread_smem_bytes
    if on:
        def extra(states):
            return 0 if states in FMA_STATES else \
                4 * 3 * states * edge_score.THREADS
        edge_score.resident_smem_bytes = lambda R, S, T, k: \
            real[0](R, S, T, k) + extra(S)
        edge_score.reread_smem_bytes = lambda R, S: real[1](R, S) + extra(S)
    try:
        yield
    finally:
        edge_score.resident_smem_bytes, edge_score.reread_smem_bytes = real


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


def round_chunks(device, inputs=None):
    """The edge scorer's arguments for every chunk of one full-width search
    round (chip_smoke.search_inputs, or `inputs` of the same form, radius
    5), one chunk at a time on the same recursion scratch: yields (args,
    log_thresh)."""
    cs = _chip_smoke()
    from .. import search_fast as sf
    from ..ops import edge_score

    _truth, start, chars, cfg, model = inputs or cs.search_inputs(device)
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


def round_ms(device, configs, libs=None, reps: int = 3, inputs=None,
             staged=None, scores=None) -> dict:
    """Summed medians (ms) of `reps` back-to-back launches per chunk of the
    round (`round_chunks`), for every (library name, form, cluster,
    newton_iters) in `configs`; cluster 0 leaves the size to
    edge_score.plan.  staged: the library names whose generic-state form
    stages pass 0's columns in shared memory (SCRATCH; edge_score's sizes
    follow them, scratch_on_host).  scores: a dict that gets every
    config's largest relative score difference from the first config's
    over the round."""
    from ..ops import edge_score

    libs = {None: _build.library()} if libs is None else libs
    total = dict.fromkeys(configs, 0.0)
    real_plan = edge_score.plan
    try:
        for args, log_thresh in round_chunks(device, inputs):
            first = None
            for config in configs:
                name, form, cluster, iters = config
                edge_score.plan = real_plan if not cluster else (
                    lambda R, S, T, limit=0, k=cluster: ("resident", k))

                def call():
                    return edge_score.edge_scores(
                        *args, newton_iters=iters, log_thresh=log_thresh,
                        form=form)
                with launching_from(libs[name]), \
                        scratch_on_host(name in (staged or ())):
                    total[config] += _median_ms(call, reps)
                    if scores is not None:
                        got = call()[0]
                        first = got if first is None else first
                        live = torch.isfinite(first)
                        diff = ((got - first).abs() / first.abs().clamp_min(
                            1e-30))[live].max().item() if live.any() else 0.0
                        scores[config] = max(scores.get(config, 0.0), diff)
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


def run_generic_blocks(device, card, emit=print):
    """The generic form (csrc/tree_sweep_generic.cu) at its 5- and
    32-state shapes, f32 and bf16, at every site block that fits, two runs
    of 30 launches back to back: what pick_site_block gives it rests on."""
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree

    limit = _build.max_shared_memory(device)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for states, tips, sites in ((5, cs.ODD5_TIPS, cs.ODD5_SITES),
                                    (32, cs.ODD32_TIPS, cs.ODD32_SITES)):
            cfg, program, model, bl, tipchars, *_ = cs.odd_case(
                tips, sites, states, device, dtype)
            prog = program.vmem_prog
            pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
            picked = partials_tree.pick_site_block(prog, cfg, limit,
                                                   sm_count=sm_count)
            for tb in partials_tree.fitting_blocks(prog, cfg, limit):
                tip_b = engine.block_tips(tipchars, cfg, tb)
                ms = [cs.cuda_ms_back_to_back(lambda: partials_tree.sweep(
                    tip_b, pmatrix, prog, cfg, tb), 30) for _ in range(2)]
                emit(f"[generic_blocks] {states} states, {tips} x {sites}, "
                     f"{str(dtype).replace('torch.', '')}, site block {tb} "
                     f"({partials_tree.fma_threads(cfg, tb)} threads, "
                     f"{partials_tree.smem_bytes(prog, cfg, tb)} bytes; "
                     f"pick_site_block {picked}): {ms[0]:.4f} / "
                     f"{ms[1]:.4f} ms ({card})")
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
    """The resident form under three register bounds: the 4-state form
    (default two CTAs an SM) over the DNA round on clusters of 4, the
    5-state generic form (default three) over the 5-state round at the
    cluster `plan` gives."""
    names = ("one_cta_an_sm", "two_ctas_an_sm", "three_ctas_an_sm")
    libs = {}
    for name, (libs[name], info) in variant_libraries(names).items():
        entry = ""
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif ("resident_kernelILi4ELi4" in entry
                  or "resident_kernelILi0ELi4ELi0ELi8" in entry) and (
                    "registers" in line or "spill" in line):
                emit(f"[registers] {name} {entry.split('_kernel')[-1][:20]}"
                     f": {line.strip()}")
    configs = [(name, "resident", 4, iters) for name in names
               for iters in (0, 3)]
    for (name, _, cluster, iters), ms in round_ms(device, configs,
                                                  libs).items():
        emit(f"[registers] edge scorer, resident on clusters of {cluster}, "
             f"{name}, {iters} Newton steps: {ms:.4f} ms over the round "
             f"({card})")
    odd = _chip_smoke().odd_search_inputs(device, 5)
    configs = [(name, None, 0, 3) for name in names]
    for (name, _, _, iters), ms in round_ms(device, configs, libs,
                                            inputs=odd).items():
        emit(f"[registers] edge scorer, 5 states (generic form), {name}, "
             f"{iters} Newton steps: {ms:.4f} ms over the round ({card})")


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
        # use_kernel=True: a case no form takes raises with the reason
        tb, _ = engine.kernel_choice(
            program, dataclasses.replace(cfg, sweep_mode="fma",
                                         use_kernel=True), device)
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


def generic_sweep_forms(device, card, emit=print, shapes=None, reps=30):
    """The generic-state sweep's forms at full width, in turns (each form,
    then each again in reverse order), `reps` launches back to back a turn:
    "scalar" (the first generic form, a thread a column: generic_groups
    forced to 0; variant generic_all_forms, whose library holds it,
    probes/generic_scalar_form.cu), "row groups" (the package's), "row
    groups x2" (twice the groups, half the rows a thread, where a warp
    holds a site's), "P through L1" (variant generic_p_l1: nothing
    staged), "one site a thread" (variant generic_one_site: up to 8 states
    too).  Each form's rows are held bit-equal to the package's
    (unblocked: the forms may take other site blocks).  shapes: {name:
    (states, tips, sites, dtype, rates)}; by default 5 and 32 states at
    four rates, f32 and bf16, and 32 states at 12 rates (a site's row
    groups over two warps) in f32.  Returns {(name, form): [ms, ...]}."""
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree as pt

    shapes = shapes or {
        f"{name} {dt}".replace("torch.", ""): (states, tips, sites, dt, 4)
        for dt in (torch.float32, torch.bfloat16)
        for name, states, tips, sites in (
            ("odd5", 5, cs.ODD5_TIPS, cs.ODD5_SITES),
            ("odd32", 32, cs.ODD32_TIPS, cs.ODD32_SITES))} | {
        f"odd32_r{cs.ODD32_WARPS_RATES} float32": (
            32, cs.ODD32_TIPS, cs.ODD32_SITES, torch.float32,
            cs.ODD32_WARPS_RATES)}
    built = variant_libraries(["generic_all_forms", "generic_p_l1",
                               "generic_one_site"])
    real, two = pt.generic_groups, pt.GENERIC_SITES_A_THREAD

    def doubled(cfg):
        groups = real(cfg)
        ok = groups and 2 * groups * pt.rate_lanes(cfg.rate_cats) <= 32
        return 2 * groups if ok else groups
    # form: (generic_groups, library, sites a thread up to 8 states)
    forms = {"scalar": (lambda cfg: 0, built["generic_all_forms"][0], two),
             "row groups": (real, None, two),
             "row groups x2": (doubled, None, two),
             "P through L1": (real, built["generic_p_l1"][0], two),
             "one site a thread": (real, built["generic_one_site"][0], 1)}
    found = {}
    for name, (states, tips, sites, dtype, rates) in shapes.items():
        cfg, program, model, bl, tipchars, *_ = cs.odd_case(
            tips, sites, states, device, dtype, rates=rates)
        prog = program.vmem_prog
        pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
        rows, blocks = {}, {}
        for form in list(forms) + list(forms)[::-1]:
            groups, lib, pt.GENERIC_SITES_A_THREAD = forms[form]
            pt.generic_groups = groups
            try:
                tb, _ = engine.kernel_choice(
                    program, dataclasses.replace(cfg, use_kernel=True),
                    device)
                tips_b = engine.block_tips(tipchars, cfg, tb)
                with launching_from(lib or _build.library()):
                    def call():
                        return pt.sweep(tips_b, pmatrix, prog, cfg, tb)
                    out = call()[0]
                    rows[form] = out.permute(0, 2, 3, 1, 4).reshape(
                        out.shape[0], out.shape[2], out.shape[3], -1)
                    found.setdefault((name, form), []).append(
                        cs.cuda_ms_back_to_back(call, reps))
                blocks[form] = (tb, pt.fma_threads(cfg, tb))
            finally:
                pt.generic_groups = real
                pt.GENERIC_SITES_A_THREAD = two
        torch.cuda.synchronize()
        emit(f"[generic_sweep] {name}, {tips} x {sites}, {states} states, "
             f"{rates} rates: "
             + "; ".join(f"{form} {min(found[(name, form)]):.4f} ms (turns "
                         + ", ".join(f"{t:.4f}" for t in found[(name, form)])
                         + f"; site block {blocks[form][0]}, "
                         f"{blocks[form][1]} threads; rows bit-equal "
                         f"{torch.equal(rows[form], rows['row groups'])})"
                         for form in forms) + f" ({card})")
        del pmatrix, rows
        torch.cuda.empty_cache()
    return found


def run_generic_sweep(device, card, emit=print):
    generic_sweep_forms(device, card, emit)


# run_generic_bounds' cases: (states, rates, per-rate scalers), each at
# f32 and bf16 (row groups G = 1, 1, 2, 2, 4, 4, 4, 2, 1, 4, 2 and 4; one
# to eight rows a group; two sites a thread up to 8 states; 32 states at 8
# and 12 rates read P through L1; the last three span warps, two of them
# with the per-site rescue across warps)
BOUNDS_CASES = ((5, 4, False), (8, 4, True), (9, 4, False), (15, 4, True),
                (17, 4, False), (32, 4, True), (32, 8, False),
                (12, 16, True), (3, 1, False), (32, 12, False),
                (9, 32, False), (32, 32, True))


def run_generic_bounds(device, card, emit=print):
    """The generic sweep's row-group form built with its accesses checked
    (BOUNDS: every shared-memory access against the block's dynamic shared
    memory, every P read against the thread's block), in three libraries:
    generic_bounds (the package's staging choice), generic_bounds_l1 (P
    through L1 at every case, so the form whose pool words a warp barrier
    alone orders) and generic_bounds_cta (that one with a CTA barrier in
    place of the warp barrier: the race reference).  Every case of
    BOUNDS_CASES on chip_smoke.py's phase-25 trees (a random ODD_TIPS-taxon
    tree x ODD_SITES, branch lengths x 30, so that sites rescue), at f32
    and bf16, at the smallest site block that fits and at the one `choose`
    takes, three launches each from each library and from the package's:
    the checks' failures (0 expected), and every library's rows bit-equal
    to the package's first and to themselves; the package's rows against
    sweep_reference.  Then the two full-width shapes (5 states 256 x
    65,536, 32 states 128 x 16,384, f32 and bf16) once each on
    generic_bounds."""
    cs = _chip_smoke()
    from .. import engine
    from ..ops import partials_tree as pt
    from ..tree.generate import random_newick

    names = ("generic_bounds", "generic_bounds_l1", "generic_bounds_cta")
    libs = {name: lib for name, (lib, _info) in
            variant_libraries(names).items()}
    for lib in libs.values():
        lib.dbg_bounds.argtypes = [ctypes.c_void_p, ctypes.c_int]
    limit = _build.max_shared_memory(device)
    counts = np.zeros(3, dtype=np.uint64)

    def read(lib):
        err = lib.dbg_bounds(counts.ctypes.data, 1)
        if err != 0:
            raise RuntimeError(f"dbg_bounds: CUDA error {err}")
        return counts.copy()

    failures = checked = 0
    rng = np.random.default_rng(2614)
    for i, (states, rates, per_rate) in enumerate(BOUNDS_CASES):
        newick = random_newick(cs.ODD_TIPS, rng)
        for dtype in (torch.float32, torch.bfloat16):
            cfg, program, _pmat, _tips, chosen = cs.sweep_inputs(
                newick, cs.ODD_SITES, 500 + i, device, states=states,
                rates=rates, per_rate=per_rate, bl_scale=30.0,
                random_model=True, dtype=dtype)
            prog = program.vmem_prog
            blocks = sorted({pt.fitting_blocks(prog, cfg, limit)[-1],
                             chosen})
            del _pmat, _tips
            for tb in blocks:
                cfg, program, pmatrix, tip_b, tb = cs.sweep_inputs(
                    newick, cs.ODD_SITES, 500 + i, device, states=states,
                    rates=rates, per_rate=per_rate, bl_scale=30.0,
                    random_model=True, dtype=dtype, tb=tb)
                want = pt.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
                first = pt.sweep(tip_b, pmatrix, prog, cfg, tb)
                if dtype == torch.bfloat16:
                    rel, mism, comp, _abs = cs.compare_rows_site(
                        first[0], want[0], first[1], want[1])
                    plain = rel <= cs.BF16_ROW_BOUND and \
                        comp <= cs.BF16_ROW_BOUND
                else:
                    _abs, mism, rel = cs.compare_rows(first[0], want[0],
                                                      first[1], want[1])
                    plain = mism == 0 and rel <= cs.CLV_RTOL
                same, bad = {}, {}
                for name, lib in (("package", None),) + tuple(libs.items()):
                    with launching_from(lib or _build.library()):
                        if lib is not None:
                            read(lib)
                        outs = [pt.sweep(tip_b, pmatrix, prog, cfg, tb)
                                for _r in range(3)]
                        torch.cuda.synchronize()
                        if lib is not None:
                            bad[name] = read(lib)
                    same[name] = all(torch.equal(o[0], first[0]) and
                                     torch.equal(o[1], first[1])
                                     for o in outs)
                failures += sum(int(b[0] + b[1]) for b in bad.values())
                checked += sum(int(b[2]) for b in bad.values())
                emit(f"[generic_bounds] S={states} R={rates} "
                     f"{str(dtype).replace('torch.', '')} per_rate="
                     f"{per_rate} tb={tb} (blocks that fit "
                     f"{pt.fitting_blocks(prog, cfg, limit)}) groups="
                     f"{pt.generic_groups(cfg)} staged="
                     f"{pt.generic_staged(cfg)} threads="
                     f"{pt.fma_threads(cfg, tb)} pool={prog.pool_size}: "
                     + "; ".join(f"{n} shared-memory faults {int(b[0])}, P "
                                 f"faults {int(b[1])}, ops checked "
                                 f"{int(b[2])}" for n, b in bad.items())
                     + "; rows bit-equal to the package's, 3 runs each: "
                     + ", ".join(f"{n} {ok}" for n, ok in same.items())
                     + f"; package against plain within bounds {plain} "
                     f"(rel {rel:.3e}, {mism} scaler mismatches) ({card})")
                del pmatrix, tip_b, want, first, outs
    for states, tips, sites in ((5, cs.ODD5_TIPS, cs.ODD5_SITES),
                                (32, cs.ODD32_TIPS, cs.ODD32_SITES)):
        for dtype in (torch.float32, torch.bfloat16):
            cfg, program, model, bl, tipchars, *_ = cs.odd_case(
                tips, sites, states, device, dtype)
            prog = program.vmem_prog
            pmatrix = engine.pmatrix_buffer(program, cfg, model, bl)
            tb, _mode = engine.kernel_choice(
                program, dataclasses.replace(cfg, use_kernel=True), device)
            tip_b = engine.block_tips(tipchars, cfg, tb)
            first = pt.sweep(tip_b, pmatrix, prog, cfg, tb)
            lib = libs["generic_bounds"]
            with launching_from(lib):
                read(lib)
                out = pt.sweep(tip_b, pmatrix, prog, cfg, tb)
                torch.cuda.synchronize()
                b = read(lib)
            failures += int(b[0] + b[1])
            checked += int(b[2])
            emit(f"[generic_bounds] full width S={states} {tips} x {sites} "
                 f"{str(dtype).replace('torch.', '')} tb={tb} threads="
                 f"{pt.fma_threads(cfg, tb)} staged={pt.generic_staged(cfg)}"
                 f": shared-memory faults {int(b[0])}, P faults {int(b[1])}, "
                 f"ops checked {int(b[2])}; rows bit-equal to the package's "
                 f"{torch.equal(out[0], first[0])} ({card})")
            del pmatrix, tip_b, first, out
            torch.cuda.empty_cache()
    emit(f"[generic_bounds] all cases: {failures} faults in {checked} "
         f"checked ops ({card})")


def run_generic_scorer(device, card, emit=print):
    """The scorer's generic-state form over one full-width 5-state round
    (chip_smoke.odd_search_inputs) and a 32-state round on 64 taxa x 2,048
    sites, each at the cluster `plan` gives, 3 Newton steps: the package's
    form against its first one (generic_scorer_first), against each choice
    of its
    redesign undone alone (generic_scratch: pass 0's columns in shared
    memory; generic_passes_v1: the later passes one site a thread;
    two_ctas_an_sm and generic_three_ctas: registers bounded for two or
    three CTAs an SM, not four) and against one that was dropped
    (generic_prefetch: pass 0 loads the next rate's rows while it computes
    this one's), in turns; every score
    held to the package's; and the package's form with 0 and 3 Newton
    steps (what pass 0 and the score take)."""
    cs = _chip_smoke()
    names = ("generic_scorer_first", "generic_scratch", "generic_passes_v1",
             "two_ctas_an_sm", "generic_three_ctas", "generic_prefetch")
    libs = {None: _build.library()}
    for name, (libs[name], info) in variant_libraries(names).items():
        entry = ""
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "resident_kernelILi0E" in entry and (
                    "registers" in line or "spill" in line):
                emit(f"[generic_scorer] {name} "
                     f"{entry.split('_kernel')[-1][:24]}: {line.strip()}")
    staged = ("generic_scorer_first", "generic_scratch")
    order = (None,) + names
    for label, inputs in (
            ("5 states, full-width round",
             cs.odd_search_inputs(device, 5)),
            ("32 states, 64 x 2,048 round",
             cs.odd_search_inputs(device, 32, 64, 2048))):
        configs = [(name, None, 0, 3) for name in order + order[::-1]]
        turns, scores = {}, {}
        for config in configs:   # one config a pass keeps the turns apart
            # the package's form first in every pass: the scores' reference
            pair = [configs[0]] + ([config] if config != configs[0] else [])
            ms = round_ms(device, pair, libs, inputs=inputs, staged=staged,
                          scores=scores)
            turns.setdefault(config[0], []).append(ms[config])
        split = round_ms(device, [(None, None, 0, 0), (None, None, 0, 3)],
                         libs, inputs=inputs)
        emit(f"[generic_scorer] {label}: " + "; ".join(
            f"{name or 'package'} {min(turns[name]):.4f} ms (turns "
            + ", ".join(f"{t:.4f}" for t in turns[name])
            + f"; scores off the package's by "
              f"{scores.get((name, None, 0, 3), 0.0):.2e})"
            for name in order) + f"; the package's form with 0 Newton steps "
            f"(pass 0 and the score) {split[(None, None, 0, 0)]:.4f} ms, "
            f"with 3 {split[(None, None, 0, 3)]:.4f} ms ({card})")


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
               "static2_smem_a": run_static2_smem_a,
               "generic_sweep": run_generic_sweep,
               "generic_blocks": run_generic_blocks,
               "generic_bounds": run_generic_bounds,
               "generic_scorer": run_generic_scorer}


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
