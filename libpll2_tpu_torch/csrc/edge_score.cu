// Fused SPR edge scorer: sumtable + Newton + logL per regraft slot.  Built
// with nvcc for sm_90a into the package's shared library
// (libpll2_tpu_torch/_build.py) and launched through ctypes by
// libpll2_tpu_torch/ops/edge_score.py:edge_scores().
//
// Replaces the Pallas kernel of the JAX package
//   libpll2_tpu/ops/edge_score_pallas.py:_kernel (:54)
// and computes what it computes, per (candidate c, score slot v), over all
// T sites (x = eigenvalue * rate / (1 - pinv), w0 = rate weight * (1-pinv)):
//   ta[r,i] = sum_j H[r,i,j] away[r,j],  tb likewise with the facing row
//   st[r,j] = (sum_k ML[r,j,k] ta[r,k] tb[r,k]) * (sum_k EV[r,j,k] sub[r,k])
//   L^(n)   = sum_{r,j} st[r,j] * x^n * w0 * exp(x t)          (n = 0, 1, 2)
//   newton_iters times: d1 = sum_w -L'/L, d2 = sum_w (L'/L)^2 - L''/L over
//     live sites (pattern weight > 0); t <- d2 > 0 ? t - d1/d2
//     : (d1 > 0 ? t/2 : 2t); a non-finite step holds t; clip [1e-8, 100]
//   score   = sum_w (log L + (scalers of away + facing + sub) * log_thresh)
// Invalid slots (score-op VALID column != 1) write -inf and t3 = t0.
//
// Unlike the TPU kernel, it reads the facing base row, the half-P and the
// scaler rows by index from the op row (Pallas BlockSpecs take no dynamic
// row index, so the JAX wrapper copies them into slot order first), and it
// starts Newton from the real f32 branch length (the TPU kernel's 1e-7
// fixed point exists because Mosaic cannot bitcast SMEM scalars).
//
// What bounds it on an H100: bytes.  A slot is newton_iters + 1 dependent
// reductions over all T sites, each needing the slot's sumtable st
// (R*S*T floats: 256 KB for DNA with four rate categories at T = 4096).
// The least the card must move is each distinct message row once; a design
// that recomputes st from the three rows in every pass moves newton_iters +
// 1 times that, and a block's 227 KB of shared memory does not hold st.
//
// What the design does about it: two forms, chosen on the host by shape
// (ops/edge_score.py:plan), never one as the other's fallback.
//   * "resident" (edge_score_resident_kernel): a slot is scored by a
//     thread-block cluster of k CTAs (1, 2, 4 or 8) on neighbouring SMs.
//     CTA `rank` owns the sites [rank * stripe, (rank + 1) * stripe) and
//     keeps its stripe of st, [R*S][stripe] f32, in shared memory.  Pass 0
//     streams the three rows once (coalesced, sites innermost; four sites a
//     thread by 16-byte loads where the state count leaves the registers
//     for it), builds st, stores it on chip and takes the first Newton sums
//     from the registers it has; every later pass reads st only: 3*R*S FMAs
//     per site, no device memory.  (d1, d2) and the score reduce inside a
//     warp by shuffles; lane 0 of every warp then stores its sum into the
//     shared memory of every CTA of the cluster (distributed shared
//     memory), one cluster.sync() makes the stores visible, and every
//     thread adds, from its own shared memory, each stripe's warp sums and
//     then the stripes in rank order 0 .. k-1.  All CTAs therefore derive
//     the same next t from the same operands in the same order (no
//     broadcast), and a slot's result does not depend on where it ran.  The
//     sums are double-buffered by pass parity and the e-terms are kept once
//     per warp, so a pass has exactly one barrier, the cluster's.  The
//     candidate's sub row and the popular facing rows are shared by many
//     slots and are served by L2.
//   * "reread" (edge_score_kernel): one CTA per slot, st recomputed from the
//     three rows in every pass.  It serves the shapes whose stripe of st
//     does not fit a block even at k = 8 (protein beyond 5,056 sites under
//     the 232,448-byte limit).
// Both forms: the per-site work runs one rate category at a time with
// S-sized register arrays, so protein (S = 20) needs no spills; the per-slot
// constants (H, ML, EV blocks and e^{x t} terms) live in shared memory;
// invalid (padding) slots exit at once, the whole cluster of a slot together
// (ball groups are padded to their widest candidate, so many slots are
// padding).  The resident kernel's registers are bounded so that two CTAs
// share an SM: with one (142 registers a thread) a full-width round took
// 11.7 ms, with three (80, spilling) 9.2 ms, with two (128) 7.5 ms on an
// H100 at 700 W (probes/variants.py registers).
// The generic-state form (every state count without an instantiation of
// its own, S at run time up to SMAX 8, 16 or 32) was first one site a
// thread in every pass, with pass 0's site columns staged in shared memory
// (3 S words a thread: 96 KB a CTA at 32 states) and no register bound:
// 28.4-29.5 ms for a full-width 5-state round on an H100 at 700 W.  Now
// pass 0 holds the columns in registers (site_lk_regs, [SMAX] arrays), the
// later passes read the sumtable four sites a thread where the alignment
// allows, and the resident kernel's registers are bounded for four CTAs
// an SM (plan budgets shared memory for three; two above 8 states).
// probes/variants.py "generic_scorer" times each choice undone (its patch
// texts hold the first form's shared-memory pass 0), and the variants
// that were dropped are in PERF.md.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// THREADS, the cluster sums, the resident passes and the Newton step
#include "newton_passes.cuh"

namespace {

// The generic-state form (the state counts without an instantiation of
// their own): pass 0 holds a site's columns in registers (site_lk_regs);
// the resident form's later passes, which read only the sumtable, run four
// sites a thread wherever the alignment allows (else one); the resident
// kernel's registers are bounded for RESIDENT_CTAS_GENERIC CTAs an SM at
// up to 8 states (at least the three ops/edge_score.py:plan budgets shared
// memory for; four ran a 5-state round 5 % faster than three, spilling 40
// bytes), for RESIDENT_CTAS above.  probes/variants.py "generic_scorer"
// undoes each choice in a variant of its own.
constexpr int RESIDENT_CTAS = 2;
constexpr int RESIDENT_CTAS_GENERIC = 4;
// score-op columns (libpll2_tpu_torch/search_fast.py BOP_*)
constexpr int OP_COLS = 12;
constexpr int OP_PARENT = 0;
constexpr int OP_SC_ROW = 8;
constexpr int OP_SC_SCAL = 9;
constexpr int OP_EDGE = 10;
constexpr int OP_VALID = 11;

struct Args {
  const float* away;       // [cb, slots, R*S, T]
  const int* away_scal;    // [cb, slots, T]
  const float* base;       // [rows, R*S, T]
  const int* base_scal;    // [srows, T]
  const float* halves;     // [E, R, S, S]
  const int* ops;          // [cb, vg, OP_COLS]
  const int* sub_rows;     // [cb, 2]
  const float* t0;         // [cb]
  const float* lbd;        // [R*S, R*S] block-diagonal ML
  const float* rbd;        // [R*S, R*S] block-diagonal EV
  const float* xw;         // [R*S, 2]: x | w0
  const float* pw;         // [T]
  float* score;            // [cb, vg]
  float* t3;               // [cb, vg]
  int vg, slots, rates, sites, newton_iters;
  float log_thresh;
  int states;              // read by the generic-state form only
};

// The rows one slot reads.
struct Rows {
  const float *away, *other, *sub;
  const int *away_sc, *other_sc, *sub_sc;
};

__device__ __forceinline__ Rows slot_rows(const Args& a, const int* op, int c,
                                          int span) {
  const size_t T = (size_t)a.sites;
  const size_t row = (size_t)span * T;
  const size_t scratch = (size_t)c * a.slots + __ldg(op + OP_PARENT);
  Rows r;
  r.away = a.away + scratch * row;
  r.away_sc = a.away_scal + scratch * T;
  r.other = a.base + (size_t)__ldg(op + OP_SC_ROW) * row;
  r.other_sc = a.base_scal + (size_t)__ldg(op + OP_SC_SCAL) * T;
  r.sub = a.base + (size_t)__ldg(a.sub_rows + 2 * c) * row;
  r.sub_sc = a.base_scal + (size_t)__ldg(a.sub_rows + 2 * c + 1) * T;
  return r;
}

// The per-slot constants: H, ML, EV [R][S][S] and x, w0 [R*S], consecutive
// from sH.  The caller synchronises.  S is a compile-time constant where the
// kernel is specialised for it (the call is inlined and folds it).
__device__ __forceinline__ void load_constants(const Args& a, const int* op,
                                               float* sH, int S) {
  const int R = a.rates, span = R * S, ss = S * S;
  float* sL = sH + R * ss;
  float* sE = sL + R * ss;
  float* sx = sE + R * ss;
  float* sw = sx + span;
  const float* H = a.halves + (size_t)__ldg(op + OP_EDGE) * R * ss;
  for (int i = threadIdx.x; i < R * ss; i += THREADS) {
    const int r = i / ss, j = (i % ss) / S, k = i % S;
    const size_t bd = (size_t)(r * S + j) * span + r * S + k;
    sH[i] = __ldg(H + i);
    sL[i] = __ldg(a.lbd + bd);
    sE[i] = __ldg(a.rbd + bd);
  }
  for (int q = threadIdx.x; q < span; q += THREADS) {
    sx[q] = __ldg(a.xw + 2 * q);
    sw[q] = __ldg(a.xw + 2 * q + 1);
  }
}

// (L, L', L'') of V consecutive sites from the three rows at the current
// e-terms se[q] = (e, x e, x^2 e, -).  KEEP: also store the sites' sumtable
// columns to st[q * st_stride ..].  RC > 0: the number of rate categories,
// known at compile time, so that the loop over them unrolls and the next
// category's loads are in flight during this one's products.
template <int S, int V, int RC, bool KEEP>
__device__ __forceinline__ void site_lk(const float* __restrict__ away,
                                        const float* __restrict__ other,
                                        const float* __restrict__ sub,
                                        size_t T, int R, const float* sH,
                                        const float* sL, const float* sE,
                                        const float4* se, bool derivs,
                                        float* st, int st_stride,
                                        float (&lk0)[V], float (&lk1)[V],
                                        float (&lk2)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) lk0[v] = lk1[v] = lk2[v] = 0.0f;
  auto rate = [&](int r) {
    float a[S][V], o[S][V], sb[S][V], clvp[S][V];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const size_t off = (size_t)(r * S + j) * T;
      load_sites<V>(away + off, a[j]);
      load_sites<V>(other + off, o[j]);
      load_sites<V>(sub + off, sb[j]);
    }
    const float* H = sH + r * S * S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float ta[V], tb[V];
#pragma unroll
      for (int v = 0; v < V; ++v) ta[v] = tb[v] = 0.0f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float h = H[i * S + j];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          ta[v] = fmaf(h, a[j][v], ta[v]);
          tb[v] = fmaf(h, o[j][v], tb[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) clvp[i][v] = ta[v] * tb[v];
    }
    const float* L = sL + r * S * S;
    const float* E = sE + r * S * S;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float lef[V], rig[V];
#pragma unroll
      for (int v = 0; v < V; ++v) lef[v] = rig[v] = 0.0f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float l = L[j * S + k], e = E[j * S + k];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          lef[v] = fmaf(l, clvp[k][v], lef[v]);
          rig[v] = fmaf(e, sb[k][v], rig[v]);
        }
      }
      const int q = r * S + j;
      const float4 e = se[q];
      float val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        val[v] = lef[v] * rig[v];
        lk0[v] = fmaf(val[v], e.x, lk0[v]);
        if (derivs) {
          lk1[v] = fmaf(val[v], e.y, lk1[v]);
          lk2[v] = fmaf(val[v], e.z, lk2[v]);
        }
      }
      if constexpr (KEEP) {
        float* dst = st + (size_t)q * st_stride;
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(val[0], val[1], val[2], val[3]);
        else
          dst[0] = val[0];
      }
    }
  };
  if constexpr (RC > 0) {
#pragma unroll
    for (int r = 0; r < RC; ++r) rate(r);
  } else {
    for (int r = 0; r < R; ++r) rate(r);
  }
}

// The generic-state form of site_lk at one site with the site's columns in
// registers: a, o [SMAX] (the away and facing rows of a rate category), c
// [SMAX] their half-branch product, then the sub row over a; the state
// count S at run time, every loop unrolled to SMAX with S as its bound.
// The sums run over j (and k) in the order site_lk's do, so the values are
// theirs to the bit.
template <int SMAX, bool KEEP>
__device__ __forceinline__ void site_lk_regs(
    const float* __restrict__ away, const float* __restrict__ other,
    const float* __restrict__ sub, size_t T, int R, int S, const float* sH,
    const float* sL, const float* sE, const float4* se, bool derivs,
    float* st, int st_stride, float& lk0, float& lk1, float& lk2) {
  lk0 = lk1 = lk2 = 0.0f;
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

// The live sites' share of the pass's sums: (w d1, w d2) in a Newton pass,
// the weighted log-likelihood with its scalers in the last.  A site of
// weight 0 is padding and adds nothing (its L may be 0).
template <int V>
__device__ __forceinline__ void accumulate(bool last, const float (&w)[V],
                                           const float (&lk0)[V],
                                           const float (&lk1)[V],
                                           const float (&lk2)[V],
                                           const Rows& rows, size_t site,
                                           float log_thresh, float& acc1,
                                           float& acc2) {
  if (!last) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!(w[v] > 0.0f)) continue;
      const float deriv1 = -lk1[v] / lk0[v];
      const float deriv2 = deriv1 * deriv1 - lk2[v] / lk0[v];
      acc1 += w[v] * deriv1;
      acc2 += w[v] * deriv2;
    }
  } else {
    int s1[V], s2[V], s3[V];
    load_sites<V>(rows.away_sc + site, s1);
    load_sites<V>(rows.other_sc + site, s2);
    load_sites<V>(rows.sub_sc + site, s3);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!(w[v] > 0.0f)) continue;
      acc1 += w[v] * (logf(lk0[v]) +
                      (float)(s1[v] + s2[v] + s3[v]) * log_thresh);
    }
  }
}

// Floats of shared memory of the two forms, before the resident form's
// sumtable stripe.  "reread": red [NWARPS] float2, the e-terms [R*S] float4,
// then H, ML, EV [R][S][S] and x, w0 [R*S].  "resident": sums [2][MAX_CLUSTER]
// [NWARPS] float2 (every warp's sum of every CTA of the cluster, by pass
// parity), the e-terms [NWARPS][R*S] float4 (a copy per warp, so that no
// pass needs a CTA-wide barrier of its own), then the same constants;
// rounded up to 16 bytes.
__host__ __device__ constexpr int const_floats(int R, int S) {
  return 3 * R * S * S + 2 * R * S;
}
__host__ __device__ constexpr int reread_floats(int R, int S) {
  return 2 * NWARPS + 4 * R * S + const_floats(R, S);
}
__host__ __device__ constexpr int resident_head_floats(int R, int S) {
  return (SUM_FLOATS + 4 * NWARPS * R * S + const_floats(R, S) + 3) / 4 * 4;
}

// The "reread" form.  grid = cb * vg slots, block = THREADS.  SMAX > 0: the
// generic-state form, S = a.states at run time (S = 0 in the template).
template <int S, int SMAX = 0>
__global__ void __launch_bounds__(THREADS) edge_score_kernel(Args a) {
  extern __shared__ float4 smem4[];
  __shared__ float s_t;
  const int Sn = SMAX > 0 ? a.states : S;
  const int tid = threadIdx.x;
  const int slot = blockIdx.x;               // c * vg + v
  const int c = slot / a.vg;
  const int R = a.rates;
  const int span = R * Sn;
  const int ss = Sn * Sn;
  const size_t T = (size_t)a.sites;
  const int* op = a.ops + (size_t)slot * OP_COLS;
  const float t0 = __ldg(a.t0 + c);
  if (__ldg(op + OP_VALID) != 1) {
    if (tid == 0) {
      a.score[slot] = -INFINITY;
      a.t3[slot] = t0;
    }
    return;
  }

  float* smem = reinterpret_cast<float*>(smem4);
  float4* se = smem4;
  float2* red = reinterpret_cast<float2*>(smem + 4 * span);
  float* sH = smem + 4 * span + 2 * NWARPS;
  float* sL = sH + R * ss;
  float* sE = sL + R * ss;
  float* sx = sE + R * ss;
  float* sw = sx + span;
  load_constants(a, op, sH, Sn);
  const Rows rows = slot_rows(a, op, c, span);
  if (tid == 0) s_t = t0;
  __syncthreads();

  for (int it = 0; it <= a.newton_iters; ++it) {
    const bool last = it == a.newton_iters;
    const float t = s_t;
    for (int q = tid; q < span; q += THREADS) se[q] = e_term(sx[q], sw[q], t);
    __syncthreads();
    float acc1 = 0.0f, acc2 = 0.0f;
    for (size_t site = tid; site < T; site += THREADS) {
      float w[1], lk0[1], lk1[1], lk2[1];
      load_sites<1>(a.pw + site, w);
      if (!any_live(w)) continue;      // padding: weight 0, inert
      if constexpr (SMAX > 0)
        site_lk_regs<SMAX, false>(rows.away + site, rows.other + site,
                                  rows.sub + site, T, R, Sn, sH, sL, sE, se,
                                  !last, nullptr, 0, lk0[0], lk1[0], lk2[0]);
      else
        site_lk<S, 1, 0, false>(rows.away + site, rows.other + site,
                                rows.sub + site, T, R, sH, sL, sE, se, !last,
                                nullptr, 0, lk0, lk1, lk2);
      accumulate<1>(last, w, lk0, lk1, lk2, rows, site, a.log_thresh, acc1,
                    acc2);
    }
    const float2 mine = warp_sum2(acc1, acc2);
    if ((tid & 31) == 0) red[tid >> 5] = mine;
    __syncthreads();
    if (tid == 0) {
      float2 tot = make_float2(0.0f, 0.0f);
      for (int w = 0; w < NWARPS; ++w) {
        tot.x += red[w].x;
        tot.y += red[w].y;
      }
      if (!last) {
        s_t = newton_step<true>(t, tot.x, tot.y, 1e-8f, 100.0f);
      } else {
        a.score[slot] = tot.x;
        a.t3[slot] = t;
      }
    }
    __syncthreads();
  }
}

// The "resident" form.  grid = cb * vg slots * k CTAs in clusters of k along
// x, block = THREADS.  V sites per thread and step (4: 16-byte loads; the
// host checks the alignment), RC as in site_lk.  shared: the head as above,
// then the CTA's stripe of the sumtable, st [R*S][stripe] f32.  SMAX > 0:
// the generic-state form (S = 0, RC = 0): pass 0 at one site a thread and
// step (site_lk_regs), the later passes at V.
template <int S, int V, int RC, int SMAX = 0>
__global__ void __launch_bounds__(THREADS, SMAX > 0 && SMAX <= 8
                                               ? RESIDENT_CTAS_GENERIC
                                           : V == 4 || SMAX > 0
                                               ? RESIDENT_CTAS
                                               : 1)
edge_score_resident_kernel(Args a, int stripe) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = blockIdx.x / k;           // c * vg + v
  const int c = slot / a.vg;
  const int R = RC > 0 ? RC : a.rates;
  const int Sn = SMAX > 0 ? a.states : S;
  const int span = R * Sn;
  const int ss = Sn * Sn;
  const size_t T = (size_t)a.sites;
  const int* op = a.ops + (size_t)slot * OP_COLS;
  const float t0 = __ldg(a.t0 + c);
  if (__ldg(op + OP_VALID) != 1) {           // the whole cluster leaves
    if (rank == 0 && tid == 0) {
      a.score[slot] = -INFINITY;
      a.t3[slot] = t0;
    }
    return;
  }

  float* smem = reinterpret_cast<float*>(smem4);
  float4* se = smem4 + warp * span;          // this warp's e-terms
  float2* sums = reinterpret_cast<float2*>(smem + 4 * NWARPS * span);
  float* sH = smem + 4 * NWARPS * span + SUM_FLOATS;
  float* sL = sH + R * ss;
  float* sE = sL + R * ss;
  float* sx = sE + R * ss;
  float* sw = sx + span;
  float* st = smem + resident_head_floats(R, Sn);
  load_constants(a, op, sH, Sn);
  const Rows rows = slot_rows(a, op, c, span);
  const size_t first = (size_t)rank * stripe;
  const size_t left = first < T ? T - first : 0;
  const int mine = left < (size_t)stripe ? (int)left : stripe;
  // the constants are in place, and every CTA of the cluster has started:
  // its shared memory may be written from outside
  cluster.sync();

  float t = t0;
  for (int it = 0; it <= a.newton_iters; ++it) {
    const bool last = it == a.newton_iters;
    for (int q = lane; q < span; q += 32) se[q] = e_term(sx[q], sw[q], t);
    __syncwarp();
    float acc1 = 0.0f, acc2 = 0.0f;
    // the passes that read the sumtable (and the specialised forms' pass
    // 0), V sites a thread and step
    auto v_pass = [&]() {
      for (int ls = tid * V; ls < mine; ls += THREADS * V) {
        const size_t site = first + ls;
        float w[V], lk0[V], lk1[V], lk2[V];
        load_sites<V>(a.pw + site, w);
        if (!any_live(w)) continue;      // padding: weight 0, inert
        if constexpr (SMAX == 0) {
          if (it == 0)
            site_lk<S, V, RC, true>(rows.away + site, rows.other + site,
                                    rows.sub + site, T, R, sH, sL, sE, se,
                                    !last, st + ls, stripe, lk0, lk1, lk2);
          else
            site_lk_resident<V>(st + ls, stripe, span, se, !last, lk0, lk1,
                                lk2);
        } else {
          site_lk_resident<V>(st + ls, stripe, span, se, !last, lk0, lk1,
                              lk2);
        }
        accumulate<V>(last, w, lk0, lk1, lk2, rows, site, a.log_thresh,
                      acc1, acc2);
      }
    };
    if constexpr (SMAX > 0) {
      if (it == 0) {
        // the generic form's pass 0, one site a thread and step: a padding
        // site's sumtable column stays unwritten, and the later passes
        // skip it by its weight
        for (int ls = tid; ls < mine; ls += THREADS) {
          const size_t site = first + ls;
          float w[1], lk0[1], lk1[1], lk2[1];
          load_sites<1>(a.pw + site, w);
          if (!any_live(w)) continue;
          site_lk_regs<SMAX, true>(rows.away + site, rows.other + site,
                                   rows.sub + site, T, R, Sn, sH, sL, sE, se,
                                   !last, st + ls, stripe, lk0[0], lk1[0],
                                   lk2[0]);
          accumulate<1>(last, w, lk0, lk1, lk2, rows, site, a.log_thresh,
                        acc1, acc2);
        }
      } else {
        v_pass();
      }
    } else {
      v_pass();
    }
    // the pass's sums over the cluster, in stripe order
    const float2 d = cluster_sum2(
        cluster, sums + (it & 1) * MAX_CLUSTER * NWARPS, k, rank, acc1, acc2);
    if (!last) {
      t = newton_step<true>(t, d.x, d.y, 1e-8f, 100.0f);
    } else if (rank == 0 && tid == 0) {
      a.score[slot] = d.x;
      a.t3[slot] = t;
    }
  }
  // the last remote store was before the last barrier: a CTA may leave
}

size_t resident_bytes(int rates, int S, int sites, int cluster) {
  const int stripe = (sites + cluster - 1) / cluster;
  return ((size_t)resident_head_floats(rates, S) +
          (size_t)rates * S * stripe) * sizeof(float);
}

size_t reread_bytes(int rates, int S) {
  return (size_t)reread_floats(rates, S) * sizeof(float);
}

template <class K>
cudaError_t launch_resident(K kernel, const Args& a, int n_slots, int S,
                            int cluster, cudaStream_t stream) {
  const int stripe = (a.sites + cluster - 1) / cluster;
  return launch_clusters(kernel, n_slots, cluster,
                         resident_bytes(a.rates, S, a.sites, cluster), stream,
                         a, stripe);
}

// cluster == 0: the "reread" form; else the "resident" form on clusters of
// `cluster` CTAs: four sites per thread and step where the state count is
// small enough for the registers, there are four rate categories and every
// row and stripe starts on 16 bytes, else one.  SMAX > 0 (S = 0): the
// generic-state form of either, pass 0 at one site per thread and step,
// the resident form's later passes at four where the sites, the stripe,
// the pattern weights and the scaler rows are 16-byte aligned (pass 0
// reads the message rows one site at a time, at any alignment), else one.
template <int S, int SMAX = 0>
cudaError_t launch(const Args& a, int n_slots, int cluster,
                   cudaStream_t stream) {
  const int Sn = SMAX > 0 ? a.states : S;
  if (cluster == 0) {
    const size_t smem = reread_bytes(a.rates, Sn);
    cudaError_t err = allow_shared(edge_score_kernel<S, SMAX>, smem);
    if (err != cudaSuccess) return err;
    edge_score_kernel<S, SMAX><<<n_slots, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
  if constexpr (S > 0 && S <= 4) {
    const int stripe = (a.sites + cluster - 1) / cluster;
    if (a.rates == 4 && a.sites % 4 == 0 && stripe % 4 == 0 &&
        aligned16(a.away) && aligned16(a.base) && aligned16(a.pw) &&
        aligned16(a.away_scal) && aligned16(a.base_scal))
      return launch_resident(edge_score_resident_kernel<S, 4, 4>, a, n_slots,
                             S, cluster, stream);
  }
  if constexpr (SMAX > 0) {
    const int stripe = (a.sites + cluster - 1) / cluster;
    if (a.sites % 4 == 0 && stripe % 4 == 0 && aligned16(a.pw) &&
        aligned16(a.away_scal) && aligned16(a.base_scal))
      return launch_resident(edge_score_resident_kernel<0, 4, 0, SMAX>, a,
                             n_slots, Sn, cluster, stream);
  }
  return launch_resident(edge_score_resident_kernel<S, 1, 0, SMAX>, a,
                         n_slots, Sn, cluster, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the resident form needs at
// `cluster` CTAs per slot (what ops/edge_score.py:plan computes on the host;
// the tests on the card hold the two against each other).
int edge_score_resident_smem(int rates, int states, int sites, int cluster) {
  return (int)resident_bytes(rates, states, sites, cluster);
}

// Launch the scorer on `stream`; returns the cudaError_t of the launch.
// cluster: 0 for the "reread" form, else 1, 2, 4 or 8 CTAs per slot for the
// "resident" form.  The kernels allocate nothing and do not synchronise.
int edge_score_launch(const float* away, const int* away_scal,
                      const float* base, const int* base_scal,
                      const float* halves, const int* ops,
                      const int* sub_rows, const float* t0, const float* lbd,
                      const float* rbd, const float* xw, const float* pw,
                      float* score, float* t3, int n_cand, int vg, int slots,
                      int rates, int states, int sites, int newton_iters,
                      float log_thresh, int cluster, void* stream) {
  const Args a{away, away_scal, base, base_scal, halves, ops, sub_rows, t0,
               lbd, rbd, xw, pw, score, t3, vg, slots, rates, sites,
               newton_iters, log_thresh, states};
  if (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4 &&
      cluster != 8)
    return (int)cudaErrorInvalidValue;
  const int n_slots = n_cand * vg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 2: return (int)launch<2>(a, n_slots, cluster, s);
    case 4: return (int)launch<4>(a, n_slots, cluster, s);
    case 10: return (int)launch<10>(a, n_slots, cluster, s);
    case 16: return (int)launch<16>(a, n_slots, cluster, s);
    case 20: return (int)launch<20>(a, n_slots, cluster, s);
    default: break;
  }
  // every other count of an int32 tip mask: the generic-state form
  if (states < 2 || states > 32) return (int)cudaErrorInvalidValue;
  if (states <= 8) return (int)launch<0, 8>(a, n_slots, cluster, s);
  if (states <= 16) return (int)launch<0, 16>(a, n_slots, cluster, s);
  return (int)launch<0, 32>(a, n_slots, cluster, s);
}

// Bytes of dynamic shared memory one CTA of the "reread" form needs (what
// ops/edge_score.py:reread_smem_bytes computes on the host).
int edge_score_reread_smem(int rates, int states) {
  return (int)reread_bytes(rates, states);
}

}  // extern "C"
