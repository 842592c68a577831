// Fused SPR edge scorer: sumtable + Newton + logL per regraft slot, one CTA
// per slot.  Built with nvcc for sm_90a into the package's shared library
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
// What bounds it on an H100: each Newton round is a reduction over all T
// sites whose result feeds the next, so a slot is newton_iters + 1
// dependent passes.  The sumtable (R*S*T floats) does not fit in shared
// memory at T = 4096, so each pass recomputes it from the three message
// rows: 3*R*S*T*4 bytes read per pass (the candidate's sub row and popular
// facing rows hit L2), about 3*R*S*S FMAs per site and rate.  The kernel is
// bound by device-memory (and L2) bandwidth over those re-reads.
//
// What the design does about it:
//   * one CTA per slot, threads striding over sites: each pass is a
//     coalesced stream of the three rows, [R*S][T] with sites innermost;
//   * the per-site work runs one rate category at a time with S-sized
//     register arrays, so protein (S = 20) needs no spills;
//   * the per-slot constants (H, ML, EV blocks and e^{x t} terms) live in
//     shared memory; (d1, d2) reduce by warp shuffles, then one warp's sums;
//   * invalid (padding) slots exit at once: ball groups are padded to their
//     widest candidate, so many slots are padding.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
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
};

// (L, L', L'') of one site from the three rows at the current e-terms.
template <int S>
__device__ __forceinline__ void site_lk(const float* __restrict__ away,
                                        const float* __restrict__ other,
                                        const float* __restrict__ sub,
                                        size_t T, int R, const float* sH,
                                        const float* sL, const float* sE,
                                        const float* se0, const float* se1,
                                        const float* se2, bool derivs,
                                        float& lk0, float& lk1, float& lk2) {
  lk0 = lk1 = lk2 = 0.0f;
  for (int r = 0; r < R; ++r) {
    float a[S], o[S], sb[S], clvp[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const size_t off = (size_t)(r * S + j) * T;
      a[j] = __ldg(away + off);
      o[j] = __ldg(other + off);
      sb[j] = __ldg(sub + off);
    }
    const float* H = sH + r * S * S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float ta = 0.0f, tb = 0.0f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        ta = fmaf(H[i * S + j], a[j], ta);
        tb = fmaf(H[i * S + j], o[j], tb);
      }
      clvp[i] = ta * tb;
    }
    const float* L = sL + r * S * S;
    const float* E = sE + r * S * S;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float lef = 0.0f, rig = 0.0f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        lef = fmaf(L[j * S + k], clvp[k], lef);
        rig = fmaf(E[j * S + k], sb[k], rig);
      }
      const float st = lef * rig;
      const int q = r * S + j;
      lk0 = fmaf(st, se0[q], lk0);
      if (derivs) {
        lk1 = fmaf(st, se1[q], lk1);
        lk2 = fmaf(st, se2[q], lk2);
      }
    }
  }
}

// Sum (x, y) over the CTA; the result is valid in thread 0.  Ends with the
// CTA's warps past their writes to `red`.
__device__ __forceinline__ float2 block_sum2(float x, float y, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(x, y);
  __syncthreads();
  float2 tot = make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < NWARPS; ++w) {
      tot.x += red[w].x;
      tot.y += red[w].y;
    }
  }
  return tot;
}

// grid = cb * vg slots, block = THREADS.
// shared: red [NWARPS] float2, then H, ML, EV [R][S][S], then x, w0, e0,
// e1, e2 [R*S] f32.
template <int S>
__global__ void __launch_bounds__(THREADS) edge_score_kernel(Args a) {
  extern __shared__ float2 smem2[];
  __shared__ float s_t;
  const int tid = threadIdx.x;
  const int slot = blockIdx.x;               // c * vg + v
  const int c = slot / a.vg;
  const int R = a.rates;
  const int span = R * S;
  const int ss = S * S;
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

  float2* red = smem2;
  float* sH = reinterpret_cast<float*>(smem2 + NWARPS);
  float* sL = sH + R * ss;
  float* sE = sL + R * ss;
  float* sx = sE + R * ss;
  float* sw = sx + span;
  float* se0 = sw + span;
  float* se1 = se0 + span;
  float* se2 = se1 + span;

  const float* H = a.halves + (size_t)__ldg(op + OP_EDGE) * R * ss;
  for (int i = tid; i < R * ss; i += THREADS) {
    const int r = i / ss, j = (i % ss) / S, k = i % S;
    const size_t bd = (size_t)(r * S + j) * span + r * S + k;
    sH[i] = __ldg(H + i);
    sL[i] = __ldg(a.lbd + bd);
    sE[i] = __ldg(a.rbd + bd);
  }
  for (int q = tid; q < span; q += THREADS) {
    sx[q] = __ldg(a.xw + 2 * q);
    sw[q] = __ldg(a.xw + 2 * q + 1);
  }
  const size_t row = (size_t)span * T;
  const float* away =
      a.away + ((size_t)c * a.slots + __ldg(op + OP_PARENT)) * row;
  const int* away_sc =
      a.away_scal + ((size_t)c * a.slots + __ldg(op + OP_PARENT)) * T;
  const float* other = a.base + (size_t)__ldg(op + OP_SC_ROW) * row;
  const int* other_sc = a.base_scal + (size_t)__ldg(op + OP_SC_SCAL) * T;
  const float* sub = a.base + (size_t)__ldg(a.sub_rows + 2 * c) * row;
  const int* sub_sc = a.base_scal + (size_t)__ldg(a.sub_rows + 2 * c + 1) * T;
  if (tid == 0) s_t = t0;
  __syncthreads();

  for (int it = 0; it <= a.newton_iters; ++it) {
    const bool last = it == a.newton_iters;
    const float t = s_t;
    for (int q = tid; q < span; q += THREADS) {
      const float e = sw[q] * expf(sx[q] * t);
      se0[q] = e;
      se1[q] = sx[q] * e;
      se2[q] = sx[q] * sx[q] * e;
    }
    __syncthreads();
    float acc1 = 0.0f, acc2 = 0.0f;
    for (size_t site = tid; site < T; site += THREADS) {
      const float w = __ldg(a.pw + site);
      if (!(w > 0.0f)) continue;       // padding: weight 0, inert
      float lk0, lk1, lk2;
      site_lk<S>(away + site, other + site, sub + site, T, R, sH, sL, sE,
                 se0, se1, se2, !last, lk0, lk1, lk2);
      if (!last) {
        const float deriv1 = -lk1 / lk0;
        const float deriv2 = deriv1 * deriv1 - lk2 / lk0;
        acc1 += w * deriv1;
        acc2 += w * deriv2;
      } else {
        const int sc = __ldg(away_sc + site) + __ldg(other_sc + site) +
                       __ldg(sub_sc + site);
        acc1 += w * (logf(lk0) + (float)sc * a.log_thresh);
      }
    }
    const float2 tot = block_sum2(acc1, acc2, red);
    if (tid == 0) {
      if (!last) {
        const float d1 = tot.x, d2 = tot.y;
        const float newton = t - d1 / d2;
        const float fallback = d1 > 0.0f ? t * 0.5f : t * 2.0f;
        float tn = d2 > 0.0f ? newton : fallback;
        if (!isfinite(tn)) tn = t;
        s_t = fminf(fmaxf(tn, 1e-8f), 100.0f);
      } else {
        a.score[slot] = tot.x;
        a.t3[slot] = t;
      }
    }
    __syncthreads();
  }
}

template <int S>
cudaError_t launch(const Args& a, int n_slots, cudaStream_t stream) {
  const size_t smem = NWARPS * sizeof(float2) +
                      (size_t)(3 * a.rates * S * S + 5 * a.rates * S) *
                          sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        edge_score_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  edge_score_kernel<S><<<n_slots, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the scorer on `stream`; returns the cudaError_t of the launch.
// The kernel allocates nothing and does not synchronise.
int edge_score_launch(const float* away, const int* away_scal,
                      const float* base, const int* base_scal,
                      const float* halves, const int* ops,
                      const int* sub_rows, const float* t0, const float* lbd,
                      const float* rbd, const float* xw, const float* pw,
                      float* score, float* t3, int n_cand, int vg, int slots,
                      int rates, int states, int sites, int newton_iters,
                      float log_thresh, void* stream) {
  const Args a{away, away_scal, base, base_scal, halves, ops, sub_rows, t0,
               lbd, rbd, xw, pw, score, t3, vg, slots, rates, sites,
               newton_iters, log_thresh};
  const int n_slots = n_cand * vg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 2: return (int)launch<2>(a, n_slots, s);
    case 4: return (int)launch<4>(a, n_slots, s);
    case 10: return (int)launch<10>(a, n_slots, s);
    case 16: return (int)launch<16>(a, n_slots, s);
    case 20: return (int)launch<20>(a, n_slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
