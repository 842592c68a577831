// All-directions message sweep over one site block per CTA, every message
// in device memory, the propagation as f32 FMAs: the card's form of
// libpll2_tpu_torch/engine.py:message_sweep (ops/message_sweep.py:
// sweep_messages).  Built with nvcc for sm_90a into the package's shared
// library with a plain C interface (libpll2_tpu_torch/_build.py) and
// launched through ctypes.
//
// It replaces no Pallas kernel: the JAX package leaves this sweep to XLA
// (libpll2_tpu/engine.py:message_sweep over ops/partials.py's level
// update).  The port ran it as plain PyTorch, about 22 launches a level and
// 640 a sweep of a 256-taxon tree, so the host's launches set its pace.
//
// What it computes, for every (directed) message op of a level-ordered
// table, in order:
//   child c = tip ? bits of its packed state mask : clv[c]
//   left[r,i]  = sum_j P1[r,i,j] c1[r,j],  right likewise with P2, c2
//   parent     = left * right
//   rescue     : if every entry of the site (per-rate mode: of the
//                (site, rate)) is < thresh, parent *= factor, counter + 1
//   scaler     = s1 + s2 + rescue (the read-zero scaler row counts 0)
// into the dense clv [rows, R, S, T] and scalers [srows, T] (per-rate
// [srows, R, T]) that the derivatives, the search and the fit's backward
// index: the same rows as ops/partials.py:update_partials, which this
// walks op by op.  Tip rows are written too, decoded from the masks; the
// clv scratch row and the scalers' zero and scratch rows are written as
// zeros.  Rows that no op writes and no tip fills are left as they were.
//
// What bounds it on an H100: the bytes.  Every op reads two children of
// R * S floats a site (a tip child: one 4-byte mask) and writes a parent;
// the P rows are a few KB read by every CTA through L1.  At 256 taxa x
// 4,096 sites (GTR+G4) a sweep of 762 ops must write about 0.29 GB (every
// row once), 0.085 ms at 3.35 TB/s, and moves about 0.56 GB with its
// children's reads, 0.17 ms; the FMAs (2 R S^2 an op and site) are a
// tenth of that.  The dependency is the tree's: an op waits for its
// children, so a CTA walks the table level by level.
//
// What this design does about it:
//   * the sites are independent, so one CTA owns a block of sites and
//     walks the whole table for them: no CTA ever waits for another, and
//     the table's levels need only a CTA barrier between them.  The
//     messages stay in device memory (the pool of 1,000 rows does not fit
//     a CTA's shared memory; the consumers read them there anyway);
//   * a thread holds one rate lane of one site (lanes: the rates rounded
//     up to a power of two, padding lanes repeating the last rate and
//     writing nothing), so a warp reads 32 / lanes sites of each rate at
//     consecutive addresses; the per-site rescue ANDs a site's lanes with
//     __shfl_xor_sync;
//   * the CTA has `groups` copies of those threads, each taking every
//     groups-th op of a level, so that the ops of a level (up to 90 at 256
//     taxa) run side by side and their loads overlap; the barrier between
//     levels orders a child's read after its write;
//   * an op's row is one or two 16-byte loads through the read-only path,
//     the same for every thread of a warp; a tip child is one 4-byte mask;
//   * the table is runtime data: an int64 [levels, width, 8] tensor (the
//     engine's level program, or the search's runtime topology), whose
//     padding rows (parent = the clv scratch row) the kernel skips.
// The state count is a template parameter at 4 and 20 (DNA, protein);
// every other count from 2 to 32 runs a form with the count at run time,
// its arrays sized 8 or 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Threads a CTA may have: the register budget of the state count
// (ops/message_sweep.py:max_threads holds copies of these).
constexpr int THREADS_SMALL = 1024;  // up to 8 states
constexpr int THREADS_20 = 512;      // 20 states
constexpr int THREADS_LARGE = 256;   // 9-32 states, run-time count

template <int SMAX, bool EXACT>
struct Shape {
  static constexpr int THREADS =
      SMAX <= 8 ? THREADS_SMALL : (EXACT && SMAX == 20 ? THREADS_20
                                                       : THREADS_LARGE);
};

// One row of the op table (ops/partials.py's columns): parent clv, child
// clvs, child P-matrices, parent scaler, child scalers.
struct Op {
  int parent, c1, c2, m1, m2, sp, s1, s2;
};

// Row k of an int64 [n][8] table, 16-byte aligned.
__device__ __forceinline__ Op load_op(const long long* ops, int k) {
  Op o;
  const longlong2* p = reinterpret_cast<const longlong2*>(ops) + 4 * k;
  const longlong2 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2),
                  d = __ldg(p + 3);
  o.parent = (int)a.x, o.c1 = (int)a.y, o.c2 = (int)b.x, o.m1 = (int)b.y;
  o.m2 = (int)c.x, o.sp = (int)c.y, o.s1 = (int)d.x, o.s2 = (int)d.y;
  return o;
}

// Where a thread sits, and the strides of the dense tensors.
struct Lane {
  size_t sites;      // T, the stride of a state
  size_t clv_row;    // floats of a clv row, R * S * T
  size_t scal_row;   // words of a scaler row, T or R * T
  size_t p_stride;   // floats of a P-matrix, R * S * S
  const int* tips_at;  // tipchars + this site
  float* clv_at;       // clv + this (rate, site), state 0, row 0
  int* scal_at;        // scalers + this (rate,) site, row 0
  const float* p_at;   // pmat + this rate's block, P-matrix 0
  int tips;
  int zero;            // the read-zero scaler row
  bool live;           // a real site and rate: writes
  bool keeps;          // reads and writes the scaler (per-rate, or lane 0)
};

// A child's S entries at this lane: decoded from its tip mask, or read
// from its clv row (written by this CTA at an earlier level).
template <int SMAX, bool EXACT>
__device__ __forceinline__ void child(float (&c)[SMAX], int index, int S,
                                      const Lane& L) {
  if (index < L.tips) {
    const int code = __ldg(L.tips_at + (size_t)index * L.sites);
#pragma unroll
    for (int j = 0; j < SMAX; ++j)
      if (EXACT || j < S) c[j] = static_cast<float>((code >> j) & 1);
  } else {
    const float* src = L.clv_at + (size_t)index * L.clv_row;
#pragma unroll
    for (int j = 0; j < SMAX; ++j)
      if (EXACT || j < S) c[j] = src[(size_t)j * L.sites];
  }
}

// Row i of P . c, summed over j in order.  A compile-time count that is a
// multiple of 4 reads the row as float4 (P-matrices start on 16 bytes).
template <int SMAX, bool EXACT>
__device__ __forceinline__ float row_dot(const float* __restrict__ p,
                                         const float (&c)[SMAX], int S) {
  float acc = 0.0f;
  if constexpr (EXACT && SMAX % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int q = 0; q < SMAX / 4; ++q) {
      const float4 v = __ldg(p4 + q);
      acc = fmaf(v.x, c[4 * q], acc);
      acc = fmaf(v.y, c[4 * q + 1], acc);
      acc = fmaf(v.z, c[4 * q + 2], acc);
      acc = fmaf(v.w, c[4 * q + 3], acc);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SMAX; ++j)
      if (EXACT || j < S) acc = fmaf(__ldg(p + j), c[j], acc);
  }
  return acc;
}

// One op at this lane.  Every lane of a warp takes part (the shuffles use
// the full mask); only live lanes store.
template <int SMAX, bool EXACT>
__device__ __forceinline__ void op_lane(const Op& o, int S, int lanes,
                                        int per_rate, float thresh,
                                        float factor, const Lane& L) {
  float a[SMAX], b[SMAX];
  child<SMAX, EXACT>(a, o.c1, S, L);
  child<SMAX, EXACT>(b, o.c2, S, L);
  const float* P1 = L.p_at + (size_t)o.m1 * L.p_stride;
  const float* P2 = L.p_at + (size_t)o.m2 * L.p_stride;
  float v[SMAX];
  unsigned below = 1u;  // every entry of this lane < thresh
#pragma unroll
  for (int i = 0; i < SMAX; ++i) {
    if (EXACT || i < S) {
      v[i] = row_dot<SMAX, EXACT>(P1 + i * S, a, S) *
             row_dot<SMAX, EXACT>(P2 + i * S, b, S);
      if (!(v[i] < thresh)) below = 0u;
    }
  }
  if (!per_rate) {
    for (int x = 1; x < lanes; x <<= 1)
      below &= __shfl_xor_sync(FULL, below, x);
  }
  if (!L.live) return;
  float* dst = L.clv_at + (size_t)o.parent * L.clv_row;
#pragma unroll
  for (int i = 0; i < SMAX; ++i)
    if (EXACT || i < S) dst[(size_t)i * L.sites] = below ? v[i] * factor
                                                         : v[i];
  if (L.keeps) {
    int sc = (int)below;
    if (o.s1 != L.zero) sc += L.scal_at[(size_t)o.s1 * L.scal_row];
    if (o.s2 != L.zero) sc += L.scal_at[(size_t)o.s2 * L.scal_row];
    L.scal_at[(size_t)o.sp * L.scal_row] = sc;
  }
}

// grid = ceil(sites / tb) site blocks; block = groups * tb * lanes threads:
// thread t has rate lane t % lanes of site t / lanes % tb of the block, in
// group t / (tb * lanes).  A group's threads are whole warps.  Level l is
// rows l * width .. (l + 1) * width of the table, where a row whose parent
// is clv_scratch is padding.
template <int SMAX, bool EXACT>
__global__ void __launch_bounds__(Shape<SMAX, EXACT>::THREADS)
message_sweep_kernel(const long long* __restrict__ ops, int n_levels,
                     int width, const float* __restrict__ pmat,
                     const int* __restrict__ tipchars, int tips, float* clv,
                     int* scal, int sites, int tb, int rates, int lane_bits,
                     int states, int clv_scratch, int scaler_zero,
                     int scaler_scratch, int per_rate, float thresh,
                     float factor) {
  const int S = EXACT ? SMAX : states;
  const int lanes = 1 << lane_bits;
  const int t = threadIdx.x;
  const int r = t & (lanes - 1);
  const int per_group = tb << lane_bits;
  const int group = t / per_group, groups = blockDim.x / per_group;
  const int site_raw = blockIdx.x * tb + ((t % per_group) >> lane_bits);
  // a lane past the last site computes on the last one and stores nothing
  const int site = min(site_raw, sites - 1);
  const int rp = min(r, rates - 1);
  Lane L;
  L.sites = (size_t)sites;
  L.clv_row = (size_t)rates * S * sites;
  L.scal_row = per_rate ? (size_t)rates * sites : (size_t)sites;
  L.p_stride = (size_t)rates * S * S;
  L.tips_at = tipchars + site;
  L.clv_at = clv + (size_t)rp * S * sites + site;
  L.scal_at = scal + (per_rate ? (size_t)rp * sites : 0) + site;
  L.p_at = pmat + (size_t)rp * S * S;
  L.tips = tips;
  L.zero = scaler_zero;
  L.live = site_raw < sites && r < rates;
  L.keeps = per_rate || r == 0;

  if (L.live) {
    // the tip rows, which the consumers read by index, and the reserved
    // rows; nothing below reads them, so no barrier waits for them
    for (int tip = group; tip < tips; tip += groups) {
      const int code = __ldg(L.tips_at + (size_t)tip * L.sites);
      float* dst = L.clv_at + (size_t)tip * L.clv_row;
#pragma unroll
      for (int j = 0; j < SMAX; ++j)
        if (EXACT || j < S)
          dst[(size_t)j * L.sites] = static_cast<float>((code >> j) & 1);
    }
    if (group == 0) {
      float* dst = L.clv_at + (size_t)clv_scratch * L.clv_row;
#pragma unroll
      for (int j = 0; j < SMAX; ++j)
        if (EXACT || j < S) dst[(size_t)j * L.sites] = 0.0f;
      if (L.keeps) {
        L.scal_at[(size_t)scaler_zero * L.scal_row] = 0;
        L.scal_at[(size_t)scaler_scratch * L.scal_row] = 0;
      }
    }
  }

  for (int l = 0; l < n_levels; ++l) {
    const int end = (l + 1) * width;
    // the same ops for every thread of a warp: the shuffles stay converged
    for (int k = l * width + group; k < end; k += groups) {
      const Op o = load_op(ops, k);
      if (o.parent == clv_scratch) continue;
      op_lane<SMAX, EXACT>(o, S, lanes, per_rate, thresh, factor, L);
    }
    // this level's parents are the next levels' children
    __syncthreads();
  }
}

template <int SMAX, bool EXACT>
cudaError_t launch(const long long* ops, int n_levels, int width,
                   const float* pmat, const int* tipchars, int tips,
                   float* clv, int* scal, int sites, int tb, int groups,
                   int rates, int lane_bits, int states, int clv_scratch,
                   int scaler_zero, int scaler_scratch, int per_rate,
                   float thresh, float factor, cudaStream_t stream) {
  const int threads = groups * (tb << lane_bits);
  if (threads > Shape<SMAX, EXACT>::THREADS) return cudaErrorInvalidValue;
  const int nt = (sites + tb - 1) / tb;
  message_sweep_kernel<SMAX, EXACT><<<nt, threads, 0, stream>>>(
      ops, n_levels, width, pmat, tipchars, tips, clv, scal, sites, tb,
      rates, lane_bits, states, clv_scratch, scaler_zero, scaler_scratch,
      per_rate, thresh, factor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the sweep on `stream` of CUDA device `device` (made current for
// the launch if it is not); returns the cudaError_t of the launch.
// ops: the table, int64 [n_levels][width][8], 16-byte aligned, a row
// whose parent is clv_scratch padding.  pmat: f32
// [n_pmat][rates][states][states], 16-byte aligned.  tipchars: int32
// [tips][sites] packed state masks.  clv: f32
// [clv_rows][rates][states][sites]; scal: int32 [scaler_rows][sites], or
// [scaler_rows][rates][sites] with per_rate.  states 2-32, rates 1-32;
// tb * (rates rounded up to a power of two) a multiple of 32, and groups
// times that at most THREADS_SMALL up to 8 states, THREADS_20 at 20,
// THREADS_LARGE otherwise.  The kernel allocates nothing and does not
// synchronise; the caller keeps every index of the table inside the
// tensors.
int message_sweep_launch(const long long* ops, int n_levels, int width,
                         const float* pmat, const int* tipchars, int tips,
                         float* clv, int* scal, int sites, int tb,
                         int groups, int rates, int states, int clv_scratch,
                         int scaler_zero, int scaler_scratch, int per_rate,
                         float thresh, float factor, int device,
                         void* stream) {
  int lane_bits = 0;
  while ((1 << lane_bits) < rates) ++lane_bits;
  if (n_levels <= 0 || width <= 0 || sites <= 0 || tb <= 0 || groups <= 0 ||
      rates <= 0 || rates > 32 || states < 2 || states > 32 ||
      (tb << lane_bits) % 32 || reinterpret_cast<uintptr_t>(ops) % 16 ||
      reinterpret_cast<uintptr_t>(pmat) % 16)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MESSAGE_SWEEP_ARGS                                                 \
  ops, n_levels, width, pmat, tipchars, tips, clv, scal, sites, tb, groups, \
      rates, lane_bits, states, clv_scratch, scaler_zero, scaler_scratch,    \
      per_rate, thresh, factor, s
  if (states == 4)
    err = launch<4, true>(MESSAGE_SWEEP_ARGS);
  else if (states == 20)
    err = launch<20, true>(MESSAGE_SWEEP_ARGS);
  else if (states <= 8)
    err = launch<8, false>(MESSAGE_SWEEP_ARGS);
  else
    err = launch<32, false>(MESSAGE_SWEEP_ARGS);
#undef MESSAGE_SWEEP_ARGS
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // extern "C"
