// The tree sweep's generic-state form: every state count from 2 to 32
// without an instantiation of its own in csrc/tree_sweep.cu (3, 5-9, 11-15,
// 17-19, 21-32: odd counts, Dayhoff-6, multistate morphology), f32 or bf16
// pool, 1-32 rates, per-site or per-rate scalers.  Built with nvcc for
// sm_90a beside csrc/tree_sweep.cu (a source of its own, so that the two
// compile side by side) into the package's shared library
// (libpll2_tpu_torch/_build.py); tree_sweep_launch, the sweep's one C
// entry point, sends these state counts to launch_generic_states below.
//
// Replaces, at these state counts, the Pallas kernels of the JAX package
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_static     (:808)
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_static_seg (:1136)
// and the "vpu" mode of its runtime-ops kernel _tree_kernel (:410), which
// take any state count.  It computes what tree_sweep.cu's op_lane computes
// (see the head of that file), with the state count S at run time up to
// SMAX (8 or 32).
//
// What bounds it on an H100: per op and (site, rate) 2 * S * S FMAs, and
// the loads that feed them.  The first generic form (the "scalar" form, a
// thread a column; probes/generic_scalar_form.cu keeps it for the
// experiments) summed each parent row over j reading the child entry from
// the pool and the P entry through L1 at every FMA: about 4 * S * S load
// instructions for 2 * S * S FMAs, each child column re-read S times, and
// the load/store pipe issues about a quarter of the FFMA pipe's rate.  At
// 32 states its pool let one CTA of 128 threads (four warps) run on an SM.
// It took 1.91 ms at 5 states (256 x 65,536) and 24.0 ms at 32 states
// (128 x 16,384) on an H100 at 700 W, and 132 ms at 32 states and 12
// rates (where the row groups take 33 ms).
//
// What this design ("row groups") does about it:
//   * a (site, rate lane) column's S parent rows are split over G threads,
//     its row groups: thread g forms rows g, g + G, g + 2 G, ... (at most
//     GROUP_ROWS), so at 32 states (G = 4) a 32-site CTA has 512 threads;
//     up to 8 states (G = 1) a thread forms every row of two columns (two
//     sites of one rate), so that one load of P feeds twice the FMAs;
//   * the op is an outer product: for j = 0 .. S - 1 the thread reads child
//     entry j of both children once (a pool word all G groups of the column
//     read together, or the bit of a tip mask) and adds P[i][j] * c[j] into
//     the accumulator of each of its rows, so every row is the fmaf chain
//     over j ascending of the scalar form and of op_lane (bit-equal rows);
//     child loads fall from S * S to S a child;
//   * the P-matrices are laid out once a call, by group_pmatrix_kernel, as
//     [P][R][G][S][rows padded to 4] (a block padded to an odd count of
//     16-byte pieces): a thread's P entries at one j are consecutive, one
//     16-byte load for four rows, and the blocks of a warp's (rate, group)
//     pairs fall in distinct banks.  Where both P-matrices of an op fit
//     twice in GENERIC_STAGE_BYTES, the CTA copies the next op's into shared
//     memory (cp.async, double-buffered) while it computes this one, with
//     one CTA barrier an op; else (many rates at many states) a thread reads
//     them through L1, 16 bytes at a time;
//   * a thread loads the tip masks of the next op's tip children at its
//     sites while it computes this op, so no device-memory latency is on
//     the chain from op to op;
//   * the G groups of a column are adjacent lanes of one warp, and so are
//     the rate lanes of a site up to G * lanes = 32 (thread (site * lanes +
//     rate) * G + group, the site being the first of its H): a rescue is an
//     AND over G lanes (per-rate) or G * lanes lanes (per-site) by
//     __shfl_xor_sync, and a child entry written by another group is read
//     after the warp's barrier (or the CTA's) that ends the op.  Where a
//     site's G * lanes threads span warps (9-32 rates at many states), a
//     per-site rescue ANDs the warps' words through shared memory behind a
//     CTA barrier, and the op ends at a CTA barrier;
//   * the thread keeps its rows in registers until the rescue is decided,
//     scales them, and stores them once; at bf16 the scaled f32 row is
//     rounded once where it is stored (the rule of the scalar form), and an
//     exported parent goes out in f32 at its op.
// G is the fewest, a power of two, with ceil(S / G) <= GROUP_ROWS
// (partials_tree.generic_groups, on the host).  probes/variants.py
// ("generic_sweep") times the forms and variants, and "generic_bounds"
// checks every shared-memory access.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// one row of the "fma" device table: two 16-byte halves (tree_sweep.cu)
constexpr int ROW_INT4 = 2;

template <class T>
constexpr bool IS_BF16 = std::is_same<T, __nv_bfloat16>::value;

template <class T>
struct Store {};

__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// The row-group form.
//
// Rows a thread forms at most; the host's partials_tree.GENERIC_ROWS.
constexpr int GROUP_ROWS = 8;
// Shared memory for the staged P-matrices: both of an op's, twice (the op
// computed and the next one copied); above it a thread reads P through L1.
// The host's partials_tree.GENERIC_STAGE_BYTES.
constexpr int GENERIC_STAGE_BYTES = 73728;
constexpr int GROUP_THREADS = 1024;

// Rows of a group padded to whole 16-byte loads.
__host__ __device__ constexpr int group_rows_padded(int S, int G) {
  return ((S + G - 1) / G + 3) & ~3;
}
// Floats of one (matrix, rate, group) block: S * rows padded, rounded up
// to an odd count of 16-byte pieces so that consecutive blocks start in
// distinct banks.
__host__ __device__ constexpr int group_block_floats(int S, int G) {
  return ((S * group_rows_padded(S, G) / 4) | 1) * 4;
}
// Floats of one P-matrix in the group layout: [R][G][block].
__host__ __device__ constexpr int group_matrix_floats(int R, int S, int G) {
  return R * G * group_block_floats(S, G);
}
__host__ __device__ constexpr bool group_staged(int R, int S, int G) {
  return 2 * 2 * group_matrix_floats(R, S, G) * 4 <= GENERIC_STAGE_BYTES;
}

// pg [n_blocks = P * R * G][block]: entry j * RP + k of block (m, r, g) is
// P[m][r][g + G * k][j], 0 where that row is past S, and the block's tail
// is 0.
__global__ void group_pmatrix_kernel(const float* __restrict__ pmat,
                                     float* __restrict__ pg, int n_blocks,
                                     int S, int G) {
  const int RP = group_rows_padded(S, G), B = group_block_floats(S, G);
  const size_t total = (size_t)n_blocks * B;
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < total;
       x += (size_t)gridDim.x * blockDim.x) {
    const int within = (int)(x % B);
    const size_t blk = x / B;
    const int g = (int)(blk % G);
    const size_t mr = blk / G;
    const int j = within / RP, k = within % RP;
    const int i = g + G * k;
    pg[x] = j < S && i < S ? __ldg(pmat + (mr * S + i) * S + j) : 0.0f;
  }
}

template <bool STAGED>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (STAGED)
    return *reinterpret_cast<const float4*>(p);
  else
    return __ldg(reinterpret_cast<const float4*>(p));
}

// One op for one thread: rows g + G * k (k < GROUP_ROWS, row < S) of the
// parents of its H columns.  c1, c2, par: the first column's word of entry
// 0 in the children's and the parent's slots (entry i at + i * cols, column
// h at + h * hcol).  m1, m2: the tip masks of the H columns' sites.  P1,
// P2: the thread's block of the two P-matrices (in shared memory when
// STAGED): one 16-byte load feeds 4 * H FMAs.  rows: the most rows a group
// has (ceil(S / G)), the same in every lane, so that the loads' branches
// are uniform; a row past S has P = 0 and is neither tested nor stored.
// s1, s2, sp: the first column's scaler words (column h at + h * hs).
// width: the lanes of the rescue's AND, the same in every thread of the
// CTA; above 32 (a site's threads span width / 32 warps, H = 1) the warps'
// ANDs meet in words [threads / 32] behind a CTA barrier.  out / sout:
// where this lane's exported parent and its scaler go (bf16; null: none;
// site h at + h * hout).
template <int SMAX, int H, bool STAGED, bool K1_TIP, bool K2_TIP, class T>
__device__ __forceinline__ void group_op(
    const unsigned (&m1)[H], const unsigned (&m2)[H], const T* c1,
    const T* c2, T* par, int hcol, const float* P1, const float* P2, int RP,
    int S, int G, int g, int rows, int cols, const int* s1, const int* s2,
    int* sp, int hs, bool keeps, int width, unsigned* words, float thresh,
    float factor, float* out, int* sout, int hout, int tb) {
  float left[H][GROUP_ROWS], right[H][GROUP_ROWS];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int k = 0; k < GROUP_ROWS; ++k) left[h][k] = right[h][k] = 0.0f;
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < S) {
      float a[H], b[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        a[h] = K1_TIP ? static_cast<float>((m1[h] >> j) & 1u)
                      : widen(c1[h * hcol + (size_t)j * cols]);
        b[h] = K2_TIP ? static_cast<float>((m2[h] >> j) & 1u)
                      : widen(c2[h * hcol + (size_t)j * cols]);
      }
#pragma unroll
      for (int q = 0; q < GROUP_ROWS / 4; ++q) {
        if (4 * q < rows) {
          const float4 x = load4<STAGED>(P1 + j * RP + 4 * q);
          const float4 y = load4<STAGED>(P2 + j * RP + 4 * q);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            float* l = left[h] + 4 * q;
            float* r = right[h] + 4 * q;
            l[0] = fmaf(x.x, a[h], l[0]);
            l[1] = fmaf(x.y, a[h], l[1]);
            l[2] = fmaf(x.z, a[h], l[2]);
            l[3] = fmaf(x.w, a[h], l[3]);
            r[0] = fmaf(y.x, b[h], r[0]);
            r[1] = fmaf(y.y, b[h], r[1]);
            r[2] = fmaf(y.z, b[h], r[2]);
            r[3] = fmaf(y.w, b[h], r[3]);
          }
        }
      }
    }
  }
  // bit h: every entry of column h's parent (or of its site's) < thresh
  unsigned below = (1u << H) - 1;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int k = 0; k < GROUP_ROWS; ++k) {
      left[h][k] *= right[h][k];
      if (g + G * k < S && !(left[h][k] < thresh)) below &= ~(1u << h);
    }
  // every lane of the warp takes part in each shuffle
  for (int x = 1; x < width && x < 32; x <<= 1)
    below &= __shfl_xor_sync(FULL, below, x);
  if (width > 32) {
    const int warp = threadIdx.x >> 5, first = warp & ~((width >> 5) - 1);
    if ((threadIdx.x & 31) == 0) words[warp] = below;
    __syncthreads();
    for (int v = 0; v < width >> 5; ++v) below &= words[first + v];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const bool low = (below >> h) & 1u;
#pragma unroll
    for (int k = 0; k < GROUP_ROWS; ++k) {
      const int i = g + G * k;
      if (i < S) {
        const float v = low ? left[h][k] * factor : left[h][k];
        put(par + h * hcol + (size_t)i * cols, v);
        if (out) out[h * hout + (size_t)i * tb] = v;
      }
    }
    // scalers: only the lane that keeps this word reads or writes it
    if (keeps) {
      int sc = low ? 1 : 0;
      if (!K1_TIP) sc += s1[h * hs];
      if (!K2_TIP) sc += s2[h * hs];
      sp[h * hs] = sc;
      if (sout) sout[h * hout] = sc;
    }
  }
}

// Sites a thread of the row-group form holds: two up to 8 states (SMAX 8),
// where a thread's rows are few and one P load then feeds twice the FMAs,
// one above; and the threads such a CTA takes at most, fewer than the
// form's GROUP_THREADS: at 5 states 128-site blocks of 256 threads ran 5 %
// faster than 256-site blocks of 512 on an H100 at 700 W
// (probes/variants.py generic_blocks).  The host's
// partials_tree.GENERIC_SITES_A_THREAD and GENERIC_SITES_THREADS.
constexpr int GROUP_SITES = 2;
constexpr int GROUP_SITES_THREADS = 256;
template <int SMAX>
__host__ __device__ constexpr int sites_of() {
  return SMAX <= 8 ? GROUP_SITES : 1;
}
template <int SMAX>
__host__ __device__ constexpr int threads_of() {
  return sites_of<SMAX>() > 1 ? GROUP_SITES_THREADS : GROUP_THREADS;
}

// grid = NT site blocks of TB sites; block = TB * lanes * G / H threads:
// thread t has group t % G of column pair t / G, whose H columns are col +
// h * cols / H; column c is the rate lane c % lanes of site c / lanes
// (lanes: the rates rounded up to a power of two; padding lanes repeat the
// last rate and write nothing out), so a thread's sites are s0 + h * TB /
// H.  shared: pool [pool_size][S][TB * lanes] of T, spool [pool_size][SR]
// i32 (SR = TB * lanes per-rate, TB per-site), then when STAGED two buffers
// of an op's two P-matrices [2][2][group_matrix_floats], then where a
// per-site rescue spans warps (G * lanes > 32) one word a warp.  pg: the
// P-matrices in the group layout (group_pmatrix_kernel).  ops,
// export_slots, export_at and p_base as for tree_sweep.cu's kernels.
template <int SMAX, bool STAGED, class T>
__global__ void __launch_bounds__(threads_of<SMAX>())
tree_sweep_groups_kernel(const int4* __restrict__ ops, int n_ops,
                         const float* __restrict__ pg,
                         const int* __restrict__ p_base,
                         const int* __restrict__ tip_blocked, int tips,
                         const int* __restrict__ export_slots, int n_exp,
                         const int* __restrict__ export_at,
                         float* __restrict__ clv_out,
                         int* __restrict__ scal_out, int S, int rates,
                         int lane_bits, int group_bits, int pool_size,
                         int per_rate, float thresh, float factor) {
  constexpr int H = sites_of<SMAX>();
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, nth = blockDim.x;
  const int G = 1 << group_bits, lanes = 1 << lane_bits;
  const int g = t & (G - 1), col = t >> group_bits;
  const int cols = (nth >> group_bits) * H, hcol = cols / H;
  const int r = col & (lanes - 1), s0 = col >> lane_bits;
  const int tb = cols >> lane_bits, hsite = tb / H;
  const int R = rates;
  const int RP = group_rows_padded(S, G), rows = (S + G - 1) / G;
  const int mat = group_matrix_floats(R, S, G);
  if (p_base != nullptr) pg += (size_t)__ldg(p_base + blockIdx.x) * mat;
  const int sr_stride = per_rate ? cols : tb;
  const int sidx = per_rate ? col : s0;
  const int hs = per_rate ? hcol : hsite;
  const bool keeps = g == 0 && (per_rate || r == 0);
  const int width = per_rate ? G : G * lanes;
  const size_t slot_words = (size_t)S * cols;
  T* pool = reinterpret_cast<T*>(smem);
  int* spool = reinterpret_cast<int*>(pool + (size_t)pool_size * slot_words);
  float* stage = reinterpret_cast<float*>(spool + (size_t)pool_size *
                                                      sr_stride);
  unsigned* words = reinterpret_cast<unsigned*>(stage + (STAGED ? 4 * mat
                                                                : 0));
  const int* tip_col = tip_blocked + (size_t)blockIdx.x * tips * tb + s0;
  const int p_thread = (min(r, R - 1) * G + g) * group_block_floats(S, G);
  const int nt = gridDim.x, blk = blockIdx.x;

  // op k's two P-matrices into buffer k % 2, in 16-byte pieces
  auto stage_op = [&](int k) {
    const int4 sk = __ldg(ops + ROW_INT4 * (size_t)k);
    float* dst = stage + (k & 1) * 2 * mat;
    const int pieces = mat / 4;
    for (int c = t; c < 2 * pieces; c += nth) {
      const int m = c >= pieces;
      const int off = (c - m * pieces) * 4;
      copy_async(dst + m * mat + off,
                 pg + (size_t)(m ? sk.w : sk.z) * mat + off);
    }
    commit_copies();
  };
  // op k's tip masks at this thread's sites (read unsigned: bit 31 is a
  // state at S = 32 and the gap mask is all ones; 0 for a child that is
  // not a tip), loaded an op ahead of their use
  auto masks_of = [&](int k, unsigned (&m1)[H], unsigned (&m2)[H]) {
    const int4 sk = __ldg(ops + ROW_INT4 * (size_t)k);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int* tip = tip_col + h * hsite;
      m1[h] = sk.x >= 0 ? static_cast<unsigned>(__ldg(tip + (size_t)sk.x *
                                                           tb))
                        : 0u;
      m2[h] = sk.y >= 0 ? static_cast<unsigned>(__ldg(tip + (size_t)sk.y *
                                                           tb))
                        : 0u;
    }
  };
  unsigned next1[H], next2[H];
  masks_of(0, next1, next2);
  if constexpr (STAGED) {
    stage_op(0);
    wait_all_copies();
    __syncthreads();
  }

  for (int w = 0; w < n_ops; ++w) {
    unsigned mask1[H], mask2[H];
#pragma unroll
    for (int h = 0; h < H; ++h) mask1[h] = next1[h], mask2[h] = next2[h];
    if (w + 1 < n_ops) masks_of(w + 1, next1, next2);
    if constexpr (STAGED) {
      if (w + 1 < n_ops) stage_op(w + 1);
    }
    const int4 st = __ldg(ops + ROW_INT4 * (size_t)w);
    const int4 op = __ldg(ops + ROW_INT4 * (size_t)w + 1);
    const float* P1;
    const float* P2;
    if constexpr (STAGED) {
      P1 = stage + (w & 1) * 2 * mat + p_thread;
      P2 = P1 + mat;
    } else {
      P1 = pg + (size_t)st.z * mat + p_thread;
      P2 = pg + (size_t)st.w * mat + p_thread;
    }
    float* out = nullptr;
    int* sout = nullptr;
    if constexpr (IS_BF16<T>) {
      const int e = __ldg(export_at + w);
      if (e >= 0 && r < R) {
        out = clv_out + (((size_t)e * nt + blk) * R + r) * S * tb + s0;
        if (keeps)
          sout = scal_out + (((size_t)e * nt + blk) * (per_rate ? R : 1) +
                             (per_rate ? r : 0)) * tb + s0;
      }
    }
    const T* c1 = pool + (size_t)op.y * slot_words + col;
    const T* c2 = pool + (size_t)op.z * slot_words + col;
    T* par = pool + (size_t)op.x * slot_words + col;
    const int* s1 = spool + op.y * sr_stride + sidx;
    const int* s2 = spool + op.z * sr_stride + sidx;
    int* sp = spool + op.x * sr_stride + sidx;
#define LIBPLL_GROUP_OP(T1, T2)                                               \
  group_op<SMAX, H, STAGED, T1, T2>(mask1, mask2, c1, c2, par, hcol, P1, P2, \
                                    RP, S, G, g, rows, cols, s1, s2, sp, hs, \
                                    keeps, width, words, thresh, factor, out, \
                                    sout, hsite, tb)
    // the op's case 2 * kinds + keep; kinds (tip, tip), (tip, pool),
    // (tip, handed on), (pool, pool), (pool, handed on): a handed-on child
    // is read from its slot, and every parent is stored
    switch (op.w >> 1) {
      case 0: LIBPLL_GROUP_OP(true, true); break;
      case 1:
      case 2: LIBPLL_GROUP_OP(true, false); break;
      default: LIBPLL_GROUP_OP(false, false); break;
    }
#undef LIBPLL_GROUP_OP
    // the op's rows and scalers (and the next op's P, and the rescue's
    // words) before the next op
    if constexpr (STAGED) {
      wait_all_copies();
      __syncthreads();
    } else if (width > 32) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  }

  // export slots are never reused by the schedule: a thread copies its own
  // rows; padding lanes write nothing (a bf16 kernel wrote its exports at
  // their ops)
  if constexpr (!IS_BF16<T>) {
    if (r >= R) return;
    for (int e = 0; e < n_exp; ++e) {
      const int slot = __ldg(export_slots + e);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float* src = pool + (size_t)slot * slot_words + col + h * hcol;
        float* dst = clv_out + (((size_t)e * nt + blk) * R + r) * S * tb +
                     s0 + h * hsite;
#pragma unroll
        for (int k = 0; k < GROUP_ROWS; ++k) {
          const int i = g + G * k;
          if (i < S) dst[(size_t)i * tb] = src[(size_t)i * cols];
        }
        if (keeps)
          scal_out[(((size_t)e * nt + blk) * (per_rate ? R : 1) +
                    (per_rate ? r : 0)) * tb + s0 + h * hsite] =
              spool[slot * sr_stride + sidx + h * hs];
      }
    }
  }
}

template <int SMAX, bool STAGED, class T>
cudaError_t launch_groups_kernel(const int* ops, int n_ops, const float* pg,
                                 const int* p_base, const int* tip_blocked,
                                 int tips,
                                 const int* export_slots, int n_exp,
                                 const int* export_at, float* clv_out,
                                 int* scal_out, int nt, int nth, size_t smem,
                                 int states, int rates, int lane_bits,
                                 int group_bits, int pool_size, int per_rate,
                                 float thresh, float factor,
                                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tree_sweep_groups_kernel<SMAX, STAGED, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tree_sweep_groups_kernel<SMAX, STAGED, T><<<nt, nth, smem, stream>>>(
      reinterpret_cast<const int4*>(ops), n_ops, pg, p_base, tip_blocked,
      tips, export_slots, n_exp, export_at, clv_out, scal_out, states, rates,
      lane_bits, group_bits, pool_size, per_rate, thresh, factor);
  return cudaGetLastError();
}

// The row-group form at `groups` row groups: lay the P-matrices out in pg
// (n_pmat * group_matrix_floats floats), then sweep.
template <int SMAX, class T>
cudaError_t launch_groups(Store<T>, const int* ops, int n_ops,
                          const float* pmat, const int* p_base, int n_pmat,
                          float* pg,
                          const int* tip_blocked, int tips,
                          const int* export_slots, int n_exp,
                          const int* export_at, float* clv_out,
                          int* scal_out, int nt, int tb, int rates,
                          int states, int groups, int pool_size,
                          int per_rate, float thresh, float factor,
                          cudaStream_t stream) {
  constexpr int H = sites_of<SMAX>();
  int lane_bits = 0, group_bits = 0;
  while ((1 << lane_bits) < rates) ++lane_bits;
  while ((1 << group_bits) < groups) ++group_bits;
  const int cols = tb << lane_bits, nth = cols * groups / H;
  if ((1 << group_bits) != groups ||
      (states + groups - 1) / groups > GROUP_ROWS || tb % H ||
      nth > threads_of<SMAX>() || nth % 32 || pg == nullptr)
    return cudaErrorInvalidValue;
  const int sr = per_rate ? cols : tb;
  const bool staged = group_staged(rates, states, groups);
  const bool spans = !per_rate && (groups << lane_bits) > 32;
  const size_t smem =
      (size_t)pool_size * ((size_t)states * cols * sizeof(T) +
                           (size_t)sr * 4) +
      (staged ? (size_t)4 * group_matrix_floats(rates, states, groups) * 4
              : 0) +
      (spans ? (size_t)nth / 32 * 4 : 0);
  const int n_blocks = n_pmat * rates * groups;
  const size_t total = (size_t)n_blocks * group_block_floats(states, groups);
  const int grid = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                     : 4096);
  group_pmatrix_kernel<<<grid, 256, 0, stream>>>(pmat, pg, n_blocks, states,
                                                 groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define LIBPLL_GROUPS_ARGS                                                    \
  ops, n_ops, pg, p_base, tip_blocked, tips, export_slots, n_exp, export_at, \
      clv_out, scal_out, nt, nth, smem, states, rates, lane_bits, group_bits, \
      pool_size, per_rate, thresh, factor, stream
  // up to 8 states an op's P-matrices always fit the staging
  if (staged) return launch_groups_kernel<SMAX, true, T>(LIBPLL_GROUPS_ARGS);
  if constexpr (SMAX > 8)
    return launch_groups_kernel<SMAX, false, T>(LIBPLL_GROUPS_ARGS);
  return cudaErrorInvalidValue;
#undef LIBPLL_GROUPS_ARGS
}

}  // namespace

// The generic-state sweep, called by tree_sweep_launch (csrc/tree_sweep.cu)
// for every state count without an instantiation there; arguments as
// tree_sweep_launch's.  tb * lanes * groups / H threads, a multiple of 32,
// at most threads_of<SMAX>.
cudaError_t launch_generic_states(const int* ops, int n_ops,
                                  const float* pmat, const int* p_base,
                                  int n_pmat, float* pg,
                                  const int* tip_blocked, int tips,
                                  const int* export_slots, int n_exp,
                                  const int* export_at, float* clv_out,
                                  int* scal_out, int nt, int tb, int rates,
                                  int states, int pool_size, int per_rate,
                                  int bf16, int groups, float thresh,
                                  float factor, cudaStream_t s) {
  if (states < 2 || states > 32 || groups <= 0 ||
      reinterpret_cast<uintptr_t>(pg) % 16)
    return cudaErrorInvalidValue;
#define LIBPLL_GROUP_ARGS                                                     \
  ops, n_ops, pmat, p_base, n_pmat, pg, tip_blocked, tips, export_slots,     \
      n_exp, export_at, clv_out, scal_out, nt, tb, rates, states, groups,    \
      pool_size, per_rate, thresh, factor, s
  if (bf16) {
    if (states <= 8)
      return launch_groups<8>(Store<__nv_bfloat16>{}, LIBPLL_GROUP_ARGS);
    return launch_groups<32>(Store<__nv_bfloat16>{}, LIBPLL_GROUP_ARGS);
  }
  if (states <= 8) return launch_groups<8>(Store<float>{}, LIBPLL_GROUP_ARGS);
  return launch_groups<32>(Store<float>{}, LIBPLL_GROUP_ARGS);
#undef LIBPLL_GROUP_ARGS
}

extern "C" {

// Floats of one P-matrix in the row-group form's layout at (rates, states,
// groups), and whether that form stages an op's P-matrices in shared
// memory (what partials_tree.generic_matrix_floats and generic_staged
// compute on the host; the tests on the card hold them equal).
int tree_sweep_generic_matrix_floats(int rates, int states, int groups) {
  return group_matrix_floats(rates, states, groups);
}
int tree_sweep_generic_staged(int rates, int states, int groups) {
  return group_staged(rates, states, groups) ? 1 : 0;
}

}  // extern "C"
