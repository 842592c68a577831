// Felsenstein tree sweep with the propagation P . clv on the tensor cores:
// the "mma" form of libpll2_tpu_torch/ops/partials_tree.py:sweep().  Built
// with nvcc for sm_90a into the package's shared library (_build.py) and
// launched through ctypes.
//
// Replaces the runtime-ops Pallas kernels of the JAX package:
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_splitk (:547)
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel, mxu=True (:410)
// Both run the propagation of one op as one 2-D product with the
// rate-block-diagonal P [span, span] on the matrix unit; "splitk" stacks
// bf16 split terms along K to keep f32 quality.  (_tree_kernel with
// mxu=False, the broadcast-FMA form, is csrc/tree_sweep.cu.)
//
// Same contract as tree_sweep.cu: a runtime op table [OPS, 9], CLV and
// scaler pools in shared memory, tips expanded from packed bits, per-site
// rescue, exported rows written as [E, NT, R, S, TB] / [E, NT, 1, TB].
// The difference is the product.  Per warp and per 8-site tile,
//   left = Pbd . c1,  right = Pbd . c2
// by mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: the A operand is
// the block-diagonal P (16-row m-tiles, 8-column k-steps; a (m-tile, k-step)
// pair whose rows and columns share no rate is all zero and is skipped at
// compile time: 2 pairs at span 16, 22 of 50 at span 80), the B operand the
// child's [span, 8] column tile.  One TF32 pass keeps 11 significant bits,
// so each operand is split into a TF32 head and a TF32 remainder
// (x = hi + lo, |lo| <= 2^-11 |x|) and one f32 accumulator collects
//   A_lo.B_hi + A_hi.B_lo + A_hi.B_hi
// (the dropped A_lo.B_lo term and the remainders' own rounding are each
// about 2^-22 relative: the size of f32 rounding itself).  The same idea as
// the TPU kernel's stacked bf16 split terms, on this card's units.  P is
// split once per call by a small kernel of this file
// (pmatrix_fragments_kernel), which also lays it out in A-fragment order
// (pfrag below), so a lane fetches its four A registers with one 16-byte
// load and no conversion.  The tensor cores round their accumulator toward
// zero where an FMA rounds to nearest: about half an f32 ulp per product,
// always downward, so exported rows drift from the FMA form's by about
// 3e-8 per op below them (2e-4 at 8,190 ops) while the logL, a sum of logs
// of magnitude thousands per site, moves by less than 1e-7 relative.  Tip
// children are 0/1: their remainder is zero and that product is skipped.
//
// What bounds it on an H100: per op and 8-site tile, 3 * 2 * NP mma (NP
// nonzero pairs), against 2 * span * 8 * 4 bytes read and span * 8 * 4 bytes
// written in shared memory, plus the split of every B element (two cvt and
// a subtract).  At span 16 that is 12 mma of 2048 FLOP each for 128 FMAs of
// useful work per site (3/4 of every A tile is structural zero, and the
// split triples the rest), so the tensor cores do 24x the useful FLOPs; at
// their rate that still is less time than the FMA form's issue slots, and
// the kernel is bound by shared-memory latency, the B splits and the
// cross-lane rescue, like the FMA form.  (Measured on an H100 at 700 W,
// PERF.md: at span 16 this form takes 0.84-0.88 of the FMA form's time, at
// span 80 less than half.)
//
// What the design does about it:
//   * every slot is laid out [TB/8 tiles][span][8 sites]: a B fragment load
//     (k = lane%4 (+4), site = lane/4) then touches 32 different banks, and
//     the C fragment (row = lane/4 (+8), cols 2*(lane%4), +1) is stored as
//     float2 to 64 consecutive words.  The [span][TB] layout of
//     tree_sweep.cu would make the B loads 4-way bank conflicts.  No
//     padding, so the footprint equals the FMA form's;
//   * a warp owns 32 sites (4 tiles) in every slot and reads nothing another
//     warp writes: one __syncwarp per op orders the C-layout stores against
//     the next op's B-layout loads, and there is no __syncthreads;
//   * a site's span entries sit in 8 lanes (same lane%4): the rescue's max
//     is three __shfl_xor_sync over lane bits 2-4, and the scaler is added
//     once per site by the lanes with lane/4 == 0;
//   * op rows are read with __ldg: tables above 4096 rows do not fit the
//     constant cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int OP_COLS = 9;
constexpr int TILE = 8;        // sites per mma n-tile
constexpr int WARP_TILES = 4;  // tiles per warp: 32 sites
constexpr unsigned FULL = 0xffffffffu;

// Does the block-diagonal P have a nonzero entry in rows [16mt, 16mt+15],
// columns [8ks, 8ks+7]?  (Do the rates of the rows meet those of the
// columns.)
__host__ __device__ constexpr bool pair_nonzero(int S, int mt, int ks) {
  return (16 * mt) / S <= (8 * ks + 7) / S &&
         (8 * ks) / S <= (16 * mt + 15) / S;
}

// Position of pair (mt, ks) among the nonzero pairs in row-major order;
// pair_index(S, KS, MT - 1, KS) is their number.
__host__ __device__ constexpr int pair_index(int S, int KS, int mt, int ks) {
  int n = 0;
  for (int m = 0; m <= mt; ++m)
    for (int k = 0; k < (m == mt ? ks : KS); ++k)
      if (pair_nonzero(S, m, k)) ++n;
  return n;
}

template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a[16x8] . b[8x8], TF32 operands, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// acc[mt] = (Pbd . child)[16mt .. 16mt+15][8 sites of this tile] in C
// fragment layout.  TIP: the child is a tip with packed state mask `code`
// (this lane's site); else its tile [span][8] starts at `tile`.
// A: this lane's entry of pfrag[slot], [NP][2 (hi, lo)][32 lanes] uint4.
template <int S, int R, bool TIP>
__device__ __forceinline__ void child_product(float (&acc)[R * S / 16][4],
                                              int code, const float* tile,
                                              const uint4* __restrict__ A,
                                              int g, int q) {
  constexpr int SPAN = R * S, MT = SPAN / 16, KS = SPAN / 8;
  uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * ks + 4 * h + q;
      if constexpr (TIP) {
        bh[ks][h] = ((code >> (k % S)) & 1) ? 0x3f800000u : 0u;  // 1.0f / 0
        bl[ks][h] = 0u;
      } else {
        const float x = tile[k * TILE + g];
        const uint32_t hi = to_tf32(x);
        bh[ks][h] = hi;
        bl[ks][h] = to_tf32(x - __uint_as_float(hi));
      }
    }
  }
  static_for<0, MT>([&](auto mi) {
    constexpr int mt = decltype(mi)::value;
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
    static_for<0, KS>([&](auto ki) {
      constexpr int ks = decltype(ki)::value;
      if constexpr (pair_nonzero(S, mt, ks)) {
        constexpr int p = pair_index(S, KS, mt, ks);
        const uint4 a_hi = __ldg(A + (2 * p + 0) * 32);
        const uint4 a_lo = __ldg(A + (2 * p + 1) * 32);
        mma_tf32(acc[mt], a_lo, bh[ks][0], bh[ks][1]);
        if constexpr (!TIP) mma_tf32(acc[mt], a_hi, bl[ks][0], bl[ks][1]);
        mma_tf32(acc[mt], a_hi, bh[ks][0], bh[ks][1]);
      }
    });
  });
}

// grid = NT site blocks, block = TB threads: warp w owns sites 32w..32w+31.
// shared: pool [pool_size][TB/8][span][8] f32, spool [pool_size][TB] i32.
template <int S, int R>
__global__ void __launch_bounds__(256)
tree_sweep_mma_kernel(const int* __restrict__ ops, int n_ops,
                      const uint4* __restrict__ pfrag,
                      const int* __restrict__ tip_blocked, int tips,
                      const int* __restrict__ export_slots, int n_exp,
                      float* __restrict__ clv_out, int* __restrict__ scal_out,
                      int pool_size, float thresh, float factor) {
  constexpr int SPAN = R * S, MT = SPAN / 16, KS = SPAN / 8;
  static_assert(SPAN % 16 == 0, "span must fill whole 16-row m-tiles");
  constexpr int NP = pair_index(S, KS, MT - 1, KS);
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int blk = blockIdx.x, nt = gridDim.x;
  const size_t slot_stride = (size_t)SPAN * tb;
  float* pool = smem;
  int* spool = reinterpret_cast<int*>(smem + (size_t)pool_size * slot_stride);
  const int warp_off = warp * WARP_TILES * SPAN * TILE;
  // tip i at this lane's site: tip_col[i * tb]
  const int* tip_col = tip_blocked + (size_t)blk * tips * tb + threadIdx.x;

  for (int w = 0; w < n_ops; ++w) {
    const int* op = ops + (size_t)w * OP_COLS;
    const int p_slot = __ldg(op + 0);
    const bool tip1 = __ldg(op + 3) != 0;
    const bool tip2 = __ldg(op + 6) != 0;
    const int slot1 = __ldg(op + 2);
    const int slot2 = __ldg(op + 5);
    const int code1 = tip1 ? __ldg(tip_col + (size_t)__ldg(op + 1) * tb) : 0;
    const int code2 = tip2 ? __ldg(tip_col + (size_t)__ldg(op + 4) * tb) : 0;
    const uint4* A1 = pfrag + (size_t)__ldg(op + 7) * (NP * 2 * 32) + lane;
    const uint4* A2 = pfrag + (size_t)__ldg(op + 8) * (NP * 2 * 32) + lane;
    const float* c1 = pool + slot1 * slot_stride + warp_off;
    const float* c2 = pool + slot2 * slot_stride + warp_off;
    float* par = pool + p_slot * slot_stride + warp_off;

    // span 16: the four tiles unrolled, so that one tile's shared-memory
    // loads and splits overlap another's mma and the A fragments are
    // loaded once per op; at span 80 one tile's state fills the registers
#pragma unroll (NP <= 4 ? WARP_TILES : 1)
    for (int tile = 0; tile < WARP_TILES; ++tile) {
      // the B fragment's site is lane/4 of this tile
      const int t1 = __shfl_sync(FULL, code1, tile * TILE + g);
      const int t2 = __shfl_sync(FULL, code2, tile * TILE + g);
      const int tile_off = tile * SPAN * TILE;
      float left[MT][4], right[MT][4];
      if (tip1)
        child_product<S, R, true>(left, t1, nullptr, A1, g, q);
      else
        child_product<S, R, false>(left, 0, c1 + tile_off, A1, g, q);
      if (tip2)
        child_product<S, R, true>(right, t2, nullptr, A2, g, q);
      else
        child_product<S, R, false>(right, 0, c2 + tile_off, A2, g, q);

      // this lane holds sites 2q, 2q+1 of the tile, rows g and g+8 of each
      // m-tile; the other rows of those sites are in the lanes with equal q
      float m0 = 0.0f, m1 = 0.0f;  // CLV entries are >= 0
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) left[mt][i] *= right[mt][i];
        m0 = fmaxf(m0, fmaxf(left[mt][0], left[mt][2]));
        m1 = fmaxf(m1, fmaxf(left[mt][1], left[mt][3]));
      }
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, x));
        m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, x));
      }
      const bool below0 = m0 < thresh, below1 = m1 < thresh;
      const float f0 = below0 ? factor : 1.0f, f1 = below1 ? factor : 1.0f;
      float* out = par + tile_off + 2 * q;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        *reinterpret_cast<float2*>(out + (16 * mt + g) * TILE) =
            make_float2(left[mt][0] * f0, left[mt][1] * f1);
        *reinterpret_cast<float2*>(out + (16 * mt + g + 8) * TILE) =
            make_float2(left[mt][2] * f0, left[mt][3] * f1);
      }
      if (g == 0) {  // once per site: lanes 0-3 carry sites 2q, 2q+1
        const int site = warp * 32 + tile * TILE + 2 * q;
        int2 s = make_int2(below0 ? 1 : 0, below1 ? 1 : 0);
        if (!tip1) {
          const int2 a = *reinterpret_cast<const int2*>(
              spool + (size_t)slot1 * tb + site);
          s.x += a.x;
          s.y += a.y;
        }
        if (!tip2) {
          const int2 a = *reinterpret_cast<const int2*>(
              spool + (size_t)slot2 * tb + site);
          s.x += a.x;
          s.y += a.y;
        }
        *reinterpret_cast<int2*>(spool + (size_t)p_slot * tb + site) = s;
      }
    }
    // stores in C layout above, loads in B layout in the next op
    __syncwarp();
  }

  // Export slots are never reused by the schedule.  Thread t copies site t,
  // which its own warp wrote: no block-wide barrier needed.
  const int t = threadIdx.x;
  for (int e = 0; e < n_exp; ++e) {
    const int slot = __ldg(export_slots + e);
    const float* src =
        pool + slot * slot_stride + (size_t)(t >> 3) * SPAN * TILE + (t & 7);
    float* dst = clv_out + ((size_t)e * nt + blk) * SPAN * tb + t;
    for (int k = 0; k < SPAN; ++k) dst[(size_t)k * tb] = src[k * TILE];
    scal_out[((size_t)e * nt + blk) * tb + t] = spool[(size_t)slot * tb + t];
  }
}

// pfrag [n_slots][n_pairs][2 (hi, lo)][32][4] from pmat [n_slots][pm_words]:
// element j of a slot's [n_pairs][32][4] fragment table is pmat[idx[j]]
// (idx[j] == pm_words: the zero outside the rate blocks), split into a TF32
// head and a TF32 remainder.  One thread per element.
__global__ void pmatrix_fragments_kernel(const float* __restrict__ pmat,
                                         const int* __restrict__ idx,
                                         float* __restrict__ pfrag,
                                         int n_slots, int n_pairs,
                                         int pm_words) {
  const int words = n_pairs * 128;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n_slots * words) return;
  const int slot = (int)(i / words), j = (int)(i % words);
  const int k = __ldg(idx + j);
  const float x = k < pm_words ? __ldg(pmat + (size_t)slot * pm_words + k)
                               : 0.0f;
  const float hi = __uint_as_float(to_tf32(x));
  const float lo = __uint_as_float(to_tf32(x - hi));
  float* out = pfrag + ((size_t)slot * n_pairs + j / 128) * 256 + j % 128;
  out[0] = hi;
  out[128] = lo;
}

template <int S, int R>
cudaError_t launch(const int* ops, int n_ops, const void* pfrag,
                   const int* tip_blocked, int tips, const int* export_slots,
                   int n_exp, float* clv_out, int* scal_out, int nt, int tb,
                   int pool_size, float thresh, float factor,
                   cudaStream_t stream) {
  const size_t smem = (size_t)pool_size * (R * S + 1) * tb * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tree_sweep_mma_kernel<S, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tree_sweep_mma_kernel<S, R><<<nt, tb, smem, stream>>>(
      ops, n_ops, static_cast<const uint4*>(pfrag), tip_blocked, tips,
      export_slots, n_exp, clv_out, scal_out, pool_size, thresh, factor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tree_sweep_mma_fragments: split P [n_slots][pm_words] into TF32 (hi, lo)
// in A-fragment order, by the index table idx [n_pairs][32][4] int32
// (partials_tree.mma_fragment_index), on `stream`.
//
// tree_sweep_mma_launch: the tensor-core sweep on `stream`.  pfrag:
// [P][NP][2 (hi, lo)][32 lanes][4] f32 already rounded to TF32 (the output
// of tree_sweep_mma_fragments).  tb is a multiple of 32; (states, rates)
// one of (4, 4), (20, 4).  Both return the cudaError_t of the launch.
int tree_sweep_mma_fragments(const float* pmat, const int* idx, float* pfrag,
                             int n_slots, int n_pairs, int pm_words,
                             void* stream) {
  const size_t total = (size_t)n_slots * n_pairs * 128;
  if (total == 0) return (int)cudaSuccess;
  pmatrix_fragments_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pmat, idx, pfrag, n_slots, n_pairs, pm_words);
  return (int)cudaGetLastError();
}

int tree_sweep_mma_launch(const int* ops, int n_ops, const void* pfrag,
                          const int* tip_blocked, int tips,
                          const int* export_slots, int n_exp, float* clv_out,
                          int* scal_out, int nt, int tb, int rates, int states,
                          int pool_size, float thresh, float factor,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tb % 32 != 0 || tb > 256) return (int)cudaErrorInvalidValue;
  if (states == 4 && rates == 4)
    return (int)launch<4, 4>(ops, n_ops, pfrag, tip_blocked, tips,
                             export_slots, n_exp, clv_out, scal_out, nt, tb,
                             pool_size, thresh, factor, s);
  if (states == 20 && rates == 4)
    return (int)launch<20, 4>(ops, n_ops, pfrag, tip_blocked, tips,
                              export_slots, n_exp, clv_out, scal_out, nt, tb,
                              pool_size, thresh, factor, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
