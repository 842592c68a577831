// Rate of the small dense products a tree sweep could be built from, on
// the card's units: f32 FMAs, the tensor cores through mma.sync and
// through Hopper's warpgroup wgmma.mma_async.  Launched by
// libpll2_tpu_torch/probes/mma.py.
//
// Replaces tools/mxu_probe.py:kernel (:36) of the JAX package, which asked
// the same of the TPU's matrix unit: NREP products over NBUF = 4 rotating
// operand buffers and NBUF accumulator slots, product j adding A . B[j % NBUF]
// into slot j % NBUF, so that the slots are independent chains that expose
// the unit's pipelined rate, and nothing folds away.  The JAX kernel returns
// slot 0; this one returns every slot, out [grid][NBUF][...] f32, so that no
// slot can be dropped and each can be checked.  Every CTA computes the same
// sums over its TB sites (the columns of B[j]), as a sweep CTA would.
//
// Two orientations, as in the JAX probe (its transposed=False and True):
//   P on M      A = P [M, K], B[j] = sites [K, TB]  -> out[s] [M][TB]
//               (variants 0-4; forms FFMA and mma.sync);
//   sites on M  A = B[j]^T sites [TB, K], B = P [K, N] -> out[s] [TB][N]
//               (variants 5-7; form wgmma; the FFMA arithmetic would be the
//               same as P on M, so there is no FFMA form of it).
//
// What bounds it: operations, when the operands reach the unit fast enough.
// Each form is built so that they do:
//   FFMA      thread (pair, g) owns sites 2 pair, 2 pair + 1 and MG = M / G
//             rows; B [NBUF][K][TB] in shared memory, one float2 a k and
//             slot; A transposed [K][M] in shared memory (through the
//             read-only cache where it does not fit beside B), read as
//             warp-uniform float4 broadcasts that feed 2 SC FFMAs each: SC
//             slots are in flight and share every A load.
//   mma.sync  m16n8k8 TF32 / m16n8k16 bf16; a warp owns WT tiles of 8
//             sites and M / MW rows (MW warps share a site tile where one
//             CTA fills an SM, so that it has 8 warps); A in fragment order
//             [M/16][K/KSTEP][32 lanes][4] words, held in registers for the
//             whole chain where it takes at most 48 a lane, else in shared
//             memory (or the read-only cache); B tiled [NBUF][TB/8][K or
//             K/2][8] words in shared memory; SC slots in flight share each
//             A fragment.
//   wgmma     m64nNk8 TF32 / m64nNk16 bf16; a warpgroup owns 64 sites;
//             the NBUF site tiles and P sit in shared memory as 8-row x
//             16-byte core matrices, K-major (TF32 takes no other layout),
//             no swizzle, read through matrix descriptors; SC slots' products
//             are issued back to back, one commit group a round, and
//             wait_group 1 keeps a group in flight.
// The wrapper packs every operand into its form's layout, rounded to the
// unit's precision (TF32 nearest, bf16 nearest even), so that the products
// are exact and only the order and rounding of the sums differ.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBUF = 4;
constexpr int TILE = 8;           // sites of an mma.sync n-tile
constexpr int WG_SITES = 64;      // sites of a warpgroup's tile (wgmma)
constexpr int MAX_THREADS = 256;

enum Unit { UNIT_FMA = 0, UNIT_TF32 = 1, UNIT_BF16 = 2 };
enum ASource { A_REGS = 0, A_SMEM = 1, A_GLOBAL = 2 };

// Bytes of dynamic shared memory: the NBUF site buffers, then A (P) where
// it is staged there.  Element size 2 for bf16, 4 otherwise.
constexpr size_t smem_bytes(int width, int k, int unit, int asrc, int tb) {
  const size_t eb = unit == UNIT_BF16 ? 2 : 4;
  return (size_t)NBUF * k * tb * eb +
         (asrc == A_SMEM ? (size_t)width * k * eb : 0);
}

// n 16-byte words from global to shared memory, by all threads of the CTA.
__device__ __forceinline__ void stage(uint4* dst, const uint4* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// ---- FFMA ----------------------------------------------------------------

template <int M, int K, int G, int SC, int ASRC>
__global__ void __launch_bounds__(MAX_THREADS)
ffma_kernel(const float* __restrict__ a_t, const float* __restrict__ b,
            float* __restrict__ out, int tb, int nrep) {
  constexpr int MG = M / G;
  static_assert(MG % 4 == 0 && NBUF % SC == 0, "rows a thread, slots");
  extern __shared__ __align__(16) float fs[];
  const int b_floats = NBUF * K * tb;
  stage(reinterpret_cast<uint4*>(fs), reinterpret_cast<const uint4*>(b),
        b_floats / 4);
  if constexpr (ASRC == A_SMEM)
    stage(reinterpret_cast<uint4*>(fs + b_floats),
          reinterpret_cast<const uint4*>(a_t), K * M / 4);
  __syncthreads();
  const int pairs = tb / 2;
  const int pair = threadIdx.x % pairs, g = threadIdx.x / pairs;
  // A^T [K][M]: this thread's rows g MG.. as float4s, M / 4 of them a k
  const float4* a_s = reinterpret_cast<const float4*>(fs + b_floats) + g * MG / 4;
  const float4* a_g = reinterpret_cast<const float4*>(a_t) + g * MG / 4;
  const int rounds = nrep / NBUF;

  for (int s0 = 0; s0 < NBUF; s0 += SC) {
    float2 acc[SC][MG];
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int m = 0; m < MG; ++m) acc[c][m] = make_float2(0.0f, 0.0f);
    for (int r = 0; r < rounds; ++r) {
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        float2 x[SC];
#pragma unroll
        for (int c = 0; c < SC; ++c)
          x[c] = *reinterpret_cast<const float2*>(
              fs + ((s0 + c) * K + k) * tb + 2 * pair);
#pragma unroll
        for (int m4 = 0; m4 < MG / 4; ++m4) {
          float4 a;
          if constexpr (ASRC == A_SMEM)
            a = a_s[k * (M / 4) + m4];
          else
            a = __ldg(a_g + k * (M / 4) + m4);
#pragma unroll
          for (int c = 0; c < SC; ++c) {
            float2* o = acc[c] + 4 * m4;
            o[0].x = fmaf(a.x, x[c].x, o[0].x);
            o[0].y = fmaf(a.x, x[c].y, o[0].y);
            o[1].x = fmaf(a.y, x[c].x, o[1].x);
            o[1].y = fmaf(a.y, x[c].y, o[1].y);
            o[2].x = fmaf(a.z, x[c].x, o[2].x);
            o[2].y = fmaf(a.z, x[c].y, o[2].y);
            o[3].x = fmaf(a.w, x[c].x, o[3].x);
            o[3].y = fmaf(a.w, x[c].y, o[3].y);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      float* dst = out + ((size_t)blockIdx.x * NBUF + s0 + c) * M * tb +
                   (size_t)g * MG * tb + 2 * pair;
#pragma unroll
      for (int m = 0; m < MG; ++m)
        *reinterpret_cast<float2*>(dst + (size_t)m * tb) = acc[c][m];
    }
  }
}

// ---- mma.sync ------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

template <int M, int K, int UNIT, int SC, int ASRC, int WT, int MW>
__global__ void __launch_bounds__(MAX_THREADS)
mma_sync_kernel(const uint4* __restrict__ a_frag,
                const uint32_t* __restrict__ b, float* __restrict__ out,
                int tb, int nrep) {
  constexpr int KSTEP = UNIT == UNIT_BF16 ? 16 : 8;
  constexpr int MT = M / 16, KS = K / KSTEP;
  // a site's column in 32-bit words: K (TF32) or K/2 pairs (bf16)
  constexpr int KW = UNIT == UNIT_BF16 ? K / 2 : K;
  constexpr int MTW = MT / MW;   // m-tiles a warp
  constexpr int KS_UNROLL = ASRC == A_REGS ? KS : 2;
  static_assert(NBUF % SC == 0 && MT % MW == 0, "slots, m-tiles a warp");
  extern __shared__ __align__(16) uint32_t ws[];
  const int b_words = NBUF * KW * tb;
  stage(reinterpret_cast<uint4*>(ws), reinterpret_cast<const uint4*>(b),
        b_words / 4);
  const uint4* a_s = reinterpret_cast<const uint4*>(ws + b_words);
  if constexpr (ASRC == A_SMEM)
    stage(reinterpret_cast<uint4*>(ws + b_words), a_frag, MT * KS * 32);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // warp (sw, mw): WT tiles of 8 sites from sw WT 8 on, m-tiles mw MTW..
  const int site_warps = tb / (TILE * WT);
  const int sw = warp % site_warps, mw = warp / site_warps;
  const uint4* a_mine = a_frag + mw * MTW * KS * 32 + lane;
  const uint4* a_s_mine = a_s + mw * MTW * KS * 32 + lane;
  uint4 a_reg[ASRC == A_REGS ? MTW * KS : 1];
  if constexpr (ASRC == A_REGS) {
#pragma unroll
    for (int i = 0; i < MTW * KS; ++i) a_reg[i] = __ldg(a_mine + i * 32);
  }
  const int rounds = nrep / NBUF;

  for (int s0 = 0; s0 < NBUF; s0 += SC) {
    float acc[SC][WT][MTW][4];
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt)
          acc[c][i][mt][0] = acc[c][i][mt][1] = acc[c][i][mt][2] =
              acc[c][i][mt][3] = 0.0f;
    for (int r = 0; r < rounds; ++r) {
#pragma unroll (KS_UNROLL)
      for (int ks = 0; ks < KS; ++ks) {
        uint4 a[MTW];
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          if constexpr (ASRC == A_REGS)
            a[mt] = a_reg[mt * KS + ks];
          else if constexpr (ASRC == A_SMEM)
            a[mt] = a_s_mine[(mt * KS + ks) * 32];
          else
            a[mt] = __ldg(a_mine + (mt * KS + ks) * 32);
        }
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          const uint32_t* bp = ws + (s0 + c) * KW * tb +
                               sw * WT * KW * TILE + g;
          uint32_t b0[WT], b1[WT];
#pragma unroll
          for (int i = 0; i < WT; ++i) {
            b0[i] = bp[(i * KW + 8 * ks + q) * TILE];
            b1[i] = bp[(i * KW + 8 * ks + q + 4) * TILE];
          }
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
            for (int i = 0; i < WT; ++i) {
              if constexpr (UNIT == UNIT_TF32)
                mma_tf32(acc[c][i][mt], a[mt], b0[i], b1[i]);
              else
                mma_bf16(acc[c][i][mt], a[mt], b0[i], b1[i]);
            }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        float* o = out + ((size_t)blockIdx.x * NBUF + s0 + c) * M * tb +
                   (sw * WT + i) * TILE + 2 * q;
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          const int row = 16 * (mw * MTW + mt) + g;
          *reinterpret_cast<float2*>(o + (size_t)row * tb) =
              make_float2(acc[c][i][mt][0], acc[c][i][mt][1]);
          *reinterpret_cast<float2*>(o + (size_t)(row + 8) * tb) =
              make_float2(acc[c][i][mt][2], acc[c][i][mt][3]);
        }
      }
  }
}

// ---- wgmma ---------------------------------------------------------------

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading byte offset (the next 16-byte core-matrix column along K) and
// stride byte offset (the next 8 rows), each in 16-byte units.
__device__ __forceinline__ uint64_t matrix_desc(uint32_t smem_addr,
                                                uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products' fences and waits.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(b)                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),      \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

template <int N, int UNIT>
struct Wgmma;

template <>
struct Wgmma<16, UNIT_TF32> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : WG_D8(0)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<16, UNIT_BF16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : WG_D8(0)
        : "l"(da), "l"(db), "r"(1));
  }
};

#define WG_N80_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"

template <>
struct Wgmma<80, UNIT_TF32> {
  static __device__ __forceinline__ void run(float (&d)[40], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " WG_N80_REGS
        ", %40, %41, p, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<80, UNIT_BF16> {
  static __device__ __forceinline__ void run(float (&d)[40], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " WG_N80_REGS
        ", %40, %41, p, 1, 1, 0, 0;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32)
        : "l"(da), "l"(db), "r"(1));
  }
};

// sites: NBUF buffers of [TB/8][K*EB/16][8][16 B]; p: [N/8][K*EB/16][8][16 B]
// (core matrices, K-major); out [grid][NBUF][TB][N].
template <int N, int K, int UNIT, int SC>
__global__ void __launch_bounds__(MAX_THREADS)
wgmma_kernel(const uint4* __restrict__ p, const uint4* __restrict__ sites,
             float* __restrict__ out, int tb, int nrep) {
  constexpr int EB = UNIT == UNIT_BF16 ? 2 : 4;
  constexpr int KC = K * EB / 16;      // 16-byte core-matrix columns a row
  constexpr int KS = K * EB / 32;      // k-steps of 32 bytes
  constexpr int CORE = 128;            // bytes of an 8 x 16-byte core matrix
  constexpr int R = N / 2;             // accumulators a thread and slot
  static_assert(NBUF % SC == 0 && K * EB % 32 == 0 && N % 8 == 0, "shape");
  extern __shared__ __align__(128) uint4 ss[];
  const int site_bytes = tb * K * EB;  // one buffer
  stage(ss, sites, NBUF * site_bytes / 16);
  stage(ss + NBUF * site_bytes / 16, p, N * K * EB / 16);
  // the products read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(ss));
  const uint64_t p_desc =
      matrix_desc(base + NBUF * site_bytes, CORE, KC * CORE);
  const uint32_t wg_rows = base + wg * (WG_SITES / 8) * KC * CORE;
  constexpr uint64_t STEP = 2 * CORE >> 4;   // one k-step in 16-byte units
  const int rounds = nrep / NBUF;

  for (int s0 = 0; s0 < NBUF; s0 += SC) {
    float acc[SC][R];
    uint64_t a_desc[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[c][i] = 0.0f;
      fence_operands(acc[c]);
      a_desc[c] = matrix_desc(wg_rows + (s0 + c) * site_bytes, CORE,
                              KC * CORE);
    }
    wgmma_fence();
    for (int rd = 0; rd < rounds; ++rd) {
#pragma unroll
      for (int c = 0; c < SC; ++c)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          Wgmma<N, UNIT>::run(acc[c], a_desc[c] + ks * STEP,
                              p_desc + ks * STEP);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      fence_operands(acc[c]);
      // accumulator i of lane (g, q) in warp w: row 16 w + g (+ 8 for
      // i % 4 >= 2), column 8 (i / 4) + 2 q (+ 1 for odd i)
      const int w = t >> 5, g = (t & 31) >> 2, q = t & 3;
      const int row = wg * WG_SITES + 16 * w + g;
      float* o = out + (((size_t)blockIdx.x * NBUF + s0 + c) * tb + row) * N +
                 2 * q;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * N + 8 * j) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    }
  }
}

// ---- launch --------------------------------------------------------------

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), size_t smem, int grid,
                   int threads, cudaStream_t stream, Args... args) {
  if (threads <= 0 || threads > MAX_THREADS) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int M, int K, int G, int SC, int ASRC>
cudaError_t ffma(const void* a, const void* b, float* out, int grid, int tb,
                 int nrep, cudaStream_t s, size_t* smem_only) {
  const size_t smem = smem_bytes(M, K, UNIT_FMA, ASRC, tb);
  if (smem_only) { *smem_only = smem; return cudaSuccess; }
  return launch(ffma_kernel<M, K, G, SC, ASRC>, smem, grid, tb / 2 * G, s,
                static_cast<const float*>(a), static_cast<const float*>(b),
                out, tb, nrep);
}

template <int M, int K, int UNIT, int SC, int ASRC, int WT, int MW>
cudaError_t mma_sync(const void* a, const void* b, float* out, int grid,
                     int tb, int nrep, cudaStream_t s, size_t* smem_only) {
  const size_t smem = smem_bytes(M, K, UNIT, ASRC, tb);
  if (smem_only) { *smem_only = smem; return cudaSuccess; }
  if (tb % (TILE * WT) != 0) return cudaErrorInvalidValue;
  return launch(mma_sync_kernel<M, K, UNIT, SC, ASRC, WT, MW>, smem, grid,
                tb / (TILE * WT) * MW * 32, s,
                static_cast<const uint4*>(a), static_cast<const uint32_t*>(b),
                out, tb, nrep);
}

template <int N, int K, int UNIT, int SC>
cudaError_t wgmma(const void* p, const void* sites, float* out, int grid,
                  int tb, int nrep, cudaStream_t s, size_t* smem_only) {
  const size_t smem = smem_bytes(N, K, UNIT, A_SMEM, tb);
  if (smem_only) { *smem_only = smem; return cudaSuccess; }
  if (tb % WG_SITES != 0) return cudaErrorInvalidValue;
  return launch(wgmma_kernel<N, K, UNIT, SC>, smem, grid,
                tb / WG_SITES * 128, s, static_cast<const uint4*>(p),
                static_cast<const uint4*>(sites), out, tb, nrep);
}

// The configuration of every (variant, unit): probes/mma.py's CONFIGS holds
// the same (form, A source, slots in flight, row groups).
cudaError_t dispatch(int variant, int unit, const void* a, const void* b,
                     float* out, int grid, int tb, int nrep, cudaStream_t s,
                     size_t* smem_only) {
#define ARGS a, b, out, grid, tb, nrep, s, smem_only
  switch (variant * 3 + unit) {
    // ffma<M, K, row groups, slots in flight, A source>;
    // mma_sync<M, K, unit, slots in flight, A source, warp tiles, m-warps>
    // span16 [16,16]
    case 0: return ffma<16, 16, 1, 4, A_SMEM>(ARGS);
    case 1: return mma_sync<16, 16, UNIT_TF32, 4, A_REGS, 4, 1>(ARGS);
    case 2: return mma_sync<16, 16, UNIT_BF16, 4, A_REGS, 4, 1>(ARGS);
    // stacked3 [16,48]
    case 3: return ffma<16, 48, 2, 4, A_SMEM>(ARGS);
    case 4: return mma_sync<16, 48, UNIT_TF32, 4, A_REGS, 4, 1>(ARGS);
    case 5: return mma_sync<16, 48, UNIT_BF16, 4, A_REGS, 4, 1>(ARGS);
    // span80 [80,80]
    case 6: return ffma<80, 80, 4, 4, A_SMEM>(ARGS);
    case 7: return mma_sync<80, 80, UNIT_TF32, 1, A_SMEM, 2, 1>(ARGS);
    case 8: return mma_sync<80, 80, UNIT_BF16, 1, A_SMEM, 2, 1>(ARGS);
    // pack2 [32,96]
    case 9: return ffma<32, 96, 4, 4, A_SMEM>(ARGS);
    case 10: return mma_sync<32, 96, UNIT_TF32, 2, A_REGS, 4, 2>(ARGS);
    case 11: return mma_sync<32, 96, UNIT_BF16, 2, A_REGS, 4, 1>(ARGS);
    // pack4 [64,192]: A does not fit beside the f32 / TF32 site buffers
    case 12: return ffma<64, 192, 8, 4, A_GLOBAL>(ARGS);
    case 13: return mma_sync<64, 192, UNIT_TF32, 1, A_GLOBAL, 4, 4>(ARGS);
    case 14: return mma_sync<64, 192, UNIT_BF16, 1, A_SMEM, 4, 2>(ARGS);
    // t_span16 [TB,16]@[16,16], t_stacked3 [TB,48]@[48,16],
    // t_span80 [TB,80]@[80,80]: sites on M, no FFMA form
    case 16: return wgmma<16, 16, UNIT_TF32, 4>(ARGS);
    case 17: return wgmma<16, 16, UNIT_BF16, 4>(ARGS);
    case 19: return wgmma<16, 48, UNIT_TF32, 4>(ARGS);
    case 20: return wgmma<16, 48, UNIT_BF16, 4>(ARGS);
    case 22: return wgmma<80, 80, UNIT_TF32, 2>(ARGS);
    case 23: return wgmma<80, 80, UNIT_BF16, 2>(ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef ARGS
}

}  // namespace

extern "C" {

// variant: 0 span16 [16,16], 1 stacked3 [16,48], 2 span80 [80,80], 3 pack2
// [32,96], 4 pack4 [64,192] (M, K of A = P), 5 t_span16, 6 t_stacked3,
// 7 t_span80 (sites on M; K, N of B = P [16,16], [48,16], [80,80]); unit:
// 0 FMA, 1 TF32, 2 BF16.  a, b: the form's layouts (see top); out
// [grid][NBUF][M][tb] or [grid][NBUF][tb][N] f32; nrep a multiple of NBUF.
// Returns the cudaError_t of the launch.
int mma_probe_launch(int variant, int unit, const void* a, const void* b,
                     float* out, int grid, int tb, int nrep, void* stream) {
  if (tb <= 0 || tb % 32 != 0 || nrep % NBUF != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(variant, unit, a, b, out, grid, tb, nrep,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// Bytes of dynamic shared memory the launch of (variant, unit) at `tb`
// asks for, or -1 where there is no such launch.
long long mma_probe_smem(int variant, int unit, int tb) {
  size_t bytes = 0;
  if (dispatch(variant, unit, nullptr, nullptr, nullptr, 1, tb, NBUF,
               nullptr, &bytes) != cudaSuccess)
    return -1;
  return (long long)bytes;
}

}  // extern "C"
