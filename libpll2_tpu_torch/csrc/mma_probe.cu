// Rate of the small dense products a tree sweep could be built from, per
// execution unit of the card: f32 FMAs, TF32 mma.sync.m16n8k8 and bf16
// mma.sync.m16n8k16.  Launched by libpll2_tpu_torch/probes/mma.py.
//
// Replaces tools/mxu_probe.py:kernel (:36) of the JAX package, which asked the
// same of the TPU's matrix unit: NREP dependent products acc += A . B[j]
// with rotating B buffers and an f32 accumulator, operands resident on
// chip, so that nothing folds away and only the unit's rate is left.
//
// One CTA owns TB sites (columns of B) as a sweep CTA does; all CTAs read
// the same A [M, K] and B [NBUF, K, TB].  B is copied to shared memory
// once; A is read through the read-only cache in the layout its unit wants
// (prepared by the wrapper), as the sweep kernels read their P-matrices:
//   FMA   thread t owns site t and M accumulators; A transposed [K][M],
//         float4 uniform loads; B [NBUF][K][TB];
//   TF32  warp w owns 4 tiles of 8 sites; A in m16n8k8 fragment order
//         [M/16][K/8][32 lanes][4]; B tiled [NBUF][TB/8][K][8], values
//         already rounded to TF32;
//   BF16  the same with m16n8k16: A [M/16][K/16][32][4] packed bf16 pairs,
//         B [NBUF][TB/8][K/2][8] packed pairs along k.
// In the mma forms an A fragment is loaded once per (m-tile, k-step) and
// used for the warp's 4 tiles.  Bound: by the unit's issue rate when A and
// B loads keep up; the probe says whether they do.  out [grid][M][TB] f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBUF = 2;
constexpr int TILE = 8;
constexpr int WARP_TILES = 4;

enum Unit { UNIT_FMA = 0, UNIT_TF32 = 1, UNIT_BF16 = 2 };

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

// 32-bit words of one B buffer in shared memory.
template <int K, int UNIT>
__host__ __device__ constexpr int b_words(int tb) {
  return (UNIT == UNIT_BF16 ? K / 2 : K) * tb;
}

template <int M, int K, int UNIT>
__global__ void __launch_bounds__(256)
mma_probe_kernel(const void* __restrict__ a_in,
                 const uint32_t* __restrict__ b_in, float* __restrict__ out,
                 int nrep) {
  extern __shared__ uint32_t bs[];
  const int tb = blockDim.x, t = threadIdx.x;
  const int words = b_words<K, UNIT>(tb);
  for (int i = t; i < NBUF * words; i += tb) bs[i] = __ldg(b_in + i);
  __syncthreads();
  float* dst = out + (size_t)blockIdx.x * M * tb;

  if constexpr (UNIT == UNIT_FMA) {
    const float4* At = static_cast<const float4*>(a_in);   // [K][M/4]
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.0f;
    for (int rep = 0; rep < nrep; ++rep) {
      const float* b = reinterpret_cast<const float*>(bs) +
                       (rep % NBUF) * words + t;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float x = b[k * tb];
#pragma unroll
        for (int m4 = 0; m4 < M / 4; ++m4) {
          const float4 a = __ldg(At + k * (M / 4) + m4);
          acc[4 * m4 + 0] = fmaf(a.x, x, acc[4 * m4 + 0]);
          acc[4 * m4 + 1] = fmaf(a.y, x, acc[4 * m4 + 1]);
          acc[4 * m4 + 2] = fmaf(a.z, x, acc[4 * m4 + 2]);
          acc[4 * m4 + 3] = fmaf(a.w, x, acc[4 * m4 + 3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) dst[m * tb + t] = acc[m];
  } else {
    constexpr int KSTEP = UNIT == UNIT_BF16 ? 16 : 8;
    constexpr int MT = M / 16, KS = K / KSTEP;
    // rows of one tile in 32-bit words: K (tf32) or K/2 pairs (bf16)
    constexpr int KW = UNIT == UNIT_BF16 ? K / 2 : K;
    const uint4* A = static_cast<const uint4*>(a_in);   // [MT][KS][32]
    const int lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, q = lane & 3;
    float acc[WARP_TILES][MT][4];
#pragma unroll
    for (int i = 0; i < WARP_TILES; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        acc[i][mt][0] = acc[i][mt][1] = acc[i][mt][2] = acc[i][mt][3] = 0.0f;
    for (int rep = 0; rep < nrep; ++rep) {
      const uint32_t* b = bs + (rep % NBUF) * words +
                          warp * WARP_TILES * KW * TILE + g;
#pragma unroll 2
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b0[WARP_TILES], b1[WARP_TILES];
#pragma unroll
        for (int i = 0; i < WARP_TILES; ++i) {
          b0[i] = b[(i * KW + 8 * ks + q) * TILE];
          b1[i] = b[(i * KW + 8 * ks + q + 4) * TILE];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4 a = __ldg(A + (mt * KS + ks) * 32 + lane);
#pragma unroll
          for (int i = 0; i < WARP_TILES; ++i) {
            if constexpr (UNIT == UNIT_TF32)
              mma_tf32(acc[i][mt], a, b0[i], b1[i]);
            else
              mma_bf16(acc[i][mt], a, b0[i], b1[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WARP_TILES; ++i) {
      float* o = dst + warp * 32 + i * TILE + 2 * q;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        o[(16 * mt + g) * tb] = acc[i][mt][0];
        o[(16 * mt + g) * tb + 1] = acc[i][mt][1];
        o[(16 * mt + g + 8) * tb] = acc[i][mt][2];
        o[(16 * mt + g + 8) * tb + 1] = acc[i][mt][3];
      }
    }
  }
}

template <int M, int K, int UNIT>
cudaError_t launch_one(const void* a, const void* b, float* out, int grid,
                       int tb, int nrep, cudaStream_t stream) {
  const size_t smem = (size_t)NBUF * b_words<K, UNIT>(tb) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      mma_probe_kernel<M, K, UNIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mma_probe_kernel<M, K, UNIT><<<grid, tb, smem, stream>>>(
      a, static_cast<const uint32_t*>(b), out, nrep);
  return cudaGetLastError();
}

template <int M, int K>
cudaError_t launch_unit(int unit, const void* a, const void* b, float* out,
                        int grid, int tb, int nrep, cudaStream_t stream) {
  switch (unit) {
    case UNIT_FMA:
      return launch_one<M, K, UNIT_FMA>(a, b, out, grid, tb, nrep, stream);
    case UNIT_TF32:
      return launch_one<M, K, UNIT_TF32>(a, b, out, grid, tb, nrep, stream);
    case UNIT_BF16:
      return launch_one<M, K, UNIT_BF16>(a, b, out, grid, tb, nrep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// variant: 0 [16,16], 1 [16,48], 2 [80,80], 3 [32,96], 4 [64,192] (M, K of
// A); unit: 0 FMA, 1 TF32, 2 BF16.  a, b: the unit's layouts (see top);
// out [grid][M][tb] f32.  Returns the cudaError_t of the launch.
int mma_probe_launch(int variant, int unit, const void* a, const void* b,
                     float* out, int grid, int tb, int nrep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tb % 32 != 0 || tb > 256) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return (int)launch_unit<16, 16>(unit, a, b, out, grid, tb, nrep, s);
    case 1: return (int)launch_unit<16, 48>(unit, a, b, out, grid, tb, nrep, s);
    case 2: return (int)launch_unit<80, 80>(unit, a, b, out, grid, tb, nrep, s);
    case 3: return (int)launch_unit<32, 96>(unit, a, b, out, grid, tb, nrep, s);
    case 4: return (int)launch_unit<64, 192>(unit, a, b, out, grid, tb, nrep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
