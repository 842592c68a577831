// Which construct of the tensor-core tree sweep (tree_sweep_mma.cu) costs
// the time: five minimal kernels over the same n_ops dependent ops at span
// 16, the first four each adding one construct of that sweep's inner loop to
// the one before, the fifth taking the costliest one out again the way the
// sweep does.  Launched by libpll2_tpu_torch/probes/constructs.py.
//
// Replaces tools/static2probe.py:kernel (:41) of the JAX package, which found
// the slow construct of a TPU sweep kernel the same way: four kernels k0-k3
// computing acc += P[pm_w] @ pool[slot_w] with pm_w = (7 w) % 64 and
// slot_w = w % 8, from one plain product per op up to that kernel's whole
// inner loop.
//
// One CTA owns TB sites and holds the 8 pool slots in shared memory, tiled
// [TB/8][span][8] as the sweep tiles its slots; a warp owns 32 sites (4
// tiles of 8, unrolled as in the sweep) and reads nothing another warp
// writes.  P comes as the sweep's prologue leaves it: split into a TF32
// head and a TF32 remainder, in A-fragment order, pfrag [64][2 k-steps]
// [2 (hi, lo)][32 lanes][4].
//   c0  one mma.sync.m16n8k8 TF32 product per op and k-step: A fragments of
//       the fixed P[0] in registers, B loaded from the pool slot and rounded
//       to TF32, accumulated in registers;
//   c1  c0 plus the compensated split: B split into head and remainder at
//       load (a second cvt and a subtract), A's remainder in registers too,
//       three products per op and k-step (A_lo.B_hi + A_hi.B_lo + A_hi.B_hi);
//   c2  c1 plus the A fragments fetched per op by the gathered pm with
//       __ldg (through L1/L2), as the sweep reads pfrag;
//   c3  c2 plus the per-site rescue (maximum over a site's 16 entries by
//       three __shfl_xor_sync, rescale by `factor` below `thresh`, scaler
//       add by the lanes that own the site) and the C-fragment float2 store
//       into pool slot (w + 1) % 8, which op w + 1 reads after one
//       __syncwarp: the sweep's whole inner loop for one child, a chain
//       x <- rescue(P[pm_w] . x) through shared memory.
//   c4  c3 with the sweep's register carry: the parent goes from the
//       C-fragment layout to the next op's B-fragment layout by four
//       __shfl_sync per tile (tree_sweep_mma.cu's carry_tile) and never
//       touches shared memory; only the last op stores.  The same chain as
//       c3, bit for bit: what an op of the sweep costs when its inner child
//       is the previous op's parent.
// c0-c2 write acc [16, TB]; c3 and c4 write the last slot and the scaler
// counts.
//
// What bounds them on an H100: operations by the count, but neither peak in
// practice.  Per op and 8-site tile c0 runs 2 mma (c1-c3: 6) of 2048 FLOP;
// 65,536 sites x 128 ops of c1-c3 are 1.3e10 FLOP, 0.026 ms at the TF32
// rate, and the pool never leaves shared memory (4 MB of output, 0.001 ms).
// What is left is dispatch and latency: the dependent accumulator chain of the
// mma, the shared-memory round trip of c3, the shuffles.  The probe prices
// each, and c4 - c3 is what the register carry buys.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN = 16;       // rates * states of DNA with four categories
constexpr int KS = SPAN / 8;   // k-steps of one product
constexpr int P_ROWS = 64;
constexpr int N_SLOTS = 8;
constexpr int TILE = 8;        // sites per mma n-tile
constexpr int WARP_TILES = 4;  // tiles per warp: 32 sites
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a[16x8] . b[8x8], TF32 operands, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// A parent tile from C-fragment layout (y: rows g, g + 8 at sites 2q, 2q + 1)
// to B-fragment layout (b[ks][h]: row 8ks + 4h + q at site g), as
// tree_sweep_mma.cu's carry_tile does it at one m-tile.
__device__ __forceinline__ void carry_tile(const float (&y)[4],
                                           float (&b)[KS][2], int g, int q) {
  const bool upper = g >= 4;
  const int e = g & 1;
  const int src_same = 4 * (4 * e + q) + (g >> 1);
  const int src_other = 4 * (4 * (1 - e) + q) + (g >> 1);
  const float r0 = __shfl_sync(FULL, upper ? y[1] : y[0], src_same);
  const float r1 = __shfl_sync(FULL, upper ? y[3] : y[2], src_same);
  const float r2 = __shfl_sync(FULL, upper ? y[0] : y[1], src_other);
  const float r3 = __shfl_sync(FULL, upper ? y[2] : y[3], src_other);
  b[0][0] = e ? r2 : r0;
  b[0][1] = e ? r0 : r2;
  b[1][0] = e ? r3 : r1;
  b[1][1] = e ? r1 : r3;
}

// grid = CTAs of TB sites, block = TB threads.  shared: pool [8][TB/8][16][8]
// f32, spool [TB] i32.
template <int V>
__global__ void __launch_bounds__(256)
construct_probe_kernel(const uint4* __restrict__ pfrag,
                       const float* __restrict__ pool_in,
                       float* __restrict__ out, int* __restrict__ scal_out,
                       int n_ops, float thresh, float factor) {
  extern __shared__ float smem[];
  const int tb = blockDim.x, t = threadIdx.x;
  const int slot_stride = SPAN * tb;
  float* pool = smem;
  int* spool = reinterpret_cast<int*>(smem + N_SLOTS * slot_stride);
  for (int i = t; i < N_SLOTS * slot_stride; i += tb)
    pool[i] = __ldg(pool_in + i);
  spool[t] = 0;
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int warp_off = warp * WARP_TILES * SPAN * TILE;
  const uint4* A = pfrag + lane;   // entry (pm, ks, h): ((pm*KS + ks)*2 + h)*32

  uint4 a_hi[KS], a_lo[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a_hi[ks] = __ldg(A + (ks * 2 + 0) * 32);
    a_lo[ks] = __ldg(A + (ks * 2 + 1) * 32);
  }
  float acc[WARP_TILES][4];
  float held[WARP_TILES][KS][2];   // c4: the previous op's parent
#pragma unroll
  for (int i = 0; i < WARP_TILES; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) held[i][ks][0] = held[i][ks][1] = 0.0f;
  }

  for (int w = 0; w < n_ops; ++w) {
    if constexpr (V >= 2) {
      const int pm = (w * 7) % P_ROWS;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a_hi[ks] = __ldg(A + ((pm * KS + ks) * 2 + 0) * 32);
        a_lo[ks] = __ldg(A + ((pm * KS + ks) * 2 + 1) * 32);
      }
    }
    const float* src = pool + (w % N_SLOTS) * slot_stride + warp_off;
    float* dst = pool + ((w + 1) % N_SLOTS) * slot_stride + warp_off;
#pragma unroll
    for (int tile = 0; tile < WARP_TILES; ++tile) {
      const int tile_off = tile * SPAN * TILE;
      float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float(&d)[4] = V >= 3 ? y : acc[tile];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // the B fragment: k = q (+4) of this k-step, site g of the tile
        float x0, x1;
        if (V == 4 && w > 0) {
          x0 = held[tile][ks][0];
          x1 = held[tile][ks][1];
        } else {
          x0 = src[tile_off + (8 * ks + q) * TILE + g];
          x1 = src[tile_off + (8 * ks + q + 4) * TILE + g];
        }
        const uint32_t h0 = to_tf32(x0), h1 = to_tf32(x1);
        if constexpr (V >= 1) {
          const uint32_t l0 = to_tf32(x0 - __uint_as_float(h0));
          const uint32_t l1 = to_tf32(x1 - __uint_as_float(h1));
          mma_tf32(d, a_lo[ks], h0, h1);
          mma_tf32(d, a_hi[ks], l0, l1);
        }
        mma_tf32(d, a_hi[ks], h0, h1);
      }
      if constexpr (V >= 3) {
        // this lane holds sites 2q, 2q+1 of the tile, rows g and g+8; the
        // other rows of those sites are in the lanes with equal q
        float m0 = fmaxf(y[0], y[2]), m1 = fmaxf(y[1], y[3]);
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, x));
          m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, x));
        }
        const bool below0 = m0 < thresh, below1 = m1 < thresh;
        const float f0 = below0 ? factor : 1.0f, f1 = below1 ? factor : 1.0f;
        y[0] *= f0;
        y[1] *= f1;
        y[2] *= f0;
        y[3] *= f1;
        if (V == 4 && w + 1 < n_ops) {
          carry_tile(y, held[tile], g, q);
        } else {
          float* o = dst + tile_off + 2 * q;
          *reinterpret_cast<float2*>(o + g * TILE) = make_float2(y[0], y[1]);
          *reinterpret_cast<float2*>(o + (g + 8) * TILE) =
              make_float2(y[2], y[3]);
        }
        if (g == 0) {  // once per site: lanes 0-3 carry sites 2q, 2q+1
          int2* s = reinterpret_cast<int2*>(spool + warp * 32 + tile * TILE +
                                            2 * q);
          int2 v = *s;
          v.x += below0 ? 1 : 0;
          v.y += below1 ? 1 : 0;
          *s = v;
        }
      }
    }
    // stores in C layout above, loads in B layout in the next op
    if (V == 3 || (V == 4 && w + 1 == n_ops)) __syncwarp();
  }

  float* o = out + (size_t)blockIdx.x * SPAN * tb;
  if constexpr (V >= 3) {
    // thread t copies site t, which its own warp wrote
    const float* src = pool + (n_ops % N_SLOTS) * slot_stride +
                       (t >> 3) * SPAN * TILE + (t & 7);
    for (int k = 0; k < SPAN; ++k) o[k * tb + t] = src[k * TILE];
  } else {
#pragma unroll
    for (int tile = 0; tile < WARP_TILES; ++tile) {
      float* c = o + warp * 32 + tile * TILE + 2 * q;
      c[g * tb] = acc[tile][0];
      c[g * tb + 1] = acc[tile][1];
      c[(g + 8) * tb] = acc[tile][2];
      c[(g + 8) * tb + 1] = acc[tile][3];
    }
  }
  scal_out[(size_t)blockIdx.x * tb + t] = spool[t];
}

template <int V>
cudaError_t launch(const void* pfrag, const float* pool, float* out,
                   int* scal_out, int grid, int tb, int n_ops, float thresh,
                   float factor, cudaStream_t stream) {
  const size_t smem = (size_t)(N_SLOTS * SPAN + 1) * tb * 4;
  cudaError_t err = cudaFuncSetAttribute(
      construct_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  construct_probe_kernel<V><<<grid, tb, smem, stream>>>(
      static_cast<const uint4*>(pfrag), pool, out, scal_out, n_ops, thresh,
      factor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0-4 (c0-c4).  pfrag [64][2][2 (hi, lo)][32][4] f32 rounded to
// TF32; pool [8][tb/8][16][8] f32; out [grid][16][tb] f32; scal_out
// [grid][tb] i32.  tb a multiple of 32 up to 256.  Returns the cudaError_t
// of the launch.
int construct_probe_launch(int variant, const void* pfrag, const float* pool,
                           float* out, int* scal_out, int grid, int tb,
                           int n_ops, float thresh, float factor,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tb % 32 != 0 || tb <= 0 || tb > 256 || n_ops < 0)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return (int)launch<0>(pfrag, pool, out, scal_out, grid, tb, n_ops,
                                  thresh, factor, s);
    case 1: return (int)launch<1>(pfrag, pool, out, scal_out, grid, tb, n_ops,
                                  thresh, factor, s);
    case 2: return (int)launch<2>(pfrag, pool, out, scal_out, grid, tb, n_ops,
                                  thresh, factor, s);
    case 3: return (int)launch<3>(pfrag, pool, out, scal_out, grid, tb, n_ops,
                                  thresh, factor, s);
    case 4: return (int)launch<4>(pfrag, pool, out, scal_out, grid, tb, n_ops,
                                  thresh, factor, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
