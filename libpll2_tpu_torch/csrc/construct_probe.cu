// The construct probe: two kernels in one source, launched by
// libpll2_tpu_torch/probes/constructs.py.
//
// static2_probe_launch: tools/static2probe.py:kernel (:41) of the JAX
// package, the same function.  Four kernels k0-k3 add, over n_ops ops w,
// acc[16, sites] += P . X in f32 from bf16 operands, with pm = (7 w) % 64,
// slot = w % 8, pcm [64][16][96] and pool [8][48][sites]:
//   k0  pcm[pm][:, :16] . pool[slot, :16]                 (one product)
//   k1  pcm[pm][:, :48] . pool[slot, :48]                 (K = 48)
//   k2  sum_s pcm[0][:, offs[s]:offs[s+1]] . pool[slot, :16 (s+1)],
//       offs = 0, 16, 48, 96: three static column groups of depth 16, 32, 48
//   k3  k2 with the gathered row pcm[pm]
// The TPU probe asked which of those constructs slowed a kernel down; here
// they are priced on Hopper's warpgroup products.
//
// What bounds it on an H100: at 65,536 sites and 128 ops, bytes for k0 and
// k1 (the pool, 17-50 MB, read once) and operations for k2 and k3 (2.6e10
// FLOP, 26 us at the bf16 peak).  The design keeps both in reach:
//   - sites on M: a warpgroup owns a tile of 64 sites and runs
//     wgmma.m64n16k16 bf16 with an f32 accumulator; N = 16 is the 16 rows
//     of the output, which stay in 8 registers a thread over all ops;
//   - A, the pool's site tile, in registers: a slot is re-read every 8 ops
//     and its prefix feeds all three column groups of k2 / k3, so all 8
//     slots' A fragments are loaded once a tile (8 x K/16 x 4 registers a
//     thread: 96 at K = 48) from a layout the wrapper packs in fragment
//     order, 16-byte loads, consecutive threads on consecutive words; the
//     pool is read from device memory once, and a warpgroup's next tile is
//     prefetched into L2 (bulk prefetches) while it computes this one;
//   - B, pcm's column groups, K-major 8-row x 16-byte core matrices in
//     shared memory, staged once per CTA with a zero row (32,768 bytes for
//     k0, 98,304 k1, 3,072 k2, 196,608 k3, and the row); a 64 x 16 x 16
//     product reads only its 512 B
//     there, against 8 clocks of tensor work, where both operands in shared
//     memory read 2,560;
//   - persistent CTAs of 2 warpgroups, as many as the card holds, every
//     warpgroup taking the same number of tiles; B copied by cp.async while
//     the first tile's A loads are in flight.
// Each op's products go into the one accumulator in w order (one wgmma a
// 16-deep k-step, k2 / k3's groups in order), without regrouping: the probe
// prices an op.  probes/variants.py's static2_smem_a builds the same kernel
// with A in shared memory (A_IN_REGISTERS = false), so that the gain of the
// register tile is measured, not assumed.
//
// construct_probe_launch: which construct of the tensor-core tree sweep
// (tree_sweep_mma.cu) costs the time: five minimal kernels c0-c4 over the
// same n_ops dependent ops at span 16, the first four each adding one
// construct of that sweep's inner loop to the one before, the fifth taking
// the costliest one out again the way the sweep does.  This port's study of
// its own sweep, on f32 inputs, with pm_w and slot_w as in the JAX probe.
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


// ---- k0-k3: tools/static2probe.py's function on wgmma -------------------

constexpr int WG_SITES = 64;   // sites of a warpgroup's tile: the wgmma's M
constexpr int CORE = 128;      // bytes of an 8-row x 16-byte core matrix
// Where the products read A, the pool's site tile: registers (this design)
// or the warpgroup's shared memory (probes/variants.py's static2_smem_a).
constexpr bool A_IN_REGISTERS = true;
// Warpgroups a CTA.  At K = 48 the A tile takes 96 registers a thread, and
// with 4 warpgroups (128 registers a thread at most) ptxas has too few left
// to keep the products in flight and serializes them.
constexpr int NWG = 2;

template <int V>
struct Static2 {
  static constexpr int K = V == 0 ? 16 : 48;     // pool rows a slot gives
  static constexpr int KS = K / 16;              // k-steps of a slot
  static constexpr int COLS = V == 0 ? 16 : V == 1 ? 48 : 96;  // pcm columns
  static constexpr int ROWS = V == 2 ? 1 : P_ROWS;             // pcm rows
  static constexpr int KC = COLS / 8;            // core matrices along K
  static constexpr int ROW_BYTES = 2 * KC * CORE;  // one pcm row [16][COLS]
  static constexpr int B_BYTES = ROWS * ROW_BYTES;
  // B, then a zero row: the ops of a last round of 8 past n_ops multiply it
  static constexpr int STAGED_BYTES = B_BYTES + ROW_BYTES;
  static constexpr int SLOT_BYTES = WG_SITES * K * 2;    // a slot's A tile
  static constexpr int A_BYTES = N_SLOTS * SLOT_BYTES;   // shared A a wg
  static constexpr int TILE_WORDS = N_SLOTS * KS * 128;  // uint4 a tile
};

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading byte offset (the next core matrix along K) and stride byte offset
// (the next 8 rows), each in 16-byte units.
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
// Keeps the compiler from moving accesses of the accumulators and of the A
// registers across the asynchronous products' fences and waits.
__device__ __forceinline__ void fence_acc(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_a(uint4& a) {
  asm volatile("" : "+r"(a.x), "+r"(a.y), "+r"(a.z), "+r"(a.w)::"memory");
}

#define S2_D8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

// d[64 x 16] += A[64 x 16] . B[16 x 16], bf16, f32 accumulate: A from four
// registers a thread (the mma.m16n8k16 A layout, warp w holding rows
// 16 w..16 w + 15), B through a descriptor.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint4& a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : S2_D8
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(1));
}
// The same with A through a descriptor too.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : S2_D8
      : "l"(da), "l"(db), "r"(1));
}
#undef S2_D8

// The products of one op into acc: `a` the slot's A registers, `da` its A
// tile in shared memory (static2_smem_a), `db` the descriptor of the op's
// pcm row.  A column c of the row starts c 16-byte units further on (c / 8
// core matrices of 128 bytes); a k-step of A is two core matrices.
template <int V>
__device__ __forceinline__ void static2_op(float (&acc)[8],
                                           const uint4 (&a)[Static2<V>::KS],
                                           uint64_t da, uint64_t db) {
  constexpr uint64_t STEP = 2 * CORE >> 4;
  auto product = [&](int ks, int col) {
    if constexpr (A_IN_REGISTERS)
      wgmma_rs(acc, a[ks], db + col);
    else
      wgmma_ss(acc, da + ks * STEP, db + col);
  };
  if constexpr (V <= 1) {
#pragma unroll
    for (int ks = 0; ks < Static2<V>::KS; ++ks) product(ks, 16 * ks);
  } else {
    product(0, 0);                    // columns 0-15 . rows 0-15
    product(0, 16);                   // columns 16-47 . rows 0-31
    product(1, 32);
    product(0, 48);                   // columns 48-95 . rows 0-47
    product(1, 64);
    product(2, 80);
  }
}

// grid: persistent CTAs of NWG warpgroups; warpgroup j of CTA b takes the
// tiles b NWG + j + i gridDim.x NWG.  a_frag [sites/64][8 slots][KS]
// [128 threads] uint4 (A fragments, bf16 pairs); b_cm [ROWS][2][KC][8][8]
// bf16 (core matrices); out [16][sites] f32.  Shared memory: B, a zero row
// of B, then (A in shared memory) each warpgroup's A tiles as core matrices
// [8 slots][8 site rows][K/8][8][8].
template <int V>
__global__ void __launch_bounds__(NWG * 128, 1)
static2_kernel(const uint4* __restrict__ a_frag,
               const uint4* __restrict__ b_cm, float* __restrict__ out,
               int sites, int n_ops) {
  using S = Static2<V>;
  extern __shared__ __align__(128) uint4 s2[];
  // the warpgroup and warp indices broadcast from lane 0, so that the
  // compiler sees every branch on them as warp-uniform: a wgmma, or a
  // register it reads, in a path it thinks divergent is serialized
  const int wg = __shfl_sync(FULL, threadIdx.x >> 7, 0);
  const int warp = __shfl_sync(FULL, (threadIdx.x >> 5) & 3, 0);
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = sites / WG_SITES, stride = gridDim.x * NWG;
  const int first = blockIdx.x * NWG + wg;
  const int count = first < tiles ? (tiles - first + stride - 1) / stride : 0;

  uint4 a[N_SLOTS][S::KS];
  auto load_a = [&](int tl) {
    const uint4* src = a_frag + (size_t)tl * S::TILE_WORDS + t;
#pragma unroll
    for (int s = 0; s < N_SLOTS; ++s)
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks)
        a[s][ks] = __ldg(src + (s * S::KS + ks) * 128);
  };
  // the first tile's loads and B's copies (16 bytes a thread at a time,
  // all in flight at once) go out together
  if (count > 0) load_a(first);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s2));
  for (int i = threadIdx.x; i < S::B_BYTES / 16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16 * i),
                 "l"(b_cm + i)
                 : "memory");
  for (int i = threadIdx.x; i < S::ROW_BYTES / 16; i += blockDim.x)
    s2[S::B_BYTES / 16 + i] = make_uint4(0, 0, 0, 0);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
  // the products read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t b_desc = matrix_desc(base, CORE, S::KC * CORE);
  const uint64_t zero_desc = b_desc + (S::B_BYTES >> 4);
  const uint32_t a_base = base + S::STAGED_BYTES + wg * S::A_BYTES;
  const uint64_t a_desc = matrix_desc(a_base, CORE, S::K / 8 * CORE);
  char* a_smem =
      reinterpret_cast<char*>(s2) + S::STAGED_BYTES + wg * S::A_BYTES;

  for (int it = 0; it < count; ++it) {
    const int tile = first + it * stride;
    // the warpgroup's next tile into L2 while this one is computed: warp 0,
    // 1/32 of it a lane
    if (warp == 0 && it + 1 < count)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                       a_frag + (size_t)(tile + stride) * S::TILE_WORDS +
                       lane * (S::TILE_WORDS / 32)),
                   "r"(S::TILE_WORDS / 32 * 16)
                   : "memory");
    if constexpr (!A_IN_REGISTERS) {
      // register r of k-step ks holds sites 16 warp + g (+ 8 for odd r),
      // k = 16 ks + 2 q (+ 8 for r >= 2) and k + 1: one word of a core
      // matrix row
#pragma unroll
      for (int s = 0; s < N_SLOTS; ++s)
#pragma unroll
        for (int ks = 0; ks < S::KS; ++ks) {
          const uint32_t r4[4] = {a[s][ks].x, a[s][ks].y, a[s][ks].z,
                                  a[s][ks].w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(
                a_smem + s * S::SLOT_BYTES +
                ((2 * warp + (r & 1)) * (S::K / 8) + 2 * ks + (r >> 1)) *
                    CORE +
                g * 16 + q * 4) = r4[r];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    }
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    fence_acc(acc);
#pragma unroll
    for (int s = 0; s < N_SLOTS; ++s)
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) fence_a(a[s][ks]);
    wgmma_fence();
    // rounds of 8 ops, one a slot; an op past n_ops in the last round
    // multiplies the zero row (adds exact zeros), so that no product sits
    // in a branch
    int pm = 0;   // 7 w mod 64
    for (int w0 = 0; w0 < n_ops; w0 += N_SLOTS) {
#pragma unroll
      for (int s = 0; s < N_SLOTS; ++s) {
        const uint64_t db =
            w0 + s < n_ops ? b_desc + ((V == 2 ? 0 : pm) * S::ROW_BYTES >> 4)
                           : zero_desc;
        static2_op<V>(acc, a[s], a_desc + (s * S::SLOT_BYTES >> 4), db);
        pm = (pm + 7) & (P_ROWS - 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // accumulator i: site 16 warp + g (+ 8 for i % 4 >= 2), output row
    // 8 (i / 4) + 2 q (+ 1 for odd i)
    float* o = out + (size_t)tile * WG_SITES + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[(size_t)(8 * (i >> 2) + 2 * q + (i & 1)) * sites + 8 * ((i >> 1) & 1)] =
          acc[i];
    if constexpr (!A_IN_REGISTERS)   // every warp is past its last product
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    if (it + 1 < count) load_a(tile + stride);
  }
}

// Launches on `stream`.  The first launch of an instantiation sets its
// shared-memory limit and counts the CTAs the card holds at once (one card:
// the count is kept for every later launch, so that a launch captured in a
// CUDA graph makes no other CUDA call).  The grid gives every warpgroup
// the same number of tiles: rounds = ceil(tiles / (held x NWG)).
template <int V>
cudaError_t launch_static2(const void* a_frag, const void* b_cm, float* out,
                           int sites, int n_ops, cudaStream_t stream) {
  using S = Static2<V>;
  constexpr size_t smem =
      S::STAGED_BYTES + (A_IN_REGISTERS ? 0 : (size_t)NWG * S::A_BYTES);
  static int held = 0;
  if (held == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        static2_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, static2_kernel<V>, NWG * 128, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    held = per_sm * sms;
  }
  const int tiles = sites / WG_SITES;
  const int rounds = (tiles + held * NWG - 1) / (held * NWG);
  const int grid = (tiles + rounds * NWG - 1) / (rounds * NWG);
  static2_kernel<V><<<grid, NWG * 128, smem, stream>>>(
      static_cast<const uint4*>(a_frag), static_cast<const uint4*>(b_cm), out,
      sites, n_ops);
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

// variant 0-3 (k0-k3).  a_frag: the pool's A fragments [sites/64][8]
// [K/16][128] uint4 (K = 16 for k0, 48 otherwise); b_cm: pcm's staged rows
// and columns as core matrices [ROWS][2][COLS/8][8][8] bf16 (k0 64 rows x
// 16 columns, k1 64 x 48, k2 row 0 x 96, k3 64 x 96); out [16][sites] f32.
// sites a positive multiple of 64.  Returns the cudaError_t of the launch.
int static2_probe_launch(int variant, const void* a_frag, const void* b_cm,
                         float* out, int sites, int n_ops, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sites <= 0 || sites % WG_SITES != 0 || n_ops < 0)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return (int)launch_static2<0>(a_frag, b_cm, out, sites, n_ops, s);
    case 1: return (int)launch_static2<1>(a_frag, b_cm, out, sites, n_ops, s);
    case 2: return (int)launch_static2<2>(a_frag, b_cm, out, sites, n_ops, s);
    case 3: return (int)launch_static2<3>(a_frag, b_cm, out, sites, n_ops, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
