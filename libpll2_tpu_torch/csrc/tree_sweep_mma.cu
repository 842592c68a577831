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
// Same contract as tree_sweep.cu: a runtime op table, CLV and scaler pools
// in shared memory, tips expanded from packed bits, per-site rescue,
// exported rows written as [E, NT, R, S, TB] / [E, NT, 1, TB].  The
// difference is the product, by
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  One TF32 pass keeps 11
// significant bits, so each operand is split into a TF32 head and a TF32
// remainder (x = hi + lo, |lo| <= 2^-11 |x|) and the three products
//   P_lo.c_hi + P_hi.c_lo + P_hi.c_hi
// are summed (the dropped P_lo.c_lo term and the remainders' own rounding
// are each about 2^-22 relative: the size of f32 rounding itself).  The same
// idea as the TPU kernel's stacked bf16 split terms, on this card's units.
// P is split once per call by a small kernel of this file
// (pmatrix_fragments_kernel), which also lays it out in fragment order, so a
// lane fetches its registers with 16-byte loads and no conversion.  The
// tensor cores round their accumulator toward zero where an FMA rounds to
// nearest: about half an f32 ulp per product, always downward, so exported
// rows drift from the FMA form's by about 2e-8 per op below them (1.6e-4 at
// 8,190 ops) while the logL, a sum of logs of magnitude thousands per site,
// moves by less than 1e-7 relative.  Tip children are 0/1: their remainder
// is zero and that product is skipped.
//
// Two kernels share the file.  The general one (tree_sweep_mma_kernel, span
// 80) takes the block-diagonal P as the A operand (16-row m-tiles, 8-column
// k-steps; pairs whose rows and columns share no rate are all zero and are
// skipped at compile time: 22 of 50) and the child's [span, 8] column tile
// as B; every parent goes through its pool slot, tiled [TB/8][span][8] so
// that the B loads and the C stores are free of bank conflicts.  One tile's
// accumulators and B fragments fill its registers (122 a thread), so it
// hands nothing on.  The small-span one (tree_sweep_mma_small_kernel, span
// 16) is the redesign described next.
//
// What bounds the sweep on an H100: the time one warp needs for one op,
// times the ops.  The ops of a tree are a dependent chain, thousands long,
// and under the Sethi-Ullman order two thirds of them consume the parent
// the op before them wrote.  The first version of this kernel took 2.6 us
// per op on 8,192 taxa (21.4 ms for 8,190 ops, H100 at 700 W), with eight
// warps on an SM or with two:
//   * the op's tips and P fragments were loaded at addresses only the op
//     row knows, after the row: two dependent trips to device memory per op;
//   * the warp's four 8-site tiles ran one after the other, because the
//     tip-or-inner branch sat inside the tile loop;
//   * the parent went to the next op through shared memory: rescue
//     shuffles, C-layout store, __syncwarp, B-layout load;
//   * the products' FLOPs are under 1 % of the tensor cores' rate, but a
//     warp's mma.sync, conversions and shuffles each wait for the one
//     before: the instruction count on the chain is what an op costs.
//
// What the small-span kernel does about it:
//   * sites on the M side: out[site][n] = sum_k child[site][k] Pbd[n][k],
//     the child's 16-site tile as A, P^T as B.  With 8 % S == 0 only the
//     SPAN / 8 pairs with k-step == n-tile are nonzero, each result tile is
//     one product per split term (half the mma.sync of the other
//     orientation), and with the contraction index permuted (k-index q is
//     state 8j + 2q, q + 4 is state 8j + 2q + 1) the accumulator a lane holds
//     IS the A fragment the next product needs: a parent stays in registers
//     for the op that consumes it with no data movement at all.  The host
//     marks which parents are handed on and which are stored
//     (partials_tree.carry_flags); rows and scalers are bit-equal either way;
//   * a lane reads from the pool only what it wrote itself, so the pool is
//     laid out per lane (16-byte loads and stores, no bank conflicts) and
//     nothing orders the lanes of a warp: no __syncwarp, no __syncthreads;
//   * the kinds of an op's children (tip, pool slot, handed on) and whether
//     its parent is stored are template parameters, chosen by one switch per
//     op, so the warp's two 16-site tiles and both children's products are
//     one straight line of code and their chains overlap; the host orders
//     the children so that five cases cover all (left * right commutes
//     exactly);
//   * op rows are fetched two ops ahead and the tips and P fragments one op
//     ahead, into registers: device memory is off the chain;
//   * a site's 16 entries sit in the four lanes of a quad: the rescue's max
//     is two __shfl_xor_sync, not three, and a quad's lane 0 keeps the
//     scalers of its two sites;
//   * the compensated split's three products go to two accumulators (the
//     chain is two mma.sync long, not three);
//   * the site block is chosen small (partials_tree.pick_site_block with the
//     SM count): warps are independent, and small blocks pack more of them
//     into an SM's shared memory; an op row is three 16-byte loads.
// What is left is one warp's instruction stream: 0.73 us per op on the same
// tree, about 1,200 cycles, which clock reads in the op loop
// (probes/variants.py clocks) put mostly before the first tile's products
// are done; neither fewer products per op, nor fetching two ops ahead, nor
// 16 sites a warp moved it.
//
// bf16 pools (BF16; cfg.dtype bfloat16), the counterpart of
// _tree_kernel_splitk at one split part: both operands are bf16 and each
// child is one mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per
// output tile, f32 accumulators, no split (a bf16 x bf16 product is exact in
// f32).  The rescue is decided on the f32 parent; the parent is rounded to
// the nearest even bf16 where it is stored, and where it is handed on (at
// the consuming op, with the same rounding, so the carry on and off stay
// bit-equal); an exported parent goes to device memory in f32 at the op
// that makes it (the slot holds the rounded one).
//   * small span (16): one k16 step covers the span.  A is the child's
//     16-site tile over all 16 states, B_j = P^T's n-tile j (half of it
//     zero: rates do not meet).  The C fragments of n-tiles 0 and 1 ARE the
//     A fragment of the next product (rows g, g + 8; columns 2q, 2q + 1 and
//     2q + 8, 2q + 9), packed to bf16x2: a lane's pool entry of a tile is
//     that fragment, one 16-byte word.
//   * general (span 80): the block-diagonal P in 16 x 16 tiles is A, five
//     k16 steps, the 13 of 25 tile pairs that meet a rate block; the child
//     tile [16 rows, 8 sites] is B, its pool slot laid out [TB/8][span/2][8]
//     words of two rows, so that b0 and b1 are one 32-bit load each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 8;        // sites per mma n-tile
constexpr int WARP_TILES = 4;  // tiles per warp: 32 sites
constexpr unsigned FULL = 0xffffffffu;

// Does the block-diagonal P have a nonzero entry in rows [16mt, 16mt+15],
// columns [K ks, K ks + K - 1]?  (Do the rates of the rows meet those of
// the columns.)  K: the k-step, 8 (TF32) or 16 (bf16).
__host__ __device__ constexpr bool pair_nonzero(int S, int mt, int ks,
                                                int K = 8) {
  return (16 * mt) / S <= (K * ks + K - 1) / S &&
         (K * ks) / S <= (16 * mt + 15) / S;
}

// Position of pair (mt, ks) among the nonzero pairs in row-major order;
// pair_index(S, KS, MT - 1, KS) is their number.
__host__ __device__ constexpr int pair_index(int S, int KS, int mt, int ks,
                                             int K = 8) {
  int n = 0;
  for (int m = 0; m <= mt; ++m)
    for (int k = 0; k < (m == mt ? ks : KS); ++k)
      if (pair_nonzero(S, m, k, K)) ++n;
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

// d += a[16x16] . b[16x8], bf16 operands (two a register, the lower index
// in the low half), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest even bf16, as one bf16x2 register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A tip's entries at states s0 and s1 of the packed mask `code` as one
// bf16x2 register: 1.0 (0x3f80) where the mask has the state, else 0.
__device__ __forceinline__ uint32_t tip_pair(int code, int s0, int s1) {
  return (((code >> s0) & 1) ? 0x3f80u : 0u) |
         (((code >> s1) & 1) ? 0x3f800000u : 0u);
}

// acc[mt] = (Pbd . child)[16mt .. 16mt+15][8 sites of this tile] in C
// fragment layout.  TIP: the child is a tip with packed state mask `code`
// (this lane's site); else b_of(ks, h) gives this lane's B-fragment entry,
// row 8ks + 4h + q of the child's tile at site g.  a_of(p, h) gives this
// lane's A fragment of nonzero pair p, TF32 head (h = 0) or remainder (1).
template <int S, int R, bool TIP, class BF, class AF>
__device__ __forceinline__ void child_product(float (&acc)[R * S / 16][4],
                                              int code, BF&& b_of, AF&& a_of,
                                              int q) {
  constexpr int SPAN = R * S, MT = SPAN / 16, KS = SPAN / 8;
  uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (TIP) {
        const int k = 8 * ks + 4 * h + q;
        bh[ks][h] = ((code >> (k % S)) & 1) ? 0x3f800000u : 0u;  // 1.0f / 0
        bl[ks][h] = 0u;
      } else {
        const float x = b_of(ks, h);
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
        const uint4 a_hi = a_of(p, 0);
        const uint4 a_lo = a_of(p, 1);
        mma_tf32(acc[mt], a_lo, bh[ks][0], bh[ks][1]);
        if constexpr (!TIP) mma_tf32(acc[mt], a_hi, bl[ks][0], bl[ks][1]);
        mma_tf32(acc[mt], a_hi, bh[ks][0], bh[ks][1]);
      }
    });
  });
}

// The same at bf16 (the general kernel): acc[mt] = (Pbd . child) over
// k16 steps.  TIP: the child is a tip (this lane's site g); else b_of(ks, h)
// gives this lane's B register h of k-step ks, rows 16ks + 8h + 2q and + 1
// at site g.  a_of(p) gives this lane's A fragment of nonzero pair p.
template <int S, int R, bool TIP, class BF, class AF>
__device__ __forceinline__ void child_product_bf16(
    float (&acc)[R * S / 16][4], int code, BF&& b_of, AF&& a_of, int q) {
  constexpr int SPAN = R * S, MT = SPAN / 16, KS = SPAN / 16;
  uint32_t b[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * ks + 8 * h + 2 * q;
      b[ks][h] = TIP ? tip_pair(code, k % S, (k + 1) % S) : b_of(ks, h);
    }
  }
  static_for<0, MT>([&](auto mi) {
    constexpr int mt = decltype(mi)::value;
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
    static_for<0, KS>([&](auto ki) {
      constexpr int ks = decltype(ki)::value;
      if constexpr (pair_nonzero(S, mt, ks, 16))
        mma_bf16(acc[mt], a_of(pair_index(S, KS, mt, ks, 16)), b[ks][0],
                 b[ks][1]);
    });
  });
}

// left *= right, then the per-site rescue.  This lane holds sites 2q, 2q+1
// of the tile, rows g and g+8 of each m-tile; the other rows of those sites
// are in the seven lanes with equal q: three __shfl_xor_sync over lane bits
// 2-4 take the site's maximum.  Returns whether each site was rescued.
template <int MT>
__device__ __forceinline__ int2 multiply_rescue(float (&left)[MT][4],
                                                const float (&right)[MT][4],
                                                float thresh, float factor) {
  float m0 = 0.0f, m1 = 0.0f;
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
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    left[mt][0] *= f0;
    left[mt][1] *= f1;
    left[mt][2] *= f0;
    left[mt][3] *= f1;
  }
  return make_int2(below0 ? 1 : 0, below1 ? 1 : 0);
}

// A parent tile in C-fragment layout to its place in a pool slot.
template <int MT>
__device__ __forceinline__ void store_tile(float* out,
                                           const float (&y)[MT][4], int g,
                                           int q) {
  out += 2 * q;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    *reinterpret_cast<float2*>(out + (16 * mt + g) * TILE) =
        make_float2(y[mt][0], y[mt][1]);
    *reinterpret_cast<float2*>(out + (16 * mt + g + 8) * TILE) =
        make_float2(y[mt][2], y[mt][3]);
  }
}

// Export slots are never reused by the schedule, and an exported parent is
// always stored.  Thread t copies site t, which its own warp wrote: no
// block-wide barrier needed.
template <int SPAN>
__device__ __forceinline__ void export_rows(
    const float* pool, const int* spool, size_t slot_stride, int tb,
    const int* __restrict__ export_slots, int n_exp,
    float* __restrict__ clv_out, int* __restrict__ scal_out) {
  const int t = threadIdx.x;
  const int blk = blockIdx.x, nt = gridDim.x;
  for (int e = 0; e < n_exp; ++e) {
    const int slot = __ldg(export_slots + e);
    const float* src =
        pool + slot * slot_stride + (size_t)(t >> 3) * SPAN * TILE + (t & 7);
    float* dst = clv_out + ((size_t)e * nt + blk) * SPAN * tb + t;
    for (int k = 0; k < SPAN; ++k) dst[(size_t)k * tb] = src[k * TILE];
    scal_out[((size_t)e * nt + blk) * tb + t] = spool[(size_t)slot * tb + t];
  }
}

// One row of the device table (partials_tree.mma_device_table): columns 0-8
// the schedule's, 9 the op's case (which kinds of children), 10 whether the
// parent is stored to its slot, 11 whether it is handed on in registers.
struct OpRow {
  int4 a, b, c;
  __device__ int parent() const { return a.x; }
  __device__ int tip1() const { return a.y; }
  __device__ int slot1() const { return a.z; }
  __device__ bool is_tip1() const { return a.w != 0; }
  __device__ int tip2() const { return b.x; }
  __device__ int slot2() const { return b.y; }
  __device__ bool is_tip2() const { return b.z != 0; }
  __device__ int pm1() const { return b.w; }
  __device__ int pm2() const { return c.x; }
  __device__ int kinds() const { return c.y; }
  __device__ bool keep() const { return c.w != 0; }
};

__device__ __forceinline__ OpRow load_row(const int4* __restrict__ ops,
                                          int w) {
  const int4* row = ops + 3 * (size_t)w;
  return OpRow{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
}

// The general kernel's scalers of sites `site` and `site` + 1, once per
// site (lanes 0-3 carry sites 2q, 2q+1 of a tile): the rescues s plus the
// children's counts, stored to the parent's slot and returned.
__device__ __forceinline__ int2 tile_scalers(int2 s, const OpRow& op,
                                             int* spool, int tb, int site) {
  if (!op.is_tip1()) {
    const int2 x = *reinterpret_cast<const int2*>(
        spool + (size_t)op.slot1() * tb + site);
    s.x += x.x;
    s.y += x.y;
  }
  if (!op.is_tip2()) {
    const int2 x = *reinterpret_cast<const int2*>(
        spool + (size_t)op.slot2() * tb + site);
    s.x += x.x;
    s.y += x.y;
  }
  *reinterpret_cast<int2*>(spool + (size_t)op.parent() * tb + site) = s;
  return s;
}

// One op of the general kernel at bf16, for the warp's WARP_TILES tiles of
// 8 sites.  A pool slot is [TB/8][span/2][8] words: rows 2k and 2k + 1 of
// site s in word k * 8 + s of its tile, the lower row in the low half.
// The parent is stored rounded; an exported one (export_at[w] >= 0) also
// goes out in f32.
template <int S, int R>
__device__ __forceinline__ void general_op_bf16(
    const OpRow& op, int w, const uint4* __restrict__ pfrag,
    __nv_bfloat16* poolb, int* spool, size_t slot_stride, int warp_off,
    int code1, int code2, const int* __restrict__ export_at,
    float* __restrict__ clv_out, int* __restrict__ scal_out, int tb,
    float thresh, float factor) {
  constexpr int SPAN = R * S, MT = SPAN / 16;
  constexpr int NP16 = pair_index(S, SPAN / 16, MT - 1, SPAN / 16, 16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool tip1 = op.is_tip1(), tip2 = op.is_tip2();
  const uint4* A1 = pfrag + (size_t)op.pm1() * (NP16 * 32) + lane;
  const uint4* A2 = pfrag + (size_t)op.pm2() * (NP16 * 32) + lane;
  auto a1 = [&](int p) { return __ldg(A1 + p * 32); };
  auto a2 = [&](int p) { return __ldg(A2 + p * 32); };
  const uint32_t* c1 = reinterpret_cast<const uint32_t*>(
      poolb + op.slot1() * slot_stride + warp_off);
  const uint32_t* c2 = reinterpret_cast<const uint32_t*>(
      poolb + op.slot2() * slot_stride + warp_off);
  __nv_bfloat16* par = poolb + op.parent() * slot_stride + warp_off;
  const int e = __ldg(export_at + w);
  const int nt = gridDim.x, blk = blockIdx.x;
#pragma unroll 1
  for (int tile = 0; tile < WARP_TILES; ++tile) {
    const int t1 = __shfl_sync(FULL, code1, tile * TILE + g);
    const int t2 = __shfl_sync(FULL, code2, tile * TILE + g);
    const int tile_words = tile * SPAN * TILE / 2;
    // rows 16ks + 8h + 2q, + 1 of site g: word (8ks + 4h + q) * 8 + g
    auto b1 = [&](int ks, int h) {
      return c1[tile_words + (8 * ks + 4 * h + q) * TILE + g];
    };
    auto b2 = [&](int ks, int h) {
      return c2[tile_words + (8 * ks + 4 * h + q) * TILE + g];
    };
    float left[MT][4], right[MT][4];
    if (tip1)
      child_product_bf16<S, R, true>(left, t1, b1, a1, q);
    else
      child_product_bf16<S, R, false>(left, 0, b1, a1, q);
    if (tip2)
      child_product_bf16<S, R, true>(right, t2, b2, a2, q);
    else
      child_product_bf16<S, R, false>(right, 0, b2, a2, q);
    int2 s = multiply_rescue<MT>(left, right, thresh, factor);
    // C layout: rows 16mt + g (+ 8), sites 2q, 2q + 1 of the tile
    __nv_bfloat16* out = par + tile * SPAN * TILE;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * mt + g + (i >> 1) * 8, site = 2 * q + (i & 1);
        out[((row >> 1) * TILE + site) * 2 + (row & 1)] =
            __float2bfloat16_rn(left[mt][i]);
      }
    }
    const int site = warp * 32 + tile * TILE + 2 * q;
    if (g == 0) s = tile_scalers(s, op, spool, tb, site);
    if (e >= 0) {
      float* dst = clv_out + ((size_t)e * nt + blk) * SPAN * tb + site;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[(size_t)(16 * mt + g + (i >> 1) * 8) * tb + (i & 1)] =
              left[mt][i];
      }
      if (g == 0)
        *reinterpret_cast<int2*>(scal_out + ((size_t)e * nt + blk) * tb +
                                 site) = s;
    }
  }
}

// The general kernel: any (S, R) whose span fills whole m-tiles; every parent
// goes through its pool slot (columns 9-11 of the table are not read).
// grid = NT site blocks, block = TB threads: warp w owns sites 32w..32w+31.
// shared: pool [pool_size][TB/8][span][8] f32 or, BF16, [pool_size][TB/8]
// [span/2][8] words of two rows; spool [pool_size][TB] i32.  export_at as
// in tree_sweep.cu (read by the BF16 kernel only), and p_base: a site
// block's P-matrices start p_base[block] slots into pfrag (null: 0).
template <int S, int R, bool BF16>
__global__ void __launch_bounds__(256)
tree_sweep_mma_kernel(const int4* __restrict__ ops, int n_ops,
                      const uint4* __restrict__ pfrag,
                      const int* __restrict__ p_base,
                      const int* __restrict__ tip_blocked, int tips,
                      const int* __restrict__ export_slots, int n_exp,
                      const int* __restrict__ export_at,
                      float* __restrict__ clv_out, int* __restrict__ scal_out,
                      int pool_size, float thresh, float factor) {
  constexpr int SPAN = R * S, MT = SPAN / 16, KS = SPAN / 8;
  static_assert(SPAN % 16 == 0, "span must fill whole 16-row m-tiles");
  constexpr int NP = pair_index(S, KS, MT - 1, KS);
  constexpr int NP16 = pair_index(S, SPAN / 16, MT - 1, SPAN / 16, 16);
  if (p_base != nullptr)
    pfrag += (size_t)__ldg(p_base + blockIdx.x) * (BF16 ? NP16 : NP * 2) * 32;
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t slot_stride = (size_t)SPAN * tb;   // entries
  float* pool = smem;
  __nv_bfloat16* poolb = reinterpret_cast<__nv_bfloat16*>(smem);
  int* spool = BF16 ? reinterpret_cast<int*>(poolb + pool_size * slot_stride)
                    : reinterpret_cast<int*>(pool + pool_size * slot_stride);
  const int warp_off = warp * WARP_TILES * SPAN * TILE;
  // tip i at this lane's site: tip_col[i * tb]
  const int* tip_col =
      tip_blocked + (size_t)blockIdx.x * tips * tb + threadIdx.x;

  for (int w = 0; w < n_ops; ++w) {
    const OpRow op = load_row(ops, w);
    const bool tip1 = op.is_tip1(), tip2 = op.is_tip2();
    const int code1 = tip1 ? __ldg(tip_col + (size_t)op.tip1() * tb) : 0;
    const int code2 = tip2 ? __ldg(tip_col + (size_t)op.tip2() * tb) : 0;
    if constexpr (BF16) {
      general_op_bf16<S, R>(op, w, pfrag, poolb, spool, slot_stride,
                            warp_off, code1, code2, export_at, clv_out,
                            scal_out, tb, thresh, factor);
    } else {
      const uint4* A1 = pfrag + (size_t)op.pm1() * (NP * 2 * 32) + lane;
      const uint4* A2 = pfrag + (size_t)op.pm2() * (NP * 2 * 32) + lane;
      auto a1 = [&](int p, int h) { return __ldg(A1 + (2 * p + h) * 32); };
      auto a2 = [&](int p, int h) { return __ldg(A2 + (2 * p + h) * 32); };
      const float* c1 = pool + op.slot1() * slot_stride + warp_off;
      const float* c2 = pool + op.slot2() * slot_stride + warp_off;
      float* par = pool + op.parent() * slot_stride + warp_off;

      // one tile at a time: at span 80 one tile's accumulators and B
      // fragments fill the registers
#pragma unroll 1
      for (int tile = 0; tile < WARP_TILES; ++tile) {
        // the B fragment's site is lane/4 of this tile
        const int t1 = __shfl_sync(FULL, code1, tile * TILE + g);
        const int t2 = __shfl_sync(FULL, code2, tile * TILE + g);
        const int tile_off = tile * SPAN * TILE;
        auto b1 = [&](int ks, int h) {
          return c1[tile_off + (8 * ks + 4 * h + q) * TILE + g];
        };
        auto b2 = [&](int ks, int h) {
          return c2[tile_off + (8 * ks + 4 * h + q) * TILE + g];
        };
        float left[MT][4], right[MT][4];
        if (tip1)
          child_product<S, R, true>(left, t1, b1, a1, q);
        else
          child_product<S, R, false>(left, 0, b1, a1, q);
        if (tip2)
          child_product<S, R, true>(right, t2, b2, a2, q);
        else
          child_product<S, R, false>(right, 0, b2, a2, q);
        int2 s = multiply_rescue<MT>(left, right, thresh, factor);
        store_tile<MT>(par + tile_off, left, g, q);
        if (g == 0)
          tile_scalers(s, op, spool, tb, warp * 32 + tile * TILE + 2 * q);
      }
    }
    // stores in C layout above, loads in B layout in a later op
    __syncwarp();
  }
  if constexpr (!BF16)
    export_rows<SPAN>(pool, spool, slot_stride, tb, export_slots, n_exp,
                      clv_out, scal_out);
}

// ---- the small-span kernel: sites on the M side of the product, operands
// fetched one op ahead, a parent handed on in its accumulator registers ----
//
// out[site][n] = sum_k child[site][k] Pbd[n][k]: the child's 16-site tile is
// the A operand, P^T the B operand.  With 8 % S == 0 the 8 states of a
// k-step share their rates with exactly one 8-row n-tile, so the nonzero
// (k-step, n-tile) pairs are the SPAN / 8 with k-step == n-tile == j, and
// n-tile j of the result is one product.  The contraction index may be
// permuted freely as long as both operands agree; here k-index q stands
// for state 8j + 2q and k-index q + 4 for state 8j + 2q + 1.  Then the
// accumulator a lane holds for n-tile j (C fragment: sites g, g + 8; states
// 8j + 2q, 8j + 2q + 1) IS the A fragment it needs for k-step j of the next
// product (rows g, g + 8; k-indices q, q + 4): c0, c2, c1, c3 are a0, a1, a2,
// a3.  A parent reaches the op that consumes it without any data movement.

constexpr int M_SITES = 16;   // sites per m-tile
constexpr int WARP_M = 2;     // m-tiles a warp owns: 32 sites

// Where a child's tile comes from.  The host orders an op's children so
// that the first kind is not after the second (the product left * right
// commutes exactly), and at most the second is CARRIED.
enum class Child { TIP, POOL, CARRIED };

// What an op reads from device memory besides its row.  M: m-tiles a warp
// owns; NT: n-tiles (= k-steps) of the span.
template <int M, int NT, bool BF16 = false>
struct Fetched {
  int code1[M][2], code2[M][2];  // the tips' packed states at sites g, g + 8
  // this lane's B fragments of both P-matrices: f32, per n-tile (b0, b1)
  // TF32 heads, (b0, b1) remainders; bf16, (b0, b1) of n-tile 0, then of
  // n-tile 1, in one word
  std::conditional_t<BF16, uint4, float4> b1[BF16 ? 1 : NT], b2[BF16 ? 1 : NT];
};

// The P fragments' element type: float4 (f32) or uint4 (bf16).
template <bool BF16>
using PFrag = std::conditional_t<BF16, uint4, float4>;

template <int M, int NT, bool BF16>
__device__ __forceinline__ void fetch(
    Fetched<M, NT, BF16>& f, const OpRow& op,
    const PFrag<BF16>* __restrict__ pfrag_lane,
    const int* __restrict__ tip_col, int tb) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int site = m * M_SITES + 8 * c;
      f.code1[m][c] = op.is_tip1()
                          ? __ldg(tip_col + (size_t)op.tip1() * tb + site) : 0;
      f.code2[m][c] = op.is_tip2()
                          ? __ldg(tip_col + (size_t)op.tip2() * tb + site) : 0;
    }
  }
  if constexpr (BF16) {
    f.b1[0] = __ldg(pfrag_lane + (size_t)op.pm1() * 32);
    f.b2[0] = __ldg(pfrag_lane + (size_t)op.pm2() * 32);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      f.b1[j] = __ldg(pfrag_lane + ((size_t)op.pm1() * NT + j) * 32);
      f.b2[j] = __ldg(pfrag_lane + ((size_t)op.pm2() * NT + j) * 32);
    }
  }
}

// bf16, span 16: the A fragment of a child's 16-site tile over the whole
// span (registers: rows g, g + 8 at columns 2q, 2q + 1; the same at
// 2q + 8, 2q + 9) ...
// ... of a tip, from its packed states at sites g and g + 8;
template <int S>
__device__ __forceinline__ uint4 tip_fragment(int code_g, int code_g8,
                                              int q) {
  const int k = 2 * q, k8 = 2 * q + 8;
  return make_uint4(tip_pair(code_g, k % S, (k + 1) % S),
                    tip_pair(code_g8, k % S, (k + 1) % S),
                    tip_pair(code_g, k8 % S, (k8 + 1) % S),
                    tip_pair(code_g8, k8 % S, (k8 + 1) % S));
}

// ... and of a parent from its accumulators (n-tiles 0 and 1 in C order),
// rounded to nearest even: how it is stored, and how a handed-on one is
// read.
__device__ __forceinline__ uint4 parent_fragment(const float (&y)[2][4]) {
  return make_uint4(pack_bf16(y[0][0], y[0][1]), pack_bf16(y[0][2], y[0][3]),
                    pack_bf16(y[1][0], y[1][1]), pack_bf16(y[1][2], y[1][3]));
}

// A tip's entries at one n-tile, in C order, as f32 bit patterns: 1.0f where
// the packed state mask has the state, else 0 (both exact in TF32).
__device__ __forceinline__ void tip_entries(float (&x)[4], int code_g,
                                            int code_g8, int st) {
  x[0] = __uint_as_float(((code_g >> st) & 1) ? 0x3f800000u : 0u);
  x[1] = __uint_as_float(((code_g >> (st + 1)) & 1) ? 0x3f800000u : 0u);
  x[2] = __uint_as_float(((code_g8 >> st) & 1) ? 0x3f800000u : 0u);
  x[3] = __uint_as_float(((code_g8 >> (st + 1)) & 1) ? 0x3f800000u : 0u);
}

// d (C order: site g states 2q, 2q + 1; site g + 8 the same) = child tile .
// P^T for one n-tile.  x: the child's entries in the same C order (a tip's
// are 0 or 1: their own TF32 heads, with no remainder).  The three products
// of the compensated split go to two accumulators that are added at the
// end, so the chain is two mma long, not three.
template <bool TIP>
__device__ __forceinline__ void site_product(float (&d)[4],
                                             const float (&x)[4],
                                             const float4& b) {
  uint4 hi, lo;
  if constexpr (TIP) {
    hi.x = __float_as_uint(x[0]), hi.y = __float_as_uint(x[2]);
    hi.z = __float_as_uint(x[1]), hi.w = __float_as_uint(x[3]);
  } else {
    hi.x = to_tf32(x[0]), hi.y = to_tf32(x[2]);
    hi.z = to_tf32(x[1]), hi.w = to_tf32(x[3]);
  }
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
  float main[4] = {0.0f, 0.0f, 0.0f, 0.0f}, corr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(corr, hi, bl0, bl1);
  if constexpr (!TIP) {
    lo.x = to_tf32(x[0] - __uint_as_float(hi.x));
    lo.y = to_tf32(x[2] - __uint_as_float(hi.y));
    lo.z = to_tf32(x[1] - __uint_as_float(hi.z));
    lo.w = to_tf32(x[3] - __uint_as_float(hi.w));
    mma_tf32(corr, lo, bh0, bh1);
  }
  mma_tf32(main, hi, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = main[i] + corr[i];
}

// The warp's share of one op: M m-tiles of 16 sites, each NT products per
// child.  The kinds of both children and whether the parent is handed on
// (KEEP) or stored are compile-time, so the tiles are one straight line of
// code and their chains overlap.  A lane reads from the pool only what it
// wrote itself (pool4: [slot][16-site tile][n-tile][lane] float4 in C
// order; spool: [slot][site], the lanes with q == 0), so nothing orders
// the warp's lanes against each other.
// BF16: the pool is uint4 [slot][tile][lane], a lane's A fragment of the
// tile (parent_fragment), and an exported parent (e >= 0) also goes out to
// clv_out / scal_out in f32 at this op.
template <int S, int R, int M, Child K1, Child K2, bool KEEP, bool BF16>
__device__ __forceinline__ void op_tiles(
    const OpRow& op, const Fetched<M, R * S / 8, BF16>& f, void* pool,
    int* spool, int tb, int warp, int lane, float thresh, float factor,
    float (&held)[M][R * S / 8][4], int2 (&held_scal)[M], int e,
    float* __restrict__ clv_out, int* __restrict__ scal_out) {
  constexpr int NT = R * S / 8;
  static_assert(K1 != Child::CARRIED, "the host puts a carried child second");
  static_assert(!BF16 || NT == 2, "bf16: one k16 step, span 16");
  const int g = lane >> 2, q = lane & 3;
  const int tiles = tb / M_SITES;      // 16-site tiles of the CTA
  float4* pool4 = static_cast<float4*>(pool);
  uint4* poolb = static_cast<uint4*>(pool);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int tile = warp * M + m;
    const float4* c1 = pool4 + ((size_t)op.slot1() * tiles + tile) * NT * 32
                       + lane;
    const float4* c2 = pool4 + ((size_t)op.slot2() * tiles + tile) * NT * 32
                       + lane;
    float y[NT][4];
    if constexpr (BF16) {
      uint4 a1, a2;
      if constexpr (K1 == Child::TIP)
        a1 = tip_fragment<S>(f.code1[m][0], f.code1[m][1], q);
      else
        a1 = poolb[((size_t)op.slot1() * tiles + tile) * 32 + lane];
      if constexpr (K2 == Child::TIP)
        a2 = tip_fragment<S>(f.code2[m][0], f.code2[m][1], q);
      else if constexpr (K2 == Child::CARRIED)
        a2 = parent_fragment(held[m]);
      else
        a2 = poolb[((size_t)op.slot2() * tiles + tile) * 32 + lane];
      const uint4 b1 = f.b1[0], b2 = f.b2[0];
      float right[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) y[j][i] = right[j][i] = 0.0f;
      }
      mma_bf16(y[0], a1, b1.x, b1.y);
      mma_bf16(y[1], a1, b1.z, b1.w);
      mma_bf16(right[0], a2, b2.x, b2.y);
      mma_bf16(right[1], a2, b2.z, b2.w);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) y[j][i] *= right[j][i];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float x1[4], x2[4], right[4];
        const int st = (8 * j + 2 * q) % S;   // state 8j + 2q within its rate
        if constexpr (K1 == Child::TIP) {
          tip_entries(x1, f.code1[m][0], f.code1[m][1], st);
        } else {
          const float4 v = c1[j * 32];
          x1[0] = v.x, x1[1] = v.y, x1[2] = v.z, x1[3] = v.w;
        }
        if constexpr (K2 == Child::TIP) {
          tip_entries(x2, f.code2[m][0], f.code2[m][1], st);
        } else if constexpr (K2 == Child::CARRIED) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x2[i] = held[m][j][i];
        } else {
          const float4 v = c2[j * 32];
          x2[0] = v.x, x2[1] = v.y, x2[2] = v.z, x2[3] = v.w;
        }
        site_product<K1 == Child::TIP>(y[j], x1, f.b1[j]);
        site_product<K2 == Child::TIP>(right, x2, f.b2[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) y[j][i] *= right[i];
      }
    }
    // the rescue: a site's 16 entries sit in the four lanes of its quad
    float ma = 0.0f, mb = 0.0f;  // CLV entries are >= 0
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      ma = fmaxf(ma, fmaxf(y[j][0], y[j][1]));
      mb = fmaxf(mb, fmaxf(y[j][2], y[j][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, x));
      mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, x));
    }
    const bool below_a = ma < thresh, below_b = mb < thresh;
    const float fa = below_a ? factor : 1.0f, fb = below_b ? factor : 1.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      y[j][0] *= fa;
      y[j][1] *= fa;
      y[j][2] *= fb;
      y[j][3] *= fb;
    }
    // scalers, once per site: the quad's lane 0 carries sites g and g + 8
    const int site = tile * M_SITES + g;
    int2 s = make_int2(below_a ? 1 : 0, below_b ? 1 : 0);
    if (q == 0) {
      if constexpr (K1 == Child::POOL) {
        s.x += spool[(size_t)op.slot1() * tb + site];
        s.y += spool[(size_t)op.slot1() * tb + site + 8];
      }
      if constexpr (K2 == Child::POOL) {
        s.x += spool[(size_t)op.slot2() * tb + site];
        s.y += spool[(size_t)op.slot2() * tb + site + 8];
      }
      if constexpr (K2 == Child::CARRIED) {
        s.x += held_scal[m].x;
        s.y += held_scal[m].y;
      }
    }
    if constexpr (KEEP) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) held[m][j][i] = y[j][i];
      }
      held_scal[m] = s;
    } else {
      if constexpr (BF16) {
        poolb[((size_t)op.parent() * tiles + tile) * 32 + lane] =
            parent_fragment(y);
      } else {
        float4* par = pool4 + ((size_t)op.parent() * tiles + tile) * NT * 32
                      + lane;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          par[j * 32] = make_float4(y[j][0], y[j][1], y[j][2], y[j][3]);
      }
      if (q == 0) {
        spool[(size_t)op.parent() * tb + site] = s.x;
        spool[(size_t)op.parent() * tb + site + 8] = s.y;
      }
      if constexpr (BF16) {
        // an exported parent is never handed on
        if (e >= 0) {
          const size_t row0 = (size_t)e * gridDim.x + blockIdx.x;
          float* dst = clv_out + row0 * (R * S) * tb + site;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float* row = dst + (size_t)(8 * j + 2 * q) * tb;
            row[0] = y[j][0];
            row[tb] = y[j][1];
            row[8] = y[j][2];
            row[tb + 8] = y[j][3];
          }
          if (q == 0) {
            scal_out[row0 * tb + site] = s.x;
            scal_out[row0 * tb + site + 8] = s.y;
          }
        }
      }
    }
  }
}

// grid = NT site blocks of TB sites; block = TB threads: a warp owns WARP_M
// tiles of 16 sites, whose chains overlap.  shared: pool4 and spool as
// op_tiles says, TB * (span * item + 4) bytes a slot (item 4, or 2 at
// BF16), the general kernel's footprint.  A parent is either stored or
// handed on, never both (partials_tree.carry_flags).  export_at as in
// tree_sweep.cu (read by the BF16 kernel only).  p_base as for
// tree_sweep_mma_kernel.
template <int S, int R, bool BF16>
__global__ void __launch_bounds__(256)
tree_sweep_mma_small_kernel(const int4* __restrict__ ops, int n_ops,
                            const PFrag<BF16>* __restrict__ pfrag,
                            const int* __restrict__ p_base,
                            const int* __restrict__ tip_blocked, int tips,
                            const int* __restrict__ export_slots, int n_exp,
                            const int* __restrict__ export_at,
                            float* __restrict__ clv_out,
                            int* __restrict__ scal_out, int pool_size,
                            float thresh, float factor) {
  constexpr int SPAN = R * S, NT = SPAN / 8, M = WARP_M;
  static_assert(8 % S == 0, "a k-step's states must share whole rates");
  extern __shared__ float4 smem4[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  float4* pool4 = smem4;
  const size_t pool_bytes = (size_t)pool_size * tb * SPAN * (BF16 ? 2 : 4);
  int* spool = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                      pool_bytes);
  // the tips at this lane's sites g (+ 8) of the warp's first tile
  const int* tip_col = tip_blocked + (size_t)blockIdx.x * tips * tb +
                       warp * M * M_SITES + g;
  if (p_base != nullptr)
    pfrag += (size_t)__ldg(p_base + blockIdx.x) * (BF16 ? 1 : NT) * 32;
  const PFrag<BF16>* pfrag_lane = pfrag + lane;

  float held[M][NT][4];   // the previous parent, as its accumulators left it
  int2 held_scal[M];      // its scaler counts (lanes with q == 0)
#pragma unroll
  for (int m = 0; m < M; ++m) {
    held_scal[m] = make_int2(0, 0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) held[m][j][i] = 0.0f;
    }
  }

  // rows two ops ahead, tips and B fragments one op ahead: their device
  // memory latency is off the chain from one op to the next.  Past the end
  // the last row is fetched again and not used.
  const int last = n_ops - 1;
  OpRow op = load_row(ops, 0), next_op = load_row(ops, min(1, last));
  Fetched<M, NT, BF16> f, next_f;
  fetch<M, NT, BF16>(f, op, pfrag_lane, tip_col, tb);
  for (int w = 0; w < n_ops; ++w) {
    const OpRow after = load_row(ops, min(w + 2, last));
    fetch<M, NT, BF16>(next_f, next_op, pfrag_lane, tip_col, tb);
    int e = -1;  // the export row of this op's parent (BF16 only)
    if constexpr (BF16) e = __ldg(export_at + w);
#define LIBPLL_OP(K1, K2, KEEP)                                          \
  op_tiles<S, R, M, Child::K1, Child::K2, KEEP, BF16>(                   \
      op, f, pool4, spool, tb, warp, lane, thresh, factor, held, held_scal, \
      e, clv_out, scal_out)
    switch (2 * op.kinds() + (op.keep() ? 1 : 0)) {
      case 0: LIBPLL_OP(TIP, TIP, false); break;
      case 1: LIBPLL_OP(TIP, TIP, true); break;
      case 2: LIBPLL_OP(TIP, POOL, false); break;
      case 3: LIBPLL_OP(TIP, POOL, true); break;
      case 4: LIBPLL_OP(TIP, CARRIED, false); break;
      case 5: LIBPLL_OP(TIP, CARRIED, true); break;
      case 6: LIBPLL_OP(POOL, POOL, false); break;
      case 7: LIBPLL_OP(POOL, POOL, true); break;
      case 8: LIBPLL_OP(POOL, CARRIED, false); break;
      default: LIBPLL_OP(POOL, CARRIED, true); break;
    }
#undef LIBPLL_OP
    op = next_op;
    next_op = after;
    f = next_f;
  }

  // Export slots are never reused by the schedule, and an exported parent is
  // always stored.  Every lane writes out the entries it holds.  (The BF16
  // kernel wrote its exports at their ops.)
  if constexpr (BF16) return;
  const int nt = gridDim.x, blk = blockIdx.x;
  const int tiles = tb / M_SITES;
  for (int e = 0; e < n_exp; ++e) {
    const int slot = __ldg(export_slots + e);
    float* dst = clv_out + ((size_t)e * nt + blk) * SPAN * tb;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int tile = warp * M + m;
      const int site = tile * M_SITES + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 v =
            pool4[(((size_t)slot * tiles + tile) * NT + j) * 32 + lane];
        float* row = dst + (size_t)(8 * j + 2 * q) * tb + site;
        row[0] = v.x;
        row[tb] = v.y;
        row[8] = v.z;
        row[tb + 8] = v.w;
      }
      if (q == 0) {
        int* out = scal_out + ((size_t)e * nt + blk) * tb + site;
        out[0] = spool[(size_t)slot * tb + site];
        out[8] = spool[(size_t)slot * tb + site + 8];
      }
    }
  }
}

// The P operand of both kernels, from pmat [n_slots][pm_words]: element i of
// a slot's `words` table entries is pmat[idx[i]] (idx[i] == pm_words: the
// zero outside the rate blocks), split into a TF32 head and a TF32
// remainder.  Entries come in runs of `run`; a run's heads are followed by
// its remainders: pfrag[slot][i / run][2 (hi, lo)][run].  One thread per
// entry.
__global__ void pmatrix_fragments_kernel(const float* __restrict__ pmat,
                                         const int* __restrict__ idx,
                                         float* __restrict__ pfrag,
                                         int n_slots, int words, int run,
                                         int pm_words) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n_slots * words) return;
  const int slot = (int)(i / words), j = (int)(i % words);
  const int k = __ldg(idx + j);
  const float x = k < pm_words ? __ldg(pmat + (size_t)slot * pm_words + k)
                               : 0.0f;
  const float hi = __uint_as_float(to_tf32(x));
  const float lo = __uint_as_float(to_tf32(x - hi));
  float* out = pfrag + ((size_t)slot * words + (j / run) * run) * 2 + j % run;
  out[0] = hi;
  out[run] = lo;
}

// The bf16 P operand: element i of a slot's `words` entries is pmat[idx[i]]
// (idx[i] == pm_words: zero), 16-bit patterns copied as they are.
__global__ void pmatrix_gather_kernel(const uint16_t* __restrict__ pmat,
                                      const int* __restrict__ idx,
                                      uint16_t* __restrict__ pfrag,
                                      int n_slots, int words, int pm_words) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n_slots * words) return;
  const int slot = (int)(i / words), j = (int)(i % words);
  const int k = __ldg(idx + j);
  pfrag[i] = k < pm_words ? pmat[(size_t)slot * pm_words + k] : uint16_t(0);
}

// item: bytes of a pool entry (4 f32, 2 bf16)
template <class K, class F>
cudaError_t launch(K kernel, int span, int item, const int* ops, int n_ops,
                   const F* pfrag, const int* p_base, const int* tip_blocked,
                   int tips,
                   const int* export_slots, int n_exp, const int* export_at,
                   float* clv_out, int* scal_out, int nt, int tb,
                   int pool_size, float thresh, float factor,
                   cudaStream_t stream) {
  const size_t smem = (size_t)pool_size * (span * item + 4) * tb;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nt, tb, smem, stream>>>(
      reinterpret_cast<const int4*>(ops), n_ops, pfrag, p_base, tip_blocked,
      tips, export_slots, n_exp, export_at, clv_out, scal_out, pool_size,
      thresh, factor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tree_sweep_mma_fragments: the P operand of this case in fragment order,
// by the index table idx [words] int32 (partials_tree.mma_fragment_index),
// on `stream`: f32 P [n_slots][pm_words] split into TF32 (hi, lo) in runs
// of `run`; bf16 P (bf16 = 1) gathered as it is.
//
// tree_sweep_mma_launch: the tensor-core sweep on `stream`.  ops: [n_ops][12]
// int32, 16-byte aligned (partials_tree.mma_device_table).  pfrag: the
// output of tree_sweep_mma_fragments for this case; p_base [nt] int32 or
// null, as tree_sweep_launch's (in slots of pfrag).  export_slots [n_exp]
// (copied out after the sweep, f32) and export_at [n_ops] (each op's export
// row, -1: none; written out at the op, bf16) as in tree_sweep.cu.  bf16:
// the pool's type, 0 f32 or 1 bf16.  tb is a multiple of 32 up to 256.
// (states, rates) (4, 4): the small-span kernel; (20, 4): the general
// kernel, which never hands a parent on and always stores.  Both return
// the cudaError_t of the launch.
int tree_sweep_mma_fragments(const void* pmat, const int* idx, void* pfrag,
                             int n_slots, int words, int run, int pm_words,
                             int bf16, void* stream) {
  const size_t total = (size_t)n_slots * words;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    pmatrix_gather_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const uint16_t*>(pmat), idx,
        static_cast<uint16_t*>(pfrag), n_slots, words, pm_words);
    return (int)cudaGetLastError();
  }
  if (run <= 0 || words % run) return (int)cudaErrorInvalidValue;
  pmatrix_fragments_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(pmat), idx, static_cast<float*>(pfrag),
      n_slots, words, run, pm_words);
  return (int)cudaGetLastError();
}

int tree_sweep_mma_launch(const int* ops, int n_ops, const void* pfrag,
                          const int* p_base, const int* tip_blocked, int tips,
                          const int* export_slots, int n_exp,
                          const int* export_at, float* clv_out, int* scal_out,
                          int nt, int tb, int rates, int states,
                          int pool_size, int bf16, float thresh, float factor,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ops <= 0 || tb <= 0 || tb % 32 || tb > 256 ||
      reinterpret_cast<uintptr_t>(ops) % 16 ||
      reinterpret_cast<uintptr_t>(pfrag) % 16)
    return (int)cudaErrorInvalidValue;
#define TREE_SWEEP_MMA_ARGS                                                  \
  ops, n_ops, static_cast<const PF*>(pfrag), p_base, tip_blocked, tips,      \
      export_slots, n_exp, export_at, clv_out, scal_out, nt, tb, pool_size,  \
      thresh, factor, s
  if (states == 4 && rates == 4) {
    if (bf16) {
      using PF = uint4;
      return (int)launch(tree_sweep_mma_small_kernel<4, 4, true>, 16, 2,
                         TREE_SWEEP_MMA_ARGS);
    }
    using PF = float4;
    return (int)launch(tree_sweep_mma_small_kernel<4, 4, false>, 16, 4,
                       TREE_SWEEP_MMA_ARGS);
  }
  if (states == 20 && rates == 4) {
    using PF = uint4;
    if (bf16)
      return (int)launch(tree_sweep_mma_kernel<20, 4, true>, 80, 2,
                         TREE_SWEEP_MMA_ARGS);
    return (int)launch(tree_sweep_mma_kernel<20, 4, false>, 80, 4,
                       TREE_SWEEP_MMA_ARGS);
  }
#undef TREE_SWEEP_MMA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
