// The tree sweep's wide form: 33 to 64 states (codon models, 61 sense
// codons of the standard code), int64 tip masks, f32 pool, 1-32 rates,
// per-site or per-rate scalers.  Built with nvcc for sm_90a beside the
// other sweep forms into the package's shared library
// (libpll2_tpu_torch/_build.py); tree_sweep_wide_launch is its C entry
// point, called by ops/partials_tree.sweep(..., mode="wide").
//
// It replaces no Pallas kernel: the JAX package packs its tip masks in
// int32 and has no path above 32 states.  It computes what the other forms
// compute (csrc/tree_sweep.cu's head): for every op of the Sethi-Ullman
// schedule and every (site, rate) the parent (P1 c1) * (P2 c2), rescued by
// the config's factor (2^30 at f32) where every entry of the site (of the
// site and rate, per-rate) falls below its threshold (2^-30), a tip
// child's message the sum of the P columns its mask sets.
//
// What bounds it on an H100: operations.  At 61 states and 4 rates an
// inner child costs 2 * 61^2 FMA-operations per (site, rate), 6.1e10 for
// a 128-taxon tree over 16,384 sites: 0.91 ms at the card's 67 TFLOP/s of
// f32 FMAs, while its bytes (int64 tips, P, the two root rows) take 0.02
// ms.  A branch's P is 59.5 KB at 4 rates, so neither both P-matrices of
// an op nor a pool of 32-site slots beside them fit 227 KB of shared
// memory, and every P byte a CTA reads comes from L2 (the 15 MB of P stay
// there): the L2 bytes fall as the site block grows.
//
// What this design does about it:
//   * the pool holds only what the schedule keeps live: an exported parent
//     (the root edge's rows, which nothing reads) goes straight to its row
//     in device memory, and the slots are given anew without the exports'
//     (partials_tree.wide_device_table), so 5 or 6 slots of [R][S][32]
//     floats serve a random 128-taxon tree and a 32-site block fits;
//   * only an inner child's P-matrix is staged, one rate at a time,
//     transposed with its rows padded to 64 ([k][i], wide_pmatrix_kernel
//     lays every branch out once a call), by cp.async into two buffers:
//     the next inner child's P is copied while this one is multiplied, a
//     CTA barrier before each is used.  A tip child reads only the P columns its masks
//     name, from device memory (L2), the first column of each site loaded
//     as its step starts.  The staged matrices' order is a table of its
//     own (partials_tree.wide_items), read an item ahead, and an op's row
//     of the schedule is read two ops ahead, so that no load on the way
//     from one step to the next waits on another;
//   * a thread forms a 4 x 4 tile (rows i0..i0+3 of sites s0..s0+3) of one
//     rate: per state k one 16-byte load of P (rows) and one of the child
//     (sites) feed 16 FMAs; a warp's P loads fall in 64 bytes and its child
//     loads in 128, so shared memory serves them in one wavefront each;
//   * the contraction is split in two halves, states 0-31 and 32-63, each
//     over 16 row groups x tb/4 site groups: 8 * tb threads, 256 at 32
//     sites; a tip child's half reads the matching 32 bits of its mask and
//     sums one P column per set bit (one for a plain state, none in the
//     other half); the second half hands its two partial products over
//     (child 1 through the parent's rows, child 2 through an exchange
//     buffer) and the first half sums, multiplies and stores;
//   * the rescue is decided once the op's rates are stored: each thread
//     flags its sites that hold an entry not below the threshold, and
//     after a CTA barrier the unflagged sites' rows are scaled (exactly,
//     by a power of two) and the scalers written;
//   * the code that writes a parent is inlined once for a pool slot and
//     once for an export row, so that the pool's accesses are shared-memory
//     instructions: through one pointer that might be either, the rescue's
//     read-modify-writes were generic and serialized, 1 ms of a sweep.
// Measured on an H100 at 700 W at codon_eval's shape (128 taxa x 16,384
// codons, 4 rates, a pool of 6 slots): 6.96 ms a sweep, where a first form
// that staged every child's P, read the table and the item order in the
// step's path and wrote the parent through a generic pointer took 8.39.
// Of the 6.96, the contraction loop is about 4.0 ms (two 16-byte shared
// loads feed 16 FMAs: the loads, not the FMAs, set its pace) and the
// rest of a step (barriers, the halves' hand-over, latencies) about 3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Rows of a staged P-matrix (states padded); partials_tree.WIDE_P_ROWS.
constexpr int WIDE_SMAX = 64;
// Threads a site of the block has; partials_tree.WIDE_THREADS_A_SITE.
constexpr int THREADS_A_SITE = 8;
// States of one half of the contraction, and groups of four rows.
constexpr int HALF = 32;
constexpr int ROW_GROUPS = WIDE_SMAX / 4;
constexpr int MAX_TB = 32;

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

// Bytes of one CTA's dynamic shared memory (partials_tree.wide_smem_bytes):
// pool [n_slots][R][S][tb] f32, scaler pool [n_slots][SR][tb] i32, two
// staging buffers [2][S][WIDE_SMAX] f32, exchange [S][tb] f32, rescue
// flags [2][SR][tb] i32.
__host__ __device__ constexpr size_t wide_smem(int n_slots, int R, int S,
                                               int SR, int tb) {
  return 4 * ((size_t)n_slots * (R * S + SR) * tb +
              2 * (size_t)S * WIDE_SMAX + (size_t)S * tb + 2 * SR * tb);
}

// pt[m][k][i] = P[m][i][k] for i < S, 0 for the padding rows; a CTA a
// matrix m (a branch's rate), read whole into shared memory first.
__global__ void wide_pmatrix_kernel(const float* __restrict__ pmat,
                                    float* __restrict__ pt, int S) {
  extern __shared__ float tile[];
  const size_t m = blockIdx.x;
  const float* src = pmat + m * S * S;
  for (int x = threadIdx.x; x < S * S; x += blockDim.x)
    tile[x] = __ldg(src + x);
  __syncthreads();
  float* dst = pt + m * S * WIDE_SMAX;
  for (int x = threadIdx.x; x < S * WIDE_SMAX; x += blockDim.x) {
    const int k = x / WIDE_SMAX, i = x % WIDE_SMAX;
    dst[x] = i < S ? tile[i * S + k] : 0.0f;
  }
}

// acc[a][b] += sum over k of this half of P[i0 + a][k] * c[k][s0 + b]:
// C is the child's row 0 at the thread's first site (row k at + k * tb),
// Pk the staged P at row i0 (state k at + k * WIDE_SMAX); kn states of the
// half, the same in every lane of the warp.
__device__ __forceinline__ void inner_product(float (&acc)[4][4],
                                              const float* C,
                                              const float* Pk, int kbeg,
                                              int kn, int tb) {
#pragma unroll
  for (int kk = 0; kk < HALF; ++kk) {
    if (kk < kn) {
      const int k = kbeg + kk;
      const float4 c = *reinterpret_cast<const float4*>(C + k * tb);
      const float4 p = *reinterpret_cast<const float4*>(Pk + k * WIDE_SMAX);
      acc[0][0] = fmaf(p.x, c.x, acc[0][0]);
      acc[0][1] = fmaf(p.x, c.y, acc[0][1]);
      acc[0][2] = fmaf(p.x, c.z, acc[0][2]);
      acc[0][3] = fmaf(p.x, c.w, acc[0][3]);
      acc[1][0] = fmaf(p.y, c.x, acc[1][0]);
      acc[1][1] = fmaf(p.y, c.y, acc[1][1]);
      acc[1][2] = fmaf(p.y, c.z, acc[1][2]);
      acc[1][3] = fmaf(p.y, c.w, acc[1][3]);
      acc[2][0] = fmaf(p.z, c.x, acc[2][0]);
      acc[2][1] = fmaf(p.z, c.y, acc[2][1]);
      acc[2][2] = fmaf(p.z, c.z, acc[2][2]);
      acc[2][3] = fmaf(p.z, c.w, acc[2][3]);
      acc[3][0] = fmaf(p.w, c.x, acc[3][0]);
      acc[3][1] = fmaf(p.w, c.y, acc[3][1]);
      acc[3][2] = fmaf(p.w, c.z, acc[3][2]);
      acc[3][3] = fmaf(p.w, c.w, acc[3][3]);
    }
  }
}

// A tip child, read from the laid-out P in device memory (pt at the
// child's matrix and rate, row i0; state k at + k * WIDE_SMAX): the column
// of the first bit of each site's mask (m[b], the half's 32 bits, those
// past S cleared) is loaded into v[b] as the step starts, so that its
// latency passes under the step's other work; the remaining bits (an
// ambiguous code, a gap) stay in rest[b].
__device__ __forceinline__ void tip_first(float4 (&v)[4], unsigned (&rest)[4],
                                          const unsigned (&m)[4],
                                          const float* ptm, int kbeg) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (m[b]) {
      const int j = __ffs(m[b]) - 1;
      v[b] = __ldg(reinterpret_cast<const float4*>(ptm + (kbeg + j) *
                                                              WIDE_SMAX));
      rest[b] = m[b] & (m[b] - 1);
    } else {
      v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rest[b] = 0u;
    }
  }
}

// acc[a][b] = P[i0 + a][kbeg + j] summed over the bits j of site s0 + b's
// mask: the first column tip_first loaded, then the rest.
__device__ __forceinline__ void tip_finish(float (&acc)[4][4],
                                           const float4 (&v)[4],
                                           const unsigned (&rest)[4],
                                           const float* ptm, int kbeg) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    acc[0][b] = v[b].x;
    acc[1][b] = v[b].y;
    acc[2][b] = v[b].z;
    acc[3][b] = v[b].w;
    unsigned bits = rest[b];
    while (bits) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      const float4 p = __ldg(reinterpret_cast<const float4*>(
          ptm + (kbeg + j) * WIDE_SMAX));
      acc[0][b] += p.x;
      acc[1][b] += p.y;
      acc[2][b] += p.z;
      acc[3][b] += p.w;
    }
  }
}

// grid = NT site blocks of tb sites (8, 16 or 32); block = 8 * tb threads:
// thread t has half h = t / (16 * tb / 4), row group rg (rows 4 rg ..
// 4 rg + 3) and site group sg (sites 4 sg .. 4 sg + 3).  ops: the wide
// table [OPS][8] (partials_tree.wide_device_table) as int4 pairs; items
// [n_items]: the staged P-matrices in the order they are used, matrix *
// R + rate, one for each (op, rate, child) whose child is not a tip
// (partials_tree.wide_items).  pt: the
// P-matrices laid out [P][R][S][WIDE_SMAX] (with p_base, block b's index
// 0 is matrix p_base[b]).  tip_blocked [NT][tips][tb] int64 masks.
// clv_out [E][NT][R][S][tb] f32 and scal_out [E][NT][SR][tb] i32: the
// exported parents, written at their ops.
__global__ void __launch_bounds__(THREADS_A_SITE * MAX_TB)
tree_sweep_wide_kernel(const int4* __restrict__ ops, int n_ops,
                       const int* __restrict__ items, int n_items,
                       const float* __restrict__ pt,
                       const int* __restrict__ p_base,
                       const long long* __restrict__ tip_blocked, int tips,
                       float* __restrict__ clv_out,
                       int* __restrict__ scal_out, int S, int R,
                       int n_slots, int per_rate, float thresh,
                       float factor) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, nth = blockDim.x;
  const int tb = nth / THREADS_A_SITE, SG = tb / 4;
  const int h = t / (ROW_GROUPS * SG);
  const int rg = (t / SG) % ROW_GROUPS, sg = t % SG;
  const int i0 = 4 * rg, s0 = 4 * sg;
  const int SR = per_rate ? R : 1;
  const int blk = blockIdx.x, nt = gridDim.x;
  const size_t slot_floats = (size_t)R * S * tb;
  const int mat = S * WIDE_SMAX;
  float* pool = smem;
  int* spool = reinterpret_cast<int*>(pool + (size_t)n_slots * slot_floats);
  float* stage =
      reinterpret_cast<float*>(spool + (size_t)n_slots * SR * tb);
  float* xchg = stage + 2 * mat;
  int* flags = reinterpret_cast<int*>(xchg + (size_t)S * tb);
  if (p_base != nullptr) pt += (size_t)__ldg(p_base + blk) * R * mat;
  const int* table = reinterpret_cast<const int*>(ops);

  // `stage_next` copies the next staged item's P-matrix of its rate into
  // buffer `buf`, in 16-byte pieces; the item after it is read ahead
  int j = 0;
  int item = n_items > 0 ? __ldg(items) : 0;
  auto stage_next = [&](int buf) {
    if (j >= n_items) return;
    const float* src = pt + (size_t)item * mat;
    float* dst = stage + buf * mat;
    for (int x = t; x < mat / 4; x += nth)
      copy_async(dst + 4 * x, src + 4 * x);
    commit_copies();
    if (++j < n_items) item = __ldg(items + j);
  };
  // this half's 32 bits of an op's tip masks at the thread's four sites
  // (0 for a child that is not a tip), loaded an op ahead of their use
  // from the op's row, itself read two ops ahead, so that no load of the
  // table or of a mask waits on another
  const long long* tip_col = tip_blocked + (size_t)blk * tips * tb + s0;
  const int kbeg = HALF * h, kn = min(S - kbeg, HALF);
  const unsigned valid = kn >= HALF ? 0xffffffffu : (1u << kn) - 1u;
  auto masks_of = [&](const int4& a, unsigned (&m1)[4], unsigned (&m2)[4]) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int tip = c ? a.y : a.x;
      unsigned(&m)[4] = c ? m2 : m1;
      if (tip >= 0) {
        const longlong2* p =
            reinterpret_cast<const longlong2*>(tip_col + (size_t)tip * tb);
        const longlong2 u = __ldg(p), v = __ldg(p + 1);
        const long long x[4] = {u.x, u.y, v.x, v.y};
#pragma unroll
        for (int b = 0; b < 4; ++b)
          m[b] = static_cast<unsigned>(
                     static_cast<unsigned long long>(x[b]) >> kbeg) & valid;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) m[b] = 0u;
      }
    }
  };

  for (int x = t; x < 2 * SR * tb; x += nth) flags[x] = 0;
  int4 a_cur = __ldg(ops), o_cur = __ldg(ops + 1);
  int4 a_nxt = a_cur, o_nxt = o_cur;
  if (n_ops > 1) a_nxt = __ldg(ops + 2), o_nxt = __ldg(ops + 3);
  unsigned next1[4], next2[4];
  masks_of(a_cur, next1, next2);
  int buf = 0;                  // the buffer of the next item used
  stage_next(buf);

  for (int w = 0; w < n_ops; ++w) {
    const int4 a = a_cur, o = o_cur;
    unsigned m1[4], m2[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) m1[b] = next1[b], m2[b] = next2[b];
    if (w + 1 < n_ops) masks_of(a_nxt, next1, next2);
    a_cur = a_nxt, o_cur = o_nxt;
    if (w + 2 < n_ops)
      a_nxt = __ldg(ops + 2 * (size_t)(w + 2)),
      o_nxt = __ldg(ops + 2 * (size_t)(w + 2) + 1);
    const bool tip1 = a.x >= 0, tip2 = a.y >= 0;
    // the parent's rows and scalers: a pool slot, or an export row in
    // device memory; the code that reads and writes them is inlined once
    // for each (`at_parent`), so that the pool's accesses stay shared-
    // memory instructions
    const bool exported = o.x < 0;
    const int export_row = exported ? -1 - o.x : 0;
    float* const rows_pool = pool + (size_t)(exported ? 0 : o.x) * slot_floats;
    float* const rows_out =
        clv_out + ((size_t)export_row * nt + blk) * slot_floats;
    int* const sc_pool = spool + (size_t)(exported ? 0 : o.x) * SR * tb;
    int* const sc_out = scal_out + ((size_t)export_row * nt + blk) * SR * tb;
    auto at_parent = [&](auto&& body) {
      if (exported)
        body(rows_out, sc_out);
      else
        body(rows_pool, sc_pool);
    };
    const float* c1 = pool + (size_t)o.y * slot_floats + s0;
    const float* c2 = pool + (size_t)o.z * slot_floats + s0;
    const float* pt1 = pt + (size_t)a.z * R * mat + i0;
    const float* pt2 = pt + (size_t)a.w * R * mat + i0;
    int* fl = flags + (w & 1) * SR * tb;

    for (int r = 0; r < R; ++r) {
      float left[4][4], right[4][4];
      // a tip child's first columns from device memory, in flight while
      // the step waits and multiplies
      float4 v1[4], v2[4];
      unsigned rest1[4], rest2[4];
      if (tip1) tip_first(v1, rest1, m1, pt1 + (size_t)r * mat, kbeg);
      if (tip2) tip_first(v2, rest2, m2, pt2 + (size_t)r * mat, kbeg);
      // the step before is done with the exchange buffer and with the
      // stage buffer the next copy takes; an inner child's P has arrived
      if (!tip1 || !tip2) wait_all_copies();
      __syncthreads();
      if (r == 0)   // the next op's flags, last read by the op before
        for (int x = t; x < SR * tb; x += nth)
          flags[((w + 1) & 1) * SR * tb + x] = 0;
      if (!tip1) {
        stage_next(buf ^ 1);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) left[x][y] = 0.0f;
        inner_product(left, c1 + (size_t)r * S * tb, stage + buf * mat + i0,
                      kbeg, kn, tb);
        buf ^= 1;
      }
      if (!tip2) {
        if (!tip1) {     // child 2's P was copied during child 1's product
          wait_all_copies();
          __syncthreads();
        }
        stage_next(buf ^ 1);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) right[x][y] = 0.0f;
        inner_product(right, c2 + (size_t)r * S * tb,
                      stage + buf * mat + i0, kbeg, kn, tb);
        buf ^= 1;
      }
      if (tip1) tip_finish(left, v1, rest1, pt1 + (size_t)r * mat, kbeg);
      if (tip2) tip_finish(right, v2, rest2, pt2 + (size_t)r * mat, kbeg);
      // the second half hands its partial products over
      float* xr = xchg + s0;
      if (h == 1) {
        at_parent([&](float* out, int*) {
          float* rows = out + (size_t)r * S * tb + s0;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = i0 + x;
            if (i < S) {
              *reinterpret_cast<float4*>(rows + (size_t)i * tb) = make_float4(
                  left[x][0], left[x][1], left[x][2], left[x][3]);
              *reinterpret_cast<float4*>(xr + (size_t)i * tb) = make_float4(
                  right[x][0], right[x][1], right[x][2], right[x][3]);
            }
          }
        });
      }
      __syncthreads();
      if (h == 0) {
        unsigned above = 0;   // bit b: site s0 + b has an entry >= thresh
        at_parent([&](float* out, int*) {
          float* rows = out + (size_t)r * S * tb + s0;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = i0 + x;
            if (i < S) {
              float4* pr = reinterpret_cast<float4*>(rows + (size_t)i * tb);
              const float4 l1 = *pr;
              const float4 r1 =
                  *reinterpret_cast<const float4*>(xr + (size_t)i * tb);
              float4 v;
              v.x = (left[x][0] + l1.x) * (right[x][0] + r1.x);
              v.y = (left[x][1] + l1.y) * (right[x][1] + r1.y);
              v.z = (left[x][2] + l1.z) * (right[x][2] + r1.z);
              v.w = (left[x][3] + l1.w) * (right[x][3] + r1.w);
              *pr = v;
              if (!(v.x < thresh)) above |= 1u;
              if (!(v.y < thresh)) above |= 2u;
              if (!(v.z < thresh)) above |= 4u;
              if (!(v.w < thresh)) above |= 8u;
            }
          }
        });
        int* f = fl + (per_rate ? r : 0) * tb + s0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((above >> b) & 1u) f[b] = 1;
      }
    }
    // every rate stored and flagged: rescue the sites (or site rates)
    // with no entry at the threshold, and write the scalers
    __syncthreads();
    if (h == 0) {
      at_parent([&](float* out, int* sc_out_) {
        for (int r = 0; r < R; ++r) {
          const int sr = per_rate ? r : 0;
          const int4 f = *reinterpret_cast<const int4*>(fl + sr * tb + s0);
          const unsigned low = (f.x == 0 ? 1u : 0u) | (f.y == 0 ? 2u : 0u) |
                               (f.z == 0 ? 4u : 0u) | (f.w == 0 ? 8u : 0u);
          if (low) {
            float* rows = out + (size_t)r * S * tb + s0;
            const float4 k = make_float4(low & 1u ? factor : 1.0f,
                                         low & 2u ? factor : 1.0f,
                                         low & 4u ? factor : 1.0f,
                                         low & 8u ? factor : 1.0f);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int i = i0 + x;
              if (i < S) {
                float4* pr = reinterpret_cast<float4*>(rows + (size_t)i * tb);
                float4 v = *pr;
                v.x *= k.x;
                v.y *= k.y;
                v.z *= k.z;
                v.w *= k.w;
                *pr = v;
              }
            }
          }
          if (rg == 0 && (per_rate || r == 0)) {
            int4 sc = make_int4(low & 1u, (low >> 1) & 1u, (low >> 2) & 1u,
                                (low >> 3) & 1u);
            if (!tip1) {
              const int4 c = *reinterpret_cast<const int4*>(
                  spool + ((size_t)o.y * SR + sr) * tb + s0);
              sc.x += c.x, sc.y += c.y, sc.z += c.z, sc.w += c.w;
            }
            if (!tip2) {
              const int4 c = *reinterpret_cast<const int4*>(
                  spool + ((size_t)o.z * SR + sr) * tb + s0);
              sc.x += c.x, sc.y += c.y, sc.z += c.z, sc.w += c.w;
            }
            *reinterpret_cast<int4*>(sc_out_ + sr * tb + s0) = sc;
          }
        }
      });
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one wide CTA (what partials_tree.wide_smem_bytes
// computes on the host; a test on the card holds them equal).
long long tree_sweep_wide_smem(int n_slots, int rates, int states,
                               int per_rate, int tb) {
  return (long long)wide_smem(n_slots, rates, states,
                              per_rate ? rates : 1, tb);
}

// The wide sweep: lay the n_pmat P-matrices [n_pmat][R][S][S] f32 out in
// pt (n_pmat * R * S * WIDE_SMAX floats), then sweep nt blocks of tb
// sites.  ops [n_ops][8] int32 (partials_tree.wide_device_table), n_slots
// its pool; items [n_items] (partials_tree.wide_items); p_base [nt] or
// null.  Returns the CUDA error of the launches.
int tree_sweep_wide_launch(const int* ops, int n_ops, const int* items,
                           int n_items, const float* pmat,
                           const int* p_base, int n_pmat, float* pt,
                           const long long* tip_blocked, int tips,
                           float* clv_out, int* scal_out, int nt, int tb,
                           int rates, int states, int n_slots, int per_rate,
                           float thresh, float factor,
                           cudaStream_t stream) {
  if (states <= HALF || states > WIDE_SMAX || rates < 1 || rates > 32 ||
      (tb != 8 && tb != 16 && tb != MAX_TB) || n_slots < 0 || n_ops < 1 ||
      n_items < 0 ||
      n_pmat < 1 || reinterpret_cast<uintptr_t>(pt) % 16 ||
      reinterpret_cast<uintptr_t>(tip_blocked) % 16)
    return (int)cudaErrorInvalidValue;
  wide_pmatrix_kernel<<<n_pmat * rates, 256, states * states * 4, stream>>>(
      pmat, pt, states);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      wide_smem(n_slots, rates, states, per_rate ? rates : 1, tb);
  err = cudaFuncSetAttribute(tree_sweep_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  tree_sweep_wide_kernel<<<nt, THREADS_A_SITE * tb, smem, stream>>>(
      reinterpret_cast<const int4*>(ops), n_ops, items, n_items, pt, p_base,
      tip_blocked, tips, clv_out, scal_out, states, rates, n_slots,
      per_rate, thresh, factor);
  return (int)cudaGetLastError();
}

}  // extern "C"
