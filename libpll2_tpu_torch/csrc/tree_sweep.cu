// Felsenstein tree sweep over one site block per CTA, CLV pool in shared
// memory, the propagation as f32 FMAs: the "fma" form of
// libpll2_tpu_torch/ops/partials_tree.py:sweep().  Built with nvcc for
// sm_90a into a shared library with a plain C interface
// (libpll2_tpu_torch/_build.py) and launched through ctypes.
//
// Replaces two Pallas kernels of the JAX package:
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_static     (:808)
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_static_seg (:1136)
// and the broadcast-FMA ("vpu") mode of its runtime-ops kernel _tree_kernel
// (:410), at every state count they take (2 to 32; the generic-state form,
// csrc/tree_sweep_generic.cu, serves the counts without an instantiation).
// They compute the same thing; the JAX package unrolls the op list into the
// kernel and cuts it into segments to bound Mosaic's compile time.
// Here the op table is runtime data, so one compiled kernel serves every
// topology and every op count, with no segments.  The bf16 split-term
// operands of the TPU kernels are not carried over: f32 FMA is native here.
//
// What it computes, per site block and per op of the schedule, in order:
//   child c = tip ? bits of its packed state mask : pool[slot]
//   left[r,i]  = sum_j P1[r,i,j] c1[r,j],  right likewise with P2, c2
//   parent     = left * right
//   rescue     : if every entry of the site (per-rate mode: of the
//                (site, rate)) is < thresh, parent *= factor, counter + 1
//   scaler     = s1 + s2 + rescue (tips count 0)
// then the exported pool slots (the root edge) and their scalers go to
// device memory.
//
// What bounds it on an H100: per op and site 2*R*S*S FMAs (128 at S = 4:
// 0.07 ms of the card's f32 rate for 254 ops over 65,536 sites), and the
// operands of every op: two children and a parent through shared memory,
// both P-matrices and the tip masks from device memory at addresses only
// the op's row gives.  The first version (one thread per site, rates in a
// loop, everything loaded when the op starts) took 1.6-1.8 ms there, and
// clock reads put 2,000-3,000 cycles on each op of a warp: the pool's
// footprint left 8 warps on an SM (2 at S = 20), and each op began with
// dependent trips to device memory for its P rows and tips.
//
// What this design does about it:
//   * one thread per (site, rate category), H = 2 sites a thread up to
//     S = 4: four times the warps of the first version for the same shared
//     memory, and the P rows a thread reads serve both of its sites.  The
//     rate blocks of P are independent; only the per-site rescue joins
//     them, as an AND over the site's lanes by __shfl_xor_sync with the
//     full mask (one shuffle a round for all H sites).  A pool slot is
//     [S][H][thread]: a warp reads and writes 32 consecutive words;
//   * each thread reads back only pool words it wrote itself (the per-site
//     scaler is kept by the site's lane 0), so the sweep needs no CTA
//     barrier;
//   * every warp stages the operands of the op AHEAD ops ahead in a ring of
//     shared memory with cp.async: the 16-byte halves of the op rows
//     (partials_tree.fma_device_table) 2 * AHEAD ahead, the tip masks and,
//     up to 4 states, both P-matrices (one 16-byte piece a lane, a rate
//     block padded to 20 floats so that the four rates of a warp read from
//     distinct banks).  An op waits only for copies started AHEAD ops
//     before, so device-memory latency is off the chain from op to op;
//     above 4 states the P rows are read from device memory (through L1)
//     when the op starts: a protein op's 12.8 KB do not fit a ring;
//   * the kinds of an op's children (tip, pool slot, handed on) and whether
//     its parent is handed on are template parameters, chosen by one switch
//     per op, so the op is one straight line of code;
//   * a parent that the next op consumes and nothing else reads stays in
//     registers (partials_tree.carry_flags) and is never stored; rows and
//     scalers are bit-equal with the carry on and off;
//   * the rescue is decided from values still in registers;
//   * the rate count is a template parameter for 1 and 4 rates; other
//     counts run the same code with it at run time, the site's lanes padded
//     to a power of two (the padding lanes repeat the last rate, so the AND
//     is unchanged, and write nothing out), P read from device memory.
// probes/variants.py ("fma_staging", "fma_clocks") times the variants of
// these choices and reads the cycles an op takes.
//
// The pool's type T is float or __nv_bfloat16 (cfg.dtype bfloat16): the
// JAX package's static kernels at one split part.  At bf16 the arithmetic
// stays f32 (P is read as f32, the wrapper widens the bf16 P-matrices once
// a call, exactly; a pool child is widened exactly), the rescue is decided
// on the f32 parent, and the parent is rounded to the nearest even bf16
// where it is stored and where it is handed on, so the carry on and off
// stay bit-equal.  The exported rows are the f32 parent unrounded: the
// slot holds the rounded one, so a bf16 kernel writes an exported parent to
// device memory at the op that makes it (partials_tree.export_rows).  A
// lane's two sites of entry j share one __nv_bfloat162 word: a warp still
// reads and writes 32 consecutive words, half the bytes; a bf16 pool is
// half the f32 one, so more sites or CTAs fit an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Threads a CTA may have.  The compile-time rate counts keep to 256 so that
// ptxas may spend registers on the states; the run-time one takes up to 32
// lanes a site.
constexpr int MAX_THREADS = 256;
constexpr int MAX_THREADS_ANY_RATES = 1024;
// A thread holds this many sites (of one rate) up to 4 states, one above:
// the P rows it reads and the rescue's shuffles serve them all
// (probes/variants.py "fma_sites_1" sets 1, "fma_sites_4" 4).
constexpr int SITES_A_THREAD = 2;
// A warp starts the copies of op w + AHEAD's operands (tip masks and, where
// staged, P rows) while it computes op w, and those of op w + 2 * AHEAD's
// row (probes/variants.py "fma_ahead_1" sets 1).  The ring holds AHEAD + 1
// ops' operands and 2 * AHEAD + 1 rows.
constexpr int AHEAD = 2;
constexpr int DATA_SLOTS = AHEAD + 1;
constexpr int ROW_SLOTS = 2 * AHEAD + 1;
// Up to this many states, at a compile-time rate count, the P rows go
// through the ring too; above, a lane reads its rows from device memory when
// the op starts (probes/variants.py "fma_p_direct" sets 0).
constexpr int STAGE_P_MAX_STATES = 4;

template <class T>
constexpr bool IS_BF16 = std::is_same<T, __nv_bfloat16>::value;

// The pool type as a value, so that a launch function deduces it.
template <class T>
struct Store {};

template <int RL>
struct Threads {
  static constexpr int MAX = RL > 0 ? MAX_THREADS : MAX_THREADS_ANY_RATES;
};

// H: sites a thread holds.  What a warp's ring holds per op when P is
// staged: both P-matrices, rate block after rate block, a block padded to
// 20 floats at S = 4 so that the four rates of a warp read 16-byte rows from
// distinct banks.  Chunks are the 16-byte pieces the copies move, at most
// 32 (one a lane).
template <int S, int RL>
struct Staged {
  static constexpr int H = S <= 4 ? SITES_A_THREAD : 1;
  static constexpr bool P = RL > 0 && S <= STAGE_P_MAX_STATES;
  static constexpr int RS = S == 4 ? 20 : S * S;
  static constexpr int P_FLOATS = P ? 2 * RL * RS : 0;
  static constexpr int CHUNKS_A_RATE = S * S / 4 > 0 ? S * S / 4 : 1;
  static constexpr int CHUNKS = P ? 2 * RL * CHUNKS_A_RATE : 0;
};

// One row of the "fma" device table (partials_tree.fma_device_table), two
// 16-byte halves: what the copies ahead need, what the op needs.
//   stage: x, y the tip index of child 1, 2 (-1: not a tip); z, w their
//          P-matrices;
//   op:    x the parent's slot, y, z the children's slots, w the op's case
//          2 * kinds + keep (kinds: which kinds of children; keep: whether
//          the parent is handed on in registers instead of stored).
constexpr int ROW_INT4 = 2;

// cp.async: a copy from device to shared memory that the issuing thread
// does not wait for; groups complete in order.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Where a child comes from.  The host orders an op's children so that the
// first kind is not after the second (left * right commutes exactly), and at
// most the second is CARRIED.
enum class Child { TIP, POOL, CARRIED };

// S consecutive floats of a P row, from the ring (STAGED) or from device
// memory, in the widest loads the alignment gives (rows start on 16 bytes
// where S % 4 == 0, on 8 where S % 2 == 0).
template <int S, bool STAGED>
__device__ __forceinline__ void load_prow(float (&out)[S],
                                          const float* __restrict__ p) {
  if constexpr (S % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j = 0; j < S / 4; ++j) {
      const float4 v = STAGED ? p4[j] : __ldg(p4 + j);
      out[4 * j] = v.x, out[4 * j + 1] = v.y;
      out[4 * j + 2] = v.z, out[4 * j + 3] = v.w;
    }
  } else if constexpr (S % 2 == 0) {
    const float2* p2 = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int j = 0; j < S / 2; ++j) {
      const float2 v = STAGED ? p2[j] : __ldg(p2 + j);
      out[2 * j] = v.x, out[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) out[j] = STAGED ? p[j] : __ldg(p + j);
  }
}

// A child's S entries at one of this lane's sites; a pool slot's entry j
// is `stride` floats after entry j - 1 (f32 pools).
template <int S, Child K>
__device__ __forceinline__ void child(float (&c)[S], int code,
                                      const float* col, int stride,
                                      const float (&held)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if constexpr (K == Child::TIP)
      c[j] = static_cast<float>((code >> j) & 1);
    else if constexpr (K == Child::CARRIED)
      c[j] = held[j];
    else
      c[j] = col[(size_t)j * stride];
  }
}

// A bf16 pool slot of nth threads holds a lane's entry j of its H sites in
// [S][H / 2][nth] words of two sites (__nv_bfloat162), or [S][H][nth] at an
// odd H; stores round to nearest even.  A child's S entries at this lane's
// H sites from such a slot, from the tip masks, or handed on.
template <int S, int H, Child K>
__device__ __forceinline__ void child_bf16(float (&c)[H][S],
                                           const int (&code)[H],
                                           const __nv_bfloat16* slot, int nth,
                                           int t, const float (&held)[H][S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if constexpr (K != Child::POOL) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        c[h][j] = K == Child::TIP ? static_cast<float>((code[h] >> j) & 1)
                                  : held[h][j];
    } else if constexpr (H % 2 == 0) {
      const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(slot);
#pragma unroll
      for (int p = 0; p < H / 2; ++p) {
        const float2 v = __bfloat1622float2(w[((size_t)j * (H / 2) + p) * nth
                                              + t]);
        c[2 * p][j] = v.x;
        c[2 * p + 1][j] = v.y;
      }
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h)
        c[h][j] = __bfloat162float(slot[((size_t)j * H + h) * nth + t]);
    }
  }
}
template <int S, int H>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* slot,
                                           const float (&v)[H][S], int nth,
                                           int t) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if constexpr (H % 2 == 0) {
      __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(slot);
#pragma unroll
      for (int p = 0; p < H / 2; ++p)
        w[((size_t)i * (H / 2) + p) * nth + t] =
            __floats2bfloat162_rn(v[2 * p][i], v[2 * p + 1][i]);
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h)
        slot[((size_t)i * H + h) * nth + t] = __float2bfloat16_rn(v[h][i]);
    }
  }
}

// row i of P . c, summed over j in order
template <int S>
__device__ __forceinline__ float row_dot(const float (&p)[S],
                                         const float (&c)[S]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) acc = fmaf(p[j], c[j], acc);
  return acc;
}

// Everything one lane needs to know about where it sits.
struct Lane {
  int t;          // thread index in the CTA
  int nth;        // threads of the CTA
  int lanes;      // lanes a site has (a power of two)
  int sidx;       // this lane's scaler word of its site h = 0 in a slot
  int sidx_step;  // ... and how far the word of site h + 1 is
  int sr_stride;  // scaler words a slot has
  bool keeps_scaler;  // per-rate mode, or the site's lane 0
  int per_rate;
};

// Where a bf16 kernel writes an exported parent: this lane's entry 0 of
// its site h = 0 in export row 0 (site h at + h * part, entry i at
// + i * tb, row e at + e * clv_row) and the scaler word it keeps (row e at
// + e * scal_row).  Padding lanes write nothing.
struct Export {
  float* clv;
  int* scal;
  size_t clv_row, scal_row;
  int part, tb;
  bool writes;
};

// One op for one lane's H sites: P1 and P2 are this lane's rate block of
// the two P-matrices, in the ring (STAGED) or in device memory.  A pool
// slot is [S][H][nth] floats, or S * H * nth bf16 (child_bf16).  e: the
// export row of the op's parent (bf16 only; -1: none).
template <int S, int H, bool STAGED, Child K1, Child K2, bool KEEP, class T>
__device__ __forceinline__ void op_lane(
    const int4& op, const int (&code1)[H], const int (&code2)[H],
    const float* __restrict__ P1, const float* __restrict__ P2, T* pool,
    int* spool, const Lane& L, float thresh, float factor,
    float (&held)[H][S], int (&held_scal)[H], const Export& X, int e) {
  static_assert(K1 != Child::CARRIED, "the host puts a carried child second");
  const int stride = H * L.nth;
  const size_t slot_words = (size_t)S * stride;
  float a[H][S], b[H][S];
  if constexpr (IS_BF16<T>) {
    child_bf16<S, H, K1>(a, code1, pool + op.y * slot_words, L.nth, L.t,
                         held);
    child_bf16<S, H, K2>(b, code2, pool + op.z * slot_words, L.nth, L.t,
                         held);
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      child<S, K1>(a[h], code1[h], pool + op.y * slot_words + h * L.nth + L.t,
                   stride, held[h]);
      child<S, K2>(b[h], code2[h], pool + op.z * slot_words + h * L.nth + L.t,
                   stride, held[h]);
    }
  }
  float v[H][S];
  unsigned below = (1u << H) - 1;  // bit h: every entry of site h < thresh
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float p1[S], p2[S];
    load_prow<S, STAGED>(p1, P1 + i * S);
    load_prow<S, STAGED>(p2, P2 + i * S);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      v[h][i] = row_dot<S>(p1, a[h]) * row_dot<S>(p2, b[h]);
      if (!(v[h][i] < thresh)) below &= ~(1u << h);
    }
  }
  if (!L.per_rate) {
    // every lane of the warp takes part in each shuffle
    for (int x = 1; x < L.lanes; x <<= 1)
      below &= __shfl_xor_sync(FULL, below, x);
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const bool low = (below >> h) & 1;
    const float scale = low ? factor : 1.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) v[h][i] *= scale;

    // scalers: only the lane that keeps this word reads or writes it
    const int word = L.sidx + h * L.sidx_step;
    int sc = low ? 1 : 0;
    if (L.keeps_scaler) {
      if constexpr (K1 == Child::POOL) sc += spool[op.y * L.sr_stride + word];
      if constexpr (K2 == Child::POOL) sc += spool[op.z * L.sr_stride + word];
    }
    if constexpr (K2 == Child::CARRIED) sc += held_scal[h];
    if constexpr (KEEP) {
#pragma unroll
      for (int i = 0; i < S; ++i)
        held[h][i] = IS_BF16<T> ? __bfloat162float(__float2bfloat16_rn(
                                      v[h][i]))
                                : v[h][i];
      held_scal[h] = sc;
    } else if constexpr (IS_BF16<T>) {
      if (L.keeps_scaler) spool[op.x * L.sr_stride + word] = sc;
      // an exported parent is never handed on
      if (e >= 0 && X.writes) {
        float* dst = X.clv + e * X.clv_row + h * X.part;
#pragma unroll
        for (int i = 0; i < S; ++i) dst[(size_t)i * X.tb] = v[h][i];
        if (L.keeps_scaler) X.scal[e * X.scal_row + h * X.part] = sc;
      }
    } else {
      float* par = pool + op.x * slot_words + h * L.nth + L.t;
#pragma unroll
      for (int i = 0; i < S; ++i) par[(size_t)i * stride] = v[h][i];
      if (L.keeps_scaler) spool[op.x * L.sr_stride + word] = sc;
    }
  }
  if constexpr (IS_BF16<T> && !KEEP)
    store_bf16<S, H>(pool + op.x * slot_words, v, L.nth, L.t);
}

// 32-bit words of one warp's ring: ROW_SLOTS rows of 8, then DATA_SLOTS
// slots of P (Staged::P_FLOATS) and DATA_SLOTS slots of two tip masks for
// each of the warp's H * 32 / lanes sites, rounded up to a multiple of 4 so
// that every ring starts on 16 bytes (the rows and P slots are multiples of
// 4).
template <int S, int RL>
__host__ __device__ constexpr int ring_words(int lanes) {
  return (ROW_SLOTS * 4 * ROW_INT4 +
          DATA_SLOTS * (Staged<S, RL>::P_FLOATS +
                        2 * Staged<S, RL>::H * (32 / lanes)) +
          3) &
         ~3;
}

// grid = NT site blocks of TB sites; block = TB / H * lanes threads: thread
// t has rate t % lanes of sites s0 + h * TB / H, s0 = t / lanes, h < H.
// RL > 0: lanes == rates == RL at compile time; RL == 0: lanes (a power of
// two >= rates) at run time.  shared: pool [pool_size][S][H][threads] f32
// or its bf16 layout (child_bf16), then spool [pool_size][SR] i32 (SR =
// TB * lanes per-rate, TB per-site), then one ring a warp (ring_words).  A
// parent is either stored or handed on, never both
// (partials_tree.carry_flags).
// export_slots: the f32 kernel copies these slots out after the sweep;
// export_at [n_ops]: the export row of each op's parent, which the bf16
// kernel writes out at the op.  p_base [NT], or null for 0 everywhere: the
// P-matrix that an op's index 0 names in each site block, so that the
// blocks of one launch read the P-matrices of different partitions.
template <int S, int RL, class T>
__global__ void __launch_bounds__(Threads<RL>::MAX)
tree_sweep_kernel(const int4* __restrict__ ops, int n_ops,
                  const float* __restrict__ pmat,
                  const int* __restrict__ p_base,
                  const int* __restrict__ tip_blocked, int tips,
                  const int* __restrict__ export_slots, int n_exp,
                  const int* __restrict__ export_at,
                  float* __restrict__ clv_out, int* __restrict__ scal_out,
                  int rates, int lane_bits, int pool_size, int per_rate,
                  float thresh, float factor) {
  using St = Staged<S, RL>;
  constexpr int H = St::H;
  extern __shared__ __align__(16) float smem[];
  const int lanes = RL > 0 ? RL : 1 << lane_bits;
  const int R = RL > 0 ? RL : rates;
  Lane L;
  L.t = threadIdx.x;
  L.nth = blockDim.x;
  L.lanes = lanes;
  L.per_rate = per_rate;
  const int part = L.nth / lanes;  // sites of one h: TB / H
  const int tb = part * H;
  const int s0 = L.t / lanes, r = L.t % lanes;
  const int lane = L.t % 32, spw = 32 / lanes, siw = lane / lanes;
  L.sidx = per_rate ? L.t : s0;
  L.sidx_step = per_rate ? L.nth : part;
  L.sr_stride = per_rate ? H * L.nth : tb;
  L.keeps_scaler = per_rate || r == 0;
  T* pool = reinterpret_cast<T*>(smem);
  int* spool =
      reinterpret_cast<int*>(pool + (size_t)pool_size * S * H * L.nth);
  int* ring = spool + pool_size * L.sr_stride +
              (L.t / 32) * ring_words<S, RL>(lanes);
  int4* rows = reinterpret_cast<int4*>(ring);
  float* p_ring = reinterpret_cast<float*>(ring + ROW_SLOTS * 4 * ROW_INT4);
  int* tip_ring = ring + ROW_SLOTS * 4 * ROW_INT4 + DATA_SLOTS * St::P_FLOATS;
  // tip i at this lane's site h: tip_col[i * tb + h * part]
  const int* tip_col = tip_blocked + (size_t)blockIdx.x * tips * tb + s0;
  // P-matrix m is p_stride floats after P-matrix 0; a lane reads its rate
  // block (a padding lane repeats the last rate)
  const int p_stride = R * S * S;
  if (p_base != nullptr) pmat += (size_t)__ldg(p_base + blockIdx.x) * p_stride;
  const int r_p = min(r, R - 1);
  Export X;
  X.writes = r < R;
  X.clv = clv_out + ((size_t)blockIdx.x * R + r_p) * S * tb + s0;
  X.clv_row = (size_t)gridDim.x * R * S * tb;
  X.scal = scal_out + ((size_t)blockIdx.x * (per_rate ? R : 1) +
                       (per_rate ? r_p : 0)) * tb + s0;
  X.scal_row = (size_t)gridDim.x * (per_rate ? R : 1) * tb;
  X.part = part;
  X.tb = tb;
  // the 16-byte piece of an op's P-matrices this lane copies into the ring
  constexpr int PER_M = St::CHUNKS / 2 > 0 ? St::CHUNKS / 2 : 1;
  const bool copies_p = lane < St::CHUNKS;
  const int chunk_m = lane / PER_M;
  const int chunk_r = (lane % PER_M) / St::CHUNKS_A_RATE;
  const int chunk_q = lane % St::CHUNKS_A_RATE;
  const int p_src = chunk_r * S * S + chunk_q * 4;
  const int p_dst = (chunk_m * RL + chunk_r) * St::RS + chunk_q * 4;

  auto stage_row = [&](int k) {
    if (lane < ROW_INT4)
      copy_async(rows + ROW_INT4 * (k % ROW_SLOTS) + lane,
                 ops + ROW_INT4 * (size_t)k + lane, 16);
  };
  // op k's operands, from its row in the ring, into data slot k
  auto stage_operands = [&](int k) {
    const int4 st = rows[ROW_INT4 * (k % ROW_SLOTS)];
    const int slot = k % DATA_SLOTS;
    int* codes = tip_ring + slot * 2 * H * spw + siw;
    if (r == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (st.x >= 0)
          copy_async(codes + h * spw, tip_col + (size_t)st.x * tb + h * part,
                     4);
        if (st.y >= 0)
          copy_async(codes + (H + h) * spw,
                     tip_col + (size_t)st.y * tb + h * part, 4);
      }
    }
    if constexpr (St::P) {
      if (copies_p)
        copy_async(p_ring + slot * St::P_FLOATS + p_dst,
                   pmat + (size_t)(chunk_m ? st.w : st.z) * p_stride + p_src,
                   16);
    }
  };

  float held[H][S];      // the previous parent, handed on
  int held_scal[H];      // its scaler counts
#pragma unroll
  for (int h = 0; h < H; ++h) {
    held_scal[h] = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) held[h][i] = 0.0f;
  }

  // The ring: rows 0 .. 2 * AHEAD - 1, then the operands of ops
  // 0 .. AHEAD - 1, one group of copies an op.  At op w the copies of op
  // w + AHEAD's operands and op w + 2 * AHEAD's row start, and those of op
  // w's operands and op w + AHEAD's row (started AHEAD ops before) are
  // waited for: no device-memory latency is on the chain from op to op.
  // The warp's barrier makes each lane's copies visible to the others and
  // orders the reads of a slot before the copies that reuse it.
  for (int k = 0; k < 2 * AHEAD && k < n_ops; ++k) stage_row(k);
  commit_copies();
  wait_copies<0>();
  __syncwarp();
  for (int k = 0; k < AHEAD; ++k) {
    if (k < n_ops) stage_operands(k);
    commit_copies();
  }
  for (int w = 0; w < n_ops; ++w) {
    wait_copies<AHEAD - 1>();
    __syncwarp();
    if (w + AHEAD < n_ops) stage_operands(w + AHEAD);
    if (w + 2 * AHEAD < n_ops) stage_row(w + 2 * AHEAD);
    commit_copies();
    const int4 op = rows[ROW_INT4 * (w % ROW_SLOTS) + 1];
    const int slot = w % DATA_SLOTS;
    int code1[H], code2[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      code1[h] = tip_ring[(slot * 2 * H + h) * spw + siw];
      code2[h] = tip_ring[(slot * 2 * H + H + h) * spw + siw];
    }
    const float* P1;
    const float* P2;
    if constexpr (St::P) {
      P1 = p_ring + slot * St::P_FLOATS + r_p * St::RS;
      P2 = P1 + RL * St::RS;
    } else {
      const int4 st = rows[ROW_INT4 * (w % ROW_SLOTS)];
      P1 = pmat + (size_t)st.z * p_stride + r_p * S * S;
      P2 = pmat + (size_t)st.w * p_stride + r_p * S * S;
    }
    int e = -1;  // the export row of this op's parent (bf16 only)
    if constexpr (IS_BF16<T>) e = __ldg(export_at + w);
#define LIBPLL_OP(K1, K2, KEEP)                                               \
  op_lane<S, H, St::P, Child::K1, Child::K2, KEEP>(op, code1, code2, P1, P2,  \
                                                   pool, spool, L, thresh,    \
                                                   factor, held, held_scal,   \
                                                   X, e)
    switch (op.w) {
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
  }

  // Export slots are never reused by the schedule, and an exported parent is
  // always stored.  Each lane copies what it wrote; padding lanes nothing.
  // (A bf16 kernel wrote its exports at their ops.)
  if constexpr (!IS_BF16<T>) {
    if (r >= R) return;
    const int nt = gridDim.x, blk = blockIdx.x;
    for (int e = 0; e < n_exp; ++e) {
      const int slot = __ldg(export_slots + e);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int site = s0 + h * part;
        const float* src =
            pool + (size_t)slot * S * H * L.nth + h * L.nth + L.t;
        float* dst =
            clv_out + (((size_t)e * nt + blk) * R + r) * S * tb + site;
#pragma unroll
        for (int i = 0; i < S; ++i)
          dst[(size_t)i * tb] = src[(size_t)i * H * L.nth];
        if (L.keeps_scaler) {
          const int v = spool[slot * L.sr_stride + L.sidx + h * L.sidx_step];
          scal_out[(((size_t)e * nt + blk) * (per_rate ? R : 1) +
                    (per_rate ? r : 0)) * tb + site] = v;
        }
      }
    }
  }
}

template <int S, int RL, class T>
cudaError_t launch(Store<T>, const int* ops, int n_ops, const float* pmat,
                   const int* p_base, const int* tip_blocked, int tips,
                   const int* export_slots,
                   int n_exp, const int* export_at, float* clv_out,
                   int* scal_out, int nt, int tb, int rates, int lane_bits,
                   int pool_size, int per_rate, float thresh, float factor,
                   cudaStream_t stream) {
  constexpr int H = Staged<S, RL>::H;
  const int nth = (tb << lane_bits) / H;
  if (tb % H || nth > Threads<RL>::MAX || nth % 32)
    return cudaErrorInvalidValue;
  const int sr = per_rate ? H * nth : tb;
  const size_t smem = (size_t)pool_size *
                          ((size_t)S * H * nth * sizeof(T) + (size_t)sr * 4) +
                      (size_t)(nth / 32) * ring_words<S, RL>(1 << lane_bits) *
                          4;
  cudaError_t err = cudaFuncSetAttribute(
      tree_sweep_kernel<S, RL, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tree_sweep_kernel<S, RL, T><<<nt, nth, smem, stream>>>(
      reinterpret_cast<const int4*>(ops), n_ops, pmat, p_base, tip_blocked,
      tips, export_slots, n_exp, export_at, clv_out, scal_out, rates, lane_bits,
      pool_size, per_rate, thresh, factor);
  return cudaGetLastError();
}

template <int S, class T>
cudaError_t launch_rates(Store<T> store, const int* ops, int n_ops,
                         const float* pmat, const int* p_base,
                         const int* tip_blocked, int tips,
                         const int* export_slots, int n_exp,
                         const int* export_at, float* clv_out, int* scal_out,
                         int nt, int tb, int rates, int pool_size,
                         int per_rate, float thresh, float factor,
                         cudaStream_t stream) {
  int lane_bits = 0;
  while ((1 << lane_bits) < rates) ++lane_bits;
#define TREE_SWEEP_ARGS                                                      \
  store, ops, n_ops, pmat, p_base, tip_blocked, tips, export_slots, n_exp,   \
      export_at, clv_out, scal_out, nt, tb, rates, lane_bits, pool_size,     \
      per_rate, thresh, factor, stream
  switch (rates) {
    case 1: return launch<S, 1>(TREE_SWEEP_ARGS);
    case 4: return launch<S, 4>(TREE_SWEEP_ARGS);
    default: return launch<S, 0>(TREE_SWEEP_ARGS);
  }
#undef TREE_SWEEP_ARGS
}

// The state counts with an instantiation of their own (2, 4, 10, 16, 20)
// and every rate count 1..32 for pool type T; every other state count runs
// the generic-state form (csrc/tree_sweep_generic.cu).
template <class T>
cudaError_t launch_states(Store<T> store, const int* ops, int n_ops,
                          const float* pmat, const int* p_base,
                          const int* tip_blocked, int tips,
                          const int* export_slots, int n_exp,
                          const int* export_at, float* clv_out,
                          int* scal_out, int nt, int tb, int rates,
                          int states, int pool_size, int per_rate,
                          float thresh, float factor, cudaStream_t s) {
#define TREE_SWEEP_CASE(S_)                                                  \
  case S_:                                                                   \
    return launch_rates<S_>(store, ops, n_ops, pmat, p_base, tip_blocked,    \
                            tips, export_slots, n_exp, export_at, clv_out,   \
                            scal_out, nt, tb, rates, pool_size, per_rate,    \
                            thresh, factor, s);
  switch (states) {
    TREE_SWEEP_CASE(2)
    TREE_SWEEP_CASE(4)
    TREE_SWEEP_CASE(10)
    TREE_SWEEP_CASE(16)
    TREE_SWEEP_CASE(20)
    default:
      return cudaErrorInvalidValue;
  }
#undef TREE_SWEEP_CASE
}

}  // namespace

// The state counts without an instantiation here (csrc/tree_sweep_generic.cu,
// built into the same library); arguments as tree_sweep_launch's.
cudaError_t launch_generic_states(const int* ops, int n_ops,
                                  const float* pmat, const int* p_base,
                                  int n_pmat, float* pg,
                                  const int* tip_blocked, int tips,
                                  const int* export_slots, int n_exp,
                                  const int* export_at, float* clv_out,
                                  int* scal_out, int nt, int tb, int rates,
                                  int states, int pool_size, int per_rate,
                                  int bf16, int groups, float thresh,
                                  float factor, cudaStream_t stream);

extern "C" {

// Launch the sweep on `stream`; returns the cudaError_t of the launch.
// ops: [n_ops][8] int32, 16-byte aligned (partials_tree.fma_device_table).
// pmat: f32 [n_pmat][rates][states][states], 16-byte aligned, whatever the
// pool's type.  p_base [nt] int32, or null: the P-matrix of pmat that op
// index 0 names in each site block (an op's index p reads p_base[block] +
// p), so that one launch sweeps the site blocks of several partitions, each
// with its own P-matrices (multipartition.py); null reads pmat as it is.
// export_slots [n_exp]: the slots the f32 kernel copies out after the
// sweep; export_at [n_ops]: the export row of each op (-1: none), which
// the bf16 kernel writes out at the op (partials_tree.export_rows).
// bf16: the pool's type, 0 f32 or 1 bf16.  rates <= 32.  States 2, 4, 10,
// 16 and 20: tb * (rates rounded up to a power of two) / H threads (H = 2
// sites a thread up to 4 states, else 1), a multiple of 32, at most 256
// for 1 and 4 rates, 1024 otherwise; n_pmat, pg and groups unused.  Every
// other count from 2 to 32 (csrc/tree_sweep_generic.cu): groups, the row
// groups of a column (partials_tree.generic_groups); pg: room for the
// P-matrices in the row-group layout, n_pmat * group_matrix_floats floats,
// 16-byte aligned.
// The kernels allocate nothing and do not synchronise.
int tree_sweep_launch(const int* ops, int n_ops, const float* pmat,
                      const int* p_base, int n_pmat, float* pg,
                      const int* tip_blocked, int tips,
                      const int* export_slots, int n_exp,
                      const int* export_at, float* clv_out, int* scal_out,
                      int nt, int tb, int rates, int states, int pool_size,
                      int per_rate, int bf16, int groups, float thresh,
                      float factor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ops <= 0 || tb <= 0 || rates <= 0 || rates > 32 ||
      reinterpret_cast<uintptr_t>(ops) % 16 ||
      reinterpret_cast<uintptr_t>(pmat) % 16)
    return (int)cudaErrorInvalidValue;
  if (states != 2 && states != 4 && states != 10 && states != 16 &&
      states != 20)
    return (int)launch_generic_states(
        ops, n_ops, pmat, p_base, n_pmat, pg, tip_blocked, tips, export_slots,
        n_exp, export_at, clv_out, scal_out, nt, tb, rates, states, pool_size,
        per_rate, bf16, groups, thresh, factor, s);
  if (bf16)
    return (int)launch_states(Store<__nv_bfloat16>{}, ops, n_ops, pmat,
                              p_base, tip_blocked, tips, export_slots, n_exp,
                              export_at, clv_out, scal_out, nt, tb, rates,
                              states, pool_size, per_rate, thresh, factor, s);
  return (int)launch_states(Store<float>{}, ops, n_ops, pmat, p_base,
                            tip_blocked, tips, export_slots, n_exp,
                            export_at, clv_out, scal_out, nt, tb, rates,
                            states, pool_size, per_rate, thresh, factor, s);
}

// Dynamic shared memory a block may opt in to on `device`, in bytes.
int tree_sweep_max_smem(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* tree_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
