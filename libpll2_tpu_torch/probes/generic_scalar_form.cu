// The first generic-state form of the tree sweep ("the scalar form"), as
// it served the package before the row-group form, for
// probes/variants.py only: its
// patches (ALL_FORMS) insert this text into a copy of
// csrc/tree_sweep_generic.cu, inside its anonymous namespace, and reach it
// with groups = 0, so that the experiments time the row-group form against
// it.  The package's build does not compile this file.

// The scalar form (the first generic form, as it was): one thread per (site,
// rate lane), row i of the parent summed over j reading each child entry
// from its pool slot (or the bit of its tip mask) and each P entry through
// L1, registers O(1) in S.
//   * the parent is stored as its rows are formed and scaled in place if
//     the site (or the (site, rate) under per-rate scalers) rescues;
//   * every parent is stored and every child loaded from its slot (a
//     handed-on child's slot is the previous op's parent slot in the op
//     table), so the rows are those of the carry on and off alike;
//   * the per-site rescue is the AND over the site's lanes by
//     __shfl_xor_sync;
//   * a bf16 pool holds 16-bit entries [pool_size][S][threads]; where a
//     site rescues, its rows are formed again and stored scaled, and an
//     exported parent goes out in f32 at its op.
// Each thread reads back only pool words it wrote, so no CTA barrier.
// P rows are read as scalars: at odd S a row starts on a 4-byte boundary.
// Tip masks are read unsigned: bit 31 is a state at S = 32 and the gap
// mask is all ones.
constexpr int GENERIC_THREADS = 1024;

// One op for one lane: K1_TIP / K2_TIP say whether the children are tips
// (the op table orders a tip child first).  Child 2 at a pool slot, or
// handed on in the table, is read from its slot.
template <int SMAX, bool K1_TIP, bool K2_TIP>
__device__ __forceinline__ void scalar_op(
    const int4& st, const int4& op, const int* __restrict__ tip_col, int tb,
    const float* __restrict__ pmat, size_t p_stride, int p_rate, int S,
    float* pool, size_t slot_words, int nth, int t, int* spool,
    int sr_stride, int sidx, bool keeps, int lanes, int per_rate,
    float thresh, float factor) {
  const float* P1 = pmat + (size_t)st.z * p_stride + p_rate;
  const float* P2 = pmat + (size_t)st.w * p_stride + p_rate;
  const unsigned m1 =
      K1_TIP ? static_cast<unsigned>(__ldg(tip_col + (size_t)st.x * tb)) : 0u;
  const unsigned m2 =
      K2_TIP ? static_cast<unsigned>(__ldg(tip_col + (size_t)st.y * tb)) : 0u;
  const float* c1 = pool + (size_t)op.y * slot_words + t;
  const float* c2 = pool + (size_t)op.z * slot_words + t;
  float* par = pool + (size_t)op.x * slot_words + t;
  int below = 1;  // every entry of the parent < thresh
  for (int i = 0; i < S; ++i) {
    const float* p1 = P1 + i * S;
    const float* p2 = P2 + i * S;
    float left = 0.0f, right = 0.0f;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        const float a = K1_TIP ? static_cast<float>((m1 >> j) & 1u)
                               : c1[(size_t)j * nth];
        const float b = K2_TIP ? static_cast<float>((m2 >> j) & 1u)
                               : c2[(size_t)j * nth];
        left = fmaf(__ldg(p1 + j), a, left);
        right = fmaf(__ldg(p2 + j), b, right);
      }
    }
    const float v = left * right;
    if (!(v < thresh)) below = 0;
    par[(size_t)i * nth] = v;
  }
  if (!per_rate) {
    // every lane of the warp takes part in each shuffle
    for (int x = 1; x < lanes; x <<= 1)
      below &= __shfl_xor_sync(FULL, below, x);
  }
  if (below) {
    for (int i = 0; i < S; ++i) par[(size_t)i * nth] *= factor;
  }
  // scalers: only the lane that keeps this word reads or writes it
  if (keeps) {
    int sc = below;
    if (!K1_TIP) sc += spool[op.y * sr_stride + sidx];
    if (!K2_TIP) sc += spool[op.z * sr_stride + sidx];
    spool[op.x * sr_stride + sidx] = sc;
  }
}

// The same op with a bf16 pool [pool_size][S][threads]: rows formed in f32
// and stored rounded; where the site rescues they are formed again and
// stored scaled (a stored bf16 row scaled afterwards would differ from the
// rounded scaled f32 row below 2^-126).  out / sout: where this lane's
// exported parent and its scaler go (null: the op exports nothing, or the
// lane keeps no such word).  A copy of scalar_op rather than one template
// for both types: the f32 form with its rows in a lambda ran slower on the
// card (PERF.md, bf16 storage).
template <int SMAX, bool K1_TIP, bool K2_TIP>
__device__ __forceinline__ void scalar_op_bf16(
    const int4& st, const int4& op, const int* __restrict__ tip_col, int tb,
    const float* __restrict__ pmat, size_t p_stride, int p_rate, int S,
    __nv_bfloat16* pool, size_t slot_words, int nth, int t, int* spool,
    int sr_stride, int sidx, bool keeps, int lanes, int per_rate,
    float thresh, float factor, float* out, int* sout) {
  const float* P1 = pmat + (size_t)st.z * p_stride + p_rate;
  const float* P2 = pmat + (size_t)st.w * p_stride + p_rate;
  const unsigned m1 =
      K1_TIP ? static_cast<unsigned>(__ldg(tip_col + (size_t)st.x * tb)) : 0u;
  const unsigned m2 =
      K2_TIP ? static_cast<unsigned>(__ldg(tip_col + (size_t)st.y * tb)) : 0u;
  const __nv_bfloat16* c1 = pool + (size_t)op.y * slot_words + t;
  const __nv_bfloat16* c2 = pool + (size_t)op.z * slot_words + t;
  __nv_bfloat16* par = pool + (size_t)op.x * slot_words + t;
  // row i of the parent, f32
  auto row = [&](int i) {
    const float* p1 = P1 + i * S;
    const float* p2 = P2 + i * S;
    float left = 0.0f, right = 0.0f;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        const float a = K1_TIP ? static_cast<float>((m1 >> j) & 1u)
                               : __bfloat162float(c1[(size_t)j * nth]);
        const float b = K2_TIP ? static_cast<float>((m2 >> j) & 1u)
                               : __bfloat162float(c2[(size_t)j * nth]);
        left = fmaf(__ldg(p1 + j), a, left);
        right = fmaf(__ldg(p2 + j), b, right);
      }
    }
    return left * right;
  };
  int below = 1;  // every entry of the parent < thresh
  for (int i = 0; i < S; ++i) {
    const float v = row(i);
    if (!(v < thresh)) below = 0;
    par[(size_t)i * nth] = __float2bfloat16_rn(v);
    if (out) out[(size_t)i * tb] = v;
  }
  if (!per_rate) {
    // every lane of the warp takes part in each shuffle
    for (int x = 1; x < lanes; x <<= 1)
      below &= __shfl_xor_sync(FULL, below, x);
  }
  if (below) {
    for (int i = 0; i < S; ++i) {
      const float v = row(i) * factor;
      par[(size_t)i * nth] = __float2bfloat16_rn(v);
      if (out) out[(size_t)i * tb] = v;
    }
  }
  // scalers: only the lane that keeps this word reads or writes it
  if (keeps) {
    int sc = below;
    if (!K1_TIP) sc += spool[op.y * sr_stride + sidx];
    if (!K2_TIP) sc += spool[op.z * sr_stride + sidx];
    spool[op.x * sr_stride + sidx] = sc;
    if (sout) *sout = sc;
  }
}

// grid = NT site blocks of TB sites; block = TB * lanes threads: thread t
// has rate lane t % lanes of site t / lanes.  shared: pool
// [pool_size][S][threads] of T, then spool [pool_size][SR] i32 (SR =
// threads per-rate, TB per-site).  ops, export_slots and export_at as for
// tree_sweep_kernel.
template <int SMAX, class T>
__global__ void __launch_bounds__(GENERIC_THREADS)
tree_sweep_scalar_kernel(const int4* __restrict__ ops, int n_ops,
                          const float* __restrict__ pmat,
                          const int* __restrict__ tip_blocked, int tips,
                          const int* __restrict__ export_slots, int n_exp,
                          const int* __restrict__ export_at,
                          float* __restrict__ clv_out,
                          int* __restrict__ scal_out, int S, int rates,
                          int lane_bits, int pool_size, int per_rate,
                          float thresh, float factor) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, nth = blockDim.x;
  const int lanes = 1 << lane_bits;
  const int tb = nth >> lane_bits;
  const int s0 = t >> lane_bits, r = t & (lanes - 1);
  const int R = rates;
  const int sr_stride = per_rate ? nth : tb;
  const int sidx = per_rate ? t : s0;
  const bool keeps = per_rate || r == 0;
  const size_t slot_words = (size_t)S * nth;
  T* pool = reinterpret_cast<T*>(smem);
  int* spool = reinterpret_cast<int*>(pool + (size_t)pool_size * slot_words);
  const int* tip_col = tip_blocked + (size_t)blockIdx.x * tips * tb + s0;
  const size_t p_stride = (size_t)R * S * S;
  const int p_rate = min(r, R - 1) * S * S;
  const int nt = gridDim.x, blk = blockIdx.x;

  for (int w = 0; w < n_ops; ++w) {
    const int4 st = __ldg(ops + ROW_INT4 * (size_t)w);
    const int4 op = __ldg(ops + ROW_INT4 * (size_t)w + 1);
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
#define LIBPLL_SCALAR_ARGS                                                   \
  st, op, tip_col, tb, pmat, p_stride, p_rate, S, pool, slot_words, nth, t,   \
      spool, sr_stride, sidx, keeps, lanes, per_rate, thresh, factor
#define LIBPLL_SCALAR_OP(T1, T2)                                             \
  if constexpr (IS_BF16<T>)                                                   \
    scalar_op_bf16<SMAX, T1, T2>(LIBPLL_SCALAR_ARGS, out, sout);            \
  else                                                                        \
    scalar_op<SMAX, T1, T2>(LIBPLL_SCALAR_ARGS)
    // the op's case 2 * kinds + keep; kinds (tip, tip), (tip, pool),
    // (tip, handed on), (pool, pool), (pool, handed on)
    switch (op.w >> 1) {
      case 0: LIBPLL_SCALAR_OP(true, true); break;
      case 1:
      case 2: LIBPLL_SCALAR_OP(true, false); break;
      default: LIBPLL_SCALAR_OP(false, false); break;
    }
#undef LIBPLL_SCALAR_OP
#undef LIBPLL_SCALAR_ARGS
  }

  // export slots are never reused by the schedule; padding lanes write
  // nothing (a bf16 kernel wrote its exports at their ops)
  if constexpr (!IS_BF16<T>) {
    if (r >= R) return;
    for (int e = 0; e < n_exp; ++e) {
      const int slot = __ldg(export_slots + e);
      const float* src = pool + (size_t)slot * slot_words + t;
      float* dst = clv_out + (((size_t)e * nt + blk) * R + r) * S * tb + s0;
      for (int i = 0; i < S; ++i) dst[(size_t)i * tb] = src[(size_t)i * nth];
      if (keeps)
        scal_out[(((size_t)e * nt + blk) * (per_rate ? R : 1) +
                  (per_rate ? r : 0)) * tb + s0] =
            spool[slot * sr_stride + sidx];
    }
  }
}

template <int SMAX, class T>
cudaError_t launch_scalar(Store<T>, const int* ops, int n_ops,
                           const float* pmat, const int* tip_blocked,
                           int tips, const int* export_slots, int n_exp,
                           const int* export_at, float* clv_out,
                           int* scal_out, int nt, int tb, int rates,
                           int states, int pool_size, int per_rate,
                           float thresh, float factor, cudaStream_t stream) {
  int lane_bits = 0;
  while ((1 << lane_bits) < rates) ++lane_bits;
  const int nth = tb << lane_bits;
  if (nth > GENERIC_THREADS || nth % 32) return cudaErrorInvalidValue;
  const int sr = per_rate ? nth : tb;
  const size_t smem = (size_t)pool_size *
                      ((size_t)states * nth * sizeof(T) + (size_t)sr * 4);
  cudaError_t err = cudaFuncSetAttribute(
      tree_sweep_scalar_kernel<SMAX, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tree_sweep_scalar_kernel<SMAX, T><<<nt, nth, smem, stream>>>(
      reinterpret_cast<const int4*>(ops), n_ops, pmat, tip_blocked, tips,
      export_slots, n_exp, export_at, clv_out, scal_out, states, rates,
      lane_bits, pool_size, per_rate, thresh, factor);
  return cudaGetLastError();
}
