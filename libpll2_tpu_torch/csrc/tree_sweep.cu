// Felsenstein tree sweep over one site block per CTA, CLV pool in shared
// memory.  Built with nvcc for sm_90a into a shared library with a plain C
// interface (libpll2_tpu_torch/_build.py) and launched through ctypes by
// libpll2_tpu_torch/ops/partials_tree.py:sweep().
//
// Replaces two Pallas kernels of the JAX package:
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_static     (:808)
//   libpll2_tpu/ops/partials_pallas_tree.py:_tree_kernel_static_seg (:1136)
// Both compute the same thing; the JAX package unrolls the op list into the
// kernel and cuts it into segments to bound Mosaic's compile time.  Here the
// op table [OPS, 9] int32 is runtime data, so one compiled kernel serves
// every topology and every op count, with no segments.  The bf16 split-term
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
// What bounds it on an H100: per op and site it does 2*R*S*S FMAs and moves
// 3*R*S*4 bytes through shared memory (two children read, one parent
// written); device memory sees only the tip masks (4 bytes per tip and
// site) and the exported rows.  At S = 4 that is 128 FMAs against 192
// shared-memory bytes, so the kernel is bound by shared-memory bandwidth
// and by the P-matrix loads, not by HBM.  Occupancy is bound by shared
// memory: a CTA holds pool_size * (R*S + SR) * TB * 4 bytes.
//
// What the design does about it:
//   * one thread per site, and every slot is laid out [R*S][TB], so a warp
//     reads and writes 32 consecutive words: no bank conflicts;
//   * each thread owns its site column in every slot and reads nothing any
//     other thread writes (tips and P-matrices are read-only), so the sweep
//     needs no __syncthreads at all;
//   * the Sethi-Ullman schedule keeps the pool at O(log n) slots for
//     balanced trees, so large site blocks fit;
//   * P-matrix rows are read with 16-byte uniform loads through the
//     read-only cache when S % 4 == 0 (every thread of a warp reads the
//     same address: one transaction per warp).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_COLS = 9;

template <int S>
__device__ __forceinline__ float row_dot(const float* __restrict__ p,
                                         const float (&c)[S]) {
  float acc = 0.0f;
  if constexpr (S % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j4 = 0; j4 < S / 4; ++j4) {
      const float4 v = __ldg(p4 + j4);
      acc = fmaf(v.x, c[4 * j4 + 0], acc);
      acc = fmaf(v.y, c[4 * j4 + 1], acc);
      acc = fmaf(v.z, c[4 * j4 + 2], acc);
      acc = fmaf(v.w, c[4 * j4 + 3], acc);
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) acc = fmaf(__ldg(p + j), c[j], acc);
  }
  return acc;
}

// Load one child's rate-r CLV column into registers.
template <int S>
__device__ __forceinline__ void load_child(float (&c)[S], bool is_tip,
                                           int code, const float* col,
                                           int r, int tb) {
#pragma unroll
  for (int j = 0; j < S; ++j)
    c[j] = is_tip ? static_cast<float>((code >> j) & 1)
                  : col[(r * S + j) * tb];
}

// grid = NT site blocks, block = TB threads (one per site).
// shared: pool [pool_size][R*S][TB] f32, then spool [pool_size][SR][TB] i32.
template <int S>
__global__ void tree_sweep_kernel(const int* __restrict__ ops, int n_ops,
                                  const float* __restrict__ pmat,
                                  const int* __restrict__ tip_blocked,
                                  int tips,
                                  const int* __restrict__ export_slots,
                                  int n_exp,
                                  float* __restrict__ clv_out,
                                  int* __restrict__ scal_out,
                                  int rates, int pool_size, int per_rate,
                                  float thresh, float factor) {
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int nt = gridDim.x;
  const int span = rates * S;
  const int sr = per_rate ? rates : 1;
  float* pool = smem;
  int* spool = reinterpret_cast<int*>(smem + (size_t)pool_size * span * tb);
  // tip i of this thread's site: tip_col[i * tb]
  const int* tip_col = tip_blocked + (size_t)blk * tips * tb + t;

  for (int w = 0; w < n_ops; ++w) {
    const int* op = ops + w * OP_COLS;
    const int p_slot = __ldg(op + 0);
    const bool tip1 = __ldg(op + 3) != 0;
    const bool tip2 = __ldg(op + 6) != 0;
    const int slot1 = __ldg(op + 2);
    const int slot2 = __ldg(op + 5);
    const int code1 = tip1 ? __ldg(tip_col + __ldg(op + 1) * tb) : 0;
    const int code2 = tip2 ? __ldg(tip_col + __ldg(op + 4) * tb) : 0;
    const float* P1 = pmat + (size_t)__ldg(op + 7) * span * S;
    const float* P2 = pmat + (size_t)__ldg(op + 8) * span * S;
    const float* col1 = pool + (size_t)slot1 * span * tb + t;
    const float* col2 = pool + (size_t)slot2 * span * tb + t;
    float* par = pool + (size_t)p_slot * span * tb + t;
    const int* sc1 = spool + (size_t)slot1 * sr * tb + t;
    const int* sc2 = spool + (size_t)slot2 * sr * tb + t;
    int* psc = spool + (size_t)p_slot * sr * tb + t;

    bool site_below = true;
    for (int r = 0; r < rates; ++r) {
      float a[S], b[S];
      load_child<S>(a, tip1, code1, col1, r, tb);
      load_child<S>(b, tip2, code2, col2, r, tb);
      const float* p1r = P1 + r * S * S;
      const float* p2r = P2 + r * S * S;
      bool rate_below = true;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float v = row_dot<S>(p1r + i * S, a) *
                        row_dot<S>(p2r + i * S, b);
        par[(r * S + i) * tb] = v;
        rate_below = rate_below && (v < thresh);
      }
      if (per_rate) {
        if (rate_below) {
#pragma unroll
          for (int i = 0; i < S; ++i) par[(r * S + i) * tb] *= factor;
        }
        psc[r * tb] = (tip1 ? 0 : sc1[r * tb]) + (tip2 ? 0 : sc2[r * tb]) +
                      (rate_below ? 1 : 0);
      }
      site_below = site_below && rate_below;
    }
    if (!per_rate) {
      if (site_below) {
        for (int k = 0; k < span; ++k) par[k * tb] *= factor;
      }
      psc[0] = (tip1 ? 0 : sc1[0]) + (tip2 ? 0 : sc2[0]) +
               (site_below ? 1 : 0);
    }
  }

  // Export slots are never reused by the schedule, so they still hold the
  // exported rows.  Each thread copies its own column: no barrier needed.
  for (int e = 0; e < n_exp; ++e) {
    const int slot = __ldg(export_slots + e);
    const float* src = pool + (size_t)slot * span * tb + t;
    float* dst = clv_out + ((size_t)e * nt + blk) * span * tb + t;
    for (int k = 0; k < span; ++k) dst[k * tb] = src[k * tb];
    const int* ssrc = spool + (size_t)slot * sr * tb + t;
    int* sdst = scal_out + ((size_t)e * nt + blk) * sr * tb + t;
    for (int k = 0; k < sr; ++k) sdst[k * tb] = ssrc[k * tb];
  }
}

template <int S>
cudaError_t launch(const int* ops, int n_ops, const float* pmat,
                   const int* tip_blocked, int tips, const int* export_slots,
                   int n_exp, float* clv_out, int* scal_out, int nt, int tb,
                   int rates, int pool_size, int per_rate, float thresh,
                   float factor, cudaStream_t stream) {
  const int sr = per_rate ? rates : 1;
  const size_t smem = (size_t)pool_size * (rates * S + sr) * tb * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tree_sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tree_sweep_kernel<S><<<nt, tb, smem, stream>>>(
      ops, n_ops, pmat, tip_blocked, tips, export_slots, n_exp, clv_out,
      scal_out, rates, pool_size, per_rate, thresh, factor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the sweep on `stream`; returns the cudaError_t of the launch.
// The kernel allocates nothing and does not synchronise.
int tree_sweep_launch(const int* ops, int n_ops, const float* pmat,
                      const int* tip_blocked, int tips,
                      const int* export_slots, int n_exp, float* clv_out,
                      int* scal_out, int nt, int tb, int rates, int states,
                      int pool_size, int per_rate, float thresh, float factor,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TREE_SWEEP_CASE(S_)                                                  \
  case S_:                                                                   \
    return (int)launch<S_>(ops, n_ops, pmat, tip_blocked, tips,              \
                           export_slots, n_exp, clv_out, scal_out, nt, tb,   \
                           rates, pool_size, per_rate, thresh, factor, s);
  switch (states) {
    TREE_SWEEP_CASE(2)
    TREE_SWEEP_CASE(4)
    TREE_SWEEP_CASE(10)
    TREE_SWEEP_CASE(16)
    TREE_SWEEP_CASE(20)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TREE_SWEEP_CASE
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
