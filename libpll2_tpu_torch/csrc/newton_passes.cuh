// Newton passes over a sumtable kept on chip, shared by the two kernels
// that run them: the SPR edge scorer's resident form (edge_score.cu) and the
// all-edge Newton smoothing (newton_edges.cu).  Both keep a CTA's stripe of
// a sumtable st [R*S][stripe] f32 in shared memory, run every Newton pass
// after the first from it, and add each pass's sums across a thread-block
// cluster in stripe order; what differs (how the sumtable is built, what
// the last pass sums, whether a non-finite step is held) stays in each
// kernel's file.  Included by those two sources only, each of which keeps
// its own copy in an anonymous namespace.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// A cluster of up to 8 CTAs is portable on sm_90.
constexpr int MAX_CLUSTER = 8;
// The cluster sums in shared memory: [2 pass parities][MAX_CLUSTER]
// [NWARPS] float2 (every warp's sum of every CTA of the cluster).
constexpr int SUM_FLOATS = 2 * MAX_CLUSTER * NWARPS * 2;

// V consecutive sites from p: one 16-byte load at V = 4 (p 16-byte aligned).
template <int V>
__device__ __forceinline__ void load_sites(const float* p, float (&x)[V]) {
  static_assert(V == 1 || V == 4, "one site or four");
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_sites(const int* p, int (&x)[V]) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

// (L, L', L'') of V consecutive sites from sumtable columns kept in shared
// memory, at the e-terms se[q] = (e, x e, x^2 e, -).
template <int V>
__device__ __forceinline__ void site_lk_resident(const float* st,
                                                 int st_stride, int span,
                                                 const float4* se, bool derivs,
                                                 float (&lk0)[V],
                                                 float (&lk1)[V],
                                                 float (&lk2)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) lk0[v] = lk1[v] = lk2[v] = 0.0f;
  for (int q = 0; q < span; ++q) {
    float val[V];
    const float* src = st + (size_t)q * st_stride;
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      val[0] = t.x, val[1] = t.y, val[2] = t.z, val[3] = t.w;
    } else {
      val[0] = src[0];
    }
    const float4 e = se[q];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      lk0[v] = fmaf(val[v], e.x, lk0[v]);
      if (derivs) {
        lk1[v] = fmaf(val[v], e.y, lk1[v]);
        lk2[v] = fmaf(val[v], e.z, lk2[v]);
      }
    }
  }
}

// The e-terms of one (rate, state) at length t: (e, x e, x^2 e, -) with
// e = w0 * exp(x t).
__device__ __forceinline__ float4 e_term(float x, float w0, float t) {
  const float e = w0 * expf(x * t);
  return make_float4(e, x * e, x * x * e, 0.0f);
}

template <int V>
__device__ __forceinline__ bool any_live(const float (&w)[V]) {
  bool live = false;
#pragma unroll
  for (int v = 0; v < V; ++v) live |= w[v] > 0.0f;
  return live;
}

// The safeguarded Newton step from the pass's (d1, d2), clipped to
// [lo, hi].  HOLD_NONFINITE: a non-finite step keeps t (the edge scorer);
// else a NaN step stays NaN through the clip, as torch.clamp keeps it
// (fminf and fmaxf would drop it), so that the caller can tell.
template <bool HOLD_NONFINITE>
__device__ __forceinline__ float newton_step(float t, float d1, float d2,
                                             float lo, float hi) {
  const float newton = t - d1 / d2;
  const float fallback = d1 > 0.0f ? t * 0.5f : t * 2.0f;
  float tn = d2 > 0.0f ? newton : fallback;
  if constexpr (HOLD_NONFINITE) {
    if (!isfinite(tn)) tn = t;
  } else {
    if (isnan(tn)) return tn;
  }
  return fminf(fmaxf(tn, lo), hi);
}

// Sum (x, y) over the warp; the result is valid in lane 0.
__device__ __forceinline__ float2 warp_sum2(float x, float y) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
  }
  return make_float2(x, y);
}

// The pass's (acc1, acc2) summed over the cluster, the same in every
// thread of every CTA.  Every warp pushes its sum into pass_sums
// [MAX_CLUSTER][NWARPS] of every CTA of the cluster (remote stores into
// distributed shared memory), one cluster.sync() makes the stores visible,
// and every thread adds, from its own shared memory, each stripe's warp
// sums and then the stripes in rank order 0 .. k-1: all CTAs derive the
// same result from the same operands in the same order.  The shuffles also
// bring the warp past its reads of the pass's e-terms.  The caller
// alternates pass_sums by pass parity, so that a pass's stores never meet
// a CTA still reading the pass before.
__device__ __forceinline__ float2 cluster_sum2(cg::cluster_group& cluster,
                                               float2* pass_sums, int k,
                                               int rank, float acc1,
                                               float acc2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float2 warp_tot = warp_sum2(acc1, acc2);
  if (lane == 0) {
    float2* mine_at = pass_sums + rank * NWARPS + warp;
    for (int r = 0; r < k; ++r)
      *cluster.map_shared_rank(mine_at, r) = warp_tot;
  }
  cluster.sync();
  float d1 = 0.0f, d2 = 0.0f;
  for (int r = 0; r < k; ++r) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float2 p = pass_sums[r * NWARPS + w];
      s1 += p.x;
      s2 += p.y;
    }
    d1 += s1;
    d2 += s2;
  }
  return make_float2(d1, d2);
}

// Opt a kernel in to `smem` bytes of dynamic shared memory where it needs
// more than the default 48 KB.
template <class K>
cudaError_t allow_shared(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch `kernel` on `stream` over `n_clusters` clusters of `cluster` CTAs
// of THREADS threads along x, with `smem` bytes of dynamic shared memory.
template <class K, class... Args>
cudaError_t launch_clusters(K kernel, int n_clusters, int cluster,
                            size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)n_clusters * cluster, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
