// All-edge Newton smoothing of one colour class: sumtable, Newton steps and
// the f32 keep of every edge of the class in one launch.  Built with nvcc
// for sm_90a into the package's shared library (libpll2_tpu_torch/_build.py)
// and launched through ctypes by
// libpll2_tpu_torch/ops/newton_edges.py:newton_edges().
//
// No TPU kernel precedes it (the JAX package's smoothing is XLA).  It
// computes what engine._optimize_branch_lengths' plain path computes for
// one partition, per edge e of the class (rows a, b: the two message rows
// of e; x = eigenvalue * rate / (1 - pinv), w0 = rate weight * (1 - pinv)):
//   st[r*S+j, t] = (sum_k ML[r,j,k] a[r,k,t]) * (sum_k EV[r,j,k] b[r,k,t])
//   L^(n)(t)     = sum_{r,j} st[r,j] * x^n * w0 * exp(x t)      (n = 0, 1, 2)
//   newton_iters times, from t = bl[e]: d1 = sum_w -L'/L, d2 = sum_w
//     (L'/L)^2 - L''/L over live sites (pattern weight > 0); t <- d2 > 0 ?
//     t - d1/d2 : (d1 > 0 ? t/2 : 2t), clipped to [lo, hi], a NaN kept NaN
//     (derivatives.newton_update(..., hold_nonfinite=False))
//   bl[e] = sum_w log L(t) finite ? t : bl[e]      (engine._finite_or_start)
// Per-site scalers cancel in L'/L and leave the keep's finiteness alone, so
// the kernel reads no scaler row.
//
// What bounds it on an H100: bytes.  A class's edges each need two message
// rows (R*S*T floats each: 256 KB for DNA with four rate categories at
// T = 4096), and newton_iters + 1 dependent reductions over all T sites of
// the edge's sumtable, which a block's 227 KB of shared memory does not
// hold.
//
// What the design does about it: the edge scorer's resident form
// (edge_score.cu, sharing newton_passes.cuh).  An edge is scored by a
// thread-block cluster of k CTAs (1, 2, 4 or 8; ops/newton_edges.py:plan).
// CTA `rank` owns the sites [rank * stripe, (rank + 1) * stripe) and keeps
// its stripe of st in shared memory: pass 0 streams the two rows once,
// builds st and takes the first Newton sums from its registers; every later
// pass, and the keep's logL, read st only.  The sums are added across the
// cluster in stripe order (cluster_sum2), so that every CTA takes the same
// step, and rank 0 writes the edge's length into bl in place.  The class's
// edges share no node, so they are independent clusters of one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "newton_passes.cuh"

namespace {

// The edge-row columns the kernel reads (engine.FullTreeProgram.edge_rows:
// rowA, scalA, rowB, scalB).
constexpr int ROW_COLS = 4;
constexpr int ROW_A = 0;
constexpr int ROW_B = 2;
// Two CTAs an SM by registers (the edge scorer's RESIDENT_CTAS).
constexpr int RESIDENT_CTAS = 2;

struct Args {
  const float* clv;              // [rows, R*S, T] message rows
  const long long* edge_rows;    // [E, ROW_COLS]
  const long long* members;      // [n] the class's branch positions
  float* bl;                     // [E] branch lengths, updated in place
  const float* lbd;              // [R*S, R*S] block-diagonal ML
  const float* rbd;              // [R*S, R*S] block-diagonal EV
  const float* xw;               // [R*S, 2]: x | w0
  const float* pw;               // [T] pattern weights
  int rates, states, sites, newton_iters;
  float lo, hi;
};

// Floats of shared memory before the sumtable stripe: sums [2][MAX_CLUSTER]
// [NWARPS] float2, the e-terms [NWARPS][R*S] float4 (a copy per warp), then
// ML, EV [R][S][S] and x, w0 [R*S]; rounded up to 16 bytes.
__host__ __device__ constexpr int head_floats(int R, int S) {
  return (SUM_FLOATS + 4 * NWARPS * R * S + 2 * R * S * S + 2 * R * S + 3) /
         4 * 4;
}

size_t smem_bytes(int rates, int S, int sites, int cluster) {
  const int stripe = (sites + cluster - 1) / cluster;
  return ((size_t)head_floats(rates, S) + (size_t)rates * S * stripe) *
         sizeof(float);
}

// (L, L', L'') of V consecutive sites from the two message rows at the
// e-terms se, storing the sites' sumtable columns to st[q * st_stride ..].
// S > 0: the state count at compile time (Sn == S); S = 0: Sn at run time,
// every loop unrolled to SMAX with Sn as its bound.  RC > 0: the rate
// categories at compile time, so that the next category's loads are in
// flight during this one's products.
template <int S, int SMAX, int V, int RC>
__device__ __forceinline__ void sumtable_lk(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            size_t T, int R, int Sn,
                                            const float* sL, const float* sE,
                                            const float4* se, bool derivs,
                                            float* st, int st_stride,
                                            float (&lk0)[V], float (&lk1)[V],
                                            float (&lk2)[V]) {
  constexpr int SB = S > 0 ? S : SMAX;
#pragma unroll
  for (int v = 0; v < V; ++v) lk0[v] = lk1[v] = lk2[v] = 0.0f;
  auto rate = [&](int r) {
    float av[SB][V], bv[SB][V];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      if (j < Sn) {
        const size_t off = (size_t)(r * Sn + j) * T;
        load_sites<V>(a + off, av[j]);
        load_sites<V>(b + off, bv[j]);
      }
    }
    const float* L = sL + r * Sn * Sn;
    const float* E = sE + r * Sn * Sn;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      if (j < Sn) {
        float lef[V], rig[V];
#pragma unroll
        for (int v = 0; v < V; ++v) lef[v] = rig[v] = 0.0f;
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          if (k < Sn) {
            const float l = L[j * Sn + k], e = E[j * Sn + k];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              lef[v] = fmaf(l, av[k][v], lef[v]);
              rig[v] = fmaf(e, bv[k][v], rig[v]);
            }
          }
        }
        const int q = r * Sn + j;
        const float4 e = se[q];
        float val[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          val[v] = lef[v] * rig[v];
          lk0[v] = fmaf(val[v], e.x, lk0[v]);
          if (derivs) {
            lk1[v] = fmaf(val[v], e.y, lk1[v]);
            lk2[v] = fmaf(val[v], e.z, lk2[v]);
          }
        }
        float* dst = st + (size_t)q * st_stride;
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(val[0], val[1], val[2], val[3]);
        else
          dst[0] = val[0];
      }
    }
  };
  if constexpr (RC > 0) {
#pragma unroll
    for (int r = 0; r < RC; ++r) rate(r);
  } else {
    for (int r = 0; r < R; ++r) rate(r);
  }
}

// The live sites' share of a pass's sums: (w d1, w d2) in a Newton pass,
// the weighted log-likelihood in the keep's pass.  A site of weight 0 is
// padding and adds nothing.
template <int V>
__device__ __forceinline__ void accumulate(bool last, const float (&w)[V],
                                           const float (&lk0)[V],
                                           const float (&lk1)[V],
                                           const float (&lk2)[V],
                                           float& acc1, float& acc2) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!(w[v] > 0.0f)) continue;
    if (last) {
      acc1 += w[v] * logf(lk0[v]);
    } else {
      const float deriv1 = -lk1[v] / lk0[v];
      const float deriv2 = deriv1 * deriv1 - lk2[v] / lk0[v];
      acc1 += w[v] * deriv1;
      acc2 += w[v] * deriv2;
    }
  }
}

// grid = n edges * k CTAs in clusters of k along x, block = THREADS.  V
// sites a thread and step in the passes that read the sumtable (4: 16-byte
// reads; the host checks the alignment); pass 0 at V0 = V where the state
// count is small enough for the registers (S <= 4), else at one.  shared:
// the head, then the CTA's stripe of the sumtable, st [R*S][stripe] f32.
template <int S, int SMAX, int V, int RC>
__global__ void __launch_bounds__(THREADS, RESIDENT_CTAS)
newton_edges_kernel(Args a, int stripe) {
  constexpr int V0 = S > 0 && S <= 4 ? V : 1;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = RC > 0 ? RC : a.rates;
  const int Sn = S > 0 ? S : a.states;
  const int span = R * Sn;
  const int ss = Sn * Sn;
  const size_t T = (size_t)a.sites;
  const long long m = __ldg(a.members + blockIdx.x / k);
  const long long* row = a.edge_rows + m * ROW_COLS;
  const float* rows_a = a.clv + (size_t)__ldg(row + ROW_A) * span * T;
  const float* rows_b = a.clv + (size_t)__ldg(row + ROW_B) * span * T;
  const float t0 = a.bl[m];

  float* smem = reinterpret_cast<float*>(smem4);
  float4* se = smem4 + warp * span;          // this warp's e-terms
  float2* sums = reinterpret_cast<float2*>(smem + 4 * NWARPS * span);
  float* sL = smem + 4 * NWARPS * span + SUM_FLOATS;
  float* sE = sL + R * ss;
  float* sx = sE + R * ss;
  float* sw = sx + span;
  float* st = smem + head_floats(R, Sn);
  for (int i = tid; i < R * ss; i += THREADS) {
    const int r = i / ss, j = (i % ss) / Sn, c = i % Sn;
    const size_t bd = (size_t)(r * Sn + j) * span + r * Sn + c;
    sL[i] = __ldg(a.lbd + bd);
    sE[i] = __ldg(a.rbd + bd);
  }
  for (int q = tid; q < span; q += THREADS) {
    sx[q] = __ldg(a.xw + 2 * q);
    sw[q] = __ldg(a.xw + 2 * q + 1);
  }
  const size_t first = (size_t)rank * stripe;
  const size_t left = first < T ? T - first : 0;
  const int mine = left < (size_t)stripe ? (int)left : stripe;
  // the constants are in place, every CTA of the cluster has started (its
  // shared memory may be written from outside) and has read t0
  cluster.sync();

  float t = t0;
  for (int it = 0; it <= a.newton_iters; ++it) {
    const bool last = it == a.newton_iters;
    for (int q = lane; q < span; q += 32) se[q] = e_term(sx[q], sw[q], t);
    __syncwarp();
    float acc1 = 0.0f, acc2 = 0.0f;
    if (it == 0) {
      for (int ls = tid * V0; ls < mine; ls += THREADS * V0) {
        const size_t site = first + ls;
        float w[V0], lk0[V0], lk1[V0], lk2[V0];
        load_sites<V0>(a.pw + site, w);
        if (!any_live(w)) continue;      // padding: weight 0, inert
        sumtable_lk<S, SMAX, V0, RC>(rows_a + site, rows_b + site, T, R, Sn,
                                     sL, sE, se, !last, st + ls, stripe, lk0,
                                     lk1, lk2);
        accumulate<V0>(last, w, lk0, lk1, lk2, acc1, acc2);
      }
    } else {
      // a padding site's column may be unwritten: its weight skips it
      for (int ls = tid * V; ls < mine; ls += THREADS * V) {
        const size_t site = first + ls;
        float w[V], lk0[V], lk1[V], lk2[V];
        load_sites<V>(a.pw + site, w);
        if (!any_live(w)) continue;
        site_lk_resident<V>(st + ls, stripe, span, se, !last, lk0, lk1, lk2);
        accumulate<V>(last, w, lk0, lk1, lk2, acc1, acc2);
      }
    }
    const float2 d = cluster_sum2(
        cluster, sums + (it & 1) * MAX_CLUSTER * NWARPS, k, rank, acc1, acc2);
    if (!last) {
      t = newton_step<false>(t, d.x, d.y, a.lo, a.hi);
    } else if (rank == 0 && tid == 0) {
      // the f32 keep: an end whose logL is not finite (NaN included) gives
      // the edge back its start
      a.bl[m] = isfinite(d.x) ? t : t0;
    }
  }
  // the last remote store was before the last barrier: a CTA may leave
}

template <class K>
cudaError_t launch(K kernel, const Args& a, int n, int cluster,
                   cudaStream_t stream) {
  const int stripe = (a.sites + cluster - 1) / cluster;
  return launch_clusters(kernel, n, cluster,
                         smem_bytes(a.rates, a.states, a.sites, cluster),
                         stream, a, stripe);
}

// Four sites a thread and step where the sites, the stripe, the message
// rows and the pattern weights allow 16-byte accesses, else one; DNA with
// four rate categories has its rate loop unrolled.
template <int S, int SMAX>
cudaError_t dispatch(const Args& a, int n, int cluster, cudaStream_t stream) {
  const int stripe = (a.sites + cluster - 1) / cluster;
  const bool v4 = a.sites % 4 == 0 && stripe % 4 == 0 && aligned16(a.clv) &&
                  aligned16(a.pw);
  if constexpr (S == 4) {
    if (v4 && a.rates == 4)
      return launch(newton_edges_kernel<4, 0, 4, 4>, a, n, cluster, stream);
  }
  if (v4)
    return launch(newton_edges_kernel<S, SMAX, 4, 0>, a, n, cluster, stream);
  return launch(newton_edges_kernel<S, SMAX, 1, 0>, a, n, cluster, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs at `cluster` CTAs an edge
// (what ops/newton_edges.py:smem_bytes computes on the host; the tests on
// the card hold the two against each other).
int newton_edges_smem(int rates, int states, int sites, int cluster) {
  return (int)smem_bytes(rates, states, sites, cluster);
}

// Launch the Newton smoothing of the n edges `members` on `stream`; returns
// the cudaError_t of the launch.  cluster: 1, 2, 4 or 8 CTAs an edge.  The
// kernel allocates nothing and does not synchronise.
int newton_edges_launch(const float* clv, const long long* edge_rows,
                        const long long* members, int n, float* bl,
                        const float* lbd, const float* rbd, const float* xw,
                        const float* pw, int rates, int states, int sites,
                        int newton_iters, float lo, float hi, int cluster,
                        void* stream) {
  const Args a{clv, edge_rows, members, bl, lbd, rbd, xw, pw, rates, states,
               sites, newton_iters, lo, hi};
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return (int)cudaErrorInvalidValue;
  if (states < 2 || states > 32 || rates < 1 || n < 0 || newton_iters < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 4: return (int)dispatch<4, 0>(a, n, cluster, s);
    case 20: return (int)dispatch<20, 0>(a, n, cluster, s);
    default: break;
  }
  // every other count of an int32 tip mask: the state count at run time
  if (states <= 8) return (int)dispatch<0, 8>(a, n, cluster, s);
  return (int)dispatch<0, 32>(a, n, cluster, s);
}

}  // extern "C"
