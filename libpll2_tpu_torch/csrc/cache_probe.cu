// out[i] = 2 * x[i] + 1: the smallest kernel of the library, launched by
// libpll2_tpu_torch/probes/cache.py to exercise the build-and-reload path
// of _build.py itself (compile cold into a fresh directory, load warm in a
// second process with no nvcc in reach, rebuild after an edited source).
//
// Replaces tools/cacheprobe.py:kern (:43) of the JAX package, the trivial
// Pallas kernel with which that probe found where a cold compile under the
// persistent compilation cache hung.
//
// What bounds it on an H100: bytes.  One read and one write of 4 bytes per
// element and a single FMA: at 256 x 256 f32 that is 512 KB, 0.16 us at the
// card's memory rate, far below the few microseconds a launch costs, so a
// call's time is the host's launch path (probes/cache.py: scale_shift keeps
// it short).  The body moves 16 bytes a load and a store, four elements a
// thread, where both pointers are 16-byte aligned; the last n % 4 elements
// go to one more thread, and unaligned pointers to one element a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void cache_probe_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int n,
                                   int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!vec) {
    if (i < n) out[i] = fmaf(x[i], 2.0f, 1.0f);
    return;
  }
  const int n4 = n / 4;
  if (i < n4) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(fmaf(v.x, 2.0f, 1.0f), fmaf(v.y, 2.0f, 1.0f),
                    fmaf(v.z, 2.0f, 1.0f), fmaf(v.w, 2.0f, 1.0f));
  } else if (i == n4) {
    for (int j = 4 * n4; j < n; ++j) out[j] = fmaf(x[j], 2.0f, 1.0f);
  }
}

}  // namespace

extern "C" {

// x, out: n f32 each, on the device of `stream`.  Returns the cudaError_t
// of the launch.
int cache_probe_launch(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int threads = vec ? n / 4 + 1 : n;
  cache_probe_kernel<<<(threads + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
