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
// card's memory rate, far below the few microseconds a launch costs.  One
// thread per element, consecutive threads on consecutive words; nothing to
// design beyond that.
#include <cuda_runtime.h>

namespace {

__global__ void cache_probe_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = fmaf(x[i], 2.0f, 1.0f);
}

}  // namespace

extern "C" {

// x, out: n f32 each, on the device of `stream`.  Returns the cudaError_t
// of the launch.
int cache_probe_launch(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cache_probe_kernel<<<(n + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
