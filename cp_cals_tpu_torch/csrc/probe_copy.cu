// The launch-overhead probe's kernel for Hopper (sm_90a).
//
// probe_copy_kernel replaces scripts/probe_overhead.py:copy_kernel:
//   o[i] = x[i] * 0.999f over a float32 array, one elementwise pass with a
//   grid-stride loop. One rounded product per element, so it is
//   bit-identical to PyTorch's float32 x * 0.999 (the scalar is rounded to
//   float32 first, as here).
//
// What bounds it: bytes, 8 per element; at the probe's shapes (0.15 MB and
// 2.3 MB) the launch latency is larger than the transfer, which is what the
// probe measures.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 8;  // 8 blocks per SM of an H100

__global__ void __launch_bounds__(THREADS)
probe_copy_kernel(const float* __restrict__ x, float* __restrict__ o,
                  long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    o[i] = x[i] * 0.999f;
}

}  // namespace

// x, o [n] float32.
extern "C" int probe_copy_launch(const float* x, float* o, long long n,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  probe_copy_kernel<<<(int)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return (int)cudaGetLastError();
}
