// The launch-overhead probe's kernel for Hopper (sm_90a).
//
// probe_copy_kernel replaces scripts/probe_overhead.py:copy_kernel:
//   o[i] = x[i] * 0.999f over a float32 array. One rounded product per
//   element, so it is bit-identical to PyTorch's float32 x * 0.999 (the
//   scalar is rounded to float32 first, as here).
//
// What bounds it: bytes, 8 per element. At the probe's shapes (0.15 MB and
// 2.3 MB) a launch's latency is larger than the transfer, so the design
// keeps the grid small and every access wide:
// - each thread moves a fixed 4 * VEC = 8 elements, VEC = 2 16-byte float4
//   loads issued before either store, and no grid-stride loop: the grid is
//   sized from n, in small blocks of 64 threads (2.3 MB is 1,125 blocks,
//   all resident at once and spread evenly over the 132 SMs; 288 blocks
//   of 256 threads left SMs with 2 or 3 and read slower);
// - the body is read through the read-only path (__ldg, ld.global.nc) and
//   written with streaming stores (__stcs): the data is touched once;
// - a block's float4s are neighbours across its threads (thread t takes
//   float4 t and t + 64 of the block's 128), so each warp reads 512
//   contiguous bytes per instruction;
// - where x and o share their alignment mod 16 bytes, a scalar head of up
//   to 3 elements brings both to 16 bytes and a scalar tail of up to 3
//   ends the body; where they do not (an offset view against a fresh
//   output), the same grid moves the 8 elements with scalar accesses,
//   still neighbours across threads.
// chip_smoke.py's probe phase times it beside torch.mul, eager and
// replayed from a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 64;
constexpr int VEC = 2;  // float4s per thread
constexpr long long BLOCK_ELEMS = (long long)THREADS * VEC * 4;
constexpr float SCALE = 0.999f;

__device__ __forceinline__ float4 ld4(const float4* p) { return __ldg(p); }
__device__ __forceinline__ void st4(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ void st1(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ float4 scale4(float4 v) {
  return make_float4(v.x * SCALE, v.y * SCALE, v.z * SCALE, v.w * SCALE);
}

// x and o aligned alike: `head` scalars, `body` float4s, then the tail.
__global__ void __launch_bounds__(THREADS)
probe_copy_vec(const float* __restrict__ x, float* __restrict__ o, long long n,
               int head, long long body) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long tail_start = head + 4 * body;
  if (t < head) st1(o + t, ld1(x + t) * SCALE);
  if (t < n - tail_start) st1(o + tail_start + t, ld1(x + tail_start + t) * SCALE);
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(o + head);
  const long long base = (long long)blockIdx.x * (VEC * THREADS) + threadIdx.x;
  float4 v[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (base + k * THREADS < body) v[k] = ld4(xv + base + k * THREADS);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (base + k * THREADS < body) st4(ov + base + k * THREADS, scale4(v[k]));
}

// x and o aligned differently: 4 * VEC scalars per thread.
__global__ void __launch_bounds__(THREADS)
probe_copy_scalar(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long base = (long long)blockIdx.x * BLOCK_ELEMS + threadIdx.x;
  float v[4 * VEC];
#pragma unroll
  for (int k = 0; k < 4 * VEC; ++k)
    if (base + k * THREADS < n) v[k] = ld1(x + base + k * THREADS);
#pragma unroll
  for (int k = 0; k < 4 * VEC; ++k)
    if (base + k * THREADS < n) st1(o + base + k * THREADS, v[k] * SCALE);
}

}  // namespace

// x, o [n] float32, any 4-byte alignment.
extern "C" int probe_copy_launch(const float* x, float* o, long long n,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(o);
  if ((xa & 15) == (oa & 15) && (xa & 3) == 0) {
    long long head = (long long)((16 - (xa & 15)) & 15) / 4;
    if (head > n) head = n;
    const long long body = (n - head) / 4;
    probe_copy_vec<<<(unsigned)blocks, THREADS, 0, s>>>(x, o, n, (int)head, body);
  } else {
    probe_copy_scalar<<<(unsigned)blocks, THREADS, 0, s>>>(x, o, n);
  }
  return (int)cudaGetLastError();
}
