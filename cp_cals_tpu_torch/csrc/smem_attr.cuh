// Dynamic shared memory above the default 48 KB, shared by the kernel sources.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int MAX_DEVICES = 64;

// The current device, or -1 where it cannot be read or is past MAX_DEVICES
// (then nothing is cached for it).
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev < MAX_DEVICES ? dev : -1;
}

// Allows `fn` `bytes` of dynamic shared memory on the current device. The
// attribute is set per device, so `done` (a static array of the caller's,
// one slot per device) keeps the largest size set so far on each. Host
// threads launch at once (the engine's bucket threads): a size is stored
// (release) only after its attribute is set, and read (acquire) before a
// launch skips the set, so no launch starts before its size is allowed;
// the sets themselves take one lock, so a smaller size never overwrites a
// larger one.
inline int allow_smem(const void* fn, size_t bytes, std::atomic<size_t>* done) {
  if (bytes <= 48 * 1024) return 0;
  const int dev = current_device();
  if (dev >= 0 && bytes <= done[dev].load(std::memory_order_acquire)) return 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  if (dev >= 0 && bytes <= done[dev].load(std::memory_order_relaxed)) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev >= 0) done[dev].store(bytes, std::memory_order_release);
  return (int)e;
}

}  // namespace
