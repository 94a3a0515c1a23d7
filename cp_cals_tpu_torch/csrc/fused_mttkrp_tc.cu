// Fused 3-D MTTKRP for Hopper (sm_90a) at the bf16 tiers, on the tensor cores.
//
// Replaces the TPU kernel cp_cals_tpu/ops/pallas_mttkrp.py:_mttkrp_kernel at
// precision "default" and "high" ("highest" is strict fp32 and stays on the
// CUDA cores, csrc/fused_mttkrp.cu). For every model b and rank column r
// (packed column c = b*R + r):
//
//     G[b, n, r] = sum_j U1[b, j, r] * (sum_k bf16(X[j, n, k]) * bf16(U2[b, k, r]))
//
// with exact bf16 products and fp32 sums. At "high" the inner sum is
// xh*uh + xh*ul + xl*uh (the bf16 hi/lo split, xl*ul dropped): each product
// sums over k in its own accumulator, and the three are added in that order
// at the end of each j, as the TPU kernel's three dots are. w_j = X_j U2 is
// formed in fp32 and then scaled by the unrounded U1 row, as the TPU kernel
// does.
//
// Inputs: X is the solve's held layout, bf16 [P, J, I, Kp] (P = 1 plane at
// "default", hi and lo at "high"; Kp = K padded with zeros to a multiple of
// 8, so every row is 16-byte aligned), rounded once per solve. U1 [B, J, R]
// and U2 [B, K, R] are the engine's fp32 factors; G is written straight into
// [B, I, R], or into a workspace [S, I, B*R] when the work is split S ways
// (j, and k where U2 is too long to hold).
//
// What bounds it: operations at the bf16 tensor-core rate. One call does
// 2*J*I*K*B*R operations (three times that at "high") against 2*P bytes per
// element of the held X, about B*R/P operations per byte at the engine's
// B*R of 384-2560: above the card's balance of ~295 operations per byte, so
// the tensor cores, and only wgmma reaches their rate, set the bound.
//
// The design, per block (a 64-row x NC-column output tile and a range of j;
// two consumer warpgroups, each on NC/2 of the columns, and one producer
// warp):
// - The block's U2 column slice [Kp, NC] is gathered from [B, K, R] with
//   plain loads (R may be 1, so no 16-byte copy fits it), rounded to bf16
//   (hi and lo at "high") and stored ONCE in shared memory, where it stays
//   for every j of the block. No launch packs U2 beforehand.
// - Only X streams, through a ring of shared-memory stages of 64 rows x 64
//   k per plane. The producer warp fills each stage with one TMA copy per
//   plane (a tensor map over the held X, 128-byte swizzle; rows past I and
//   k past Kp arrive as zeros) once the stage's "empty" mbarrier says both
//   warpgroups are done with it; the copies complete on the stage's "full"
//   mbarrier. With the last stage of each j it also stores the U1 row of
//   that j, loaded when it starts the j. No block-wide barrier runs in the
//   loop.
// - Each consumer warpgroup waits on "full", runs wgmma.mma_async m64nNk16
//   (N = NC/2; bf16 x bf16 -> fp32) with A = the X stage and B = its rows
//   of the resident U2 slice, both K-major in the 128-byte swizzle, and
//   releases a stage once wgmma.wait_group shows it read. After each j's
//   last stage: acc += W * U1[j, col] in registers, from each thread's own
//   accumulator columns.
// - When the output tiles alone cannot fill the card, j is split across
//   blocks (grid z) into the workspace, which reduce_splits sums in a fixed
//   split order: the result does not depend on scheduling.
// - When the whole U2 slice does not fit in shared memory (K beyond a few
//   thousand), k is split across blocks too, each holding the slice of its
//   own k range: every block of a j range then adds W's part over its k,
//   scaled by U1, into its own workspace slice. The TPU kernel sends such
//   modes to the twostep instead; the sums differ only in fp32 order.
//
// PERF.md gives its times against this bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mttkrp_common.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int TM = 64;              // rows of the target mode per block (wgmma M)
constexpr int KS = 64;              // k per ring stage: one 128-byte swizzled row
constexpr int WGS = 2;              // consumer warpgroups, each on half of the block's columns
constexpr int NCONS = 128 * WGS;    // consumer threads
constexpr int NT = NCONS + 32;      // and one producer warp
constexpr int XSTAGE = TM * KS;     // bf16 elements of one plane of one stage

// Ring depth: what fits beside one block's resident U2 slice (hi and lo at
// "high") at the engine's K of about 300.
__host__ __device__ constexpr int stages(bool high) { return high ? 4 : 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Makes this thread's shared-memory writes visible to wgmma's operand reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Barrier 1 among the consumer warpgroups only (the producer warp runs on).
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
}
// Arms the barrier for one phase that completes when `bytes` have landed.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One TMA copy of the box at (k, row, plane-and-j) of the held X into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(z)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulator registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 64 bf16 (128 bytes) at a 128-byte stride, 8-row atoms of
// 1024 bytes (SBO), 1024-byte aligned; a k-step of 16 advances the start by
// 32 bytes inside the atom. LBO is unused in this layout (1 by convention).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Byte offset of the 16-byte chunk g (k = 8g .. 8g+7) of row m in a
// 128-byte-swizzled tile (the layout TMA's 128-byte swizzle writes): the
// chunk index is XORed with m % 8.
__device__ __forceinline__ uint32_t swz(int m, int g) { return m * 128 + ((g ^ (m & 7)) << 4); }

// D[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, fp32 accumulate; both
// operands K-major (no transpose). scale_d == 0 ignores D's old value.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

__host__ __device__ constexpr int round16(int k) { return (k + 15) & ~15; }
__host__ __device__ constexpr int round64(int k) { return (k + 63) & ~63; }

// Dynamic shared memory of one block holding kspan k of U2: resident U2, X
// ring, a U1 row per stage, the ring's full and empty barriers.
__host__ __device__ constexpr size_t smem_bytes(int nc, bool high, int kspan) {
  return (size_t)2 * (high ? 2 : 1) * (nc * (size_t)round64(kspan) + stages(high) * XSTAGE) +
         (size_t)stages(high) * (4 * nc + 16);
}

union Pack8 {
  uint4 v;
  __nv_bfloat16 h[8];
};

template <int NC, bool HIGH>
__global__ void __launch_bounds__(NT, 1)
mttkrp_tc_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ u1,
                 const float* __restrict__ u2, float* __restrict__ dst, int J, int I, int K,
                 int Kp, int R, int C, int kspan, int ksplits, int jchunk, int to_bir,
                 const int* __restrict__ pred) {
  if (pred != nullptr && *pred == 0) return;  // a predicated launch that is off: no work, no writes
  constexpr int P = HIGH ? 2 : 1;
  constexpr int NW = NC / WGS;   // columns of one warpgroup
  constexpr int NREG = NW / 2;   // accumulator floats per thread
  constexpr int STAGES = stages(HIGH);
  extern __shared__ __align__(1024) unsigned char smem[];
  const int K16 = round16(Kp), K64 = round64(Kp);
  // [P][kspan / 64][NC rows of 64 k] U2, [STAGES][P][TM rows of 64 k] X, both
  // 128-byte swizzled; [STAGES][NC] U1 rows (the stage of a j's last k
  // chunk carries U1[j]); then per stage a "full" mbarrier (the stage
  // landed) and an "empty" one (every warpgroup is done with it).
  const uint32_t u2_base = smem_addr(smem);
  const uint32_t xs_base = u2_base + 2 * P * NC * kspan;
  float* u1s = reinterpret_cast<float*>(smem + 2 * P * NC * kspan + 2 * STAGES * P * XSTAGE);
  const uint32_t full_base = smem_addr(u1s + STAGES * NC);
  const uint32_t empty_base = full_base + 8 * STAGES;
  if (u2_base & 1023) __trap();  // the swizzle atoms need 1024-byte alignment

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * NC;
  const int i0 = blockIdx.y * TM;
  // Split z: j range z / ksplits, k range z % ksplits (k0 .. k0 + kspan).
  const int j0 = (blockIdx.z / ksplits) * jchunk;
  const int k0 = (blockIdx.z % ksplits) * kspan;
  const int nkc = max(0, min(kspan, K64 - k0)) / KS;
  const int nj = nkc ? min(J, j0 + jchunk) - j0 : 0;  // K = 0: G = 0
  const int total = nj * nkc;

  // Ring stage t = (j, k chunk) into slot t % STAGES: one box per plane.
  auto issue = [&](int t) {
    const int jj = t / nkc, kc = t - jj * nkc, slot = t % STAGES;
    const uint32_t bar = full_base + 8 * slot;
    mbar_expect(bar, P * XSTAGE * 2);
#pragma unroll
    for (int p = 0; p < P; ++p)
      tma_load(xs_base + (slot * P + p) * XSTAGE * 2, &xmap, bar, k0 + kc * KS, i0, p * J + j0 + jj);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_base + 8 * s, 1);
      mbar_init(empty_base + 8 * s, WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {  // the producer warp keeps the ring full
    constexpr int UPL = (NC + 31) / 32;  // U1 columns per lane
    const int lane = tid - NCONS;
    for (int jj = 0, t = 0; jj < nj; ++jj) {
      float u1v[UPL];  // U1[j, c0 + lane + 32 m], zero past C; stored with the j's last stage
#pragma unroll
      for (int m = 0; m < UPL; ++m) {
        const int n = lane + 32 * m, c = c0 + n;
        u1v[m] = n < NC && c < C ? u1[(size_t)(c / R) * J * R + (size_t)(j0 + jj) * R + c % R]
                                 : 0.f;
      }
      for (int kc = 0; kc < nkc; ++kc, ++t) {
        const int slot = t % STAGES;
        if (t >= STAGES) mbar_wait(empty_base + 8 * slot, (t / STAGES - 1) & 1);
        if (kc == nkc - 1) {
#pragma unroll
          for (int m = 0; m < UPL; ++m)
            if (lane + 32 * m < NC) u1s[slot * NC + lane + 32 * m] = u1v[m];
          __syncwarp();  // ... ordered before lane 0's arrival on the stage's barrier
        }
        if (lane == 0) issue(t);
      }
    }
    return;
  }

  // The resident U2 slice, while the first X stages are in flight. Item
  // (n, kg) is one 16-byte chunk: U2[k, c0 + n] for the 8 k from k0 + 8 kg,
  // zero past K and past C.
#pragma unroll 4
  for (int item = tid; item < NC * (nkc * KS / 8); item += NCONS) {
    const int n = item % NC, kg = item / NC;
    const int c = c0 + n;
    float v[8];
    if (c < C) {
      const float* col = u2 + (size_t)(c / R) * K * R + c % R;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + kg * 8 + e;
        v[e] = k < K ? col[(size_t)k * R] : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    Pack8 hi, lo;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hi.h[e] = __float2bfloat16_rn(v[e]);
      lo.h[e] = __float2bfloat16_rn(v[e] - __bfloat162float(hi.h[e]));  // exact in fp32
    }
    const uint32_t off = (kg >> 3) * NC * 128 + swz(n, kg & 7);
    *reinterpret_cast<uint4*>(smem + off) = hi.v;
    if constexpr (HIGH) *reinterpret_cast<uint4*>(smem + 2 * NC * kspan + off) = lo.v;
  }
  fence_async_shared();
  sync_consumers();  // U2 is in place

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const uint32_t ub_wg = u2_base + wg * NW * 128;  // this warpgroup's rows of U2

  // W of one j; at "high" one accumulator per product (xh*uh, xh*ul,
  // xl*uh), added in that order at the end of the j.
  constexpr int CH = HIGH ? 3 : 1;
  float acc[NREG], w[CH][NREG];
#pragma unroll
  for (int e = 0; e < NREG; ++e) acc[e] = 0.f;

  // Stages before `upto` have been read by this warpgroup's wgmma: hand
  // them back to the producer, one arrival per warpgroup.
  int released = 0;
  auto release_to = [&](int upto) {
    for (; released < upto; ++released)
      if (tid % 128 == 0) mbar_arrive(empty_base + 8 * (released % STAGES));
  };

  int t = 0;
  for (int jj = 0; jj < nj; ++jj) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {  // no wgmma is in flight here
#pragma unroll
      for (int e = 0; e < NREG; ++e) w[h][e] = 0.f;
      fence_regs<NREG>(w[h]);
    }
    for (int kc = 0; kc < nkc; ++kc, ++t) {
      const int slot = t % STAGES;
      mbar_wait(full_base + 8 * slot, (t / STAGES) & 1);  // stage t landed

      const int steps = min(KS / 16, (K16 - k0 - kc * KS) / 16);
      const uint32_t xa = xs_base + slot * P * XSTAGE * 2;
      const uint32_t ub = ub_wg + kc * NC * 128;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS / 16; ++s) {
        if (s < steps) {
          const uint64_t a_hi = desc(xa + s * 32);
          const uint64_t b_hi = desc(ub + s * 32);
          Wgmma<NW>::mma(w[0], a_hi, b_hi, 1);                              // xh * uh
          if constexpr (HIGH) {
            Wgmma<NW>::mma(w[1], a_hi, desc(ub + 2 * NC * kspan + s * 32), 1);  // xh * ul
            Wgmma<NW>::mma(w[2], desc(xa + XSTAGE * 2 + s * 32), b_hi, 1);    // xl * uh
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has been read
      release_to(t);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < CH; ++h) fence_regs<NREG>(w[h]);
    // acc += W * U1[j, col]: register e holds row 16*warp + lane/4 (+8 for
    // e & 2) and column wg*NW + 8*(e/4) + 2*(lane%4) + (e & 1).
    const float* u1r = u1s + ((t - 1) % STAGES) * NC + wg * NW + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < NREG; ++e) {
      const float we = HIGH ? (w[0][e] + w[1][e]) + w[CH - 1][e] : w[0][e];
      acc[e] = fmaf(we, u1r[8 * (e / 4) + (e & 1)], acc[e]);
    }
    // Every warp of the warpgroup has read the U1 row before its one
    // arrival hands the stage back (barrier 2 + wg, this warpgroup only).
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    release_to(t);  // the j's last stage, U1 row included
  }

  // to_bir: write G[b, i, r] directly; else the workspace [S, I, C].
  float* out = to_bir ? dst : dst + (size_t)blockIdx.z * I * C;
#pragma unroll
  for (int e = 0; e < NREG; ++e) {
    const int i = i0 + 16 * warp + lane / 4 + ((e & 2) ? 8 : 0);
    const int c = c0 + wg * NW + 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
    if (i < I && c < C) {
      const size_t o = to_bir ? (size_t)(c / R) * I * R + (size_t)i * R + (c % R)
                              : (size_t)i * C + c;
      out[o] = acc[e];
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime (no link
// against libcuda); the static's initialisation is thread-safe (C++11), so
// concurrent first launches look it up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    cudaDriverEntryPointQueryResult found;
    void* p = nullptr;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of the held X as [P*J][I][Kp] bf16: boxes of 64 k x 64
// rows x 1, 128-byte swizzle, zeros outside.
int x_map(CUtensorMap* map, const void* x, int planes_j, int I, int Kp) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)I, (cuuint64_t)planes_j};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 2, (cuuint64_t)I * Kp * 2};
  const cuuint32_t box[3] = {KS, TM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NC, bool HIGH>
int launch(const CUtensorMap& map, const float* u1, const float* u2, float* dst, int J, int I,
           int K, int Kp, int R, int C, int kspan, int ksplits, int splits, int jchunk, int to_bir,
           const int* pred, cudaStream_t s) {
  auto kernel = mttkrp_tc_kernel<NC, HIGH>;
  const size_t smem = smem_bytes(NC, HIGH, kspan);
  static std::atomic<size_t> smem_set[MAX_DEVICES];  // per device: the largest size allowed so far
  const int e = allow_smem((const void*)kernel, smem, smem_set);
  if (e != 0) return e;
  dim3 grid((C + NC - 1) / NC, (I + TM - 1) / TM, splits);
  kernel<<<grid, NT, smem, s>>>(map, u1, u2, dst, J, I, K, Kp, R, C, kspan, ksplits, jchunk, to_bir,
                                pred);
  return 0;
}

#define LAUNCH_ARGS map, u1, u2, dst, J, I, K, Kp, R, C, kspan, ksplits, splits, jchunk, to_bir, pred, s
template <bool HIGH>
int launch_nc(int nc, const CUtensorMap& map, const float* u1, const float* u2, float* dst,
              int J, int I, int K, int Kp, int R, int C, int kspan, int ksplits, int splits,
              int jchunk, int to_bir, const int* pred, cudaStream_t s) {
  switch (nc) {
    case 128: return launch<128, HIGH>(LAUNCH_ARGS);
    case 64: return launch<64, HIGH>(LAUNCH_ARGS);
    case 32: return launch<32, HIGH>(LAUNCH_ARGS);
    case 16: return launch<16, HIGH>(LAUNCH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block needs for column tile nc holding kspan k of U2:
// the wrapper picks the tile and the k split that fit the card.
extern "C" long long fused_mttkrp_tc_smem(int nc, int high, int kspan) {
  return (long long)smem_bytes(nc, high != 0, kspan);
}

// x: the held layout bf16 [P, J, I, Kp] (P = 2 when high), u1 [B, J, R],
// u2 [B, K, R] fp32 -> out [B, I, R] fp32; all contiguous, x 16-byte
// aligned. nc is the column tile (128, 64, 32 or 16); each block takes
// kspan k (a multiple of 64) of ksplits ranges, and jchunk j of jsplits
// ranges. More than one split in all needs work [ksplits * jsplits, I, B*R].
// pred is null, or a device int: where it holds 0 every block of both
// launches returns at once and nothing is written. Returns
// cudaGetLastError() after the launches, or the error that kept them from
// launching.
extern "C" int fused_mttkrp_tc_launch(const void* x, const float* u1, const float* u2,
                                      float* out, float* work, int J, int I, int K, int Kp,
                                      int B, int R, int high, int nc, int kspan, int ksplits,
                                      int jsplits, int jchunk, const int* pred, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = B * R;
  const int splits = ksplits * jsplits;
  const int to_bir = splits == 1;
  float* dst = to_bir ? out : work;
  CUtensorMap map = {};
  if (Kp > 0 && J > 0) {
    const int code = x_map(&map, x, (high ? 2 : 1) * J, I, Kp);
    if (code != 0) return code;
  }
  const int code = high ? launch_nc<true>(nc, LAUNCH_ARGS) : launch_nc<false>(nc, LAUNCH_ARGS);
  if (code != 0) return code;
  if (!to_bir) launch_reduce_splits(work, out, splits, I, R, C, pred, s);
  return (int)cudaGetLastError();
}
