// Fused 3-D MTTKRP for Hopper (sm_90a) at the "highest" tier, CUDA C++ on
// the CUDA cores.
//
// Replaces the TPU kernel cp_cals_tpu/ops/pallas_mttkrp.py:_mttkrp_kernel at
// precision "highest" (strict fp32: no TF32, so the tensor cores have no
// path for it). The bf16 tiers run on the tensor cores, csrc/fused_mttkrp_tc.cu.
//
// Computes, for every model b and rank column r (packed column c = b*R + r):
//
//     G[b, n, r] = sum_j U1[b, j, r] * (sum_k X[j, k, n] * U2[b, k, r])
//
// w_j = sum_k X U2 is complete in fp32 before it is scaled by the U1 row, as
// in the TPU kernel. X is the solve's held layout [J, K, I] (J = small other
// mode, K = big other mode, I = target mode; i contiguous, each row padded
// to Ip, a multiple of 4 floats, so every row starts 16-byte aligned).
// U1 [B, J, R] and U2 [B, K, R] are the engine's factors, and G is written
// straight into [B, I, R], or into a workspace [S, I, B*R] when the work is
// split S ways.
//
// What bounds it: operations at the fp32 rate of the CUDA cores.
// 2*J*I*K*B*R operations against 4*J*I*K bytes of X, about B*R/2
// operations per byte at the engine's B*R of 384-768: far above the card's
// balance, so the FFMA pipes set the bound. The design keeps them fed:
// - The block's U2 column slice [kspan, 128] stays in shared memory for all
//   of its j (152 KB at K = 301). It is gathered once, during the block's
//   first round of j, one 16-k piece per ring stage by cp.async (16-byte
//   copies where R is a multiple of 4), so the gather overlaps the first
//   FFMAs. A U2 range too long for shared memory is split across blocks
//   (grid z), each holding its own k range.
// - Only X streams, through a ring of 4 shared-memory stages of 16 k x TM
//   rows per group, each filled by one TMA copy per group that thread 0
//   issues; the copies complete on the stage's mbarrier and land as the
//   dense [16][TM] the FFMA loop reads (the held [J, K, Ip] puts i
//   innermost). Per-thread copies of X took FFMA issue slots; TMA takes
//   none. One block barrier per stage frees the slot for the copy 3 stages
//   ahead.
// - Each thread holds its RM x RN tile of w and of the output accumulator
//   in registers (8 x 8, or 16 x 4 for the short mode) and reads its
//   operands from shared memory as 128-bit loads that the warp's
//   quarter-warps share (X) or that form conflict-free 128-byte runs (U2).
// - Several groups of threads share the block's U2 slice, each on its own j
//   in turn, and their sums are added in group order at the end. So the
//   block has a multiple of 4 warps (the SM's four schedulers get equal
//   shares) while the row tile stays short: 64 rows for I = 299/301 (320
//   padded rows), 48 for I = 41.
// - The output tiles alone cannot fill the card's SMs, so j is also split
//   across blocks (grid z) into as many ranges as keep the grid within one
//   wave (one block per SM: the U2 slice fills shared memory). The
//   workspace is summed by reduce_splits in split order: no atomics, and
//   the result does not depend on scheduling.
// - Whole rounds of j per block would waste a round's share of the card
//   wherever the j ranges are not a multiple of the groups (41 j over 132
//   SMs): where a block's last round has fewer j than groups and their
//   count divides the groups, the groups of each j split its k stages and
//   add their w in part order before the U1 scaling (the split round), so
//   w_j is still complete in fp32 before it is scaled. The planner picks
//   the j ranges with the fewest rounds.
//
// PERF.md gives its times against this bound.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mttkrp_common.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int TN = 128;     // packed (model, rank) columns per block
constexpr int TK = 16;      // k per ring stage
constexpr int STAGES = 4;   // depth of the X ring

// Threads of one tile shape: NG groups, each of TM / RM row groups x
// TN / RN column groups. A thread's RM rows are contiguous; its RN columns
// are RN / 4 runs of 4, TN / (RN / 4) apart. A quarter-warp spans 8
// neighbouring column groups of one row group.
template <int TM, int RM, int RN, int NG>
struct Tile {
  static constexpr int NTY = TM / RM;
  static constexpr int NTX = TN / RN;
  static constexpr int GT = NTY * NTX;        // threads of a group
  static constexpr int NT = NG * GT;
  static constexpr int WX = NTX < 32 ? NTX : 32;
  static constexpr int WY = 32 / WX;
  static constexpr int CSTEP = TN * 4 / RN;   // columns between a thread's runs of 4
  static constexpr int XSTAGE = NG * TK * TM; // floats of one ring stage
  static_assert(TM % 4 == 0 && RM % 4 == 0 && RN % 4 == 0 && NTY % WY == 0 && GT % 32 == 0,
                "tile");
};

// U2 slice and X ring (fp32), or the groups' sums where larger, then one
// "full" mbarrier per ring stage (exported as fused_mttkrp_fp32_smem).
__host__ __device__ constexpr long long smem_bytes(int tm, int ng, int kspan) {
  const long long main = (long long)kspan * TN + (long long)STAGES * ng * TK * tm;
  const long long red = (long long)ng * tm * TN;  // the groups' sums
  return (main > red ? main : red) * 4 + 8 * STAGES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies into shared memory; with valid == false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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

// One TMA copy of the box at (i, k, j) of the held X into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int i, int k, int j) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(i), "r"(k), "r"(j)
      : "memory");
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// One block: rows [i0, i0 + TM), columns [c0, c0 + TN), k range ks of
// kspan, j range js of jchunk (blockIdx.z = ks * jsplits + js). The groups
// take the block's j in rounds, group g the round's j g. Where the last
// round has r < NG j and r divides NG (the split round), the NG / r groups
// of each of its j take one part each of its k stages, and their sums of w
// are added in part order before the U1 scaling, so that a block's j count
// need not be a multiple of NG.
template <int TM, int RM, int RN, int NG>
__global__ void __launch_bounds__(Tile<TM, RM, RN, NG>::NT, 1)
mttkrp_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ u1,
              const float* __restrict__ u2, float* __restrict__ dst, int J, int I, int K, int R,
              int C, int kspan, int jsplits, int jchunk, int to_bir, int u2_vec,
              const int* __restrict__ pred) {
  if (pred != nullptr && *pred == 0) return;  // a predicated launch that is off: no work, no writes
  using T = Tile<TM, RM, RN, NG>;
  extern __shared__ __align__(128) float smem[];
  float* us = smem;                           // [kspan][TN]   U2 column slice
  float* xs = smem + (size_t)kspan * TN;      // [STAGES][NG][TK][TM]  X ring
  const uint32_t full = smem_u32(smem) + (uint32_t)(smem_bytes(TM, NG, kspan) - 8 * STAGES);

  const int tid = threadIdx.x;
  const int grp = tid / T::GT, gtid = tid % T::GT;
  const int warp = gtid / 32, lane = gtid % 32;
  const int ty = (warp % (T::NTY / T::WY)) * T::WY + lane / T::WX;
  const int tx = (warp / (T::NTY / T::WY)) * T::WX + lane % T::WX;
  const int c0 = blockIdx.x * TN, i0 = blockIdx.y * TM;
  const int ks = blockIdx.z / jsplits, js = blockIdx.z % jsplits;
  const int k_begin = ks * kspan, k_end = min(K, k_begin + kspan);
  const int j_begin = js * jchunk, j_end = min(J, j_begin + jchunk);
  const int nk = (k_end - k_begin + TK - 1) / TK;  // stages per j
  // Whole rounds of nk stages, then the split round of h stages, if any
  // (ops/fused_mttkrp.py: fp32_rounds).
  const int nj = j_end - j_begin, rem = nj % NG;
  const int parts = rem > 0 && NG % rem == 0 ? NG / rem : 1;
  const int rounds = parts > 1 ? nj / NG : (nj + NG - 1) / NG;
  const int h = (nk + parts - 1) / parts;
  const int whole = rounds * nk;
  const int total = whole + (parts > 1 ? h : 0);
  const int first = rounds > 0 ? nk : h;  // stages of the block's first round


  // The U2 gather. With u2_vec (R a multiple of 4 and U2 16-byte aligned:
  // every run of 4 columns is one model's, contiguous) each thread copies
  // the 16-byte run un4 of the slice, rows tid / 32, tid / 32 + NT / 32, ...
  // of each stage; else the first UG threads copy column un, rows tid / TN,
  // tid / TN + UG / TN, ... Either way the thread's source offset in
  // [B, K, R] is fixed, so it is computed once.
  constexpr int UG = (T::NT / TN) * TN;
  const int un = u2_vec ? 4 * (tid % 32) : tid % TN;
  const bool u_ok = (u2_vec || tid < UG) && c0 + un < C;
  const size_t u_off = u_ok ? (size_t)((c0 + un) / R) * K * R + (c0 + un) % R : 0;
  auto gather = [&](int kc) {  // the slice's rows of k stage kc
    const int k0 = k_begin + kc * TK;
    if (u2_vec) {
      for (int kk = tid / 32; kk < TK; kk += T::NT / 32) {
        const int k = k0 + kk;
        const bool ok = u_ok && k < k_end;
        cp_async16(us + (size_t)(kc * TK + kk) * TN + un, ok ? u2 + u_off + (size_t)k * R : u2, ok);
      }
    } else if (tid < UG) {
      for (int kk = tid / TN; kk < TK; kk += UG / TN) {
        const int k = k0 + kk;
        const bool ok = u_ok && k < k_end;
        cp_async4(us + (size_t)(kc * TK + kk) * TN + un, ok ? u2 + u_off + (size_t)k * R : u2, ok);
      }
    }
  };

  // Stage t holds, for each group g, X[j, k0 .. k0 + TK, i0 .. i0 + TM] at
  // g's j and k stage kc: one TMA box per group, issued by thread 0,
  // completing on the stage's full barrier (rows past Ip and k past K
  // arrive as zeros; a group past j_end copies the block's last j, which
  // its zero U1 row cancels; a k stage past nk, where the split round's
  // last part is shorter, gets a box of zeros). The stages of the block's
  // first round also bring the U2 slice's rows of the k stages they hold,
  // by cp.async, one commit group per stage. load is called for t = 0, 1,
  // ... in turn, so thread 0 steps the round's first j and k stage.
  int lj = j_begin - NG, lkc = -1;
  auto load = [&](int t) {
    if (t < total) {
      if (tid == 0) {
        const uint32_t bar = full + 8 * (t % STAGES);
        const uint32_t xst = smem_u32(xs + (t % STAGES) * T::XSTAGE);
        mbar_expect(bar, T::XSTAGE * 4);
        if (t < whole) {
          if (++lkc == nk) lkc = 0;
          if (lkc == 0) lj += NG;
        }
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          int j = lj + g, kc = lkc;
          if (t >= whole) {
            j = j_begin + rounds * NG + g / parts;
            kc = (g % parts) * h + (t - whole);
          }
          tma_load(xst + g * TK * TM * 4, &xmap, bar, i0, kc < nk ? k_begin + kc * TK : K,
                   min(j, j_end - 1));
        }
      }
      if (t < first) {
        if (rounds > 0) {
          gather(t);
        } else {
          for (int q = 0; q < parts; ++q)
            if (q * h + t < nk) gather(q * h + t);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float w[RM][RN], acc[RM][RN], u1v[RN];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int n = 0; n < RN; ++n) w[m][n] = acc[m][n] = 0.f;
#pragma unroll
  for (int n = 0; n < RN; ++n) u1v[n] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  int j = j_begin + grp - NG, kc = -1;  // this group's j and k stage, before stage 0
  for (int t = 0; t < total; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's U2 copies of stage t have landed
    __syncthreads();              // everyone's have; and stage t - 1's slot is free
    load(t + STAGES - 1);
    mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);  // X of stage t has landed
    // This group's j and k stage (uniform over its warps), stepped from the
    // last stage's.
    if (t < whole) {
      if (++kc == nk) kc = 0;
      if (kc == 0) j += NG;
    } else if (t == whole) {
      j = j_begin + rounds * NG + grp / parts;
      kc = (grp % parts) * h;
    } else {
      ++kc;
    }
    if (kc == 0 || t == whole) {  // a new j: its U1 row, applied once w_j is complete
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int c = c0 + (n / 4) * T::CSTEP + tx * 4 + n % 4;
        u1v[n] = (c < C && j < j_end) ? u1[((size_t)(c / R) * J + j) * R + (c % R)] : 0.f;
      }
    }
    // A k stage past nk holds zeros of X; its U2 rows are the last stage's.
    const float* xst = xs + (t % STAGES) * T::XSTAGE + grp * TK * TM + ty * RM;
    const float* ust = us + (size_t)min(kc, nk - 1) * TK * TN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int m = 0; m < RM; m += 4) load4(a + m, xst + kk * TM + m);
#pragma unroll
      for (int n = 0; n < RN; n += 4) load4(b + n, ust + kk * TN + (n / 4) * T::CSTEP);
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int n = 0; n < RN; ++n) w[m][n] = fmaf(a[m], b[n], w[m][n]);
    }
    if (t < whole && kc == nk - 1) {
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          acc[m][n] = fmaf(w[m][n], u1v[n], acc[m][n]);
          w[m][n] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and U2 slice are done with

  // The split round: the parts after the first leave their w in shared
  // memory; the first part's group adds them in part order, then applies
  // its j's U1 row.
  float* red = smem;  // [NG][TM][TN]
  const auto at = [&](int g, int m, int n) {
    return ((size_t)g * TM + ty * RM + m) * TN + (n / 4) * T::CSTEP + tx * 4 + n % 4;
  };
  if (parts > 1) {
    if (grp % parts != 0) {
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int n = 0; n < RN; ++n) red[at(grp, m, n)] = w[m][n];
    }
    __syncthreads();
    if (grp % parts == 0) {
      for (int q = 1; q < parts; ++q)
#pragma unroll
        for (int m = 0; m < RM; ++m)
#pragma unroll
          for (int n = 0; n < RN; ++n) w[m][n] += red[at(grp + q, m, n)];
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int n = 0; n < RN; ++n) acc[m][n] = fmaf(w[m][n], u1v[n], acc[m][n]);
    }
    __syncthreads();
  }

  // The groups' sums, added in group order, to G[b, i, r] directly
  // (to_bir) or to the workspace [S, I, C].
  float* out = to_bir ? dst : dst + (size_t)blockIdx.z * I * C;
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int n = 0; n < RN; ++n) red[at(grp, m, n)] = acc[m][n];
  __syncthreads();
  for (int e = tid; e < TM * TN; e += T::NT) {
    const int i = i0 + e / TN, c = c0 + e % TN;
    if (i >= I || c >= C) continue;
    float v = red[e];
#pragma unroll
    for (int g = 1; g < NG; ++g) v += red[(size_t)g * TM * TN + e];
    out[to_bir ? (size_t)(c / R) * I * R + (size_t)i * R + (c % R) : (size_t)i * C + c] = v;
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

// The tensor map of the held X as [J][K][Ip] fp32: boxes of tm rows x TK k
// x 1, no swizzle (the stage is the dense [TK][tm] the FFMA loop reads),
// zeros outside.
int x_map(CUtensorMap* map, const float* x, int J, int K, int Ip, int tm) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)Ip, (cuuint64_t)K, (cuuint64_t)J};
  const cuuint64_t strides[2] = {(cuuint64_t)Ip * 4, (cuuint64_t)K * Ip * 4};
  const cuuint32_t box[3] = {(cuuint32_t)tm, TK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int TM, int RM, int RN, int NG>
int launch(const float* x, const float* u1, const float* u2, float* dst, int J, int I, int Ip,
           int K, int R, int C, int kspan, int splits, int jsplits, int jchunk, int to_bir,
           const int* pred, cudaStream_t s) {
  CUtensorMap map = {};
  if (J > 0 && K > 0) {
    const int code = x_map(&map, x, J, K, Ip, TM);
    if (code != 0) return code;
  }
  auto kernel = mttkrp_kernel<TM, RM, RN, NG>;
  const size_t smem = (size_t)smem_bytes(TM, NG, kspan);
  static std::atomic<size_t> smem_set[MAX_DEVICES];  // per device: the largest size allowed so far
  const int e = allow_smem((const void*)kernel, smem, smem_set);
  if (e != 0) return e;
  dim3 grid((C + TN - 1) / TN, (I + TM - 1) / TM, splits);
  const int u2_vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(u2) % 16 == 0;
  kernel<<<grid, Tile<TM, RM, RN, NG>::NT, smem, s>>>(map, u1, u2, dst, J, I, K, R, C, kspan,
                                                      jsplits, jchunk, to_bir, u2_vec, pred);
  return 0;
}

// The tile shapes, by id: (rows, rows per thread, columns per thread,
// groups). 0: 64 rows, 8 x 8 per thread, 2 groups (8 warps) for the long
// modes (I = 299/301: 320 padded rows); 1: 48 rows, 16 x 4 per thread (a
// warp spans one row group, so its X operand is one broadcast), 4 groups
// (12 warps) for the short mode (I = 41). Both keep the warps a multiple of
// 4, one share for each of the SM's four schedulers.
#define FP32_TILES(X) X(0, 64, 8, 8, 2) X(1, 48, 16, 4, 4)

}  // namespace

// The tile shape `id` as (rows, rows per thread, columns per thread, j
// groups) in shape[0..3]; returns 0, or -1 for an unknown id.
extern "C" int fused_mttkrp_fp32_tile(int id, int* shape) {
#define TILE_CASE(tid, tm, rm, rn, ng) \
  if (id == tid) {                     \
    shape[0] = tm;                     \
    shape[1] = rm;                     \
    shape[2] = rn;                     \
    shape[3] = ng;                     \
    return 0;                          \
  }
  FP32_TILES(TILE_CASE)
#undef TILE_CASE
  return -1;
}

// Shared memory one block of tile `id` needs holding kspan k of U2, in
// bytes, or -1 for an unknown id: the wrapper picks the k split that fits.
extern "C" long long fused_mttkrp_fp32_smem(int id, int kspan) {
  int shape[4];
  if (fused_mttkrp_fp32_tile(id, shape) != 0) return -1;
  return smem_bytes(shape[0], shape[3], kspan);
}

// x: the held layout fp32 [J, K, I] with row stride Ip (a multiple of 4),
// 16-byte aligned; u1 [B, J, R], u2 [B, K, R] -> out [B, I, R], fp32,
// contiguous. tile is the tile shape (FP32_TILES); each block takes kspan k
// (a multiple of 16) of ksplits ranges and jchunk j of jsplits ranges. More
// than one split in all needs work [ksplits * jsplits, I, B*R]. pred is
// null, or a device int: where it holds 0 every block of both launches
// returns at once and nothing is written. Returns cudaGetLastError() after
// the launches, or the error that kept them from launching.
extern "C" int fused_mttkrp_launch(const float* x, const float* u1, const float* u2, float* out,
                                   float* work, int J, int I, int Ip, int K, int B, int R,
                                   int tile, int kspan, int ksplits, int jsplits, int jchunk,
                                   const int* pred, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = B * R;
  const int splits = ksplits * jsplits;
  const int to_bir = splits == 1;
  float* dst = to_bir ? out : work;
  int code = (int)cudaErrorInvalidValue;
#define LAUNCH_CASE(id, tm, rm, rn, ng)                                                         \
  if (tile == id)                                                                            \
    code = launch<tm, rm, rn, ng>(x, u1, u2, dst, J, I, Ip, K, R, C, kspan, splits, jsplits, \
                                  jchunk, to_bir, pred, s);
  FP32_TILES(LAUNCH_CASE)
#undef LAUNCH_CASE
  if (code != 0) return code;
  if (!to_bir) launch_reduce_splits(work, out, splits, I, R, C, pred, s);
  return (int)cudaGetLastError();
}
