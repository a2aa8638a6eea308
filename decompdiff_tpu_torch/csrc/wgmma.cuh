// Hopper warpgroup matrix multiply (wgmma, sm_90a) for the triplet forward
// (triplet_attention.cu): bf16 or fp16 inputs, float32 accumulation, A from
// registers, B from shared memory.
//
// A warpgroup is four consecutive warps (128 threads) that issue one
// asynchronous product of a 64-row tile together. Register layouts, per
// warp w of the group and lane = 4 g + t:
//   * the accumulator D of m64nNk16 (N / 2 floats): d[4 j + 2 r + e] is
//     row 16 w + g + 8 r, column 8 j + 2 t + e (j < N / 8, r, e in {0, 1});
//   * the A fragment of a 16-column slice s (four registers of two 16-bit
//     values): a[u] holds row 16 w + g + 8 (u & 1), columns
//     16 s + 8 (u >> 1) + 2 t and + 1, the first in the low half.
// So the accumulator floats d[8 s .. 8 s + 7], packed pairwise in order, are
// the A fragment of slice s: a product's output feeds the next product from
// registers.
//
// B (K x N) is K-major without swizzle: core matrices of 8 rows (n) x 8
// 16-bit values (k), 128 contiguous bytes each; the core matrix
// (n / 8, k / 8) of a K-deep operand sits at (n / 8) K * 16 + (k / 8) * 128
// bytes (b_offset), so a 16-deep slice s starts 256 s bytes on, with the two
// cores along k LBO = 128 bytes apart and the cores along n SBO = K * 16
// apart.
//
// Ordering (PTX ISA, wgmma): B written by the threads' own stores needs
// fence_smem() and a barrier before a product reads it; fence() goes before
// the first product of a batch whose accumulator or A registers other
// instructions wrote; commit() closes a batch; wait<n>() returns when at
// most n batches are in flight. Between a product and the wait that covers
// it, neither its accumulator nor its A registers may be touched;
// fence_regs after the wait keeps the compiler from moving reads of the
// accumulator above it, or reusing the A registers before it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace wgmma {

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Makes this thread's shared-memory stores visible to wgmma's reads of B
// (the async proxy); then a barrier, before the first product that reads
// them.
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Offset, in 16-bit values, of B element (k, n) of a K-deep operand.
__host__ __device__ constexpr int b_offset(int k, int n, int K) {
  return ((n >> 3) * (K >> 3) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7);
}

// The descriptor of a K-deep B operand at p (shared memory, 16-byte
// aligned), slice 0; slice s is desc + 16 s (256 bytes, in 16-byte units).
__device__ __forceinline__ uint64_t b_desc(const void* p, int K) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((K * 16) >> 4) << 32);
}

// bf16x2 or half2 of (x, y), x in the low half, as a register.
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(__half2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator operands of a product (d[i .. i + 7], ...) and their
// names in its template.
#define WGMMA_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D16(i) WGMMA_D8(i), WGMMA_D8(i + 8)
#define WGMMA_D32(i) WGMMA_D16(i), WGMMA_D16(i + 16)
#define WGMMA_D64 WGMMA_D32(0), WGMMA_D32(32)
#define WGMMA_R16                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7,"                                    \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define WGMMA_R32                                                      \
  WGMMA_R16 ","                                                        \
  "%16, %17, %18, %19, %20, %21, %22, %23,"                            \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R64                                                      \
  WGMMA_R32 ","                                                        \
  "%32, %33, %34, %35, %36, %37, %38, %39,"                            \
  "%40, %41, %42, %43, %44, %45, %46, %47,"                            \
  "%48, %49, %50, %51, %52, %53, %54, %55,"                            \
  "%56, %57, %58, %59, %60, %61, %62, %63"
// One m64nNk16 product of input type T ("bf16" or "f16"): R the names of
// the accumulator operands (the variadic arguments), A those of a0..a3 and
// b, P that of accumulate.
#define WGMMA_RS(N, T, R, A, P, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." T     \
               "." T " {" R "}, " A ", p, 1, 1, 0;\n}\n"                \
               : __VA_ARGS__                                           \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b),           \
                 "r"(accumulate))

// d (+)= A (64 x 16, registers a0..a3) B (16 x N, descriptor b), bf16
// inputs (F16: fp16); accumulate 0 overwrites d.
template <int N, bool F16 = false>
struct Mma {
  static __device__ __forceinline__ void rs(float (&d)[N / 2], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b,
                                            int accumulate) {
    static_assert(N == 32 || N == 64 || N == 128, "N: 32, 64 or 128");
#define WGMMA_N(N, R, A, P, ...)               \
  if constexpr (F16)                           \
    WGMMA_RS(N, "f16", R, A, P, __VA_ARGS__);  \
  else                                         \
    WGMMA_RS(N, "bf16", R, A, P, __VA_ARGS__)
    if constexpr (N == 32) {
      WGMMA_N(32, WGMMA_R16, "{%16, %17, %18, %19}, %20", "%21",
              WGMMA_D16(0));
    } else if constexpr (N == 64) {
      WGMMA_N(64, WGMMA_R32, "{%32, %33, %34, %35}, %36", "%37",
              WGMMA_D32(0));
    } else {
      WGMMA_N(128, WGMMA_R64, "{%64, %65, %66, %67}, %68", "%69",
              WGMMA_D64);
    }
#undef WGMMA_N
  }
};

#undef WGMMA_RS
#undef WGMMA_R64
#undef WGMMA_R32
#undef WGMMA_R16
#undef WGMMA_D64
#undef WGMMA_D32
#undef WGMMA_D16
#undef WGMMA_D8

}  // namespace wgmma
