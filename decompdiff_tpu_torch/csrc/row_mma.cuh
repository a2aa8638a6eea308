// The tensor-core stage of the edge and bond forward kernels (sm_90a). The
// triplet forward, which ran on it too, has its own pipelined kernel on
// wgmma (triplet_attention.cu, wgmma.cuh).
//
// The forward kernels compute, for every destination row and each of
// its sources, two branches (k and v) of the form
//   pre = (per-pair features) @ w_feat + t_row[row] + t_src[source]
//   y   = relu(LayerNorm(pre) * ln_scale + ln_bias)
//   out = y @ Wo + bo
// then a masked softmax over the sources of the head-grouped q . k and the
// sum of alpha v. Most of the operations are the [H, H] products y @ Wo
// (and, in the bond kernel, the [H, H] w_feat); this header runs them on
// the tensor cores.
//
// Shape of a launch: one block of 512 threads per SM, looping over tiles.
// A tile is TI = 2 destination rows x KC = 32 sources (one per lane of a
// warp): 64 pair rows. For one branch the edge kernel writes the tile's
// `pre` into P ([64][H] float32, row stride H + 4) (the bond kernel takes
// its per-pair [H, H] first linear on the tensor cores as well), then
//   * ln_relu / ln_write: LayerNorm (eps 1e-5), scale, bias, relu, each
//     warp on its four rows at once; y = hi + lo is split into two bf16
//     halves written over the row (hi at its start, lo H + 8 bf16 on);
//   * tile_product: P @ Wo + bo on the tensor cores; the float32 result
//     replaces the tile in P;
//   * chunk_logits: a warp per (row, head), a lane per source: q . k, the
//     chunk's max and exponentials, the running max and sum (online
//     softmax, so any number of sources works, 32 at a time);
//   * chunk_acc_node / chunk_acc_pos: the running sum of alpha v.
// Phases are separated by block barriers. Masking follows the TPU kernels:
// the running max starts at -1e29, masked sources weigh 0 and the final
// sum is clamped at 1e-16, so a row without a valid source gives exactly 0.
//
// The product: mma.sync m16n8k16 with bf16 inputs and float32
// accumulation. Each warp owns a 32 x 32 output tile and a share of the
// reduction (two warps per tile at H = 128, summed in a fixed order), with
// its operands loaded by ldmatrix from padded rows (no bank conflicts).
// wgmma would need 64-row warpgroup tiles over swizzled shared memory and
// asynchronous fences; mma.sync is simpler. Float32
// accuracy: y and Wo are each split into bf16 hi + lo (16 significant bits)
// and the product is taken as hi*hi + hi*lo + lo*hi, so the dropped lo*lo
// term and the rounding of lo leave a relative error near 2^-16 per
// product; against the plain float32 versions at the released shapes the
// outputs (of order one) differ by at most 8.1e-6 (triplet) and 4.8e-6
// (edge) on an H100 (chip_smoke.py). bf16 rather than tf32: the bf16 pair
// of a weight is 4 bytes, so both branches' split Wo (136 KB with padding
// at H = 128) stay in shared memory for the whole launch, bf16 runs at
// twice the tf32 rate, and the triplet's `pallas_bf16` option is exactly
// the single hi*hi pass (SPLIT = false).
//
// What bounds it (per-phase clock64 counts on an H100 in an instrumented
// build): the phases run one after another between barriers, so the tensor
// cores idle while the CUDA cores build `pre` and normalize it, and the
// reverse; the three mma.sync passes are bound by ldmatrix traffic and
// mma.sync issue (about a third of the triplet forward when it ran here),
// and the edge forward's edge-feature product takes about a third of its
// time. The triplet forward left this stage for a wgmma pipeline without
// block barriers (triplet_attention.cu), which runs it in half the time at
// the released shapes: the design to carry to the edge forward next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace rowmma {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 512;          // 16 warps, one block per SM
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;                // sources per tile row: one per lane
constexpr int TI = 2;                 // destination rows per tile
constexpr int TILE = TI * KC;         // pair rows per tile
constexpr int EH = TILE + 1;          // per-head stride of E (no conflicts)

// Row strides: P in floats, Wo in bf16; the lo half of a split P row
// starts lo_off bf16 into the row.
__host__ __device__ constexpr int p_ld(int H) { return H + 4; }
__host__ __device__ constexpr int w_ld(int H) { return H + 8; }
__host__ __device__ constexpr int lo_off(int H) { return H + 8; }

// Widths the kernels take: the pre phase gives each thread TILE * H /
// THREADS rows of one channel, and Wo of both branches must fit in shared
// memory.
__host__ __device__ constexpr bool width_ok(int H) {
  return H == 32 || H == 64 || H == 128;
}

// Bump allocator over the dynamic shared memory, 16-byte aligned; the
// host runs the same sequence to size the launch.
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  }
};

__host__ __device__ inline size_t wo_bytes(int H) {
  return (size_t)H * w_ld(H) * sizeof(bf16);
}
__host__ __device__ inline size_t p_bytes(int H) {
  return (size_t)TILE * p_ld(H) * sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Wo [H][H] float32 in device memory -> hi (and, if lo is not null, lo)
// [H][w_ld(H)] bf16 in shared memory, Wo = hi + lo. No barrier.
template <int H>
__device__ __forceinline__ void stage_wo(const float* __restrict__ wo,
                                         bf16* hi, bf16* lo) {
  for (int e = threadIdx.x; e < H * H; e += THREADS) {
    const int k = e / H, n = e - k * H;
    const float w = __ldg(wo + e);
    const bf16 h = __float2bfloat16_rn(w);
    hi[k * w_ld(H) + n] = h;
    if (lo) lo[k * w_ld(H) + n] = __float2bfloat16_rn(w - __bfloat162float(h));
  }
}

// What ln_write leaves in P: float32 y, bf16 hi only, or bf16 hi and lo.
enum YForm { kF32 = 0, kHi = 1, kHiLo = 2 };

constexpr int RW = TILE / WARPS;  // rows of a tile per warp

// Rows w, w + WARPS, ... of P for warp w: y = relu(LayerNorm(x) * lns +
// lnb) of the rows' values x held in registers (lane: channels lane + 32 v),
// stored in the form FORM, all rows at once so that their shuffle
// reductions overlap. No barrier.
template <int H, int FORM>
__device__ __forceinline__ void ln_write(float* P,
                                         const float (&x)[RW][H / 32],
                                         const float* __restrict__ lns,
                                         const float* __restrict__ lnb) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sc[NV], bi[NV], mean[RW], rstd[RW];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    sc[v] = __ldg(lns + lane + 32 * v);
    bi[v] = __ldg(lnb + lane + 32 * v);
  }
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) s += x[q][v];
    mean[q] = warp_sum(s) / H;
  }
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    float s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float d = x[q][v] - mean[q];
      s2 += d * d;
    }
    rstd[q] = rsqrtf(warp_sum(s2) / H + 1e-5f);
  }
  if (FORM != kF32) __syncwarp();  // the bf16 halves overwrite the rows
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    float* row = P + (warp + q * WARPS) * p_ld(H);
    bf16* rb = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = lane + 32 * v;
      const float y =
          fmaxf((x[q][v] - mean[q]) * rstd[q] * sc[v] + bi[v], 0.f);
      if (FORM == kF32) {
        row[c] = y;
      } else {
        const bf16 h = __float2bfloat16_rn(y);
        rb[c] = h;
        if (FORM == kHiLo)
          rb[lo_off(H) + c] = __float2bfloat16_rn(y - __bfloat162float(h));
      }
    }
  }
}

// Rows [0, TILE) of P: pre (float32) -> y in the form FORM (ln_write).
// No barrier.
template <int H, int FORM>
__device__ __forceinline__ void ln_relu(float* P,
                                        const float* __restrict__ lns,
                                        const float* __restrict__ lnb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[RW][H / 32];
#pragma unroll
  for (int q = 0; q < RW; ++q)
#pragma unroll
    for (int v = 0; v < H / 32; ++v)
      x[q][v] = P[(warp + q * WARPS) * p_ld(H) + lane + 32 * v];
  ln_write<H, FORM>(P, x, lns, lnb);
}

// How W warps share a [TILE, H] x [H, H] product: 32 x 32 output tiles,
// NT of them, each reduced over H by S warps (S as large as the W warps
// and the H / 16 k-steps allow).
template <int H, int W>
struct MmaPlan {
  static constexpr int NCG = H / 32;
  static constexpr int NT = (TILE / 32) * NCG;
  static constexpr int KS = H / 16;
  static constexpr int S =
      (NT * 8 <= W && KS % 8 == 0)   ? 8
      : (NT * 4 <= W && KS % 4 == 0) ? 4
      : (NT * 2 <= W && KS % 2 == 0) ? 2
                                     : 1;
  static_assert(NT <= W, "one 32 x 32 tile per warp at least");
};

// P <- P @ Wo + bo for the TILE rows of P, which hold y from ln_write
// (bf16 hi, and lo if SPLIT), by a group of W warps (warp: the caller's
// index in its group). SPLIT: hi*hi + hi*lo + lo*hi (float32 accuracy);
// otherwise one bf16 pass hi*hi. Whi / wlo: Wo staged by stage_wo. Without
// BIAS, bo is not read (P <- P @ Wo). The float32 result replaces the rows
// of P. Contains block barriers, as many for every group of a launch, and
// ends with one.
template <int H, bool SPLIT, int W = WARPS, bool BIAS = true>
__device__ __forceinline__ void tile_product(float* P, const bf16* whi,
                                             const bf16* wlo,
                                             const float* __restrict__ bo,
                                             int warp = threadIdx.x >> 5) {
  using M = MmaPlan<H, W>;
  constexpr int KPS = M::KS / M::S;  // k-steps per warp
  const int lane = threadIdx.x & 31;
  const bool active = warp < M::NT * M::S;
  const int tile = warp % M::NT, split = warp / M::NT;
  const int row0 = (tile / M::NCG) * 32, col0 = (tile % M::NCG) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nt][q] = 0.f;

  if (active) {
    // lane's row address for ldmatrix: A rows (lane & 15), k half
    // (lane >> 4); B (k = lane & 15, n half lane >> 4), transposed
    const uint32_t a_base = smem_addr(P) +
                            (row0 + (lane & 15)) * p_ld(H) * 4 +
                            (lane >> 4) * 16;
    const uint32_t b_off =
        ((lane & 15) * w_ld(H) + col0 + (lane >> 4) * 8) * 2;
    const uint32_t bh_base = smem_addr(whi) + b_off;
    const uint32_t bl_base = SPLIT ? smem_addr(wlo) + b_off : 0u;
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      const int k0 = (split * KPS + kk) * 16;
      uint32_t ah[2][4], al[2][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const uint32_t addr = a_base + mb * 16 * p_ld(H) * 4 + k0 * 2;
        ldsm_x4(ah[mb], addr);
        if (SPLIT) ldsm_x4(al[mb], addr + lo_off(H) * 2);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const uint32_t off = (k0 * w_ld(H) + np * 16) * 2;
        ldsm_x4_t(bh[np], bh_base + off);
        if (SPLIT) ldsm_x4_t(bl[np], bl_base + off);
      }
      // pass by pass over the 8 accumulators, so that no two dependent
      // products are adjacent; the small terms first
#pragma unroll
      for (int pass = SPLIT ? 0 : 2; pass < 3; ++pass)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t(&a)[4] = pass == 0 ? al[mb] : ah[mb];
            const uint32_t(&b)[4] = pass == 1 ? bl[nt >> 1] : bh[nt >> 1];
            mma_bf16(acc[mb][nt], a, b[(nt & 1) * 2], b[(nt & 1) * 2 + 1]);
          }
    }
  }
  __syncthreads();  // every warp has read its rows of y

  // the S partial sums into P in a fixed order; the first adds bo
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll 1
  for (int s = 0; s < M::S; ++s) {
    if (active && split == s) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = row0 + mb * 16 + g, c = col0 + nt * 8 + t2;
          float2* p0 = reinterpret_cast<float2*>(P + r * p_ld(H) + c);
          float2* p1 = reinterpret_cast<float2*>(P + (r + 8) * p_ld(H) + c);
          const float* a4 = acc[mb][nt];
          if (s == 0) {
            const float b0 = BIAS ? __ldg(bo + c) : 0.f;
            const float b1 = BIAS ? __ldg(bo + c + 1) : 0.f;
            *p0 = make_float2(a4[0] + b0, a4[1] + b1);
            *p1 = make_float2(a4[2] + b0, a4[3] + b1);
          } else {
            float2 u = *p0, w = *p1;
            *p0 = make_float2(u.x + a4[0], u.y + a4[1]);
            *p1 = make_float2(w.x + a4[2], w.y + a4[3]);
          }
        }
    }
    __syncthreads();
  }
}

// The online-softmax state of a tile's TI destination rows, per head, in
// shared memory.
struct Softmax {
  float* E;   // [NH][EH] the chunk's exp(logit - m) per source row; 0 masked
  float* SC;  // [TI * NH] factor of the running sums at this chunk
  float* M;   // [TI * NH] running max
  float* L;   // [TI * NH] running sum
};

__device__ __forceinline__ void softmax_reset(const Softmax& s, int NH) {
  for (int p = threadIdx.x; p < TI * NH; p += THREADS) {
    s.M[p] = -1e29f;
    s.L[p] = 0.f;
  }
}

// One chunk of KC sources per destination row: K [TILE][H] (float32 in P),
// Q [TI][H], valid[r] of pair row r. One warp per (row, head), a lane per
// source. Updates the running max and sum and writes E and SC. No barrier.
// Warp w takes the (row, head) pairs w, w + WARPS, ... two at a time, so
// that their shuffle reductions overlap.
template <int H>
__device__ __forceinline__ void chunk_logits(const float* K, const float* Q,
                                             const int* valid, int NH,
                                             float scale, const Softmax& s) {
  const int lane = threadIdx.x & 31, hd = H / NH, np = TI * NH;
  for (int p0 = threadIdx.x >> 5; p0 < np; p0 += 2 * WARPS) {
    int p[2], r[2];
    float logit[2], m_old[2], m_new[2], e[2], sum[2];
    bool ok[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // the second pair may repeat the first
      p[u] = u == 1 && p0 + WARPS < np ? p0 + WARPS : p0;
      const int il = p[u] / NH, h = p[u] - il * NH;
      r[u] = il * KC + lane;
      const float* kr = K + r[u] * p_ld(H) + h * hd;
      const float* qr = Q + il * H + h * hd;
      float dot = 0.f;
      if ((hd & 3) == 0) {
        for (int d = 0; d < hd; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
          dot = fmaf(q4.x, k4.x, dot);
          dot = fmaf(q4.y, k4.y, dot);
          dot = fmaf(q4.z, k4.z, dot);
          dot = fmaf(q4.w, k4.w, dot);
        }
      } else {
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      }
      ok[u] = valid[r[u]] != 0;
      logit[u] = dot * scale;
      m_old[u] = s.M[p[u]];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      m_new[u] = fmaxf(m_old[u], warp_max(ok[u] ? logit[u] : -3.0e38f));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      e[u] = ok[u] ? expf(logit[u] - m_new[u]) : 0.f;
      sum[u] = warp_sum(e[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && p[1] == p[0]) break;
      const int h = p[u] % NH;
      s.E[h * EH + r[u]] = e[u];
      if (lane == 0) {
        const float sc = expf(m_old[u] - m_new[u]);
        s.SC[p[u]] = sc;
        s.M[p[u]] = m_new[u];
        s.L[p[u]] = s.L[p[u]] * sc + sum[u];
      }
    }
  }
}

// Node mode, one chunk: the thread's partial sum of channel c of row il
// over its share of the sources, acc * SC + sum E * coef * V (coef: null
// for 1). V [TILE][H] float32 in P. Thread t: c = t % H, il = (t / H) % TI,
// share t / (TI * H). No barrier.
template <int H>
__device__ __forceinline__ float chunk_acc_node(float acc, const float* V,
                                                const Softmax& s,
                                                const float* coef, int NH) {
  constexpr int NS = THREADS / (TI * H);
  const int c = threadIdx.x % H, il = (threadIdx.x / H) % TI;
  const int sp = threadIdx.x / (TI * H), h = c / (H / NH);
  acc *= s.SC[il * NH + h];
  const float* e = s.E + h * EH + il * KC;
#pragma unroll
  for (int k = sp; k < KC; k += NS) {
    const int r = il * KC + k;
    const float w = coef ? e[k] * coef[r] : e[k];
    acc = fmaf(w, V[r * p_ld(H) + c], acc);
  }
  return acc;
}

// Pos mode, one chunk: A3 [TI * NH][3] <- A3 * SC + sum_k E * VS * coef *
// rel, with VS [NH][EH] the v branch's per-head outputs and rel [TILE][3].
// Warp w takes the (row, head) pairs w, w + WARPS, ... two at a time. No
// barrier.
__device__ __forceinline__ void chunk_acc_pos(const float* VS,
                                              const Softmax& s,
                                              const float* coef,
                                              const float* rel, float* A3,
                                              int NH) {
  const int lane = threadIdx.x & 31, np = TI * NH;
  for (int p0 = threadIdx.x >> 5; p0 < np; p0 += 2 * WARPS) {
    const bool two = p0 + WARPS < np;
    int p[2];
    float t[2][3];
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // the second pair may repeat the first
      p[u] = u == 1 && two ? p0 + WARPS : p0;
      const int il = p[u] / NH, h = p[u] - il * NH, r = il * KC + lane;
      const float w = s.E[h * EH + r] * (VS[h * EH + r] * coef[r]);
#pragma unroll
      for (int d = 0; d < 3; ++d) t[u][d] = w * rel[r * 3 + d];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int d = 0; d < 3; ++d) t[u][d] = warp_sum(t[u][d]);
    if (lane == 0)
      for (int u = 0; u < (two ? 2 : 1); ++u) {
        const float sc = s.SC[p[u]];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          A3[p[u] * 3 + d] = A3[p[u] * 3 + d] * sc + t[u][d];
      }
  }
}

// VS[h][r] = bo[h] + sum_j Y[r][j] W[j][h] for the TILE rows of Y (float32
// in P) and W = Wo_v [H][NH] in shared memory. Thread: head h of rows r and
// r + TILE / 2, so that each weight it loads serves two rows. No barrier.
template <int H>
__device__ __forceinline__ void tile_heads(const float* Y, const float* W,
                                           const float* __restrict__ bo,
                                           int NH, float* VS) {
  for (int o = threadIdx.x; o < TILE / 2 * NH; o += THREADS) {
    const int h = o % NH, r = o / NH;
    const float* y0 = Y + r * p_ld(H);
    const float* y1 = y0 + TILE / 2 * p_ld(H);
    float a0 = __ldg(bo + h), a1 = a0;
#pragma unroll 4
    for (int j = 0; j < H; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(y0 + j);
      const float4 v = *reinterpret_cast<const float4*>(y1 + j);
      const float w0 = W[j * NH + h], w1 = W[(j + 1) * NH + h];
      const float w2 = W[(j + 2) * NH + h], w3 = W[(j + 3) * NH + h];
      a0 = fmaf(u.x, w0, a0);
      a0 = fmaf(u.y, w1, a0);
      a0 = fmaf(u.z, w2, a0);
      a0 = fmaf(u.w, w3, a0);
      a1 = fmaf(v.x, w0, a1);
      a1 = fmaf(v.y, w1, a1);
      a1 = fmaf(v.z, w2, a1);
      a1 = fmaf(v.w, w3, a1);
    }
    VS[h * EH + r] = a0;
    VS[h * EH + r + TILE / 2] = a1;
  }
}

// Node mode: out[il * stride + c] = (sum of the threads' partial sums) / L
// for the tile's first n_rows rows. scratch: THREADS floats. Contains a
// barrier.
template <int H>
__device__ __forceinline__ void finish_node(float acc, const Softmax& s,
                                            int NH, float* scratch,
                                            float* out, size_t stride,
                                            int n_rows) {
  constexpr int NS = THREADS / (TI * H);
  scratch[threadIdx.x] = acc;
  __syncthreads();
  const int c = threadIdx.x % H, il = threadIdx.x / H;
  if (il < n_rows) {  // threads of the first source share
    float t = 0.f;
#pragma unroll
    for (int sp = 0; sp < NS; ++sp) t += scratch[sp * TI * H + threadIdx.x];
    const float l = s.L[il * NH + c / (H / NH)];
    out[il * stride + c] = t * (1.f / fmaxf(l, 1e-16f));
  }
}

// Pos mode: out[il * 3 + d] = mean over heads of A3 / L for the tile's
// first n_rows rows, one warp per output. No barrier.
__device__ __forceinline__ void finish_pos(const Softmax& s, const float* A3,
                                           int NH, float* out, int n_rows) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w < n_rows * 3) {
    const int il = w / 3, d = w % 3;
    float t = 0.f;
    for (int h = lane; h < NH; h += 32)
      t += A3[(il * NH + h) * 3 + d] *
           (1.f / fmaxf(s.L[il * NH + h], 1e-16f));
    t = warp_sum(t);
    if (lane == 0) out[il * 3 + d] = t / NH;
  }
}

}  // namespace rowmma
