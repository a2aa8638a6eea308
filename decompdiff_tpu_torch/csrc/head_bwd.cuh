// The head-factorized softmax backward of one destination row (sm_90a),
// for a backward whose cotangent reaches k and v through q and g of the row.
//
// For a row with query q and output cotangent g ([H] each, shared by all of
// its sources), the cotangents of the two branch outputs factorize by head:
//   d k[m, c] = scale dh[m, h(c)] q[c],   d v[m, c] = alpha[m, h(c)] g[c].
// So no per-source [H, H] product is needed. With, per row,
//   Qk[h] = Wo_k[:, cols(h)] q[cols(h)],  Gv[h] = Wo_v[:, cols(h)] g[cols(h)]
// ([heads, H] each, H^2 multiply-adds a row) and y_k, y_v the branches'
// second-linear inputs:
//   logit[m, h]   = scale (y_k[m] . Qk[h] + q_h . bo_k,h)
//   d alpha[m, h] = y_v[m] . Gv[h] + g_h . bo_v,h
//   d y_k[m] = scale sum_h dh[m, h] Qk[h],  d y_v[m] = sum_h alpha[m, h] Gv[h]
//   Yd[h] = sum_m dh[m, h] y_k[m],          Ya[h] = sum_m alpha[m, h] y_v[m]
//   d q[c] = scale (Yd[h(c)] . Wo_k[:, c] + bo_k[c] sum_m dh[m, h(c)])
//   d Wo_k[:, c] += scale q[c] Yd[h(c)],    d Wo_v[:, c] += g[c] Ya[h(c)]
// Per source this is 6 heads x H multiply-adds in place of 3 x 2 x H^2.
//
// Shape of a launch: one block of THREADS threads per SM. Two thread maps:
//   warp map:    warp w holds the pair rows (sources) w + WARPS s of a chunk
//                of KC sources, a lane the channels lane + 32 v (as the
//                forward's row_mma.cuh), so LayerNorm needs only shuffles;
//   channel map: thread t holds channel t % H, and its part t / H of the
//                P = THREADS / H threads per channel takes the output
//                columns [part CR, (part + 1) CR), CR = H / P.
// The per-source sums over a chunk (Yd, Ya, and the kernel's own) run in the
// channel map over a [KC][H] tile that the warp map writes; each element of
// every accumulator is owned by one thread and summed in a fixed order, so
// the block's sums are deterministic. The logits and d alpha ([KC, H] x
// [H, heads] a chunk) run on the tensor cores from that tile
// (head_products_tc); the other heads-wide products on the CUDA cores, each
// shared-memory value feeding RW multiply-adds: tensor-core versions of
// them (one warp per 8 channels, three dependent mma.sync a step) were no
// faster at the released shapes.
//
// The triplet, edge and bond backward kernels include it. Besides the
// softmax backward it holds what they share around it: the LayerNorm of a
// tile keeping xhat (tile_ln), one branch's d y down to d pre
// (branch_back), and the 3xTF32 mma.sync fragments (frag_a, mma3) that
// head_products_tc and the bond's per-pair [H, H] products use.
#pragma once

#include <cuda_runtime.h>

#include "row_mma.cuh"

namespace headbwd {

constexpr int THREADS = 512;        // 16 warps, one block per SM
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;              // sources per chunk
constexpr int RW = KC / WARPS;      // pair rows per warp
constexpr int MAXNH = 16;           // heads: two 8-wide mma tiles
constexpr int MAXHP = 4;            // heads per thread in the channel map

template <int H>
struct Map {
  static constexpr int NV = H / 32;      // channels per lane (warp map)
  static constexpr int P = THREADS / H;  // threads per channel (channel map)
  static constexpr int CR = H / P;       // output columns per thread
};

// Row stride of the [heads][H] matrices in shared memory: the channel map's
// reads of several heads at one channel fall in distinct banks.
__host__ __device__ constexpr int mstride(int H) { return H + 1; }

// Row stride of the [KC][H] tile: the tensor-core fragment loads of eight
// rows at four columns fall in distinct banks.
__host__ __device__ constexpr int tstride(int H) { return H + 4; }

// Whether a head count takes this route (NH divides H): every channel-map
// thread then owns at most MAXHP heads.
__host__ __device__ constexpr bool heads_ok(int NH) { return NH <= MAXNH; }

// Channel map: the heads of a thread's columns, h0 .. h0 + n - 1, each
// covering `span` of them (several threads share a head wider than CR).
template <int H>
struct HeadSlots {
  int h0, n, span;
  __device__ __forceinline__ HeadSlots(int hd) {
    const int part = threadIdx.x / H;
    span = min(Map<H>::CR, hd);
    n = Map<H>::CR / span;
    h0 = part * Map<H>::CR / hd;
  }
};

// M [2 NH][mstride] <- Qk (rows 0 .. NH-1) and Gv (rows NH ..), and qb[h] =
// q_h . bo_k,h, gb[h] = g_h . bo_v,h; q and g in shared memory. NB = 1: Qk
// and qb alone (wo_v, bo_v and g unread). Consecutive
// threads read consecutive columns of a row j of Wo (four at a time where a
// head spans a multiple of four), and a head's sum is reduced by shuffles
// among the threads of its columns. No barrier.
template <int H, int NB = 2>
__device__ __forceinline__ void row_matrices(
    const float* __restrict__ wo_k, const float* __restrict__ wo_v,
    const float* __restrict__ bo_k, const float* __restrict__ bo_v,
    const float* q, const float* g, int NH, float* M, float* qb, float* gb) {
  const int hd = H / NH;
  if ((hd & 3) == 0) {
    constexpr int Q = H / 4;                 // column quads of a row
    constexpr int E = NB * H * Q;            // quads in all
    // quads per thread (a thread past E, in whole warps, takes none)
    constexpr int N = (E + THREADS - 1) / THREADS;
    constexpr int NL = N < 4 ? N : 4;        // loads in flight at once
    static_assert(N % NL == 0 && E % 32 == 0, "whole batches and warps");
#pragma unroll 1
    for (int n0 = 0; n0 < N; n0 += NL) {
      float4 w[NL];
#pragma unroll
      for (int u = 0; u < NL; ++u) {
        const int e = threadIdx.x + (n0 + u) * THREADS;
        const int br = e / (H * Q), j = e / Q - br * H, c = (e % Q) * 4;
        if (E % THREADS == 0 || e < E)
          w[u] = __ldg(reinterpret_cast<const float4*>(
              (br ? wo_v : wo_k) + (size_t)j * H + c));
      }
#pragma unroll
      for (int u = 0; u < NL; ++u) {
        const int e = threadIdx.x + (n0 + u) * THREADS;
        if (E % THREADS != 0 && e >= E) break;  // uniform over the warp
        const int br = e / (H * Q), j = e / Q - br * H, c = (e % Q) * 4;
        const float* x = (br ? g : q) + c;
        float s = w[u].x * x[0];
        s = fmaf(w[u].y, x[1], s);
        s = fmaf(w[u].z, x[2], s);
        s = fmaf(w[u].w, x[3], s);
        for (int o = hd / 8; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (c % hd == 0) M[(br * NH + c / hd) * mstride(H) + j] = s;
      }
    }
  } else {
    static_assert(NB * H * H % THREADS == 0, "whole warps per iteration");
    for (int e = threadIdx.x; e < NB * H * H; e += THREADS) {
      const int br = e / (H * H), j = e / H - br * H, c = e % H;
      float s = __ldg((br ? wo_v : wo_k) + (size_t)j * H + c) *
                (br ? g : q)[c];
      for (int o = hd / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (c % hd == 0) M[(br * NH + c / hd) * mstride(H) + j] = s;
    }
  }
  const int t = threadIdx.x;
  if (t < NB * NH) {
    const int h = t % NH;
    const float* bo = t < NH ? bo_k : bo_v;
    const float* xr = t < NH ? q : g;
    float s = 0.f;
    for (int d = h * hd; d < (h + 1) * hd; ++d) s = fmaf(xr[d], __ldg(bo + d), s);
    (t < NH ? qb : gb)[h] = s;
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a tf32 value (about 21 significant bits together).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), tf32 -> float32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's fragment of an m16n8k8 tf32 product from a float32 tile of row
// stride S at a = &A[m0 + g][k + t] (g = lane / 4, t = lane % 4), or, with
// TRANS, the transposed tile at a = &A[k + t][m0 + g]; split into hi + lo.
template <int S, bool TRANS>
__device__ __forceinline__ void frag_a(const float* a, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  constexpr int R8 = TRANS ? 8 : 8 * S, K4 = TRANS ? 4 * S : 4;
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[R8], hi[1], lo[1]);
  split_tf32(a[K4], hi[2], lo[2]);
  split_tf32(a[R8 + K4], hi[3], lo[3]);
}

// The same fragment (not transposed; o: the offset of A[m0 + g][k + t]) of
// a tile already split into tf32 hi and lo, two tiles of one layout.
template <int S>
__device__ __forceinline__ void frag_a_split(const uint32_t* hi,
                                             const uint32_t* lo, int o,
                                             uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) {
  const int at[4] = {o, o + 8 * S, o + 4, o + 8 * S + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = hi[at[i]];
    al[i] = lo[at[i]];
  }
}

// c += a b in three tf32 passes (hi hi + hi lo + lo hi: float32 accuracy),
// the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The heads-wide products of a chunk on the tensor cores: for source row m
// of the tile T ([KC][tstride], float32 y) and head h < NH,
//   out[(k0 + m) NH + h] = f (T[m] . M[h] + bias[h])    (k0 + m < n)
// with M [NH][mstride]. Warps 0 .. 3 each take 16 rows x 8 heads over the
// whole depth H, in three tf32 passes (hi hi + hi lo + lo hi: float32
// accuracy, as row_mma.cuh's bf16 split); the other warps return at once
// (w0: warps w0 .. w0 + 3 take the tiles instead, so that two products can
// run at once). No barrier.
template <int H>
__device__ __forceinline__ void head_products_tc(const float* T,
                                                 const float* M, int NH,
                                                 int k0, int n, float f,
                                                 const float* bias,
                                                 float* out, int w0 = 0) {
  static_assert(KC == 32 && MAXNH == 16, "2 x 2 tiles of 16 x 8");
  const int warp = (threadIdx.x >> 5) - w0, lane = threadIdx.x & 31;
  if (warp < 0 || warp >= 4) return;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 16, h0 = (warp & 1) * 8;
  if (h0 >= NH) return;
  const bool hb = h0 + g < NH;  // this lane's column of B is a real head
  const float* a_row = T + (m0 + g) * tstride(H) + t;
  const float* b_row = M + (h0 + g) * mstride(H) + t;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = 0; k < H; k += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    frag_a<tstride(H), false>(a_row + k, ah, al);
    split_tf32(hb ? b_row[k] : 0.f, bh[0], bl[0]);
    split_tf32(hb ? b_row[k + 4] : 0.f, bh[1], bl[1]);
    mma3(acc, ah, al, bh, bl);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = k0 + m0 + g + (q >> 1) * 8, h = h0 + 2 * t + (q & 1);
    if (m < n && h < NH) out[m * NH + h] = f * (acc[q] + bias[h]);
  }
}

// Warp map: dy[s][v] = sum_h cf C[m_s][h] M[h][c_v] for the pair rows' sources
// m_s = k0 + warp + WARPS s (0 past n sources); C is [n][NH].
template <int H>
__device__ __forceinline__ void head_expand(float (&dy)[RW][H / 32],
                                            const float* M, const float* C,
                                            float cf, int k0, int n, int NH) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < RW; ++s)
#pragma unroll
    for (int v = 0; v < H / 32; ++v) dy[s][v] = 0.f;
#pragma unroll
  for (int h = 0; h < MAXNH; ++h) {
    if (h >= NH) break;
    float cs[RW];
#pragma unroll
    for (int s = 0; s < RW; ++s) {
      const int m = k0 + warp + WARPS * s;
      cs[s] = m < n ? cf * C[m * NH + h] : 0.f;
    }
#pragma unroll
    for (int v = 0; v < H / 32; ++v) {
      const float w = M[h * mstride(H) + lane + 32 * v];
#pragma unroll
      for (int s = 0; s < RW; ++s) dy[s][v] = fmaf(cs[s], w, dy[s][v]);
    }
  }
}

// Warp map: LayerNorm and relu of the pre rows in the tile T (pair rows
// warp + WARPS s), keeping xhat (xh) and 1 / std (rs); y replaces pre in T.
// No barrier.
template <int H>
__device__ __forceinline__ void tile_ln(float* T,
                                        const float* __restrict__ lns,
                                        const float* __restrict__ lnb,
                                        float (&xh)[RW][H / 32],
                                        float (&rs)[RW]) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    float* row = T + (warp + WARPS * s) * tstride(H);
    float x[NV], sum = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      x[v] = row[lane + 32 * v];
      sum += x[v];
    }
    const float mean = rowmma::warp_sum(sum) / H;
    float s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float d = x[v] - mean;
      s2 += d * d;
    }
    rs[s] = rsqrtf(rowmma::warp_sum(s2) / H + 1e-5f);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xh[s][v] = (x[v] - mean) * rs[s];
      row[lane + 32 * v] = fmaxf(xh[s][v] * __ldg(lns + lane + 32 * v) +
                                     __ldg(lnb + lane + 32 * v),
                                 0.f);
    }
  }
}

// Warp map, one branch of pass B: d y = cf sum_h C[m][h] M[h] (with GATE
// plus d s wvm, d s in DS), the relu and LayerNorm backward to d pre, which
// replaces y in T (xh, rs from tile_ln); sl, sb: the block's sums of
// d ln_scale and d ln_bias at the lanes' channels. No barrier.
template <int H, bool GATE>
__device__ __forceinline__ void branch_back(
    float* T, const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* M, const float* C, float cf, int k0, int K, int NH,
    const float (&xh)[RW][H / 32], const float (&rs)[RW],
    float (&sl)[H / 32], float (&sb)[H / 32], const float* DS,
    const float* wvm) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dp[RW][NV];
  head_expand<H>(dp, M, C, cf, k0, K, NH);
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    if (GATE) {
      const int m = k0 + warp + WARPS * s;
      const float ds = m < K ? DS[m] : 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        dp[s][v] = fmaf(ds, wvm[lane + 32 * v], dp[s][v]);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float ls = __ldg(lns + lane + 32 * v);
      const float du =
          xh[s][v] * ls + __ldg(lnb + lane + 32 * v) > 0.f ? dp[s][v] : 0.f;
      sl[v] = fmaf(du, xh[s][v], sl[v]);
      sb[v] += du;
      const float dx = du * ls;
      dp[s][v] = dx;
      s1 += dx;
      s2 = fmaf(dx, xh[s][v], s2);
    }
    const float m1 = rowmma::warp_sum(s1) / H, m2 = rowmma::warp_sum(s2) / H;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      T[(warp + WARPS * s) * tstride(H) + lane + 32 * v] =
          rs[s] * (dp[s][v] - m1 - xh[s][v] * m2);
  }
}

// Channel map: Y[u] += sum_{r < nr} C[k0 + r][h0 + u] T[r][c], T the [KC][H]
// tile (row stride tstride) of the chunk's y, C [.][NH] the sources' dh or alpha. No barrier.
template <int H>
__device__ __forceinline__ void accumulate_heads(float (&Y)[MAXHP],
                                                 const float* T,
                                                 const float* C, int k0,
                                                 int nr, int NH) {
  static_assert(MAXHP == 4, "a thread's heads are one float4 of C");
  const int c = threadIdx.x % H;
  const HeadSlots<H> hs(H / NH);
  if (hs.n == 4) {  // h0 % 4 == 0 and NH % 4 == 0: aligned
    for (int r = 0; r < nr; ++r) {
      const float y = T[r * tstride(H) + c];
      const float4 w =
          *reinterpret_cast<const float4*>(C + (k0 + r) * NH + hs.h0);
      Y[0] = fmaf(w.x, y, Y[0]);
      Y[1] = fmaf(w.y, y, Y[1]);
      Y[2] = fmaf(w.z, y, Y[2]);
      Y[3] = fmaf(w.w, y, Y[3]);
    }
    return;
  }
  for (int r = 0; r < nr; ++r) {
    const float y = T[r * tstride(H) + c];
    const float* cr = C + (k0 + r) * NH + hs.h0;
#pragma unroll
    for (int u = 0; u < MAXHP; ++u)
      if (u < hs.n) Y[u] = fmaf(cr[u], y, Y[u]);
  }
}

// The softmax over the row's n sources and its backward, warp h per head:
// LG logits -> alpha, DA d alpha -> dh = alpha (d alpha - sum alpha d alpha)
// ([n][NH]); VL[m] != 0 for a valid source. S[h] <- sum_m dh, S[MAXNH + h]
// <- sum_m alpha. The TPU kernels' constants: the max starts at -1e29,
// the sum is clamped at 1e-16. No barrier.
__device__ __forceinline__ void head_softmax(float* LG, float* DA,
                                             const int* VL, int n, int NH,
                                             float* S) {
  const int lane = threadIdx.x & 31, h = threadIdx.x >> 5;
  if (h >= NH) return;
  float mx = -1e29f;
  for (int m = lane; m < n; m += 32)
    if (VL[m]) mx = fmaxf(mx, LG[m * NH + h]);
  mx = rowmma::warp_max(mx);
  float l = 0.f;
  for (int m = lane; m < n; m += 32)
    if (VL[m]) l += expf(LG[m * NH + h] - mx);
  const float inv = 1.f / fmaxf(rowmma::warp_sum(l), 1e-16f);
  float sd = 0.f;
  for (int m = lane; m < n; m += 32) {
    const float a = VL[m] ? expf(LG[m * NH + h] - mx) * inv : 0.f;
    LG[m * NH + h] = a;
    sd = fmaf(a, DA[m * NH + h], sd);
  }
  sd = rowmma::warp_sum(sd);
  float sdh = 0.f, sal = 0.f;
  for (int m = lane; m < n; m += 32) {
    const float a = LG[m * NH + h];
    const float dh = VL[m] ? a * (DA[m * NH + h] - sd) : 0.f;
    DA[m * NH + h] = dh;
    sdh += dh;
    sal += a;
  }
  sdh = rowmma::warp_sum(sdh);
  sal = rowmma::warp_sum(sal);
  if (lane == 0) {
    S[h] = sdh;
    S[MAXNH + h] = sal;
  }
}

// Channel map: DW[c'][j] += f x[c'] Y[slot of c'] for j = the thread's
// channel and c' its columns; DW is the block's transposed [H][mstride]
// accumulator of d Wo, x (q or g) in shared memory. No barrier.
template <int H>
__device__ __forceinline__ void update_dwo(float* DW, const float (&Y)[MAXHP],
                                           const float* x, float f, int NH) {
  const int j = threadIdx.x % H, part = threadIdx.x / H;
  const HeadSlots<H> hs(H / NH);
#pragma unroll
  for (int u = 0; u < MAXHP; ++u) {
    if (u >= hs.n) break;
    const float yu = f * Y[u];
    const int c0 = part * Map<H>::CR + u * hs.span;
    for (int d = 0; d < hs.span; ++d) {
      float* p = DW + (c0 + d) * mstride(H) + j;
      *p = fmaf(x[c0 + d], yu, *p);
    }
  }
}

// Channel map: M[h][c] <- Y[u] for the heads the thread owns (one writer
// per element). No barrier.
template <int H>
__device__ __forceinline__ void store_heads(float* M, const float (&Y)[MAXHP],
                                            int NH) {
  const int c = threadIdx.x % H, part = threadIdx.x / H, hd = H / NH;
  const HeadSlots<H> hs(hd);
  if ((part * Map<H>::CR) % hd != 0) return;  // another part holds the head
#pragma unroll
  for (int u = 0; u < MAXHP; ++u)
    if (u < hs.n) M[(hs.h0 + u) * mstride(H) + c] = Y[u];
}

// Channel map: R[part][c'] <- sum over the thread's rows j of Wo,
// [part CR, (part + 1) CR), of Yd[h(c')][j] Wo[j][c'], Yd in M. No barrier.
template <int H>
__device__ __forceinline__ void dq_partial(float* R, const float* M,
                                           const float* __restrict__ wo,
                                           int NH) {
  const int c = threadIdx.x % H, part = threadIdx.x / H;
  const float* yd = M + (c / (H / NH)) * mstride(H);
  float s = 0.f;
#pragma unroll 8
  for (int j = part * Map<H>::CR; j < (part + 1) * Map<H>::CR; ++j)
    s = fmaf(yd[j], __ldg(wo + (size_t)j * H + c), s);
  R[part * H + c] = s;
}

}  // namespace headbwd
