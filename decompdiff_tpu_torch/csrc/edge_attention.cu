// kNN edge attention, node mode (x2h) and pos mode (h2x), for sm_90a:
// forward and backward.
//
// Replaces: the Pallas TPU kernels decompdiff_tpu/ops/pallas/edge_kernel.py
//   forward  _edge_fwd_call :540 -> _edge_kernel :152-250,
//   backward _edge_bwd_call :568 -> _edge_bwd_kernel :266-498,
// each without and with m_gate (:220-225, :338-345, :381-397).
//
// Computes, per destination node i and each of its K kNN sources s:
//   edge_type = one-hot (src ligand?, dst ligand?) [+ one-hot same group]
//   pre_m     = [outer(edge_type, RBF20(|x_i - xs_s|)), edge_type] @ We_m
//               + t_row_m[i] + t_src_m[s]                      (m = k, v)
//   k, v      = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
//   [m-gate, node mode only: v *= sigmoid(v . wm + bm)] ;  v *= e_w
//   node mode: out[i] = sum_k softmax_k(q[i] . k / sqrt(hd)) v  [H]
//   pos mode:  out[i] = sum_k mean_h(alpha v) (x_i - xs_s)       [3]
// t_src = h @ Wj is projected per node before the launch and gathered here
// (K times fewer operations than projecting every gathered row).
// xs holds the sources' coordinates: x itself, or with the TPU kernel's
// gather_bf16 option (_split_hjT :132-149) x rebuilt from bf16 hi + lo by
// the caller. Every read of a source's coordinates goes through xs and
// every read of a destination's through x; the backward scatters the
// sources' coordinate cotangent into d_xs (d_x itself when xs is x).
//
// Bound on an H100: operations. At the released shapes (B=8, N=352, K=32,
// H=128) one node-mode forward is ~6.9 GFLOP of per-edge products (the two
// [H, H] second linears dominate; pos mode ~4.3 GFLOP) against ~10 MB of
// inputs and output, as chip_smoke.py counts them, not the 3.35 TB/s of
// device memory. The backward recomputes the forward and adds two products
// per forward product, about 3x the operations, so it is bound the same way.
//
// Forward design, H in 32, 64, 128 (row_mma.cuh): a persistent grid of one
// 512-thread block per SM. Each block stages the [H, H] second linears
// (both branches in node mode, k in pos mode), split into bf16 hi + lo, in
// shared memory once and loops over tiles of 2 destination nodes x 32
// sources (more sources: an online softmax across chunks of 32). Per tile
// the gathered t_src and the edge-feature products of both branches run on CUDA cores in one pass
// (they share the RBF rows and the type tests): the product uses the
// one-hot structure of edge_type, so for each type only the sources of
// that type accumulate its 20 RBF rows and constant row, with the type's
// weights in registers (21, or 42 with groups, multiply-adds per channel
// and edge). LayerNorm and relu run a warp per four edges and branch; the
// [H, H] products run on the tensor cores in three bf16 passes (float32
// accuracy), in node mode both at once, eight warps each. Pos mode's v
// branch ([H, heads]) stays on CUDA cores, with Wo_v in shared memory. The
// m-gate's v . wm is one warp reduction per edge.
// Logits, softmax and the sums of alpha v stay float32. Only the [B, N, H]
// (or [B, N, 3]) output is written; a tile with no valid edge writes zeros
// without computing.
//
// Forward design at every other width (a multiple of 32 up to 1024 whose
// head width divides 32; row_attention.cuh): one block per destination row
// with one thread per channel, the sources in chunks of 16: per chunk the
// gathered t_src and edge-feature products in registers, both branches'
// pre in shared memory ([16][H] each, never Wo), LayerNorm and relu a warp
// per source, the second linears with Wo read through the cache, then an
// online softmax. Shared memory grows with H (128 KB at 1024); the blocks
// of H > 256 threads are compiled for 1024 threads (at most 64 registers).
//
// Backward design (row_attention_bwd.cuh): a fixed grid of blocks, each
// looping over destination rows, recomputes every per-edge intermediate in
// shared memory (nothing per edge is saved by the forward). The TPU kernel
// scatter-adds the source-node cotangents with a one-hot matmul over its
// sequential grid; here d t_src and d x[src] are atomicAdds into zeroed
// buffers (their order varies between runs, within float32 rounding).
// d w_feat is accumulated per edge type, only for the 21 (42) rows of each
// edge's own types. The distance chain gives 0 where |x_i - x_s|^2 < 1e-12,
// like the clamp of the plain version's safe_norm. Blocks of H > 256
// threads take a 1024-thread build; where the row buffers do not fit in
// shared memory (H >= 512, or large K) they live in a device-memory scratch
// that the wrapper allocates (row_attention_bwd.cuh).
//
// The m-gate (uni_o2, ew_net_type 'm') is the template parameter GATE of
// both kernels; the launchers take it when wm is not null. In the forward
// its dot product over the H channels of each source is a warp reduction
// (edge_gate); the backward keeps each source's gate and
// v before the gate in shared memory, and sums d wm and d bm per block in
// registers into a slot of their own after the v branch's.
#include "row_attention_bwd.cuh"
#include "row_mma.cuh"

using namespace rowattn;

namespace {

__constant__ float kRbfOffsets[20] = {0.f, 1.f, 1.25f, 1.5f, 1.75f, 2.f, 2.25f,
                                      2.5f, 2.75f, 3.f, 3.5f, 4.f, 4.5f, 5.f,
                                      5.5f, 6.f, 7.f, 8.f, 9.f, 10.f};
constexpr int R = 20;  // RBF features per edge type

struct EdgeArgs {
  const float* x;      // [B, N, 3] destinations' coordinates
  const float* xs;     // [B, N, 3] sources' coordinates (x, or hi + lo)
  const float* lig;    // [B, N]
  const float* group;  // [B, N] or null (4 edge types)
  const int* idx;      // [B, N, K]
  const float* mask;   // [B, N, K]
  const float* ew;     // [B, N, K]
  const float* q;      // [B, N, H]
  Branch k, v;
  float* out;          // [B, N, H] or [B, N, 3]
  int N, K, H, n_heads, n_types, pos;
  Gate gate;           // m-gate wm [H], bm [1] (GATE kernels only)
};

// Per-chunk source data of one destination row (shared memory).
struct EdgeChunk {
  ChunkSources cs;
  float rbf[CH][R];
  int ta[CH], tb[CH];  // the source's 4-way and (6 types) group edge type
  float dist[CH];
  float dgrad[CH];     // d dist / d rel = rel * dgrad (0 below the clamp)
};

// The destination row's own scalars.
struct EdgeRow {
  float x0, x1, x2;
  bool lig;
  float group;
};

__device__ __forceinline__ EdgeRow edge_row(const EdgeArgs& a, int row) {
  EdgeRow r;
  r.x0 = a.x[row * 3 + 0];
  r.x1 = a.x[row * 3 + 1];
  r.x2 = a.x[row * 3 + 2];
  r.lig = a.lig[row] > 0.5f;
  r.group = a.group ? a.group[row] : 0.f;
  return r;
}

// Threads c < CH: the per-edge scalars of sources m0 .. m0+nm-1 of `row`.
__device__ __forceinline__ void edge_chunk_setup(const EdgeArgs& a,
                                                 EdgeChunk& ch, int row,
                                                 int b, int m0, int nm,
                                                 const EdgeRow& dst) {
  const int c = threadIdx.x;
  if (c >= CH) return;
  const int N = a.N, K = a.K;
  int s = 0, ok = 0, ta = 3, tb = -1;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, d = 0.f, w = 1.f, dg = 0.f;
  if (c < nm) {
    const size_t e = (size_t)row * K + m0 + c;
    s = a.idx[e];
    const bool in_range = s >= 0 && s < N;
    ok = in_range && a.mask[e] > 0.5f;
    if (!in_range) s = 0;
    const float* xs = a.xs + ((size_t)b * N + s) * 3;
    r0 = dst.x0 - xs[0];
    r1 = dst.x1 - xs[1];
    r2 = dst.x2 - xs[2];
    const float d2 = r0 * r0 + r1 * r1 + r2 * r2;
    d = sqrtf(fmaxf(d2, 1e-12f));
    dg = d2 >= 1e-12f ? 1.f / d : 0.f;
    w = a.ew[e];
    const bool lig_s = a.lig[(size_t)b * N + s] > 0.5f;
    ta = lig_s ? (dst.lig ? 0 : 1) : (dst.lig ? 2 : 3);
    if (a.group) tb = 4 + (a.group[(size_t)b * N + s] == dst.group ? 1 : 0);
  }
  ch.cs.src[c] = s;
  ch.cs.valid[c] = ok;
  ch.cs.ew[c] = w;
  ch.cs.rel[c * 3 + 0] = r0;
  ch.cs.rel[c * 3 + 1] = r1;
  ch.cs.rel[c * 3 + 2] = r2;
  ch.ta[c] = ta;
  ch.tb[c] = tb;
  ch.dist[c] = d;
  ch.dgrad[c] = dg;
  for (int r = 0; r < R; ++r) {
    const float u = d - kRbfOffsets[r];
    ch.rbf[c][r] = expf(-0.5f * u * u);
  }
}

__device__ __forceinline__ bool has_type(const EdgeChunk& ch, int m, int t) {
  return ch.ta[m] == t || ch.tb[m] == t;
}

// Every thread: the first-linear outputs of the chunk's CH sources for
// channel c into Yk and Yv ([CH][H]).
__device__ __forceinline__ void edge_chunk_pre(const EdgeArgs& a,
                                               const EdgeChunk& ch, int b,
                                               float tk, float tv, float* Yk,
                                               float* Yv) {
  const int c = threadIdx.x, H = a.H, F = a.n_types;
  float pk[CH], pv[CH];
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const size_t srow = ((size_t)b * a.N + ch.cs.src[m]) * H + c;
    pk[m] = tk + __ldg(a.k.t_src + srow);
    pv[m] = tv + __ldg(a.v.t_src + srow);
  }
  for (int t = 0; t < F; ++t) {
    float wk[R], wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wk[r] = __ldg(a.k.w_feat + (size_t)(t * R + r) * H + c);
      wv[r] = __ldg(a.v.w_feat + (size_t)(t * R + r) * H + c);
    }
    const float ck = __ldg(a.k.w_feat + (size_t)(F * R + t) * H + c);
    const float cv = __ldg(a.v.w_feat + (size_t)(F * R + t) * H + c);
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      if (!has_type(ch, m, t)) continue;  // uniform over the block
      float sk = ck, sv = cv;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sk = fmaf(ch.rbf[m][r], wk[r], sk);
        sv = fmaf(ch.rbf[m][r], wv[r], sv);
      }
      pk[m] += sk;
      pv[m] += sv;
    }
  }
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    Yk[m * H + c] = pk[m];
    Yv[m * H + c] = pv[m];
  }
}

// True if some thread sees a valid source in the row (block-uniform).
__device__ __forceinline__ bool row_has_source(const float* mrow, int K) {
  int any = 0;
  for (int t = threadIdx.x; t < K; t += blockDim.x) any |= mrow[t] > 0.5f;
  return __syncthreads_or(any);
}

// ---------------------------------------------------------------------------
// forward: tensor-core stage of row_mma.cuh
// ---------------------------------------------------------------------------

namespace rm = rowmma;

// Offsets into the forward kernel's dynamic shared memory; the launcher
// builds the same layout to size the launch.
struct EdgeLayout {
  size_t wk_hi, wk_lo, wv_hi, wv_lo, wv, pk, pv, e, vs, sc, m, l, a3, q,
      scratch, rbf, dist, src, valid, coef, rel, ta, tb, bytes;
  __host__ __device__ EdgeLayout(int H, int NH, bool pos) {
    rm::Carve c;
    wk_hi = c.take(rm::wo_bytes(H));
    wk_lo = c.take(rm::wo_bytes(H));
    wv_hi = pos ? 0 : c.take(rm::wo_bytes(H));
    wv_lo = pos ? 0 : c.take(rm::wo_bytes(H));
    wv = pos ? c.take(sizeof(float) * H * NH) : 0;
    pk = c.take(rm::p_bytes(H));
    pv = c.take(rm::p_bytes(H));
    e = c.take(sizeof(float) * NH * rm::EH);
    vs = pos ? c.take(sizeof(float) * NH * rm::EH) : 0;
    sc = c.take(sizeof(float) * rm::TI * NH);
    m = c.take(sizeof(float) * rm::TI * NH);
    l = c.take(sizeof(float) * rm::TI * NH);
    a3 = pos ? c.take(sizeof(float) * rm::TI * NH * 3) : 0;
    q = c.take(sizeof(float) * rm::TI * H);
    scratch = c.take(sizeof(float) * rm::THREADS);
    rbf = c.take(sizeof(float) * rm::TILE * R);
    dist = c.take(sizeof(float) * rm::TILE);
    src = c.take(sizeof(int) * rm::TILE);
    valid = c.take(sizeof(int) * rm::TILE);
    coef = c.take(sizeof(float) * rm::TILE);
    rel = c.take(sizeof(float) * rm::TILE * 3);
    ta = c.take(sizeof(int) * rm::TILE);
    tb = c.take(sizeof(int) * rm::TILE);
    bytes = c.off;
  }
};

// The per-edge scalars of a tile (shared memory), pair row r = (il, k).
struct EdgeTile {
  float* rbf;   // [TILE][R]
  float* dist;  // [TILE]
  int* src;     // [TILE] source node, flat b * N + s
  int* valid;   // [TILE]
  float* coef;  // [TILE] weight of v: e_w (times the m-gate)
  float* rel;   // [TILE][3] x_dst - x_src
  int* ta;      // [TILE] 4-way edge type
  int* tb;      // [TILE] group edge type (4 or 5), or -1
};

// Threads r < TILE: the scalars of pair row r (source k0 + r % KC of row
// row0 + r / KC). Rows outside the graph (row >= rows or source >= K) get
// node 0 and weigh nothing. Returns the thread's validity. No barrier.
__device__ __forceinline__ int edge_tile_setup(const EdgeArgs& a,
                                               const EdgeTile& t, int row0,
                                               int rows, int k0) {
  const int r = threadIdx.x;
  if (r >= rm::TILE) return 0;
  const int row = row0 + r / rm::KC, k = k0 + r % rm::KC;
  int s_flat = 0, ok = 0, ta = 3, tb = -1;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, d = 0.f, w = 1.f;
  if (row < rows && k < a.K) {
    const int N = a.N, b = row / N;
    const size_t e = (size_t)row * a.K + k;
    // the loads that do not depend on the source first
    int s = a.idx[e];
    const float m = a.mask[e];
    w = a.ew[e];
    const float xd0 = a.x[(size_t)row * 3 + 0], xd1 = a.x[(size_t)row * 3 + 1];
    const float xd2 = a.x[(size_t)row * 3 + 2];
    const bool lig_d = a.lig[row] > 0.5f;
    const float g_d = a.group ? a.group[row] : 0.f;
    const bool in_range = s >= 0 && s < N;
    ok = in_range && m > 0.5f;
    if (!in_range) s = 0;
    s_flat = b * N + s;
    const float* xs = a.xs + (size_t)s_flat * 3;
    r0 = xd0 - xs[0];
    r1 = xd1 - xs[1];
    r2 = xd2 - xs[2];
    d = sqrtf(fmaxf(r0 * r0 + r1 * r1 + r2 * r2, 1e-12f));
    const bool lig_s = a.lig[s_flat] > 0.5f;
    ta = lig_s ? (lig_d ? 0 : 1) : (lig_d ? 2 : 3);
    if (a.group) tb = 4 + (a.group[s_flat] == g_d ? 1 : 0);
  }
  t.src[r] = s_flat;
  t.valid[r] = ok;
  t.coef[r] = w;
  t.rel[r * 3 + 0] = r0;
  t.rel[r * 3 + 1] = r1;
  t.rel[r * 3 + 2] = r2;
  t.ta[r] = ta;
  t.tb[r] = tb;
  t.dist[r] = d;
  return ok;
}

// The weights of edge type ty for channel c: its R RBF rows, then its
// constant row.
__device__ __forceinline__ void load_type(float (&w)[R + 1],
                                          const float* __restrict__ w_feat,
                                          int F, int ty, int H, int c) {
#pragma unroll
  for (int q = 0; q < R; ++q)
    w[q] = __ldg(w_feat + (size_t)(ty * R + q) * H + c);
  w[R] = __ldg(w_feat + (size_t)(F * R + ty) * H + c);
}

// Both branches' first-linear outputs of the tile into Pk and Pv: t_row +
// the gathered t_src + the edge-feature product, type by type, only for
// the rows of each type; the two branches share the RBF loads and the type
// tests. Thread t: channel t % H of TILE * H / THREADS consecutive rows (a
// warp shares its rows, so the type tests are uniform over it). No
// barrier.
template <int H>
__device__ __forceinline__ void edge_tile_pre(const EdgeArgs& a,
                                              const EdgeTile& t, float trk,
                                              float trv, float* Pk,
                                              float* Pv) {
  constexpr int RPT = rm::TILE * H / rm::THREADS;
  const int c = threadIdx.x % H, r0 = (threadIdx.x / H) * RPT;
  const int F = a.n_types;
  unsigned types = 0;  // the types among the thread's rows
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    types |= 1u << t.ta[r0 + m] | (t.tb[r0 + m] < 0 ? 0u : 1u << t.tb[r0 + m]);
  float pk[RPT], pv[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const size_t src = (size_t)t.src[r0 + m] * H + c;
    pk[m] = trk + __ldg(a.k.t_src + src);
    pv[m] = trv + __ldg(a.v.t_src + src);
  }
  for (; types; types &= types - 1) {
    const int ty = __ffs(types) - 1;
    float wk[R + 1], wv[R + 1];
    load_type(wk, a.k.w_feat, F, ty, H, c);
    load_type(wv, a.v.w_feat, F, ty, H, c);
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int r = r0 + m;
      if (t.ta[r] != ty && t.tb[r] != ty) continue;
      const float4* rb = reinterpret_cast<const float4*>(t.rbf + r * R);
      float sk = wk[R], sv = wv[R];
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 b = rb[q];
        sk = fmaf(b.x, wk[4 * q], sk);
        sv = fmaf(b.x, wv[4 * q], sv);
        sk = fmaf(b.y, wk[4 * q + 1], sk);
        sv = fmaf(b.y, wv[4 * q + 1], sv);
        sk = fmaf(b.z, wk[4 * q + 2], sk);
        sv = fmaf(b.z, wv[4 * q + 2], sv);
        sk = fmaf(b.w, wk[4 * q + 3], sk);
        sv = fmaf(b.w, wv[4 * q + 3], sv);
      }
      pk[m] += sk;
      pv[m] += sv;
    }
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    Pk[(r0 + m) * rm::p_ld(H) + c] = pk[m];
    Pv[(r0 + m) * rm::p_ld(H) + c] = pv[m];
  }
}

// The m-gate: coef[r] *= sigmoid(V[r] . wm + bm) for the tile's rows of V
// (float32 in P). Warp w takes rows w, w + WARPS, ... at once. No barrier.
template <int H>
__device__ __forceinline__ void edge_gate(const float* V, const Gate& gt,
                                          float* coef) {
  constexpr int RW = rm::TILE / rm::WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[RW];
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const float* v = V + (warp + q * rm::WARPS) * rm::p_ld(H);
    s[q] = 0.f;
#pragma unroll
    for (int c = lane; c < H; c += 32)
      s[q] = fmaf(v[c], __ldg(gt.wm + c), s[q]);
  }
#pragma unroll
  for (int q = 0; q < RW; ++q) s[q] = rm::warp_sum(s[q]) + __ldg(gt.bm);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < RW; ++q)
      coef[warp + q * rm::WARPS] *= 1.f / (1.f + expf(-s[q]));
}

// Persistent: block g takes the tiles g, g + gridDim.x, ... of 2
// destination rows each.
template <int H, bool POS, bool GATE>
__global__ void __launch_bounds__(rm::THREADS, 1)
    edge_attention_kernel(EdgeArgs a, int B) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int K = a.K, NH = a.n_heads, rows = B * a.N;
  const EdgeLayout lay(H, NH, POS);
  rm::bf16* wkh = reinterpret_cast<rm::bf16*>(dyn + lay.wk_hi);
  rm::bf16* wkl = reinterpret_cast<rm::bf16*>(dyn + lay.wk_lo);
  rm::bf16* wvh = reinterpret_cast<rm::bf16*>(dyn + lay.wv_hi);
  rm::bf16* wvl = reinterpret_cast<rm::bf16*>(dyn + lay.wv_lo);
  float* WV = reinterpret_cast<float*>(dyn + lay.wv);
  float* Pk = reinterpret_cast<float*>(dyn + lay.pk);
  float* Pv = reinterpret_cast<float*>(dyn + lay.pv);
  float* VS = reinterpret_cast<float*>(dyn + lay.vs);
  float* A3 = reinterpret_cast<float*>(dyn + lay.a3);
  const rm::Softmax sm{reinterpret_cast<float*>(dyn + lay.e),
                       reinterpret_cast<float*>(dyn + lay.sc),
                       reinterpret_cast<float*>(dyn + lay.m),
                       reinterpret_cast<float*>(dyn + lay.l)};
  float* Q = reinterpret_cast<float*>(dyn + lay.q);
  float* scratch = reinterpret_cast<float*>(dyn + lay.scratch);
  const EdgeTile et{reinterpret_cast<float*>(dyn + lay.rbf),
                    reinterpret_cast<float*>(dyn + lay.dist),
                    reinterpret_cast<int*>(dyn + lay.src),
                    reinterpret_cast<int*>(dyn + lay.valid),
                    reinterpret_cast<float*>(dyn + lay.coef),
                    reinterpret_cast<float*>(dyn + lay.rel),
                    reinterpret_cast<int*>(dyn + lay.ta),
                    reinterpret_cast<int*>(dyn + lay.tb)};

  rm::stage_wo<H>(a.k.wo, wkh, wkl);
  if (POS) {  // Wo_v [H][NH], float32
    for (int e = threadIdx.x; e < H * NH; e += rm::THREADS)
      WV[e] = __ldg(a.v.wo + e);
  } else {
    rm::stage_wo<H>(a.v.wo, wvh, wvl);
  }
  const float scale = 1.f / sqrtf((float)(H / NH));
  const int c = threadIdx.x % H;
  // the tile row of this thread's pre-phase rows
  const int il_t = (threadIdx.x / H) * (rm::TILE * H / rm::THREADS) / rm::KC;
  const int n_tiles = (rows + rm::TI - 1) / rm::TI;

  // A tile without a valid edge skips all its chunks and writes zeros.
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * rm::TI, n_rows = min(rm::TI, rows - row0);
    float* out0 = a.out + (size_t)row0 * (POS ? 3 : H);
    const bool in_t = il_t < n_rows;
    const size_t t_off = (size_t)(row0 + il_t) * H + c;
    const float trk = in_t ? a.k.t_row[t_off] : 0.f;
    const float trv = in_t ? a.v.t_row[t_off] : 0.f;
    float acc = 0.f;

    for (int k0 = 0; k0 < max(K, 1); k0 += rm::KC) {  // K = 0: one empty
      __syncthreads();  // the last chunk (tile) is done with the shared data
      if (k0 == 0) {    // the tile's rows: q and the softmax state
        for (int e = threadIdx.x; e < rm::TI * H; e += rm::THREADS)
          Q[e] = e / H < n_rows ? a.q[(size_t)row0 * H + e] : 0.f;
        rm::softmax_reset(sm, NH);
        if (POS)
          for (int e = threadIdx.x; e < rm::TI * NH * 3; e += rm::THREADS)
            A3[e] = 0.f;
      }
      const int live = edge_tile_setup(a, et, row0, rows, k0);
      if (!__syncthreads_or(live)) continue;  // no valid edge in the chunk
      // RBF q of row r by thread r + TILE * j: q is uniform over a warp
      for (int u = threadIdx.x; u < rm::TILE * R; u += rm::THREADS) {
        const int r = u % rm::TILE, q = u / rm::TILE;
        const float v = et.dist[r] - kRbfOffsets[q];
        et.rbf[r * R + q] = expf(-0.5f * v * v);
      }
      __syncthreads();

      // both branches: first linear, LayerNorm and relu, second linear
      edge_tile_pre<H>(a, et, trk, trv, Pk, Pv);
      __syncthreads();
      rm::ln_relu<H, rm::kHiLo>(Pk, a.k.lns, a.k.lnb);
      rm::ln_relu<H, POS ? rm::kF32 : rm::kHiLo>(Pv, a.v.lns, a.v.lnb);
      __syncthreads();
      if (POS) {  // k on the tensor cores, then v's [H, heads] on CUDA cores
        rm::tile_product<H, true>(Pk, wkh, wkl, a.k.bo);
        rm::tile_heads<H>(Pv, WV, a.v.bo, NH, VS);
      } else {    // warps 0-7 take k, warps 8-15 v
        const int g = threadIdx.x / (rm::THREADS / 2);
        rm::tile_product<H, true, rm::WARPS / 2>(
            g ? Pv : Pk, g ? wvh : wkh, g ? wvl : wkl, g ? a.v.bo : a.k.bo,
            (threadIdx.x >> 5) % (rm::WARPS / 2));
      }
      // the logits and the online softmax; the m-gate
      rm::chunk_logits<H>(Pk, Q, et.valid, NH, scale, sm);
      if (GATE) edge_gate<H>(Pv, a.gate, et.coef);
      __syncthreads();
      // the sums of alpha v
      if (POS)
        rm::chunk_acc_pos(VS, sm, et.coef, et.rel, A3, NH);
      else
        acc = rm::chunk_acc_node<H>(acc, Pv, sm, et.coef, NH);
    }
    if (POS) {
      __syncthreads();
      rm::finish_pos(sm, A3, NH, out0, n_rows);
    } else {
      rm::finish_node<H>(acc, sm, NH, scratch, out0, H, n_rows);
    }
  }
}

// ---------------------------------------------------------------------------
// forward at the other widths: per-row kernel of row_attention.cuh
// ---------------------------------------------------------------------------

// One block per destination row (b, i), one thread per channel. WIDE: the
// block may have up to 1024 threads (H > 256).
template <bool GATE, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : 256)
    edge_attention_row_kernel(EdgeArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ EdgeChunk ch;

  const int H = a.H, K = a.K, N = a.N;
  const bool pos = a.pos != 0;
  float* Yk = smem;
  float* Yv = Yk + CH * H;
  float* Vs = Yv + CH * H;
  Gate gt = a.gate;
  if constexpr (GATE) {
    gt.red = Vs + CH * a.n_heads;
    gt.g = gt.red + (H / 32) * CH;
  }
  const int row = blockIdx.x;  // b * N + i
  const int b = row / N;
  const int c = threadIdx.x;
  float* out_row = a.out + (size_t)row * (pos ? 3 : H);

  if (!row_has_source(a.mask + (size_t)row * K, K)) {
    zero_row(out_row, pos);
    return;
  }

  const float q_c = a.q[(size_t)row * H + c];
  const float tk = a.k.t_row[(size_t)row * H + c];
  const float tv = a.v.t_row[(size_t)row * H + c];
  const EdgeRow dst = edge_row(a, row);
  const float scale = 1.f / sqrtf((float)(H / a.n_heads));
  RowState st;

  for (int m0 = 0; m0 < K; m0 += CH) {
    const int nm = min(CH, K - m0);
    edge_chunk_setup(a, ch, row, b, m0, nm, dst);
    __syncthreads();
    edge_chunk_pre(a, ch, b, tk, tv, Yk, Yv);
    __syncthreads();
    finish_chunk<GATE>(Yk, Yv, Vs, a.k, a.v, ch.cs, nm, H, a.n_heads, pos,
                       q_c, scale, st, gt);
  }
  finalize(st, out_row, Vs, H, a.n_heads, pos);
}

template <bool GATE, bool WIDE>
cudaError_t launch_row(const EdgeArgs& a, int rows, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(edge_attention_row_kernel<GATE, WIDE>, smem);
  if (err != cudaSuccess) return err;
  edge_attention_row_kernel<GATE, WIDE><<<rows, a.H, smem, stream>>>(a);
  return cudaGetLastError();
}

// The per-row forward: [CH][H] pre of both branches and [CH][heads] v (pos
// mode), plus with the gate its block-sum scratch and the chunk's CH gates.
cudaError_t launch_fwd_row(const EdgeArgs& a, int B, cudaStream_t stream) {
  const bool gate = a.gate.wm != nullptr, wide = a.H > 256;
  const size_t smem =
      smem_bytes(a.H, a.n_heads, 0) +
      (gate ? sizeof(float) * ((size_t)(a.H / 32) * CH + CH) : 0);
  const int rows = B * a.N;
  if (gate)
    return wide ? launch_row<true, true>(a, rows, smem, stream)
                : launch_row<true, false>(a, rows, smem, stream);
  return wide ? launch_row<false, true>(a, rows, smem, stream)
              : launch_row<false, false>(a, rows, smem, stream);
}

struct EdgeBwdArgs {
  EdgeArgs f;            // forward inputs (f.out unused)
  const float* g;        // [B, N, H] or [B, N, 3] output cotangent
  const float* woT_k;    // [H, H] transposed Wo_k
  const float* woT_v;    // [H, H] transposed Wo_v (node mode only)
  float* d_x;            // [B, N, 3]   zeroed; atomics (destinations)
  float* d_xs;           // [B, N, 3]   zeroed; atomics (sources; d_x when
                         //             xs is x)
  float* d_ew;           // [B, N, K]
  float* d_q;            // [B, N, H]
  float* d_trow_k;       // [B, N, H]
  float* d_tsrc_k;       // [B, N, H]   zeroed; atomics
  float* d_trow_v;
  float* d_tsrc_v;
  float* slots;          // [gridDim.x][P] zeroed parameter-gradient slots
  int rows;              // B * N
  float* scratch;        // row buffers in device memory (SCRATCH kernels)
  int per_block;         //   floats of them per block
};

// The backward of the rows of block blockIdx.x. SCRATCH: the row buffers in
// a.scratch (row_attention_bwd.cuh).
template <bool GATE, bool SCRATCH>
__device__ __forceinline__ void edge_bwd_rows(const EdgeBwdArgs& a) {
  using namespace rowbwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ EdgeChunk ch;
  __shared__ float s_coef[CH][R];  // d rbf / d dist

  const EdgeArgs& f = a.f;
  const int H = f.H, K = f.K, N = f.N, F = f.n_types, nh = f.n_heads;
  const bool pos = f.pos != 0;
  const int c = threadIdx.x;
  const RowSmem s = carve(row_base<SCRATCH>(smem, a.scratch, a.per_block),
                          K, H, nh, GATE);
  const float scale = 1.f / sqrtf((float)(H / nh));
  GradSlot sk, sv;
  block_slots(a.slots, F * (R + 1), H, pos ? nh : H, sk, sv,
              GATE ? H + 1 : 0);
  SmallGrads acc;
  float gw = 0.f, gb = 0.f;  // this block's d wm[c] and d bm (GATE)

  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const int b = row / N;
    if (!row_has_source(f.mask + (size_t)row * K, K)) {
      a.d_q[(size_t)row * H + c] = 0.f;
      a.d_trow_k[(size_t)row * H + c] = 0.f;
      a.d_trow_v[(size_t)row * H + c] = 0.f;
      for (int t = c; t < K; t += blockDim.x) a.d_ew[(size_t)row * K + t] = 0.f;
      continue;
    }
    const float q_c = f.q[(size_t)row * H + c];
    const float tk = f.k.t_row[(size_t)row * H + c];
    const float tv = f.v.t_row[(size_t)row * H + c];
    const EdgeRow dst = edge_row(f, row);
    float g_c = 0.f, g3[3] = {0.f, 0.f, 0.f};
    if (pos)
      for (int d = 0; d < 3; ++d) g3[d] = a.g[(size_t)row * 3 + d];
    else
      g_c = a.g[(size_t)row * H + c];

    // pass A: logits, k, and the v part of d alpha
    for (int m0 = 0; m0 < K; m0 += CH) {
      const int nm = min(CH, K - m0);
      edge_chunk_setup(f, ch, row, b, m0, nm, dst);
      if (c < nm) {
        s.VL[m0 + c] = ch.cs.valid[c] ? 1.f : 0.f;
        s.EW[m0 + c] = ch.cs.ew[c];
        s.GR[m0 + c] = ch.cs.rel[c * 3] * g3[0] + ch.cs.rel[c * 3 + 1] * g3[1] +
                       ch.cs.rel[c * 3 + 2] * g3[2];
      }
      __syncthreads();
      edge_chunk_pre(f, ch, b, tk, tv, s.Yk, s.Yv);
      __syncthreads();
      pass_a_chunk<GATE>(s, f.k, f.v, m0, nm, H, nh, pos, q_c, g_c, scale,
                         f.gate);
    }
    head_stage<GATE>(s, K, nh, pos);
    a.d_q[(size_t)row * H + c] = row_d_q(s, K, H, nh, scale);
    for (int t = c; t < K; t += blockDim.x)
      a.d_ew[(size_t)row * K + t] = s.DEW[t];
    if constexpr (GATE)
      for (int m = 0; m < K; ++m) {  // d wm = sum d s vraw, d bm = sum d s
        gw = fmaf(s.DS[m], s.VR[m * H + c], gw);
        gb += s.DS[m];
      }

    // pass B: both branches back to d pre, then the edge features
    float trow_k = 0.f, trow_v = 0.f;
    float dxd[3] = {0.f, 0.f, 0.f};  // d x of the destination (threads < CH)
    for (int m0 = 0; m0 < K; m0 += CH) {
      const int nm = min(CH, K - m0);
      edge_chunk_setup(f, ch, row, b, m0, nm, dst);
      if (c < CH)
        for (int r = 0; r < R; ++r)
          s_coef[c][r] = -(ch.dist[c] - kRbfOffsets[r]) * ch.rbf[c][r];
      __syncthreads();
      edge_chunk_pre(f, ch, b, tk, tv, s.Yk, s.Yv);
      __syncthreads();
      pass_b_chunk<GATE>(s, f.k, f.v, a.woT_k, a.woT_v, sk, sv, acc, m0, nm,
                         H, nh, pos, q_c, g_c, scale, trow_k, trow_v, f.gate);

      // source-node cotangent of t_src
      for (int m = 0; m < nm; ++m) {
        if (!ch.cs.valid[m]) continue;  // uniform over the block
        const size_t srow = ((size_t)b * N + ch.cs.src[m]) * H + c;
        atomicAdd(a.d_tsrc_k + srow, s.Dk[m * H + c]);
        atomicAdd(a.d_tsrc_v + srow, s.Dv[m * H + c]);
      }

      // d w_feat and d dist, one edge type at a time
      float sd[CH];
#pragma unroll
      for (int m = 0; m < CH; ++m) sd[m] = 0.f;
      for (int t = 0; t < F; ++t) {
        bool present = false;
        for (int m = 0; m < nm; ++m)
          present |= ch.cs.valid[m] && has_type(ch, m, t);
        if (!present) continue;  // uniform over the block
        float wk[R], wv[R], gk[R], gv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          wk[r] = __ldg(f.k.w_feat + (size_t)(t * R + r) * H + c);
          wv[r] = __ldg(f.v.w_feat + (size_t)(t * R + r) * H + c);
          gk[r] = 0.f;
          gv[r] = 0.f;
        }
        float ck = 0.f, cv = 0.f;
#pragma unroll
        for (int m = 0; m < CH; ++m) {
          if (m >= nm || !ch.cs.valid[m] || !has_type(ch, m, t)) continue;
          const float dk = s.Dk[m * H + c], dv = s.Dv[m * H + c];
          ck += dk;
          cv += dv;
          float e = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            gk[r] = fmaf(ch.rbf[m][r], dk, gk[r]);
            gv[r] = fmaf(ch.rbf[m][r], dv, gv[r]);
            e = fmaf(s_coef[m][r], fmaf(dk, wk[r], dv * wv[r]), e);
          }
          sd[m] += e;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          slot_add(sk.wfeat + (size_t)(t * R + r) * H + c, gk[r]);
          slot_add(sv.wfeat + (size_t)(t * R + r) * H + c, gv[r]);
        }
        slot_add(sk.wfeat + (size_t)(F * R + t) * H + c, ck);
        slot_add(sv.wfeat + (size_t)(F * R + t) * H + c, cv);
      }
      const float d_dist = block_sum_ch(sd, s.RED);

      // d rel = d dist * rel / dist (+ pos mode: WR * g) -> both endpoints
      if (c < nm && ch.cs.valid[c]) {
        const float fd = d_dist * ch.dgrad[c];
        const float wr = pos ? s.WR[m0 + c] : 0.f;
        const size_t src = (size_t)b * N + ch.cs.src[c];
        for (int d = 0; d < 3; ++d) {
          const float dr = fd * ch.cs.rel[c * 3 + d] + wr * g3[d];
          dxd[d] += dr;
          atomicAdd(a.d_xs + src * 3 + d, -dr);
        }
      }
      __syncthreads();  // the next chunk overwrites ch and the buffers
    }
    a.d_trow_k[(size_t)row * H + c] = trow_k;
    a.d_trow_v[(size_t)row * H + c] = trow_v;
    if (c < 32)
      for (int d = 0; d < 3; ++d) {
        const float t = warp_sum(c < CH ? dxd[d] : 0.f);
        if (c == 0) atomicAdd(a.d_x + (size_t)row * 3 + d, t);
      }
  }
  flush_small(acc, sk, sv, nh, pos);
  if constexpr (GATE) {
    float* sg = sv.lnb + H;  // the gate's slot: d wm [H], then d bm
    sg[c] = gw;
    if (c == 0) sg[H] = gb;
  }
}

// The 256-thread build (H <= 256) and the 1024-thread build
// (row_attention_bwd.cuh).
template <bool GATE, bool SCRATCH>
__global__ void edge_attention_bwd_kernel(EdgeBwdArgs a) {
  edge_bwd_rows<GATE, SCRATCH>(a);
}

template <bool GATE>
__global__ void __launch_bounds__(1024, 1)
    edge_attention_bwd_wide_kernel(EdgeBwdArgs a) {
  edge_bwd_rows<GATE, true>(a);
}

// One block per SM (at most one per tile).
template <int H>
cudaError_t launch_fwd(const EdgeArgs& a, int B, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = EdgeLayout(H, a.n_heads, a.pos != 0).bytes;
  void (*kernel)(EdgeArgs, int) = edge_attention_kernel<H, false, false>;
  if (a.pos)
    kernel = edge_attention_kernel<H, true, false>;
  else if (a.gate.wm)
    kernel = edge_attention_kernel<H, false, true>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (B * a.N + rm::TI - 1) / rm::TI;
  kernel<<<std::min(sms, tiles), rm::THREADS, smem, stream>>>(a, B);
  return cudaGetLastError();
}

// The backward kernel of width H, with or without the gate, with its row
// buffers in the scratch or in shared memory (H <= 256; the 1024-thread
// build always takes the scratch).
using EdgeBwdKernel = void (*)(EdgeBwdArgs);
EdgeBwdKernel bwd_kernel(bool gate, int H, bool scratch) {
  if (H > 256)
    return gate ? edge_attention_bwd_wide_kernel<true>
                : edge_attention_bwd_wide_kernel<false>;
  if (gate)
    return scratch ? edge_attention_bwd_kernel<true, true>
                   : edge_attention_bwd_kernel<true, false>;
  return scratch ? edge_attention_bwd_kernel<false, true>
                 : edge_attention_bwd_kernel<false, false>;
}

}  // namespace

// Forward. xs: the sources' coordinates (x when the caller has no separate
// table). H in 32, 64, 128: the tensor-core kernel; any other width the
// wrapper admits: the per-row kernel. *row: 1 when the per-row kernel was
// launched, else 0 (the wrapper counts the route from it).
extern "C" int edge_attention_fwd(
    const float* x, const float* xs, const float* lig, const float* group,
    const int* idx,
    const float* mask, const float* ew, const float* q,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb, const float* wm, const float* bm,
    float* out, int* row, int B, int N, int K, int H, int n_heads,
    int n_types, int pos, void* stream) {
  *row = 0;
  if (B * N == 0) return 0;
  if (wm && pos) return (int)cudaErrorInvalidValue;  // the gate is node-only
  EdgeArgs a{x, xs, lig, group, idx, mask, ew, q,
             Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
             Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
             out, N, K, H, n_heads, n_types, pos, Gate{wm, bm}};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 32: return (int)launch_fwd<32>(a, B, s);
    case 64: return (int)launch_fwd<64>(a, B, s);
    case 128: return (int)launch_fwd<128>(a, B, s);
    default: *row = 1; return (int)launch_fwd_row(a, B, s);
  }
}

// Floats per block of the device-memory scratch that the backward needs at
// these sizes (0: its row buffers fit in shared memory); gate: the m-gated
// kernel.
extern "C" int edge_attention_bwd_scratch(int* per_block, int K, int H,
                                          int n_heads, int gate) {
  return (int)rowbwd::scratch_floats(
      bwd_kernel(gate != 0, H, false), H,
      rowbwd::row_smem_floats(K, H, n_heads, gate != 0), per_block);
}

// Backward: G blocks over the B*N rows, then the fixed-order slot sum into
// d_params ([k: w_feat, wo, bo, ln_scale, ln_bias | v: the same] and, with
// the gate, [d wm (H) | d bm]). d_xs: the sources' coordinate cotangent, a
// zeroed buffer of its own when xs is not x, else d_x. scratch: G times
// edge_attention_bwd_scratch's floats, or null when that is 0. *route: 1
// when the row buffers went to the scratch, else 0.
extern "C" int edge_attention_bwd(
    const float* x, const float* xs, const float* lig, const float* group,
    const int* idx, const float* mask, const float* ew, const float* q,
    const float* g,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb, const float* k_woT,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb, const float* v_woT, const float* wm, const float* bm,
    float* d_x, float* d_xs, float* d_ew, float* d_q, float* d_trow_k,
    float* d_tsrc_k,
    float* d_trow_v, float* d_tsrc_v, float* slots, float* d_params,
    float* scratch, int* route, int B, int N, int K, int H, int n_heads,
    int n_types, int pos, int G, void* stream) {
  *route = 0;
  if (B * N == 0 || G <= 0) return 0;
  if (wm && pos) return (int)cudaErrorInvalidValue;  // the gate is node-only
  EdgeBwdArgs a{
      EdgeArgs{x, xs, lig, group, idx, mask, ew, q,
               Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
               Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
               nullptr, N, K, H, n_heads, n_types, pos, Gate{wm, bm}},
      g, k_woT, v_woT, d_x, d_xs, d_ew, d_q, d_trow_k, d_tsrc_k, d_trow_v,
      d_tsrc_v, slots, B * N, nullptr, 0};
  const bool gate = wm != nullptr;
  cudaError_t err = rowbwd::launch_rows(
      bwd_kernel(gate, H, false), bwd_kernel(gate, H, true), a, G,
      rowbwd::row_smem_floats(K, H, n_heads, gate), scratch, route,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int F = n_types * (R + 1);
  const size_t P = rowbwd::branch_slot_floats(F, H, H) +
                   rowbwd::branch_slot_floats(F, H, pos ? n_heads : H) +
                   (gate ? H + 1 : 0);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P,
                                    (cudaStream_t)stream);
}
