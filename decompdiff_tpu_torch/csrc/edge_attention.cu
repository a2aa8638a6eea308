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
// device memory. The backward, head-factorized, needs no per-edge [H, H]
// product: its least work is the edge features' first linears, d w_feat
// and distance chain on the CUDA cores (chip_smoke.py edge_backward_work).
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
// Destination-row window (both forward kernels): the launch may compute
// only rows start .. start + count - 1 of every molecule (the refine nets'
// coordinate attention keeps only the update of the rows after the protein
// block). Rows outside the window are written 0 by the same launch, a
// grid-stride fill before the tiles (no separate memset). The tile map
// walks only the window's tiles: B * ceil(count / 2) of them, tile t of
// molecule b at rows b * N + start + 2 t and the next, the second masked
// when count is odd. Without a window the whole batch is one block of
// B * N rows, the flat map of every tile. A tile computes its rows as
// ever (a row's arithmetic never reads its tile partner's), so each window
// row's output is bitwise that of the launch without the window. The
// per-row kernel keeps its one block per row; a block outside the window
// writes its zeros and returns.
// The backward kernels take the window only to read the cotangent's rows
// outside it as 0, which gives the gradient of the windowed forward with
// no copy of the cotangent (no extra launch). They still walk every row:
// in the refine nets that cotangent is 0 there already, and skipping those
// rows would save device time only in training, which the host paces.
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
// Backward: the TPU kernel scatter-adds the source-node cotangents with a
// one-hot matmul over its sequential grid; here d t_src and d x[src] are
// atomicAdds into zeroed buffers (their order varies between runs, within
// float32 rounding). Every parameter gradient is summed per block, each
// element by one thread in row order, then over the blocks' slots in a
// fixed order, so two launches give bitwise-equal parameter gradients.
// The distance chain gives 0 where |x_i - x_s|^2 < 1e-12, like the clamp of
// the plain version's safe_norm.
//
// Backward design, H in 32, 64, 128 with at most 16 heads and K up to 64
// (head_bwd.cuh, as the triplet backward): q and the output cotangent g
// belong to the destination row, so the cotangents of k and v factorize by
// head and the [H, H] products move to the row (Qk, Gv, d q, d Wo of both
// branches; pos mode: Qk, d q, d Wo_k, its v branch's Wo_v being [H, heads]
// already). A persistent grid of one 512-thread block per SM over
// contiguous ranges of destination rows; a row's sources go in chunks of
// 32: pass A rebuilds pre of both branches (t_row, the gathered t_src and
// the typed RBF product, in the channel map), LayerNorm and relu (warp
// map), and forms the logits and d alpha (pos mode: v) on the tensor cores
// (three tf32 passes); the softmax and its backward per head; pass B forms
// the head sums Yd, Ya, d y of both branches heads-wide, the relu and
// LayerNorm backward to d pre, then d t_row, d t_src, d w_feat and the
// distance chain to d x. With one chunk (K <= 32, the released shapes) y
// stays in the tiles and xhat in registers from pass A to pass B, so pre is
// built once a row. d Wo of both branches stays in shared memory ([H][H+1]
// each, 129 KB at H = 128) until the block ends; d w_feat (84 or 126 rows
// of both branches) does not fit beside it. A row touches at most four
// edge types (its own ligand flag fixes two of the four 4-way types, and
// groups add two), so each thread sums, for every source of the row, its
// 1/P share of each such type's 21 rows at its channel in registers (the
// same work in every thread, whatever the mix of types), and adds them to
// the block's device-memory slot once a chunk (a row at K <= 32), a
// coalesced reduction per row of w_feat. The distance chain needs d pre /
// d dist per source and channel: pass A forms it beside pre, where each
// type's weights are in registers already, and keeps it in registers. The
// m-gate adds the heads-wide vector Wo_v wm: s per source in the warp map,
// d s Wo_v wm in d y_v, and Ys = sum d s y_v summed over the block's rows,
// from which d wm and the gate's part of d Wo_v follow once at the end.
// What bounds it (clock64 phase counts, scripts/profile_torch_edge_bwd.py,
// PERF.md): latency between the block's barriers, at 128 registers with a
// few hundred bytes of spills at H = 128; rebuilding pre and the d w_feat
// sums take about two fifths of the cycles, Qk and Gv (Wo through L2) a
// tenth.
//
// Backward design at every other width (row_attention_bwd.cuh): a fixed
// grid of two blocks per SM, each looping over destination rows with one
// thread per channel, recomputes every per-edge intermediate in shared
// memory (nothing per edge is saved by the forward), with the [H, H]
// products per source on the CUDA cores; d w_feat is accumulated per edge
// type, only for the 21 (42) rows of each edge's own types. Blocks of H >
// 256 threads take a 1024-thread build; where the row buffers do not fit
// in shared memory (H >= 512, or large K) they live in a device-memory
// scratch that the wrapper allocates (row_attention_bwd.cuh).
//
// The m-gate (uni_o2, ew_net_type 'm') is the template parameter GATE of
// both kernels; the launchers take it when wm is not null. In the forward
// its dot product over the H channels of each source is a warp reduction
// (edge_gate); the backward keeps each source's gate and
// v before the gate in shared memory, and sums d wm and d bm per block in
// registers into a slot of their own after the v branch's.
#include "head_bwd.cuh"
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

// The destination rows a forward launch computes: rows start .. start +
// count - 1 of each of `mols` blocks of `stride` rows. A window of every
// molecule has mols = B, stride = N; no window is one block of every row
// (mols = 1, stride = count = B * N, start = 0).
struct RowWindow {
  int mols, stride, start, count;
  __host__ __device__ int tiles_per_mol() const {
    return (count + rm::TI - 1) / rm::TI;
  }
  __device__ bool holds(int row) const {
    const int i = row % stride;
    return i >= start && i < start + count;
  }
};

// The window of rows start .. start + count - 1 of each of B molecules of
// N rows; (0, N) is the one block of every row.
RowWindow row_window(int B, int N, int start, int count) {
  return start == 0 && count == N ? RowWindow{1, B * N, 0, B * N}
                                  : RowWindow{B, N, start, count};
}

// Zeros of the rows outside the window, `width` floats a row, over the
// launch's threads (none when the window holds every row). No barrier.
__device__ __forceinline__ void zero_outside(const RowWindow& w, float* out,
                                             int width) {
  const int gap = w.stride - w.count;  // rows outside, per block of rows
  const size_t n = (size_t)w.mols * gap * width;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / width), j = r % gap;
    const int row = r / gap * w.stride + (j < w.start ? j : j + w.count);
    out[(size_t)row * width + e % width] = 0.f;
  }
}

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
// row0 + r / KC). Rows outside the tile (row >= row_end) and sources
// beyond K get node 0 and weigh nothing. Returns the thread's validity. No
// barrier.
__device__ __forceinline__ int edge_tile_setup(const EdgeArgs& a,
                                               const EdgeTile& t, int row0,
                                               int row_end, int k0) {
  const int r = threadIdx.x;
  if (r >= rm::TILE) return 0;
  const int row = row0 + r / rm::KC, k = k0 + r % rm::KC;
  int s_flat = 0, ok = 0, ta = 3, tb = -1;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, d = 0.f, w = 1.f;
  if (row < row_end && k < a.K) {
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

// Persistent: block g takes the tiles g, g + gridDim.x, ... of the
// window's 2 destination rows each, after its share of the zeros outside.
template <int H, bool POS, bool GATE>
__global__ void __launch_bounds__(rm::THREADS, 1)
    edge_attention_kernel(EdgeArgs a, RowWindow w) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int K = a.K, NH = a.n_heads;
  zero_outside(w, a.out, POS ? 3 : H);
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
  const int per_mol = w.tiles_per_mol(), n_tiles = w.mols * per_mol;

  // A tile without a valid edge skips all its chunks and writes zeros.
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int j = tile % per_mol * rm::TI;  // the tile's first window row
    const int row0 = tile / per_mol * w.stride + w.start + j;
    const int n_rows = min(rm::TI, w.count - j);
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
      const int live = edge_tile_setup(a, et, row0, row0 + n_rows, k0);
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

// One block per destination row (b, i), one thread per channel; a row
// outside the window is written 0. WIDE: the block may have up to 1024
// threads (H > 256).
template <bool GATE, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : 256)
    edge_attention_row_kernel(EdgeArgs a, RowWindow w) {
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

  if (!w.holds(row) || !row_has_source(a.mask + (size_t)row * K, K)) {
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
cudaError_t launch_row(const EdgeArgs& a, const RowWindow& w, int rows,
                       size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(edge_attention_row_kernel<GATE, WIDE>, smem);
  if (err != cudaSuccess) return err;
  edge_attention_row_kernel<GATE, WIDE><<<rows, a.H, smem, stream>>>(a, w);
  return cudaGetLastError();
}

// The per-row forward: [CH][H] pre of both branches and [CH][heads] v (pos
// mode), plus with the gate its block-sum scratch and the chunk's CH gates.
cudaError_t launch_fwd_row(const EdgeArgs& a, const RowWindow& w, int B,
                           cudaStream_t stream) {
  const bool gate = a.gate.wm != nullptr, wide = a.H > 256;
  const size_t smem =
      smem_bytes(a.H, a.n_heads, 0) +
      (gate ? sizeof(float) * ((size_t)(a.H / 32) * CH + CH) : 0);
  const int rows = B * a.N;
  if (gate)
    return wide ? launch_row<true, true>(a, w, rows, smem, stream)
                : launch_row<true, false>(a, w, rows, smem, stream);
  return wide ? launch_row<false, true>(a, w, rows, smem, stream)
              : launch_row<false, false>(a, w, rows, smem, stream);
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
  RowWindow win;         // the forward's window: g reads 0 outside it
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
    if (a.win.holds(row)) {
      if (pos)
        for (int d = 0; d < 3; ++d) g3[d] = a.g[(size_t)row * 3 + d];
      else
        g_c = a.g[(size_t)row * H + c];
    }

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

// ---------------------------------------------------------------------------
// backward, H in 32, 64, 128: head-factorized (head_bwd.cuh)
// ---------------------------------------------------------------------------

namespace hb = headbwd;

// Pair rows of the chunk that one thread of the channel map builds.
template <int H>
struct PreRows {
  static constexpr int RPT = hb::KC * H / hb::THREADS;
};

// Offsets into the head-factorized backward's dynamic shared memory, fixed
// at compile time (sized for KMAX sources and MAXNH heads).
template <int H>
struct EdgeHeadLayout {
  static constexpr int KMAX = 64;  // sources a row: two chunks
  static constexpr size_t F = sizeof(float);
  static constexpr int MS = hb::mstride(H), TS = hb::tstride(H);
  static constexpr size_t dwo = 0;                            // [2][H][MS]
  static constexpr size_t tk = dwo + F * 2 * H * MS;          // [KC][TS]
  static constexpr size_t tv = tk + F * hb::KC * TS;
  static constexpr size_t m = tv + F * hb::KC * TS;           // [2 MAXNH][MS]
  static constexpr size_t lg = m + F * 2 * hb::MAXNH * MS;    // [KMAX][NH]
  static constexpr size_t da = lg + F * KMAX * hb::MAXNH;
  static constexpr size_t cv = da + F * KMAX * hb::MAXNH;
  static constexpr size_t rbf = cv + F * KMAX * hb::MAXNH;    // [TILE][R]
  static constexpr size_t cf = rbf + F * hb::KC * R;          // [KC][R]
  static constexpr size_t e = cf + F * hb::KC * R;            // [WARPS][RPT]
  static constexpr size_t vec = e + F * hb::WARPS * PreRows<H>::RPT;  // [4][H]
  static constexpr size_t hs = vec + F * 4 * H;               // [6][MAXNH]
  static constexpr size_t sc = hs + F * 6 * hb::MAXNH;        // [6][TILE]
  static constexpr size_t rel = sc + F * 6 * rm::TILE;        // [TILE][3]
  static constexpr size_t src = rel + F * 3 * rm::TILE;       // [6][KMAX]
  static constexpr size_t bytes = src + F * 6 * KMAX;
  static_assert(rbf % 16 == 0 && tk % 16 == 0 && m % 16 == 0, "aligned");
};

// The edge type that d w_feat slot s of a destination row sums: 0, 1: the
// 4-way type of a ligand, a protein source (they depend on the row's own
// ligand flag), 2, 3: the group types 4, 5.
__device__ __forceinline__ int slot_type(int slot, int lig_d) {
  return slot < 2 ? 2 * slot + (lig_d ? 0 : 1) : slot + 2;
}

// One branch's first-linear outputs of the chunk's KC pair rows into P (row
// stride tstride): t_row + the gathered t_src + the edge-feature product,
// type by type, only for the rows of each type, in edge_tile_pre's order
// of operations (one branch at a time: the backward has no registers for
// both branches' weights). With the type's weights at hand, z[m] <- d pre
// / d dist of the thread's row m at its channel (the RBF rows of the row's
// types times CF, d rbf / d dist), for the distance chain of pass B.
// Thread t: channel t % H of RPT consecutive rows (a warp shares its rows,
// so the type tests are uniform over it). No barrier.
template <int H>
__device__ __forceinline__ void edge_tile_pre_branch(
    const Branch& br, const EdgeTile& t, const float* CF, int F, float tr,
    float* P, float (&z)[PreRows<H>::RPT]) {
  constexpr int RPT = PreRows<H>::RPT;
  const int c = threadIdx.x % H, r0 = (threadIdx.x / H) * RPT;
  unsigned types = 0;  // the types among the thread's rows
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    types |= 1u << t.ta[r0 + m] | (t.tb[r0 + m] < 0 ? 0u : 1u << t.tb[r0 + m]);
  float p[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    p[m] = tr + __ldg(br.t_src + (size_t)t.src[r0 + m] * H + c);
    z[m] = 0.f;
  }
  for (; types; types &= types - 1) {
    const int ty = __ffs(types) - 1;
    float w[R + 1];
    load_type(w, br.w_feat, F, ty, H, c);
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int r = r0 + m;
      if (t.ta[r] != ty && t.tb[r] != ty) continue;
      const float4* rb = reinterpret_cast<const float4*>(t.rbf + r * R);
      const float4* cb = reinterpret_cast<const float4*>(CF + r * R);
      float s = w[R], e = 0.f;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 b = rb[q], d = cb[q];
        s = fmaf(b.x, w[4 * q], s);
        s = fmaf(b.y, w[4 * q + 1], s);
        s = fmaf(b.z, w[4 * q + 2], s);
        s = fmaf(b.w, w[4 * q + 3], s);
        e = fmaf(d.x, w[4 * q], e);
        e = fmaf(d.y, w[4 * q + 1], e);
        e = fmaf(d.z, w[4 * q + 2], e);
        e = fmaf(d.w, w[4 * q + 3], e);
      }
      p[m] += s;
      z[m] += e;
    }
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m) P[(r0 + m) * hb::tstride(H) + c] = p[m];
}

// The m-gate in the warp map: GT[k0 + r] <- sigmoid(y_v[r] . wvm + bvm) for
// the warp's pair rows r (y_v in T), wvm = Wo_v wm, bvm = bo_v . wm + bm.
// No barrier.
template <int H>
__device__ __forceinline__ void edge_tile_gate(const float* T,
                                               const float* wvm, float bvm,
                                               int k0, int K, float* GT) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < hb::RW; ++s) {
    const float* row = T + (warp + hb::WARPS * s) * hb::tstride(H);
    float d = 0.f;
#pragma unroll
    for (int v = 0; v < H / 32; ++v)
      d = fmaf(row[lane + 32 * v], wvm[lane + 32 * v], d);
    d = rm::warp_sum(d) + bvm;
    const int m = k0 + warp + hb::WARPS * s;
    if (lane == 0 && m < K) GT[m] = 1.f / (1.f + expf(-d));
  }
}

// The chunk's sources k0 .. k0 + KC - 1 of `row`: their scalars (the tile's,
// and VL, EW, pos mode's GRL = rel . g), the RBF features and their
// derivatives in the distance (CF), both branches' pre into Tk and Tv (and
// d pre / d dist of the thread's rows into zk, zv), then their LayerNorm
// and relu (y in the tiles, xhat and 1 / std kept), and the m-gate. Begins
// after a barrier; ends without one.
template <int H, bool POS, bool GATE>
__device__ __forceinline__ void edge_head_chunk(
    const EdgeArgs& f, const EdgeTile& et, float* CF, int row, int k0,
    float trk, float trv, const float* g3, int* VL, float* EW, float* GRL,
    float* GT, const float* wvm, float bvm, float* Tk, float* Tv,
    float (&xhk)[hb::RW][H / 32], float (&rsk)[hb::RW],
    float (&xhv)[hb::RW][H / 32], float (&rsv)[hb::RW],
    float (&zk)[PreRows<H>::RPT], float (&zv)[PreRows<H>::RPT]) {
  const int r = threadIdx.x, K = f.K;
  const int ok = edge_tile_setup(f, et, row, row + 1, k0);
  if (r < hb::KC && k0 + r < K) {
    VL[k0 + r] = ok;
    EW[k0 + r] = et.coef[r];
    if (POS)
      GRL[k0 + r] = et.rel[r * 3] * g3[0] + et.rel[r * 3 + 1] * g3[1] +
                    et.rel[r * 3 + 2] * g3[2];
  }
  __syncthreads();
  for (int u = threadIdx.x; u < hb::KC * R; u += hb::THREADS) {
    const int m = u % hb::KC, q = u / hb::KC;
    const float v = et.dist[m] - kRbfOffsets[q], e = expf(-0.5f * v * v);
    et.rbf[m * R + q] = e;
    CF[m * R + q] = -v * e;
  }
  __syncthreads();
  edge_tile_pre_branch<H>(f.k, et, CF, f.n_types, trk, Tk, zk);
  edge_tile_pre_branch<H>(f.v, et, CF, f.n_types, trv, Tv, zv);
  __syncthreads();
  hb::tile_ln<H>(Tk, f.k.lns, f.k.lnb, xhk, rsk);
  hb::tile_ln<H>(Tv, f.v.lns, f.v.lnb, xhv, rsv);
  if (GATE) edge_tile_gate<H>(Tv, wvm, bvm, k0, K, GT);
}

// Channel map: the chunk's d pre of both branches (tiles Tk, Tv) into the
// thread's d w_feat sums, gk and gv: at channel c, rows r_lo ..
// r_lo + n_r - 1 (an RBF row below R, the type's own row at R) of each of
// the row's edge-type slots (a source's 4-way type is slot 0 for a ligand
// source, 1 for a protein one; its group type 4, 5 slot 2, 3; slot_type).
// Every thread takes every source, so the work does not depend on the
// types' mix. seen: the slots the chunk's valid sources hold. No barrier.
template <int H, int NR>
__device__ __forceinline__ void edge_wfeat_back(const float* Tk,
                                                const float* Tv,
                                                const EdgeTile& t, int r_lo,
                                                int n_r, float (&gk)[4][NR],
                                                float (&gv)[4][NR],
                                                unsigned& seen) {
  const int c = threadIdx.x % H;
  for (int m = 0; m < hb::KC; ++m) {
    if (!t.valid[m]) continue;  // uniform over the block
    const float dk = Tk[m * hb::tstride(H) + c];
    const float dv = Tv[m * hb::tstride(H) + c];
    const int sa = t.ta[m] < 2 ? 0 : 1, sb = t.tb[m] - 2;  // sb < 0: none
    seen |= 1u << sa | (sb < 0 ? 0u : 1u << sb);
    float fr[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = r_lo + i;
      fr[i] = i < n_r ? (r < R ? t.rbf[m * R + r] : 1.f) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s != sa && s != sb) continue;  // uniform over the block
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        gk[s][i] = fmaf(fr[i], dk, gk[s][i]);
        gv[s][i] = fmaf(fr[i], dv, gv[s][i]);
      }
    }
  }
}

// Adds the thread's d w_feat sums of a chunk (edge-type slots `seen`, rows
// r_lo ..) to the block's slot. Each slot element has one adding thread,
// so its sum is taken in row order; a warp's adds are one coalesced
// reduction per row of w_feat.
template <int H, int NR>
__device__ __forceinline__ void flush_wfeat(float (&gw)[4][NR], float* wfeat,
                                            unsigned seen, int F, int lig_d,
                                            int r_lo, int n_r) {
  const int c = threadIdx.x % H;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (seen >> s & 1u) {
      const int ty = slot_type(s, lig_d);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (i >= n_r) break;
        const int r = r_lo + i, rowf = r < R ? ty * R + r : F * R + ty;
        rowbwd::slot_add(wfeat + (size_t)rowf * H + c, gw[s][i]);
      }
    }
  }
}

// Channel map: the distance chain of the thread's pair rows r0 + u (those
// it built pre for): E[warp][u] = sum over the warp's channels of the
// chunk's d pre times d pre / d dist (zk, zv), both branches. No barrier.
template <int H>
__device__ __forceinline__ void edge_dist_partial(
    const float* Tk, const float* Tv, const float (&zk)[PreRows<H>::RPT],
    const float (&zv)[PreRows<H>::RPT], float* E) {
  constexpr int RPT = PreRows<H>::RPT;
  const int c = threadIdx.x % H, r0 = (threadIdx.x / H) * RPT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int o = (r0 + u) * hb::tstride(H) + c;
    const float e = rm::warp_sum(fmaf(Tk[o], zk[u], Tv[o] * zv[u]));
    if (lane == 0) E[warp * RPT + u] = e;
  }
}

// Persistent: block g takes the destination rows [g rows / G, (g + 1) rows
// / G). d Wo of both branches stays in shared memory, transposed, until the
// block ends; d w_feat goes to the block's slot once a chunk of sources.
template <int H, bool POS, bool GATE>
__global__ void __launch_bounds__(hb::THREADS, 1)
    edge_attention_bwd_head_kernel(EdgeBwdArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  using lay = EdgeHeadLayout<H>;
  constexpr int MS = hb::mstride(H), TS = hb::tstride(H), NV = H / 32;
  constexpr int P = hb::Map<H>::P, KMAX = lay::KMAX;
  constexpr int RPT = PreRows<H>::RPT;
  // the rows r_lo .. r_lo + n_r - 1 of each edge type's R + 1 rows of
  // w_feat whose d w_feat this thread sums
  constexpr int NR = (R + 1 + P - 1) / P;
  const EdgeArgs& f = a.f;
  const int K = f.K, NH = f.n_heads, hd = H / NH, F = f.n_types;
  float* DWk = reinterpret_cast<float*>(dyn + lay::dwo);  // [H][MS] d Wo^T
  float* DWv = DWk + H * MS;
  float* Tk = reinterpret_cast<float*>(dyn + lay::tk);    // [KC][TS]: y,
  float* Tv = reinterpret_cast<float*>(dyn + lay::tv);    //   then d pre
  float* M = reinterpret_cast<float*>(dyn + lay::m);      // Qk, then Yd
  float* Mv = M + NH * MS;                                // Gv (pos: Wo_v^T)
  float* LG = reinterpret_cast<float*>(dyn + lay::lg);    // logit, alpha
  float* DA = reinterpret_cast<float*>(dyn + lay::da);    // d alpha, dh
  float* CV = reinterpret_cast<float*>(dyn + lay::cv);    // v's coefficients
  float* CF = reinterpret_cast<float*>(dyn + lay::cf);
  float* E = reinterpret_cast<float*>(dyn + lay::e);
  float* QR = reinterpret_cast<float*>(dyn + lay::vec);   // q of the row
  float* GR = QR + H;                                     // g (pos: [3])
  float* WVM = GR + H;                                    // Wo_v wm
  float* YS = WVM + H;                                    // sum d s y_v
  float* HS = reinterpret_cast<float*>(dyn + lay::hs);    // qb|gb|S dh|S
                                                          // alpha|S cv
  int* sc = reinterpret_cast<int*>(dyn + lay::sc);
  const EdgeTile et{reinterpret_cast<float*>(dyn + lay::rbf),
                    reinterpret_cast<float*>(sc), sc + rm::TILE,
                    sc + 2 * rm::TILE,
                    reinterpret_cast<float*>(sc + 3 * rm::TILE),
                    reinterpret_cast<float*>(dyn + lay::rel),
                    sc + 4 * rm::TILE, sc + 5 * rm::TILE};
  int* VL = reinterpret_cast<int*>(dyn + lay::src);       // [KMAX] each
  float* EW = reinterpret_cast<float*>(VL + KMAX);
  float* GRL = EW + KMAX;                                 // pos: rel . g
  float* GT = GRL + KMAX;                                 // the m-gate
  float* DS = GT + KMAX;                                  // d s
  float* WR = DS + KMAX;                                  // pos: d rel / g
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % H, part = tid / H;
  const float scale = 1.f / sqrtf((float)hd);

  // the block's slot, formed where it is used (no registers hold it)
  const auto slots = [&](rowbwd::GradSlot& gk, rowbwd::GradSlot& gv) {
    rowbwd::block_slots(a.slots, F * (R + 1), H, POS ? NH : H, gk, gv,
                        GATE ? H + 1 : 0);
  };
  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;
  float bvm = 0.f;
  if (POS) {  // the v branch's [H, heads] second linear, as heads rows
    for (int e = tid; e < H * NH; e += hb::THREADS)
      Mv[(e % NH) * MS + e / NH] = __ldg(f.v.wo + e);
    if (tid < NH) HS[hb::MAXNH + tid] = __ldg(f.v.bo + tid);
  }
  if (GATE) {  // Wo_v wm, and bvm = bo_v . wm + bm in every thread
    if (tid < H) {
      float s = 0.f;
      for (int j = 0; j < H; ++j)
        s = fmaf(__ldg(f.v.wo + (size_t)tid * H + j), __ldg(f.gate.wm + j), s);
      WVM[tid] = s;
    }
    for (int j = 0; j < H; ++j)
      bvm = fmaf(__ldg(f.v.bo + j), __ldg(f.gate.wm + j), bvm);
    bvm += __ldg(f.gate.bm);
  }

  // the block's sums over its rows
  float lsk[NV] = {}, lbk[NV] = {}, lsv[NV] = {}, lbv[NV] = {};
  float ywo[hb::MAXHP] = {};           // pos: d Wo_v [H, heads]
  float bo_k = 0.f, bo_v = 0.f, ys = 0.f, dsum = 0.f;
  const int r_lo = part * (R + 1) / P, n_r = (part + 1) * (R + 1) / P - r_lo;
  const int row_end = (int)((long long)(blockIdx.x + 1) * a.rows / gridDim.x);
  __syncthreads();

  for (int row = (int)((long long)blockIdx.x * a.rows / gridDim.x);
       row < row_end; ++row) {
    // a barrier too: the last row is done with the buffers
    if (!row_has_source(f.mask + (size_t)row * K, K)) {
      if (tid < H) {
        a.d_q[(size_t)row * H + tid] = 0.f;
        a.d_trow_k[(size_t)row * H + tid] = 0.f;
        a.d_trow_v[(size_t)row * H + tid] = 0.f;
      }
      for (int t = tid; t < K; t += hb::THREADS)
        a.d_ew[(size_t)row * K + t] = 0.f;
      continue;
    }
    const int lig = f.lig[row] > 0.5f;
    const bool held = a.win.holds(row);
    if (tid < H) {
      QR[tid] = f.q[(size_t)row * H + tid];
      if (!POS) GR[tid] = held ? a.g[(size_t)row * H + tid] : 0.f;
    }
    if (POS && tid < 3) GR[tid] = held ? a.g[(size_t)row * 3 + tid] : 0.f;
    __syncthreads();
    hb::row_matrices<H, POS ? 1 : 2>(f.k.wo, f.v.wo, f.k.bo, f.v.bo, QR, GR,
                                     NH, M, HS, HS + hb::MAXNH);
    const float trk = __ldg(f.k.t_row + (size_t)row * H + c);
    const float trv = __ldg(f.v.t_row + (size_t)row * H + c);
    // one chunk: y stays in the tiles and xhat, 1 / std in registers from
    // pass A to pass B
    const bool one = K <= hb::KC;
    float xh[2][hb::RW][NV], rs[2][hb::RW], zk[RPT], zv[RPT];

    // pass A: logits and the raw v products of every source
    for (int k0 = 0; k0 < K; k0 += hb::KC) {
      __syncthreads();  // M and HS written; the last chunk is done
      edge_head_chunk<H, POS, GATE>(f, et, CF, row, k0, trk, trv, GR, VL, EW,
                                    GRL, GT, WVM, bvm, Tk, Tv, xh[0], rs[0],
                                    xh[1], rs[1], zk, zv);
      __syncthreads();
      hb::head_products_tc<H>(Tk, M, NH, k0, K, scale, HS, LG);
      hb::head_products_tc<H>(Tv, Mv, NH, k0, K, 1.f, HS + hb::MAXNH, DA, 4);
    }
    __syncthreads();
    // d alpha; CV keeps the raw products (node: y_v . Gv + gb, pos: v_h)
    for (int e = tid; e < K * NH; e += hb::THREADS) {
      const int m = e / NH;
      const float raw = DA[e];
      CV[e] = raw;
      DA[e] = raw * (POS ? GRL[m] * EW[m] / NH
                         : EW[m] * (GATE ? GT[m] : 1.f));
    }
    __syncthreads();
    hb::head_softmax(LG, DA, VL, K, NH, HS + 2 * hb::MAXNH);
    __syncthreads();
    // per source: d e_w, the gate's d s, pos mode's d rel / g, and CV <- the
    // v branch's head coefficients (node: e_w gate alpha; pos: d v_h); a
    // thread per (source, head), 16 lanes a source (alpha is 0 at an
    // invalid source)
    for (int u = tid; u < ((K * hb::MAXNH + 31) & ~31); u += hb::THREADS) {
      const int m = u / hb::MAXNH, h = u % hb::MAXNH;
      const bool in = m < K && h < NH;
      const float al = in ? LG[m * NH + h] : 0.f;
      float dew = in ? al * CV[m * NH + h] : 0.f;
      for (int o = hb::MAXNH / 2; o > 0; o >>= 1)
        dew += __shfl_xor_sync(0xffffffffu, dew, o);
      float cf = in ? EW[m] : 0.f;
      const bool lead = h == 0 && m < K;
      if (POS) {
        cf *= in ? GRL[m] / NH : 0.f;
        if (lead) {
          a.d_ew[(size_t)row * K + m] = dew * GRL[m] / NH;
          WR[m] = dew * EW[m] / NH;
        }
      } else if (GATE) {
        const float gt = in ? GT[m] : 0.f;
        cf *= gt;
        if (lead) {
          DS[m] = EW[m] * dew * gt * (1.f - gt);
          a.d_ew[(size_t)row * K + m] = dew * gt;
        }
      } else if (lead) {
        a.d_ew[(size_t)row * K + m] = dew;
      }
      if (in) CV[m * NH + h] = al * cf;
    }
    __syncthreads();
    if (warp < NH) {  // S cv[h] = sum_m CV[m][h]
      float s = 0.f;
      for (int m = lane; m < K; m += 32) s += CV[m * NH + warp];
      s = rm::warp_sum(s);
      if (lane == 0) HS[4 * hb::MAXNH + warp] = s;
    }

    // pass B: the head sums, d y and d pre of both branches, then the edge
    // features
    float Yd[hb::MAXHP] = {}, Ya[hb::MAXHP] = {};
    float trow_k = 0.f, trow_v = 0.f;
    float dxd[3] = {0.f, 0.f, 0.f};  // d x of the destination (tid < KC)
    for (int k0 = 0; k0 < K; k0 += hb::KC) {
      const int nr = min(hb::KC, K - k0);
      if (!one) {
        __syncthreads();  // the last chunk is done with the tiles
        edge_head_chunk<H, POS, GATE>(f, et, CF, row, k0, trk, trv, GR, VL,
                                      EW, GRL, GT, WVM, bvm, Tk, Tv, xh[0],
                                      rs[0], xh[1], rs[1], zk, zv);
      }
      __syncthreads();  // y of both branches in the tiles; CV, HS written
      hb::accumulate_heads<H>(Yd, Tk, DA, k0, nr, NH);
      if (POS)
        hb::accumulate_heads<H>(ywo, Tv, CV, k0, nr, NH);
      else
        hb::accumulate_heads<H>(Ya, Tv, CV, k0, nr, NH);
      if (GATE && tid < H)
        for (int r = 0; r < nr; ++r) {
          ys = fmaf(DS[k0 + r], Tv[r * TS + c], ys);
          dsum += DS[k0 + r];
        }
      __syncthreads();  // the tiles take d pre below
      hb::branch_back<H, false>(Tk, f.k.lns, f.k.lnb, M, DA, scale, k0, K,
                                NH, xh[0], rs[0], lsk, lbk, nullptr, nullptr);
      hb::branch_back<H, GATE>(Tv, f.v.lns, f.v.lnb, Mv, CV, 1.f, k0, K, NH,
                               xh[1], rs[1], lsv, lbv, DS, WVM);
      __syncthreads();
      if (tid < H)
        for (int r = 0; r < nr; ++r) {
          trow_k += Tk[r * TS + c];
          trow_v += Tv[r * TS + c];
        }
      for (int r = part; r < nr; r += P)  // d t_src of the sources
        if (et.valid[r]) {
          const size_t s = (size_t)et.src[r] * H + c;
          atomicAdd(a.d_tsrc_k + s, Tk[r * TS + c]);
          atomicAdd(a.d_tsrc_v + s, Tv[r * TS + c]);
        }
      edge_dist_partial<H>(Tk, Tv, zk, zv, E);
      {  // the chunk's d w_feat, added to the block's slot at once
        float wk[4][NR] = {}, wv[4][NR] = {};
        unsigned seen = 0;
        edge_wfeat_back<H, NR>(Tk, Tv, et, r_lo, n_r, wk, wv, seen);
        rowbwd::GradSlot gk, gv;
        slots(gk, gv);
        flush_wfeat<H>(wk, gk.wfeat, seen, F, lig, r_lo, n_r);
        flush_wfeat<H>(wv, gv.wfeat, seen, F, lig, r_lo, n_r);
      }
      __syncthreads();
      // d rel = d dist rel / dist (+ pos mode: WR g) -> both endpoints
      if (tid < nr && et.valid[tid]) {
        const int pr = tid / RPT, u = tid - pr * RPT;  // E's part and row
        float dd = 0.f;
        for (int j = 0; j < H / 32; ++j) dd += E[(pr * H / 32 + j) * RPT + u];
        const float* rl = et.rel + tid * 3;
        const float d2 = rl[0] * rl[0] + rl[1] * rl[1] + rl[2] * rl[2];
        const float fd = d2 >= 1e-12f ? dd / et.dist[tid] : 0.f;
        const float wr = POS ? WR[k0 + tid] : 0.f;
        const size_t src = (size_t)et.src[tid] * 3;
        for (int d = 0; d < 3; ++d) {
          const float dr = fd * rl[d] + (POS ? wr * GR[d] : 0.f);
          dxd[d] += dr;
          atomicAdd(a.d_xs + src + d, -dr);
        }
      }
    }

    // the row's d t_row, d x, d bo, d Wo and d q
    if (tid < H) {
      a.d_trow_k[(size_t)row * H + c] = trow_k;
      a.d_trow_v[(size_t)row * H + c] = trow_v;
    }
    if (tid < 32)
      for (int d = 0; d < 3; ++d) {
        const float t = rm::warp_sum(dxd[d]);
        if (tid == 0) atomicAdd(a.d_x + (size_t)row * 3 + d, t);
      }
    const float* SH = HS + 2 * hb::MAXNH;  // S dh | S alpha | S cv
    if (tid < H) {
      bo_k = fmaf(scale * QR[c], SH[c / hd], bo_k);
      if (!POS) bo_v = fmaf(GR[c], SH[2 * hb::MAXNH + c / hd], bo_v);
    }
    if (POS && tid < NH) bo_v += SH[2 * hb::MAXNH + tid];
    hb::update_dwo<H>(DWk, Yd, QR, scale, NH);
    if (!POS) hb::update_dwo<H>(DWv, Ya, GR, 1.f, NH);
    hb::store_heads<H>(M, Yd, NH);  // Qk is done: pass B ended in a barrier
    __syncthreads();
    hb::dq_partial<H>(Tk, M, f.k.wo, NH);
    __syncthreads();
    if (tid < H) {
      float t = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) t += Tk[p * H + c];
      a.d_q[(size_t)row * H + c] =
          scale * (t + __ldg(f.k.bo + c) * SH[c / hd]);
    }
  }

  // the block's slot
  rowbwd::GradSlot gk, gv;
  slots(gk, gv);
  if (GATE && tid < H) YS[c] = ys;
  __syncthreads();
  if (GATE)  // d Wo_v += Ys wm^T
    for (int e = tid; e < H * H; e += hb::THREADS) {
      const int cc = e / H, j = e - cc * H;
      DWv[cc * MS + j] = fmaf(__ldg(f.gate.wm + cc), YS[j], DWv[cc * MS + j]);
    }
  if (tid < H) {
    gk.bo[c] = bo_k;
    if (!POS) gv.bo[c] = GATE ? fmaf(__ldg(f.gate.wm + c), dsum, bo_v) : bo_v;
    if (GATE) {  // d wm = Wo_v^T Ys + bo_v sum d s, d bm = sum d s
      float s = 0.f;
      for (int j = 0; j < H; ++j)
        s = fmaf(__ldg(f.v.wo + (size_t)j * H + c), YS[j], s);
      float* sg = gv.lnb + H;
      sg[c] = fmaf(__ldg(f.v.bo + c), dsum, s);
      if (c == 0) sg[H] = dsum;
    }
  }
  if (POS) {
    if (tid < NH) gv.bo[tid] = bo_v;
    const hb::HeadSlots<H> hs(hd);
    if ((part * hb::Map<H>::CR) % hd == 0)  // one writer per element
#pragma unroll
      for (int u = 0; u < hb::MAXHP; ++u)
        if (u < hs.n) gv.wo[c * NH + hs.h0 + u] = ywo[u];
  }
  __syncthreads();
  for (int e = tid; e < H * H; e += hb::THREADS) {
    const int jj = e / H, cc = e - jj * H;
    gk.wo[e] = DWk[cc * MS + jj];
    if (!POS) gv.wo[e] = DWv[cc * MS + jj];
  }
  __syncthreads();  // DWk holds the warps' LayerNorm sums next
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int cc = lane + 32 * v;
    DWk[(warp * 4 + 0) * H + cc] = lsk[v];
    DWk[(warp * 4 + 1) * H + cc] = lbk[v];
    DWk[(warp * 4 + 2) * H + cc] = lsv[v];
    DWk[(warp * 4 + 3) * H + cc] = lbv[v];
  }
  __syncthreads();
  if (tid < 4 * H) {
    const int qn = tid / H, cc = tid % H;
    float t = 0.f;
    for (int w = 0; w < hb::WARPS; ++w) t += DWk[(w * 4 + qn) * H + cc];
    float* out = qn == 0 ? gk.lns : qn == 1 ? gk.lnb : qn == 2 ? gv.lns
                                                                : gv.lnb;
    out[cc] = t;
  }
}

// Whether the head-factorized backward takes these sizes: H in 32, 64, 128,
// at most MAXNH heads, 1 to KMAX sources, and its layout within a block's
// shared memory.
template <int H>
cudaError_t edge_head_fits(int NH, int K, bool* ok) {
  *ok = false;
  if (!hb::heads_ok(NH) || K < 1 || K > EdgeHeadLayout<H>::KMAX)
    return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *ok = err == cudaSuccess && EdgeHeadLayout<H>::bytes <= (size_t)optin;
  return err;
}

cudaError_t edge_head_route(int H, int NH, int K, bool* ok) {
  switch (H) {
    case 32: return edge_head_fits<32>(NH, K, ok);
    case 64: return edge_head_fits<64>(NH, K, ok);
    case 128: return edge_head_fits<128>(NH, K, ok);
    default: *ok = false; return cudaSuccess;
  }
}

template <int H>
cudaError_t launch_bwd_head(const EdgeBwdArgs& a, int G,
                            cudaStream_t stream) {
  constexpr size_t smem = EdgeHeadLayout<H>::bytes;
  void (*kernel)(EdgeBwdArgs) = edge_attention_bwd_head_kernel<H, false, false>;
  if (a.f.pos)
    kernel = edge_attention_bwd_head_kernel<H, true, false>;
  else if (a.f.gate.wm)
    kernel = edge_attention_bwd_head_kernel<H, false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<G, hb::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One block per SM (at most one per tile, at least one for the zeros).
template <int H>
cudaError_t launch_fwd(const EdgeArgs& a, const RowWindow& w,
                       cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = EdgeLayout(H, a.n_heads, a.pos != 0).bytes;
  void (*kernel)(EdgeArgs, RowWindow) =
      edge_attention_kernel<H, false, false>;
  if (a.pos)
    kernel = edge_attention_kernel<H, true, false>;
  else if (a.gate.wm)
    kernel = edge_attention_kernel<H, false, true>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = std::max(1, std::min(sms, w.mols * w.tiles_per_mol()));
  kernel<<<grid, rm::THREADS, smem, stream>>>(a, w);
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
// launched, else 0 (the wrapper counts the route from it). Only rows
// row_start .. row_start + row_count - 1 of each molecule are computed, the
// others written 0; (0, N) computes every row.
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
    int n_types, int pos, int row_start, int row_count, void* stream) {
  *row = 0;
  if (row_start < 0 || row_count < 0 || row_start + row_count > N)
    return (int)cudaErrorInvalidValue;
  if (B * N == 0) return 0;
  if (wm && pos) return (int)cudaErrorInvalidValue;  // the gate is node-only
  const RowWindow w = row_window(B, N, row_start, row_count);
  EdgeArgs a{x, xs, lig, group, idx, mask, ew, q,
             Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
             Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
             out, N, K, H, n_heads, n_types, pos, Gate{wm, bm}};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 32: return (int)launch_fwd<32>(a, w, s);
    case 64: return (int)launch_fwd<64>(a, w, s);
    case 128: return (int)launch_fwd<128>(a, w, s);
    default: *row = 1; return (int)launch_fwd_row(a, w, B, s);
  }
}

// Floats per block of the device-memory scratch that the backward needs at
// these sizes (0: its row buffers fit in shared memory, or the
// head-factorized kernel runs); gate: the m-gated kernel.
extern "C" int edge_attention_bwd_scratch(int* per_block, int K, int H,
                                          int n_heads, int gate) {
  bool head = false;
  *per_block = 0;
  cudaError_t err = edge_head_route(H, n_heads, K, &head);
  if (err != cudaSuccess || head) return (int)err;
  return (int)rowbwd::scratch_floats(
      bwd_kernel(gate != 0, H, false), H,
      rowbwd::row_smem_floats(K, H, n_heads, gate != 0), per_block);
}

// Whether the backward at these sizes runs the per-row kernel (*row = 1) or
// the head-factorized one (*row = 0), in every mode: the wrapper sizes the
// launch from it.
extern "C" int edge_attention_bwd_route(int* row, int K, int H,
                                        int n_heads) {
  bool head = false;
  const cudaError_t err = edge_head_route(H, n_heads, K, &head);
  *row = !head;
  return (int)err;
}

// Backward: G blocks over the B*N rows, then the fixed-order slot sum into
// d_params ([k: w_feat, wo, bo, ln_scale, ln_bias | v: the same] and, with
// the gate, [d wm (H) | d bm]). d_xs: the sources' coordinate cotangent, a
// zeroed buffer of its own when xs is not x, else d_x. H in 32, 64, 128
// with at most 16 heads and K up to 64: the head-factorized kernel, one
// block per SM; any other width: the per-row kernel, two blocks per SM,
// which alone reads k_woT and v_woT (the transposed Wo) and the scratch: G
// times edge_attention_bwd_scratch's floats, or null when that is 0.
// *route: 1 when the row buffers went to the scratch, else 0; *row: 1 when
// the per-row kernel was launched, else 0. The gradients are those of the
// forward over rows row_start .. row_start + row_count - 1 of each molecule:
// g's rows outside them are read as 0.
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
    float* scratch, int* route, int* row, int B, int N, int K, int H,
    int n_heads, int n_types, int pos, int row_start, int row_count, int G,
    void* stream) {
  *route = 0;
  *row = 0;
  if (row_start < 0 || row_count < 0 || row_start + row_count > N)
    return (int)cudaErrorInvalidValue;
  if (B * N == 0 || G <= 0) return 0;
  if (wm && pos) return (int)cudaErrorInvalidValue;  // the gate is node-only
  EdgeBwdArgs a{
      EdgeArgs{x, xs, lig, group, idx, mask, ew, q,
               Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
               Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
               nullptr, N, K, H, n_heads, n_types, pos, Gate{wm, bm}},
      g, k_woT, v_woT, d_x, d_xs, d_ew, d_q, d_trow_k, d_tsrc_k, d_trow_v,
      d_tsrc_v, slots, B * N, nullptr, 0,
      row_window(B, N, row_start, row_count)};
  const bool gate = wm != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  bool head = false;
  cudaError_t err = edge_head_route(H, n_heads, K, &head);
  if (err != cudaSuccess) return (int)err;
  if (head) {
    switch (H) {
      case 32: err = launch_bwd_head<32>(a, G, s); break;
      case 64: err = launch_bwd_head<64>(a, G, s); break;
      default: err = launch_bwd_head<128>(a, G, s); break;
    }
  } else {
    *row = 1;
    err = rowbwd::launch_rows(
        bwd_kernel(gate, H, false), bwd_kernel(gate, H, true), a, G,
        rowbwd::row_smem_floats(K, H, n_heads, gate), scratch, route, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int F = n_types * (R + 1);
  const size_t P = rowbwd::branch_slot_floats(F, H, H) +
                   rowbwd::branch_slot_floats(F, H, pos ? n_heads : H) +
                   (gate ? H + 1 : 0);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P, s);
}
