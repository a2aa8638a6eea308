// Dense bond-graph attention, node mode and pos mode, for sm_90a: forward
// and backward.
//
// Replaces: the Pallas TPU kernels decompdiff_tpu/ops/pallas/bond_kernel.py
//   forward  _bond_fwd_call :128 -> _bond_kernel :30-86,
//   backward _bond_bwd_call :307 -> _bond_bwd_kernel :151-304.
//
// Computes, per ligand atom i and every ligand atom j:
//   pre_m = h_bond[i, j] @ We_m + t_row_m[i] + t_src_m[j]       (m = k, v)
//   k, v  = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
//   node mode: out[i] = sum_j softmax_j(q[i] . k / sqrt(hd)) v   [H]
//   pos mode:  out[i] = sum_j mean_h(alpha v) (x_i - x_j)         [3]
// under bond_mask[i, j]. t_row = h @ Wi + be and t_src = h @ Wj are
// projected per atom before the launch.
//
// Bound on an H100: operations. At the released shapes (B=8, Nl=32, H=128)
// one node-mode forward is ~1.0 GFLOP of per-pair [H, H] products (first
// linears h_bond @ We and second linears y @ Wo) against ~5 MB of inputs
// and output, as chip_smoke.py counts them; at three bf16 tensor-core
// passes per product that is ~3 us, above the ~1.5 us of its bytes. The
// backward adds two products per forward product (d_h_bond = d pre We^T and
// d We = h_bond^T d pre among them) and runs them on CUDA cores, so FP32
// throughput bounds it.
//
// Forward design, H in 32, 64, 128 (row_mma.cuh): a persistent grid of one
// 512-thread block per SM over tiles of 2 destination rows x 32 sources
// (more sources: an online softmax across chunks of 32). The TPU kernel
// computes h_bond @ We in its body, and so does this one: the tile's h_bond
// rows are split into bf16 hi + lo in shared memory and multiplied by We on
// the tensor cores in three bf16 passes (float32 accuracy), then t_row and
// t_src are added, LayerNorm and relu run a warp per four rows, and the
// second linear runs on the tensor cores as well; logits, online softmax
// and the sums of alpha v stay float32 (pos mode: v [H, heads] on CUDA
// cores, x_i - x_j formed in-kernel). We and Wo of one branch as bf16 hi +
// lo take 139 KB at H = 128; both branches' would take 278 KB, more than a
// block's 227 KB, so a block stages the k branch's pair, runs the k branch
// to its logits, then stages the v branch's pair over it. At the released
// shapes B * Nl / 2 = 128 tiles fill 128 of the 132 SMs once, so each
// block stages each pair once.
//
// Forward design at every other width (row_attention.cuh): one block per
// (complex, atom i), one thread per channel; sources j go in chunks of 16.
// The chunk's h_bond rows are staged in shared memory and multiplied by We
// in-kernel. At H = 128 it took 174 registers a thread, so blocks of
// H > 256 threads are compiled for 1024 threads (at most 64 registers).
//
// Backward design (row_attention_bwd.cuh): one block per row as well (the
// grid is capped at two blocks per SM, each looping over rows), every
// per-pair intermediate recomputed in shared memory. The TPU kernel holds a
// whole complex per program and sums the column cotangents d t_src[j] and,
// in pos mode, d x[j] in-program; a block per complex would give only B=8
// blocks here, so those two are atomicAdds into zeroed buffers instead
// (order varies between runs, within float32 rounding). d h_bond is per
// pair and written directly. Blocks of H > 256 threads take a 1024-thread
// build; at H >= 512 the row buffers do not fit in shared memory and live in
// a device-memory scratch that the wrapper allocates (row_attention_bwd.cuh).
#include "row_attention_bwd.cuh"
#include "row_mma.cuh"

using namespace rowattn;

namespace {

struct BondArgs {
  const float* h_bond;  // [B, Nl, Nl, H]
  const float* x;       // [B, Nl, 3] (pos mode) or null
  const float* mask;    // [B, Nl, Nl]
  const float* q;       // [B, Nl, H]
  Branch k, v;
  float* out;           // [B, Nl, H] or [B, Nl, 3]
  int Nl, H, n_heads, pos;
};

// The chunk code of the per-row forward and of the backward kernel, written
// as macros over the caller's locals (A the BondArgs; c, H, Nl, pos, row, b,
// m0, nm). As __forceinline__ functions with the same statements, ptxas
// gave the forward 138 registers instead of 174 and it ran 43% slower on an
// H100 (1.98 against 1.39 ms of device time for a training step's 12
// launches, scripts/profile_torch_train.py).
//
// Sources j = m0 .. m0+nm-1 of row (b, i): validity and (pos mode) x_i - x_j
// by threads c < CH; the h_bond rows into XS [CH][H] by every thread.
#define BOND_CHUNK_SETUP(A, CS, XS)                                         \
  {                                                                         \
    if (c < CH) {                                                           \
      const int j_ = m0 + c;                                                \
      const bool in_ = c < nm;                                              \
      (CS).src[c] = in_ ? j_ : 0;                                           \
      (CS).valid[c] = in_ && (A).mask[(size_t)row * Nl + j_] > 0.5f;        \
      (CS).ew[c] = 1.f;                                                     \
      for (int d_ = 0; d_ < 3; ++d_)                                        \
        (CS).rel[c * 3 + d_] =                                              \
            (pos && in_) ? (A).x[(size_t)row * 3 + d_] -                    \
                               (A).x[((size_t)b * Nl + j_) * 3 + d_]        \
                         : 0.f;                                             \
    }                                                                       \
    _Pragma("unroll") for (int m_ = 0; m_ < CH; ++m_)                      \
      (XS)[m_ * H + c] =                                                    \
        m_ < nm ? (A).h_bond[((size_t)row * Nl + m0 + m_) * H + c] : 0.f;   \
  }

// Every thread: the first-linear outputs of the chunk for channel c.
#define BOND_CHUNK_PRE(A, CS, XS, TK, TV, YK, YV)                           \
  {                                                                         \
    float acc_[CH];                                                         \
    matvec(XS, (A).k.w_feat, H, H, c, acc_);                                \
    _Pragma("unroll") for (int m_ = 0; m_ < CH; ++m_)                      \
      (YK)[m_ * H + c] = acc_[m_] + (TK) +                                  \
        __ldg((A).k.t_src + ((size_t)b * Nl + (CS).src[m_]) * H + c);       \
    matvec(XS, (A).v.w_feat, H, H, c, acc_);                                \
    _Pragma("unroll") for (int m_ = 0; m_ < CH; ++m_)                      \
      (YV)[m_ * H + c] = acc_[m_] + (TV) +                                  \
        __ldg((A).v.t_src + ((size_t)b * Nl + (CS).src[m_]) * H + c);       \
  }

__device__ __forceinline__ bool row_has_source(const float* mrow, int Nl) {
  int any = 0;
  for (int t = threadIdx.x; t < Nl; t += blockDim.x) any |= mrow[t] > 0.5f;
  return __syncthreads_or(any);
}

// ---------------------------------------------------------------------------
// forward, H in 32, 64, 128: tensor-core stage of row_mma.cuh
// ---------------------------------------------------------------------------

namespace rm = rowmma;

// Offsets into the forward kernel's dynamic shared memory; the launcher
// builds the same layout to size the launch. W1 holds one branch's We and
// W2 its Wo (pos mode's v: Wo_v [H][heads] float32 in WV, staged once).
struct BondLayout {
  size_t w1_hi, w1_lo, w2_hi, w2_lo, wv, p, e, vs, sc, m, l, a3, q, scratch,
      valid, coef, rel, bytes;
  __host__ __device__ BondLayout(int H, int NH, bool pos) {
    rm::Carve c;
    w1_hi = c.take(rm::wo_bytes(H));
    w1_lo = c.take(rm::wo_bytes(H));
    w2_hi = c.take(rm::wo_bytes(H));
    w2_lo = c.take(rm::wo_bytes(H));
    wv = pos ? c.take(sizeof(float) * H * NH) : 0;
    p = c.take(rm::p_bytes(H));
    e = c.take(sizeof(float) * NH * rm::EH);
    vs = pos ? c.take(sizeof(float) * NH * rm::EH) : 0;
    sc = c.take(sizeof(float) * rm::TI * NH);
    m = c.take(sizeof(float) * rm::TI * NH);
    l = c.take(sizeof(float) * rm::TI * NH);
    a3 = pos ? c.take(sizeof(float) * rm::TI * NH * 3) : 0;
    q = c.take(sizeof(float) * rm::TI * H);
    scratch = c.take(sizeof(float) * rm::THREADS);
    valid = c.take(sizeof(int) * rm::TILE);
    coef = pos ? c.take(sizeof(float) * rm::TILE) : 0;
    rel = pos ? c.take(sizeof(float) * rm::TILE * 3) : 0;
    bytes = c.off;
  }
};

// Pair row r of a tile: destination row0 + r / KC (flat b * Nl + i), source
// j = k0 + r % KC; `in` when both lie in the graph.
struct BondPair {
  int row, b, j;
  bool in;
  __device__ __forceinline__ BondPair(int r, int row0, int rows, int k0,
                                      int Nl)
      : row(row0 + r / rm::KC), b(row / Nl), j(k0 + r % rm::KC),
        in(row < rows && j < Nl) {}
};

// Threads r < TILE: validity of pair row r and, in pos mode, its x_i - x_j
// (with a weight of 1 for chunk_acc_pos). Returns the thread's validity.
// No barrier.
__device__ __forceinline__ int bond_tile_setup(const BondArgs& a, int* valid,
                                               float* coef, float* rel,
                                               int row0, int rows, int k0) {
  const int r = threadIdx.x;
  if (r >= rm::TILE) return 0;
  const BondPair p(r, row0, rows, k0, a.Nl);
  const int ok = p.in && a.mask[(size_t)p.row * a.Nl + p.j] > 0.5f;
  valid[r] = ok;
  if (a.pos) {
    const float* xi = a.x + (size_t)p.row * 3;
    const float* xj = a.x + ((size_t)p.b * a.Nl + p.j) * 3;
    for (int d = 0; d < 3; ++d) rel[r * 3 + d] = p.in ? xi[d] - xj[d] : 0.f;
    coef[r] = 1.f;
  }
  return ok;
}

// Rows w, w + WARPS, ... of P for warp w <- the tile's h_bond rows (0
// outside the graph), split into bf16 hi + lo as ln_write splits y, for the
// first linear on the tensor cores. A lane loads channels lane + 32 v. No
// barrier.
template <int H>
__device__ __forceinline__ void bond_tile_split(const BondArgs& a, float* P,
                                                int row0, int rows, int k0) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[rm::RW][NV];
#pragma unroll
  for (int q = 0; q < rm::RW; ++q) {
    const BondPair p(warp + q * rm::WARPS, row0, rows, k0, a.Nl);
    const float* src = a.h_bond + ((size_t)p.row * a.Nl + p.j) * H;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      x[q][v] = p.in ? __ldg(src + lane + 32 * v) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < rm::RW; ++q) {
    rm::bf16* rb = reinterpret_cast<rm::bf16*>(
        P + (warp + q * rm::WARPS) * rm::p_ld(H));
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = lane + 32 * v;
      const rm::bf16 h = __float2bfloat16_rn(x[q][v]);
      rb[c] = h;
      rb[rm::lo_off(H) + c] =
          __float2bfloat16_rn(x[q][v] - __bfloat162float(h));
    }
  }
}

// Rows of warp w (as in bond_tile_split): pre = P (h_bond @ We) + t_row[row]
// + t_src[b, j] (0 outside the graph), then y in the form FORM
// (rm::ln_write). No barrier.
template <int H, int FORM>
__device__ __forceinline__ void bond_tile_y(const BondArgs& a,
                                            const Branch& br, float* P,
                                            int row0, int rows, int k0) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[rm::RW][NV];
#pragma unroll
  for (int q = 0; q < rm::RW; ++q) {
    const int r = warp + q * rm::WARPS;
    const BondPair p(r, row0, rows, k0, a.Nl);
    const float* tr = br.t_row + (size_t)p.row * H;
    const float* ts = br.t_src + ((size_t)p.b * a.Nl + p.j) * H;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = lane + 32 * v;
      x[q][v] = p.in ? P[r * rm::p_ld(H) + c] + __ldg(tr + c) + __ldg(ts + c)
                     : 0.f;
    }
  }
  rm::ln_write<H, FORM>(P, x, br.lns, br.lnb);
}

// Persistent: block g takes the tiles g, g + gridDim.x, ... of 2
// destination rows each. Per chunk of 32 sources, the k branch (its We and
// Wo staged as bf16 hi + lo; h_bond @ We, LayerNorm, @ Wo, logits), then
// the v branch (its weights staged over the k branch's), then the sums of
// alpha v: both branches' four [H, H] matrices would not fit in shared
// memory together.
template <int H, bool POS>
__global__ void __launch_bounds__(rm::THREADS, 1)
    bond_attention_kernel(BondArgs a, int B) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int Nl = a.Nl, NH = a.n_heads, rows = B * Nl;
  const BondLayout lay(H, NH, POS);
  rm::bf16* w1h = reinterpret_cast<rm::bf16*>(dyn + lay.w1_hi);
  rm::bf16* w1l = reinterpret_cast<rm::bf16*>(dyn + lay.w1_lo);
  rm::bf16* w2h = reinterpret_cast<rm::bf16*>(dyn + lay.w2_hi);
  rm::bf16* w2l = reinterpret_cast<rm::bf16*>(dyn + lay.w2_lo);
  float* WV = reinterpret_cast<float*>(dyn + lay.wv);
  float* P = reinterpret_cast<float*>(dyn + lay.p);
  float* VS = reinterpret_cast<float*>(dyn + lay.vs);
  float* A3 = reinterpret_cast<float*>(dyn + lay.a3);
  const rm::Softmax sm{reinterpret_cast<float*>(dyn + lay.e),
                       reinterpret_cast<float*>(dyn + lay.sc),
                       reinterpret_cast<float*>(dyn + lay.m),
                       reinterpret_cast<float*>(dyn + lay.l)};
  float* Q = reinterpret_cast<float*>(dyn + lay.q);
  float* scratch = reinterpret_cast<float*>(dyn + lay.scratch);
  int* valid = reinterpret_cast<int*>(dyn + lay.valid);
  float* coef = reinterpret_cast<float*>(dyn + lay.coef);
  float* rel = reinterpret_cast<float*>(dyn + lay.rel);

  if (POS)  // Wo_v [H][NH], float32
    for (int e = threadIdx.x; e < H * NH; e += rm::THREADS)
      WV[e] = __ldg(a.v.wo + e);
  const float scale = 1.f / sqrtf((float)(H / NH));
  const int n_tiles = (rows + rm::TI - 1) / rm::TI;
  bool k_staged = false;  // W1 and W2 hold the k branch's weights

  // A tile without a valid bond skips all its chunks and writes zeros.
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * rm::TI, n_rows = min(rm::TI, rows - row0);
    float* out0 = a.out + (size_t)row0 * (POS ? 3 : H);
    float acc = 0.f;

    for (int k0 = 0; k0 < Nl; k0 += rm::KC) {
      __syncthreads();  // the last chunk (tile) is done with the shared data
      if (k0 == 0) {    // the tile's rows: q and the softmax state
        for (int e = threadIdx.x; e < rm::TI * H; e += rm::THREADS)
          Q[e] = e / H < n_rows ? a.q[(size_t)row0 * H + e] : 0.f;
        rm::softmax_reset(sm, NH);
        if (POS)
          for (int e = threadIdx.x; e < rm::TI * NH * 3; e += rm::THREADS)
            A3[e] = 0.f;
      }
      const int live = bond_tile_setup(a, valid, coef, rel, row0, rows, k0);
      if (!__syncthreads_or(live)) continue;  // no bond in the chunk

      // k: first linear, LayerNorm and relu, second linear, logits
      if (!k_staged) {
        rm::stage_wo<H>(a.k.w_feat, w1h, w1l);
        rm::stage_wo<H>(a.k.wo, w2h, w2l);
        k_staged = true;
      }
      bond_tile_split<H>(a, P, row0, rows, k0);
      __syncthreads();
      rm::tile_product<H, true, rm::WARPS, false>(P, w1h, w1l, nullptr);
      bond_tile_y<H, rm::kHiLo>(a, a.k, P, row0, rows, k0);
      __syncthreads();
      rm::tile_product<H, true>(P, w2h, w2l, a.k.bo);
      rm::chunk_logits<H>(P, Q, valid, NH, scale, sm);
      __syncthreads();  // the k branch is done with W1, W2 and P

      // v: first linear, LayerNorm and relu, second linear, sum of alpha v
      rm::stage_wo<H>(a.v.w_feat, w1h, w1l);
      if (!POS) rm::stage_wo<H>(a.v.wo, w2h, w2l);
      k_staged = false;
      bond_tile_split<H>(a, P, row0, rows, k0);
      __syncthreads();
      rm::tile_product<H, true, rm::WARPS, false>(P, w1h, w1l, nullptr);
      bond_tile_y<H, POS ? rm::kF32 : rm::kHiLo>(a, a.v, P, row0, rows, k0);
      __syncthreads();
      if (POS) {  // v [H, heads] on CUDA cores
        rm::tile_heads<H>(P, WV, a.v.bo, NH, VS);
        __syncthreads();
        rm::chunk_acc_pos(VS, sm, coef, rel, A3, NH);
      } else {
        rm::tile_product<H, true>(P, w2h, w2l, a.v.bo);
        acc = rm::chunk_acc_node<H>(acc, P, sm, nullptr, NH);
      }
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

// WIDE: the block may have up to 1024 threads (H > 256; at most 64
// registers a thread).
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : 256)
    bond_attention_row_kernel(BondArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;

  const int H = a.H, Nl = a.Nl;
  const bool pos = a.pos != 0;
  float* Yk = smem;
  float* Yv = Yk + CH * H;
  float* Xs = Yv + CH * H;
  float* Vs = Xs + CH * H;
  const int row = blockIdx.x;  // b * Nl + i
  const int b = row / Nl;
  const int c = threadIdx.x;
  float* out_row = a.out + (size_t)row * (pos ? 3 : H);

  if (!row_has_source(a.mask + (size_t)row * Nl, Nl)) {
    zero_row(out_row, pos);
    return;
  }

  const float q_c = a.q[(size_t)row * H + c];
  const float tk = a.k.t_row[(size_t)row * H + c];
  const float tv = a.v.t_row[(size_t)row * H + c];
  const float scale = 1.f / sqrtf((float)(H / a.n_heads));
  RowState st;

  for (int m0 = 0; m0 < Nl; m0 += CH) {
    const int nm = min(CH, Nl - m0);
    BOND_CHUNK_SETUP(a, cs, Xs);
    __syncthreads();
    BOND_CHUNK_PRE(a, cs, Xs, tk, tv, Yk, Yv);
    __syncthreads();
    finish_chunk(Yk, Yv, Vs, a.k, a.v, cs, nm, H, a.n_heads, pos, q_c, scale,
                 st);
  }
  finalize(st, out_row, Vs, H, a.n_heads, pos);
}

struct BondBwdArgs {
  BondArgs f;            // forward inputs (f.out unused)
  const float* g;        // [B, Nl, H] or [B, Nl, 3] output cotangent
  const float* woT_k;    // [H, H] transposed Wo_k
  const float* woT_v;    // [H, H] transposed Wo_v (node mode only)
  const float* weT_k;    // [H, H] transposed We_k
  const float* weT_v;    // [H, H] transposed We_v
  float* d_hbond;        // [B, Nl, Nl, H] zeroed
  float* d_x;            // [B, Nl, 3]     zeroed; atomics (pos mode)
  float* d_q;            // [B, Nl, H]
  float* d_trow_k;       // [B, Nl, H]
  float* d_tsrc_k;       // [B, Nl, H]     zeroed; atomics
  float* d_trow_v;
  float* d_tsrc_v;
  float* slots;          // [gridDim.x][P] zeroed parameter-gradient slots
  int rows;              // B * Nl
  float* scratch;        // row buffers in device memory (SCRATCH kernels)
  int per_block;         //   floats of them per block
};

// The row buffers: the chunk's h_bond rows, then RowSmem.
inline size_t bond_bwd_floats(int Nl, int H, int n_heads) {
  return (size_t)CH * H + rowbwd::row_smem_floats(Nl, H, n_heads);
}

// The backward of the rows of block blockIdx.x. SCRATCH: the row buffers in
// a.scratch (row_attention_bwd.cuh).
template <bool SCRATCH>
__device__ __forceinline__ void bond_bwd_rows(const BondBwdArgs& a) {
  using namespace rowbwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;

  const BondArgs& f = a.f;
  const int H = f.H, Nl = f.Nl, nh = f.n_heads;
  const bool pos = f.pos != 0;
  const int c = threadIdx.x;
  float* Xs = row_base<SCRATCH>(smem, a.scratch, a.per_block);  // [CH][H]
  const RowSmem s = carve(Xs + CH * H, Nl, H, nh);
  const float scale = 1.f / sqrtf((float)(H / nh));
  GradSlot sk, sv;
  block_slots(a.slots, H, H, pos ? nh : H, sk, sv);
  SmallGrads acc;

  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const int b = row / Nl;
    if (!row_has_source(f.mask + (size_t)row * Nl, Nl)) {
      a.d_q[(size_t)row * H + c] = 0.f;
      a.d_trow_k[(size_t)row * H + c] = 0.f;
      a.d_trow_v[(size_t)row * H + c] = 0.f;
      continue;
    }
    const float q_c = f.q[(size_t)row * H + c];
    const float tk = f.k.t_row[(size_t)row * H + c];
    const float tv = f.v.t_row[(size_t)row * H + c];
    float g_c = 0.f, g3[3] = {0.f, 0.f, 0.f};
    if (pos)
      for (int d = 0; d < 3; ++d) g3[d] = a.g[(size_t)row * 3 + d];
    else
      g_c = a.g[(size_t)row * H + c];

    // pass A
    for (int m0 = 0; m0 < Nl; m0 += CH) {
      const int nm = min(CH, Nl - m0);
      BOND_CHUNK_SETUP(f, cs, Xs);
      if (c < nm) {
        s.VL[m0 + c] = cs.valid[c] ? 1.f : 0.f;
        s.EW[m0 + c] = 1.f;
        s.GR[m0 + c] = cs.rel[c * 3] * g3[0] + cs.rel[c * 3 + 1] * g3[1] +
                       cs.rel[c * 3 + 2] * g3[2];
      }
      __syncthreads();
      BOND_CHUNK_PRE(f, cs, Xs, tk, tv, s.Yk, s.Yv);
      __syncthreads();
      pass_a_chunk(s, f.k, f.v, m0, nm, H, nh, pos, q_c, g_c, scale);
    }
    head_stage(s, Nl, nh, pos);
    a.d_q[(size_t)row * H + c] = row_d_q(s, Nl, H, nh, scale);

    // pass B
    float trow_k = 0.f, trow_v = 0.f;
    float dxd[3] = {0.f, 0.f, 0.f};  // d x_i (threads < CH, pos mode)
    for (int m0 = 0; m0 < Nl; m0 += CH) {
      const int nm = min(CH, Nl - m0);
      BOND_CHUNK_SETUP(f, cs, Xs);
      __syncthreads();
      BOND_CHUNK_PRE(f, cs, Xs, tk, tv, s.Yk, s.Yv);
      __syncthreads();
      pass_b_chunk(s, f.k, f.v, a.woT_k, a.woT_v, sk, sv, acc, m0, nm, H, nh,
                   pos, q_c, g_c, scale, trow_k, trow_v);

      float dpk[CH], dpv[CH];
#pragma unroll
      for (int m = 0; m < CH; ++m) {
        dpk[m] = s.Dk[m * H + c];
        dpv[m] = s.Dv[m * H + c];
      }
      // column cotangent of t_src
      for (int m = 0; m < nm; ++m) {
        if (!cs.valid[m]) continue;  // uniform over the block
        const size_t srow = ((size_t)b * Nl + m0 + m) * H + c;
        atomicAdd(a.d_tsrc_k + srow, dpk[m]);
        atomicAdd(a.d_tsrc_v + srow, dpv[m]);
      }
      // d We = h_bond^T d pre (thread c owns column c)
      for (int j = 0; j < H; ++j) {
        float gk = 0.f, gv = 0.f;
#pragma unroll
        for (int m = 0; m < CH; ++m) {
          gk = fmaf(Xs[m * H + j], dpk[m], gk);
          gv = fmaf(Xs[m * H + j], dpv[m], gv);
        }
        slot_add(sk.wfeat + (size_t)j * H + c, gk);
        slot_add(sv.wfeat + (size_t)j * H + c, gv);
      }
      // d h_bond = d pre_k We_k^T + d pre_v We_v^T
      float hk[CH], hv[CH];
      matvec(s.Dk, a.weT_k, H, H, c, hk);
      matvec(s.Dv, a.weT_v, H, H, c, hv);
#pragma unroll
      for (int m = 0; m < CH; ++m)
        if (m < nm)
          a.d_hbond[((size_t)row * Nl + m0 + m) * H + c] = hk[m] + hv[m];
      // pos mode: d rel = WR * g -> +x_i, -x_j
      if (pos && c < nm && cs.valid[c]) {
        const float wr = s.WR[m0 + c];
        for (int d = 0; d < 3; ++d) {
          dxd[d] += wr * g3[d];
          atomicAdd(a.d_x + ((size_t)b * Nl + m0 + c) * 3 + d, -wr * g3[d]);
        }
      }
      __syncthreads();  // the next chunk overwrites cs and the buffers
    }
    a.d_trow_k[(size_t)row * H + c] = trow_k;
    a.d_trow_v[(size_t)row * H + c] = trow_v;
    if (pos && c < 32)
      for (int d = 0; d < 3; ++d) {
        const float t = warp_sum(c < CH ? dxd[d] : 0.f);
        if (c == 0) atomicAdd(a.d_x + (size_t)row * 3 + d, t);
      }
  }
  flush_small(acc, sk, sv, nh, pos);
}

// The 256-thread build (H <= 256) and the 1024-thread build
// (row_attention_bwd.cuh).
template <bool SCRATCH>
__global__ void bond_attention_bwd_kernel(BondBwdArgs a) {
  bond_bwd_rows<SCRATCH>(a);
}

__global__ void __launch_bounds__(1024, 1)
    bond_attention_bwd_wide_kernel(BondBwdArgs a) {
  bond_bwd_rows<true>(a);
}

// One block per SM (at most one per tile).
template <int H>
cudaError_t launch_fwd(const BondArgs& a, int B, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = BondLayout(H, a.n_heads, a.pos != 0).bytes;
  void (*kernel)(BondArgs, int) = a.pos ? bond_attention_kernel<H, true>
                                        : bond_attention_kernel<H, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (B * a.Nl + rm::TI - 1) / rm::TI;
  kernel<<<std::min(sms, tiles), rm::THREADS, smem, stream>>>(a, B);
  return cudaGetLastError();
}

// The per-row forward: [CH][H] pre of both branches, the chunk's h_bond rows
// and [CH][heads] v (pos mode).
cudaError_t launch_fwd_row(const BondArgs& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.H, a.n_heads, 1);
  void (*kernel)(BondArgs) = a.H > 256 ? bond_attention_row_kernel<true>
                                       : bond_attention_row_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.Nl, a.H, smem, stream>>>(a);
  return cudaGetLastError();
}

// The backward kernel of width H, with its row buffers in the scratch or
// in shared memory (H <= 256; the 1024-thread build always takes the
// scratch).
using BondBwdKernel = void (*)(BondBwdArgs);
BondBwdKernel bwd_kernel(int H, bool scratch) {
  if (H > 256) return bond_attention_bwd_wide_kernel;
  return scratch ? bond_attention_bwd_kernel<true>
                 : bond_attention_bwd_kernel<false>;
}

}  // namespace

// Forward. H in 32, 64, 128: the tensor-core kernel; any other width the
// wrapper admits: the per-row kernel. *row: 1 when the per-row kernel was
// launched, else 0 (the wrapper counts the route from it).
extern "C" int bond_attention_fwd(
    const float* h_bond, const float* x, const float* mask, const float* q,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb,
    float* out, int* row, int B, int Nl, int H, int n_heads, int pos,
    void* stream) {
  *row = 0;
  if (B * Nl == 0) return 0;
  BondArgs a{h_bond, x, mask, q,
             Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
             Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
             out, Nl, H, n_heads, pos};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 32: return (int)launch_fwd<32>(a, B, s);
    case 64: return (int)launch_fwd<64>(a, B, s);
    case 128: return (int)launch_fwd<128>(a, B, s);
    default: *row = 1; return (int)launch_fwd_row(a, B, s);
  }
}

// Floats per block of the device-memory scratch that the backward needs at
// these sizes (0: its row buffers fit in shared memory).
extern "C" int bond_attention_bwd_scratch(int* per_block, int Nl, int H,
                                          int n_heads) {
  return (int)rowbwd::scratch_floats(
      bwd_kernel(H, false), H, bond_bwd_floats(Nl, H, n_heads),
      per_block);
}

// Backward: G blocks over the B*Nl rows, then the fixed-order slot sum into
// d_params ([k: w_feat, wo, bo, ln_scale, ln_bias | v: the same]). scratch:
// G times bond_attention_bwd_scratch's floats, or null when that is 0.
// *route: 1 when the row buffers went to the scratch, else 0.
extern "C" int bond_attention_bwd(
    const float* h_bond, const float* x, const float* mask, const float* q,
    const float* g,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb, const float* k_woT, const float* k_weT,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb, const float* v_woT, const float* v_weT,
    float* d_hbond, float* d_x, float* d_q, float* d_trow_k, float* d_tsrc_k,
    float* d_trow_v, float* d_tsrc_v, float* slots, float* d_params,
    float* scratch, int* route, int B, int Nl, int H, int n_heads, int pos,
    int G, void* stream) {
  *route = 0;
  if (B * Nl == 0 || G <= 0) return 0;
  BondBwdArgs a{
      BondArgs{h_bond, x, mask, q,
               Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
               Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
               nullptr, Nl, H, n_heads, pos},
      g, k_woT, v_woT, k_weT, v_weT, d_hbond, d_x, d_q, d_trow_k, d_tsrc_k,
      d_trow_v, d_tsrc_v, slots, B * Nl, nullptr, 0};
  cudaError_t err = rowbwd::launch_rows(
      bwd_kernel(H, false), bwd_kernel(H, true), a, G,
      bond_bwd_floats(Nl, H, n_heads), scratch, route, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const size_t P = rowbwd::branch_slot_floats(H, H, H) +
                   rowbwd::branch_slot_floats(H, H, pos ? n_heads : H);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P,
                                    (cudaStream_t)stream);
}
