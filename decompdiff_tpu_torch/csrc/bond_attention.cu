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
// backward, head-factorized, keeps three [H, H] products per pair and
// branch (pre = h_bond We again, d h_bond = d pre We^T, d We = h_bond^T
// d pre): ~1.75 GFLOP with the heads-wide and per-row ones, ~6 us at three
// tensor-core passes, above its ~2.5 us of bytes.
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
// Backward design, H in 32, 64, 128 with at most 16 heads and Nl up to
// NLMAX = 64 (head_bwd.cuh), two launches:
//   A  bond_attention_bwd_head_kernel: one 512-thread block per SM over
//      contiguous destination rows. q and the output cotangent belong to
//      the row, so the second linears' side is head-factorized as in the
//      triplet and edge backward (no per-pair [H, H] product there): per
//      row Qk and Gv, per chunk of 32 sources the first linears of both
//      branches on the tensor cores (3xTF32 mma.sync, We read as fragments
//      through L2), LayerNorm, the logits and d alpha on the tensor cores,
//      the softmax backward, then the heads-wide d y, Yd and Ya, the relu
//      and LayerNorm backward. It writes d pre of both branches to a
//      device-memory buffer ([2][B, Nl, Nl, H]) and does all that is
//      row-local: d q, d t_row, d t_src and d x (atomics), the LayerNorm
//      and bias sums, and d Wo summed per block in shared memory. d Wo of
//      both branches takes 129 KB of shared memory at H = 128; We of both
//      branches, as float32 or as bf16 hi + lo, would take 128 KB more,
//      past a block's 227 KB, so We stays in L2 (each element read once a
//      chunk), and d We and d h_bond, which need all of a chunk's d pre
//      anyway, move to
//   B  bond_attention_bwd_gemm_kernel: a tensor-core product over the
//      B * Nl^2 pair rows in chunks of 32, with We of both branches staged
//      in its shared memory: d h_bond = [d pre_k | d pre_v] [We_k ; We_v]^T
//      (K = 2H) written out, and the block's partial sums of d We_m =
//      h_bond^T d pre_m in registers (one owner per element), stored into
//      the block's slot.
// The extra traffic of the buffer is ~17 MB at the released shapes (~5 us
// at 3.35 TB/s). Every parameter gradient has one adding thread per block
// and is summed over the blocks in a fixed order (launch_reduce); d t_src
// and d x are atomics (order varies, within float32 rounding).
//
// Backward design at every other width (row_attention_bwd.cuh): one block
// per row as well (the grid is capped at two blocks per SM, each looping
// over rows), every per-pair intermediate recomputed in shared memory. The
// TPU kernel holds a whole complex per program and sums the column
// cotangents d t_src[j] and, in pos mode, d x[j] in-program; a block per
// complex would give only B=8 blocks here, so those two are atomicAdds into
// zeroed buffers instead (order varies between runs, within float32
// rounding). d h_bond is per pair and written directly. Blocks of H > 256
// threads take a 1024-thread build; at H >= 512 the row buffers do not fit
// in shared memory and live in a device-memory scratch that the wrapper
// allocates (row_attention_bwd.cuh).
#include "head_bwd.cuh"
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
  float* d_pre;          // [2][B, Nl, Nl, H] d pre_k, d pre_v (head route)
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

// ---------------------------------------------------------------------------
// backward, H in 32, 64, 128: head-factorized (head_bwd.cuh), then the
// tensor-core products of d h_bond and d We
// ---------------------------------------------------------------------------

namespace hb = headbwd;

// Phase marks of the head route's kernels, for
// scripts/profile_torch_bond_bwd.py, which defines BOND_BWD_PHASE to count
// each phase's cycles (n < 0: the start); empty here. Each stands where
// every thread of the block arrives.
#ifndef BOND_BWD_PHASE
#define BOND_BWD_PHASE(n)
#endif

// Offsets into launch A's dynamic shared memory, fixed at compile time
// (sized for NLMAX sources and MAXNH heads).
template <int H>
struct BondHeadLayout {
  static constexpr int NLMAX = 64;  // sources a row: two chunks
  static constexpr size_t F = sizeof(float);
  static constexpr int MS = hb::mstride(H), TS = hb::tstride(H);
  static constexpr size_t dwo = 0;                            // [2][H][MS]
  static constexpr size_t tk = dwo + F * 2 * H * MS;          // [KC][TS]
  static constexpr size_t tv = tk + F * hb::KC * TS;
  static constexpr size_t m = tv + F * hb::KC * TS;           // [2 MAXNH][MS]
  static constexpr size_t lg = m + F * 2 * hb::MAXNH * MS;    // [NLMAX][NH]
  static constexpr size_t da = lg + F * NLMAX * hb::MAXNH;
  static constexpr size_t cv = da + F * NLMAX * hb::MAXNH;
  static constexpr size_t vec = cv + F * NLMAX * hb::MAXNH;   // [2][H]
  static constexpr size_t hs = vec + F * 2 * H;               // [5][MAXNH]
  static constexpr size_t src = hs + F * 5 * hb::MAXNH;       // [3][NLMAX]
  static constexpr size_t bytes = src + F * 3 * NLMAX;
  static_assert(tk % 16 == 0 && tv % 16 == 0 && m % 16 == 0, "aligned");
};

// Launch B's dynamic shared memory: We_k and We_v ([H][tstride] each,
// staged once a block; at the end the block's d We sums), then the chunk's
// h_bond rows and its d pre_k and d pre_v rows as tf32 hi and lo,
// [KC][tstride] each.
template <int H>
constexpr size_t gemm_smem_bytes() {
  return sizeof(float) * (2 * H + 5 * hb::KC) * hb::tstride(H);
}

// The chunk's first linears of both branches on the tensor cores:
// pre_m = X We_m + t_row_m[row] + t_src_m[source] into Pk and Pv for the
// KC pair rows of X ([KC][tstride] float32 h_bond rows; t_src 0 past the n
// sources of the chunk, whose rows in X are 0). Pv may be X: the products
// stay in registers until every warp has read X. We_m [H][H] is read as mma
// fragments through L2 (it does not fit in shared memory beside the block's
// d Wo); warp w takes the 8 output columns of n-tile w % (H / 8) for its
// share of the (branch, m-tile) pairs, so each element of We is read once a
// chunk. Contains a block barrier; ends without one.
template <int H>
__device__ __forceinline__ void bond_pre_tc(const float* X, const Branch& bk,
                                            const Branch& bv, int row,
                                            size_t src0, int n, float* Pk,
                                            float* Pv) {
  constexpr int TS = hb::tstride(H), NT = H / 8, WPN = hb::WARPS / NT;
  constexpr int NB = WPN == 1 ? 2 : 1, NM = WPN <= 2 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, sub = warp / NT;
  const int n0 = (warp % NT) * 8;
  const int br0 = NB == 2 ? 0 : NM == 2 ? sub : sub / 2;
  const int mt0 = NM == 2 ? 0 : sub % 2;
  const float* w[NB];
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
    w[bi] = (br0 + bi ? bv : bk).w_feat + t * H + n0 + g;
  float acc[NB][NM][4] = {};
#pragma unroll 4
  for (int k = 0; k < H; k += 8) {
    uint32_t ah[NM][4], al[NM][4], bh[NB][2], bl[NB][2];
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      hb::split_tf32(__ldg(w[bi] + k * H), bh[bi][0], bl[bi][0]);
      hb::split_tf32(__ldg(w[bi] + (k + 4) * H), bh[bi][1], bl[bi][1]);
    }
#pragma unroll
    for (int mi = 0; mi < NM; ++mi)
      hb::frag_a<TS, false>(X + ((mt0 + mi) * 16 + g) * TS + k + t, ah[mi],
                            al[mi]);
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
#pragma unroll
      for (int mi = 0; mi < NM; ++mi)
        hb::mma3(acc[bi][mi], ah[mi], al[mi], bh[bi], bl[bi]);
  }
  __syncthreads();  // every warp has read X
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const Branch& br = br0 + bi ? bv : bk;
    float* P = br0 + bi ? Pv : Pk;
    const int c = n0 + 2 * t;
    const float2 tr =
        __ldg(reinterpret_cast<const float2*>(br.t_row + (size_t)row * H + c));
#pragma unroll
    for (int mi = 0; mi < NM; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mt0 + mi) * 16 + g + 8 * hf;
        const float2 ts =
            r < n ? __ldg(reinterpret_cast<const float2*>(
                        br.t_src + (src0 + r) * H + c))
                  : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(P + r * TS + c) =
            make_float2(acc[bi][mi][2 * hf] + tr.x + ts.x,
                        acc[bi][mi][2 * hf + 1] + tr.y + ts.y);
      }
  }
}

// The chunk's sources k0 .. k0 + KC - 1 of `row` (complex b): VL and, in
// pos mode, GRL = (x_i - x_j) . g; the h_bond rows (0 past Nl) into Tv,
// the first linears of both branches into Tk and Tv, their LayerNorm and
// relu (y in the tiles, xhat and 1 / std kept). Begins after a barrier;
// ends without one.
template <int H, bool POS>
__device__ __forceinline__ void bond_head_chunk(
    const BondArgs& f, int row, int b, int k0, const float* g3, int* VL,
    float* GRL, float* Tk, float* Tv, float (&xhk)[hb::RW][H / 32],
    float (&rsk)[hb::RW], float (&xhv)[hb::RW][H / 32],
    float (&rsv)[hb::RW]) {
  constexpr int TS = hb::tstride(H), Q = H / 4;
  const int tid = threadIdx.x, Nl = f.Nl, n = min(hb::KC, Nl - k0);
  if (tid < n) {
    const int j = k0 + tid;
    VL[j] = f.mask[(size_t)row * Nl + j] > 0.5f;
    if (POS) {
      float s = 0.f;
      for (int d = 0; d < 3; ++d)
        s = fmaf(f.x[(size_t)row * 3 + d] - f.x[((size_t)b * Nl + j) * 3 + d],
                 g3[d], s);
      GRL[j] = s;
    }
  }
  const float4* hb4 = reinterpret_cast<const float4*>(
      f.h_bond + ((size_t)row * Nl + k0) * H);
  for (int e = tid; e < hb::KC * Q; e += hb::THREADS) {
    const int r = e / Q, c4 = e - r * Q;
    *reinterpret_cast<float4*>(Tv + r * TS + 4 * c4) =
        r < n ? __ldg(hb4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  BOND_BWD_PHASE(3);
  bond_pre_tc<H>(Tv, f.k, f.v, row, (size_t)b * Nl + k0, n, Tk, Tv);
  __syncthreads();
  BOND_BWD_PHASE(4);
  hb::tile_ln<H>(Tk, f.k.lns, f.k.lnb, xhk, rsk);
  hb::tile_ln<H>(Tv, f.v.lns, f.v.lnb, xhv, rsv);
}

// Launch A. Persistent: block g takes the destination rows [g rows / G,
// (g + 1) rows / G). d Wo of both branches stays in shared memory,
// transposed, until the block ends; d pre of both branches goes to a.d_pre
// (zeros for the rows without a bond) for launch B.
template <int H, bool POS>
__global__ void __launch_bounds__(hb::THREADS, 1)
    bond_attention_bwd_head_kernel(BondBwdArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  using lay = BondHeadLayout<H>;
  constexpr int MS = hb::mstride(H), TS = hb::tstride(H), NV = H / 32;
  constexpr int P = hb::Map<H>::P, NLMAX = lay::NLMAX;
  const BondArgs& f = a.f;
  const int Nl = f.Nl, NH = f.n_heads, hd = H / NH;
  float* DWk = reinterpret_cast<float*>(dyn + lay::dwo);  // [H][MS] d Wo^T
  float* DWv = DWk + H * MS;
  float* Tk = reinterpret_cast<float*>(dyn + lay::tk);    // [KC][TS]: pre,
  float* Tv = reinterpret_cast<float*>(dyn + lay::tv);    //   y, then d pre
  float* M = reinterpret_cast<float*>(dyn + lay::m);      // Qk, then Yd
  float* Mv = M + NH * MS;                                // Gv (pos: Wo_v^T)
  float* LG = reinterpret_cast<float*>(dyn + lay::lg);    // logit, alpha
  float* DA = reinterpret_cast<float*>(dyn + lay::da);    // d alpha, dh
  float* CV = reinterpret_cast<float*>(dyn + lay::cv);    // pos: v, then
                                                          //   v's coefficients
  float* QR = reinterpret_cast<float*>(dyn + lay::vec);   // q of the row
  float* GR = QR + H;                                     // g (pos: [3])
  float* HS = reinterpret_cast<float*>(dyn + lay::hs);    // qb|gb (pos:
                                                          // bo_v)|S dh|S
                                                          // alpha|S cv
  int* VL = reinterpret_cast<int*>(dyn + lay::src);       // [NLMAX] each
  float* GRL = reinterpret_cast<float*>(VL + NLMAX);      // pos: rel . g
  float* WR = GRL + NLMAX;                                // pos: d rel / g
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % H, part = tid / H;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t pair_floats = (size_t)a.rows * Nl * H;
  float* dpk = a.d_pre;                                   // [B, Nl, Nl, H]
  float* dpv = a.d_pre + pair_floats;
  // the v branch's head coefficients, and their sums over the sources
  const float* CVB = POS ? CV : LG;
  const float* SCV = HS + (POS ? 4 : 3) * hb::MAXNH;

  BOND_BWD_PHASE(-1);
  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;
  if (POS) {  // the v branch's [H, heads] second linear, as heads rows
    for (int e = tid; e < H * NH; e += hb::THREADS)
      Mv[(e % NH) * MS + e / NH] = __ldg(f.v.wo + e);
    if (tid < NH) HS[hb::MAXNH + tid] = __ldg(f.v.bo + tid);
  }

  // the block's sums over its rows
  float lsk[NV] = {}, lbk[NV] = {}, lsv[NV] = {}, lbv[NV] = {};
  float ywo[hb::MAXHP] = {};  // pos: d Wo_v [H, heads]
  float bo_k = 0.f, bo_v = 0.f;
  const int row_end = (int)((long long)(blockIdx.x + 1) * a.rows / gridDim.x);
  __syncthreads();
  BOND_BWD_PHASE(0);

  for (int row = (int)((long long)blockIdx.x * a.rows / gridDim.x);
       row < row_end; ++row) {
    const int b = row / Nl;
    // a barrier too: the last row is done with the buffers
    if (!row_has_source(f.mask + (size_t)row * Nl, Nl)) {
      if (tid < H) {
        a.d_q[(size_t)row * H + tid] = 0.f;
        a.d_trow_k[(size_t)row * H + tid] = 0.f;
        a.d_trow_v[(size_t)row * H + tid] = 0.f;
      }
      for (int e = tid; e < Nl * H; e += hb::THREADS) {
        dpk[(size_t)row * Nl * H + e] = 0.f;
        dpv[(size_t)row * Nl * H + e] = 0.f;
      }
      continue;
    }
    if (tid < H) {
      QR[tid] = f.q[(size_t)row * H + tid];
      if (!POS) GR[tid] = a.g[(size_t)row * H + tid];
    }
    if (POS && tid < 3) GR[tid] = a.g[(size_t)row * 3 + tid];
    __syncthreads();
    BOND_BWD_PHASE(1);
    hb::row_matrices<H, POS ? 1 : 2>(f.k.wo, f.v.wo, f.k.bo, f.v.bo, QR, GR,
                                     NH, M, HS, HS + hb::MAXNH);
    // one chunk: y stays in the tiles and xhat, 1 / std in registers from
    // pass A to pass B
    const bool one = Nl <= hb::KC;
    float xh[2][hb::RW][NV], rs[2][hb::RW];

    // pass A: logits and d alpha (pos: v) of every source
    for (int k0 = 0; k0 < Nl; k0 += hb::KC) {
      __syncthreads();  // M and HS written; the last chunk is done
      BOND_BWD_PHASE(k0 ? 6 : 2);
      bond_head_chunk<H, POS>(f, row, b, k0, GR, VL, GRL, Tk, Tv, xh[0],
                              rs[0], xh[1], rs[1]);
      __syncthreads();
      BOND_BWD_PHASE(5);
      hb::head_products_tc<H>(Tk, M, NH, k0, Nl, scale, HS, LG);
      hb::head_products_tc<H>(Tv, Mv, NH, k0, Nl, 1.f, HS + hb::MAXNH,
                              POS ? CV : DA, 4);
    }
    __syncthreads();
    BOND_BWD_PHASE(6);
    if (POS) {  // d alpha = v_h (rel . g) / heads; CV keeps v_h
      for (int e = tid; e < Nl * NH; e += hb::THREADS)
        DA[e] = CV[e] * GRL[e / NH] / NH;
      __syncthreads();
    }
    hb::head_softmax(LG, DA, VL, Nl, NH, HS + 2 * hb::MAXNH);
    __syncthreads();
    if (POS) {
      // per source: d rel / g = sum_h alpha v_h / heads, and CV <- the v
      // branch's head coefficients alpha (rel . g) / heads; 16 lanes a
      // source (alpha is 0 at an invalid source)
      for (int u = tid; u < ((Nl * hb::MAXNH + 31) & ~31);
           u += hb::THREADS) {
        const int m = u / hb::MAXNH, h = u % hb::MAXNH;
        const bool in = m < Nl && h < NH;
        const float al = in ? LG[m * NH + h] : 0.f;
        float dv = in ? al * CV[m * NH + h] : 0.f;
        for (int o = hb::MAXNH / 2; o > 0; o >>= 1)
          dv += __shfl_xor_sync(0xffffffffu, dv, o);
        if (h == 0 && m < Nl) WR[m] = dv / NH;
        if (in) CV[m * NH + h] = al * GRL[m] / NH;
      }
      __syncthreads();
      if (warp < NH) {  // S cv[h] = sum_m CV[m][h]
        float s = 0.f;
        for (int m = lane; m < Nl; m += 32) s += CV[m * NH + warp];
        s = rm::warp_sum(s);
        if (lane == 0) HS[4 * hb::MAXNH + warp] = s;
      }
    }
    BOND_BWD_PHASE(7);

    // pass B: the head sums, d y and d pre of both branches
    float Yd[hb::MAXHP] = {}, Ya[hb::MAXHP] = {};
    float trow_k = 0.f, trow_v = 0.f;
    float dxd[3] = {0.f, 0.f, 0.f};  // pos: d x of the destination (tid < KC)
    for (int k0 = 0; k0 < Nl; k0 += hb::KC) {
      const int nr = min(hb::KC, Nl - k0);
      if (!one) {
        __syncthreads();  // the last chunk is done with the tiles
        bond_head_chunk<H, POS>(f, row, b, k0, GR, VL, GRL, Tk, Tv, xh[0],
                                rs[0], xh[1], rs[1]);
      }
      __syncthreads();  // y of both branches in the tiles; CV, HS written
      BOND_BWD_PHASE(8);
      hb::accumulate_heads<H>(Yd, Tk, DA, k0, nr, NH);
      if (POS)
        hb::accumulate_heads<H>(ywo, Tv, CV, k0, nr, NH);
      else
        hb::accumulate_heads<H>(Ya, Tv, LG, k0, nr, NH);
      __syncthreads();  // the tiles take d pre below
      BOND_BWD_PHASE(9);
      hb::branch_back<H, false>(Tk, f.k.lns, f.k.lnb, M, DA, scale, k0, Nl,
                                NH, xh[0], rs[0], lsk, lbk, nullptr, nullptr);
      hb::branch_back<H, false>(Tv, f.v.lns, f.v.lnb, Mv, CVB, 1.f, k0, Nl,
                                NH, xh[1], rs[1], lsv, lbv, nullptr, nullptr);
      __syncthreads();
      BOND_BWD_PHASE(10);
      if (tid < H)
        for (int r = 0; r < nr; ++r) {
          trow_k += Tk[r * TS + c];
          trow_v += Tv[r * TS + c];
        }
      // d pre out for launch B; d t_src of the valid sources
      for (int r = part; r < nr; r += P) {
        const float vk = Tk[r * TS + c], vv = Tv[r * TS + c];
        const size_t o = ((size_t)row * Nl + k0 + r) * H + c;
        dpk[o] = vk;
        dpv[o] = vv;
        if (VL[k0 + r]) {
          const size_t s = ((size_t)b * Nl + k0 + r) * H + c;
          atomicAdd(a.d_tsrc_k + s, vk);
          atomicAdd(a.d_tsrc_v + s, vv);
        }
      }
      // pos mode: d rel = WR g -> +x_i, -x_j
      if (POS && tid < nr && VL[k0 + tid]) {
        const float wr = WR[k0 + tid];
        for (int d = 0; d < 3; ++d) {
          const float dr = wr * GR[d];
          dxd[d] += dr;
          atomicAdd(a.d_x + ((size_t)b * Nl + k0 + tid) * 3 + d, -dr);
        }
      }
      BOND_BWD_PHASE(11);
    }

    // the row's d t_row, d x, d bo, d Wo and d q
    if (tid < H) {
      a.d_trow_k[(size_t)row * H + c] = trow_k;
      a.d_trow_v[(size_t)row * H + c] = trow_v;
    }
    if (POS && tid < 32)
      for (int d = 0; d < 3; ++d) {
        const float t = rm::warp_sum(dxd[d]);
        if (tid == 0) atomicAdd(a.d_x + (size_t)row * 3 + d, t);
      }
    const float* SH = HS + 2 * hb::MAXNH;  // S dh
    if (tid < H) {
      bo_k = fmaf(scale * QR[c], SH[c / hd], bo_k);
      if (!POS) bo_v = fmaf(GR[c], SCV[c / hd], bo_v);
    }
    if (POS && tid < NH) bo_v += SCV[tid];
    hb::update_dwo<H>(DWk, Yd, QR, scale, NH);
    if (!POS) hb::update_dwo<H>(DWv, Ya, GR, 1.f, NH);
    hb::store_heads<H>(M, Yd, NH);  // Qk is done: a barrier followed its use
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
    BOND_BWD_PHASE(12);
  }

  // the block's slot (its w_feat part is launch B's)
  rowbwd::GradSlot gk, gv;
  rowbwd::block_slots(a.slots, H, H, POS ? NH : H, gk, gv);
  if (tid < H) {
    gk.bo[c] = bo_k;
    if (!POS) gv.bo[c] = bo_v;
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
  BOND_BWD_PHASE(13);
}

// d h_bond of the chunk's n < KC pair rows on the tensor cores:
// out[r] = Dk[r] We_k^T + Dv[r] We_v^T (K = 2H; We_m[x][c] is the
// fragment element B[c][x]; W: We_k, We_v [H][tstride] in shared memory;
// D: the tf32 hi of d pre_k, d pre_v, then their lo, [KC][tstride] each),
// three tf32 passes. Warp w takes the output columns of n-tile w % (H / 8)
// for its m-tiles (at H = 32 warps 8 .. 15 have none). No barrier.
template <int H>
__device__ __forceinline__ void bond_dhb_tc(const uint32_t* D, const float* W,
                                            float* out, size_t n) {
  constexpr int TS = hb::tstride(H), NT = H / 8, TILES = 2 * NT;
  constexpr int NM = TILES > hb::WARPS ? TILES / hb::WARPS : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= TILES) return;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (warp % NT) * 8, mt0 = NM == 2 ? 0 : warp / NT;
  float acc[NM][4] = {};
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const uint32_t* dh = D + br * hb::KC * TS;
    const uint32_t* dl = dh + 2 * hb::KC * TS;
    const float* w = W + (br * H + n0 + g) * TS + t;
#pragma unroll 4
    for (int k = 0; k < H; k += 8) {
      uint32_t ah[NM][4], al[NM][4], bh[2], bl[2];
      hb::split_tf32(w[k], bh[0], bl[0]);
      hb::split_tf32(w[k + 4], bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < NM; ++mi) {
        hb::frag_a_split<TS>(dh, dl, ((mt0 + mi) * 16 + g) * TS + k + t,
                             ah[mi], al[mi]);
        hb::mma3(acc[mi], ah[mi], al[mi], bh, bl);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < NM; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = (mt0 + mi) * 16 + g + 8 * hf;
      if ((size_t)r < n)
        *reinterpret_cast<float2*>(out + (size_t)r * H + n0 + 2 * t) =
            make_float2(acc[mi][2 * hf], acc[mi][2 * hf + 1]);
    }
}

// Launch B: over the B * Nl^2 pair rows (b, i, j flattened) in chunks of
// KC, d h_bond = [d pre_k | d pre_v] [We_k ; We_v]^T, and the block's
// partial sums of d We_m = h_bond^T d pre_m on the tensor cores, three tf32
// passes. Block g takes the chunks [g C / G, (g + 1) C / G), with We of
// both branches staged in shared memory once (read through L2 a chunk, it
// took two fifths of the launch). d pre, an operand of every warp, is split
// into tf32 hi and lo once, as the chunk comes in. Warp w owns TPW m16n8
// tiles of d We, all of one branch and one 16-row m-tile, in registers (64
// floats a thread at H = 128), summed in chunk order: one owner per
// element. At the end they go through shared memory, so that the block's
// slot is written in coalesced rows (stored from the fragments, they took a
// third of the launch).
template <int H>
__global__ void __launch_bounds__(hb::THREADS, 1)
    bond_attention_bwd_gemm_kernel(BondBwdArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  constexpr int TS = hb::tstride(H), NT = H / 8, KC = hb::KC, Q = H / 4;
  constexpr int PER_BR = (H / 16) * NT;            // m16n8 tiles a branch
  constexpr int TPW = 2 * PER_BR / hb::WARPS;      // a warp's tiles
  static_assert(TPW >= 1 && NT % TPW == 0, "a warp's tiles share a row");
  float* W = reinterpret_cast<float*>(dyn);        // [2][H][TS] We_k, We_v
  float* X = W + 2 * H * TS;                       // [KC][TS] h_bond rows
  // [hi | lo][k | v][KC][TS] d pre rows as tf32
  uint32_t* D = reinterpret_cast<uint32_t*>(X + KC * TS);
  const BondArgs& f = a.f;
  const size_t pairs = (size_t)a.rows * f.Nl;
  const float* dpk = a.d_pre;
  const float* dpv = a.d_pre + pairs * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = warp * TPW, wbr = t0 / PER_BR;
  const int x0 = ((t0 % PER_BR) / NT) * 16, c0 = (t0 % NT) * 8;
  const uint32_t* Dwh = D + wbr * KC * TS;          // this warp's branch
  const uint32_t* Dwl = Dwh + 2 * KC * TS;
  float acc[TPW][4] = {};
  const long long C = (long long)((pairs + KC - 1) / KC);
  const long long c_end = (blockIdx.x + 1) * C / gridDim.x;

  BOND_BWD_PHASE(-1);
  for (int e = threadIdx.x; e < 2 * H * Q; e += hb::THREADS) {
    const int br = e / (H * Q), x = e / Q - br * H, c4 = e % Q;
    *reinterpret_cast<float4*>(W + (br * H + x) * TS + 4 * c4) =
        __ldg(reinterpret_cast<const float4*>(br ? f.v.w_feat : f.k.w_feat) +
              x * Q + c4);
  }
  for (long long ch = blockIdx.x * C / gridDim.x; ch < c_end; ++ch) {
    const size_t p0 = (size_t)ch * KC;
    const size_t n = pairs - p0 < (size_t)KC ? pairs - p0 : (size_t)KC;
    __syncthreads();  // the last chunk is done with the tiles
    for (int e = threadIdx.x; e < KC * Q; e += hb::THREADS) {
      const int r = e / Q, c4 = e - r * Q;
      const size_t o = (p0 * H) / 4 + e;
      const bool in = (size_t)r < n;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(X + r * TS + 4 * c4) =
          in ? __ldg(reinterpret_cast<const float4*>(f.h_bond) + o) : z;
#pragma unroll
      for (int br = 0; br < 2; ++br) {
        const float4 d =
            in ? __ldg(reinterpret_cast<const float4*>(br ? dpv : dpk) + o)
               : z;
        uint4 h, l;
        hb::split_tf32(d.x, h.x, l.x);
        hb::split_tf32(d.y, h.y, l.y);
        hb::split_tf32(d.z, h.z, l.z);
        hb::split_tf32(d.w, h.w, l.w);
        const int at = (br * KC + r) * TS + 4 * c4;
        *reinterpret_cast<uint4*>(D + at) = h;
        *reinterpret_cast<uint4*>(D + 2 * KC * TS + at) = l;
      }
    }
    __syncthreads();
    BOND_BWD_PHASE(14);
    bond_dhb_tc<H>(D, W, a.d_hbond + p0 * H, n);
    BOND_BWD_PHASE(15);
    // d We += X^T D over the chunk's pair rows (rows past n are 0)
#pragma unroll
    for (int k = 0; k < KC; k += 8) {
      uint32_t ah[4], al[4];
      hb::frag_a<TS, true>(X + (k + t) * TS + x0 + g, ah, al);
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int o = (k + t) * TS + c0 + 8 * i + g;
        const uint32_t bh[2] = {Dwh[o], Dwh[o + 4 * TS]};
        const uint32_t bl[2] = {Dwl[o], Dwl[o + 4 * TS]};
        hb::mma3(acc[i], ah, al, bh, bl);
      }
    }
    BOND_BWD_PHASE(16);
  }

  // the block's d We [H(in)][H(out)] of both branches into W, then its
  // slot
  __syncthreads();  // every warp is done with We
  float* S = W + wbr * H * TS;
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(S + (x0 + g + 8 * hf) * TS + c0 + 8 * i +
                                 2 * t) =
          make_float2(acc[i][2 * hf], acc[i][2 * hf + 1]);
  __syncthreads();
  rowbwd::GradSlot gk, gv;
  rowbwd::block_slots(a.slots, H, H, f.pos ? f.n_heads : H, gk, gv);
  for (int e = threadIdx.x; e < 2 * H * H; e += hb::THREADS) {
    const int br = e / (H * H), x = e / H - br * H, c = e % H;
    (br ? gv.wfeat : gk.wfeat)[x * H + c] = W[(br * H + x) * TS + c];
  }
  BOND_BWD_PHASE(17);
}

// Whether the head route takes these sizes: H in 32, 64, 128, at most
// MAXNH heads, 1 to NLMAX atoms, and its layout within a block's shared
// memory.
template <int H>
cudaError_t bond_head_fits(int NH, int Nl, bool* ok) {
  *ok = false;
  if (!hb::heads_ok(NH) || Nl < 1 || Nl > BondHeadLayout<H>::NLMAX)
    return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *ok = err == cudaSuccess && BondHeadLayout<H>::bytes <= (size_t)optin;
  return err;
}

cudaError_t bond_head_route(int H, int NH, int Nl, bool* ok) {
  switch (H) {
    case 32: return bond_head_fits<32>(NH, Nl, ok);
    case 64: return bond_head_fits<64>(NH, Nl, ok);
    case 128: return bond_head_fits<128>(NH, Nl, ok);
    default: *ok = false; return cudaSuccess;
  }
}

// Launches A and B of the head route, G blocks each (the slots' count).
template <int H>
cudaError_t launch_bwd_head(const BondBwdArgs& a, int G,
                            cudaStream_t stream) {
  constexpr size_t smem = BondHeadLayout<H>::bytes;
  void (*head)(BondBwdArgs) = bond_attention_bwd_head_kernel<H, false>;
  if (a.f.pos) head = bond_attention_bwd_head_kernel<H, true>;
  cudaError_t err = cudaFuncSetAttribute(
      head, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  head<<<G, hb::THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t gsmem = gemm_smem_bytes<H>();
  err = cudaFuncSetAttribute(bond_attention_bwd_gemm_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gsmem);
  if (err != cudaSuccess) return err;
  bond_attention_bwd_gemm_kernel<H><<<G, hb::THREADS, gsmem, stream>>>(a);
  return cudaGetLastError();
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

// Floats per block of the device-memory scratch that the per-row backward
// needs at these sizes (0: its row buffers fit in shared memory).
extern "C" int bond_attention_bwd_scratch(int* per_block, int Nl, int H,
                                          int n_heads) {
  return (int)rowbwd::scratch_floats(
      bwd_kernel(H, false), H, bond_bwd_floats(Nl, H, n_heads),
      per_block);
}

// Whether the backward at these sizes runs the per-row kernel (*row = 1) or
// the head route (*row = 0): the wrapper sizes the launch and its buffers
// from it.
extern "C" int bond_attention_bwd_route(int* row, int Nl, int H,
                                        int n_heads) {
  bool head = false;
  const cudaError_t err = bond_head_route(H, n_heads, Nl, &head);
  *row = !head;
  return (int)err;
}

// Backward, then the fixed-order slot sum into d_params ([k: w_feat, wo,
// bo, ln_scale, ln_bias | v: the same]). H in 32, 64, 128 with at most 16
// heads and Nl up to 64: the head route, launches A and B over G blocks
// (one per SM), which alone reads d_pre (2 B Nl^2 H floats, written by A,
// read by B); any other width: the per-row kernel over G blocks (two per
// SM), which alone reads k_woT, k_weT, v_woT, v_weT (the transposed
// weights) and the scratch: G times bond_attention_bwd_scratch's floats, or
// null when that is 0. *route: 1 when the row buffers went to the scratch,
// else 0; *row: 1 when the per-row kernel was launched, else 0.
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
    float* scratch, float* d_pre, int* route, int* row, int B, int Nl, int H,
    int n_heads, int pos, int G, void* stream) {
  *route = 0;
  *row = 0;
  if (B * Nl == 0 || G <= 0) return 0;
  BondBwdArgs a{
      BondArgs{h_bond, x, mask, q,
               Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
               Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
               nullptr, Nl, H, n_heads, pos},
      g, k_woT, v_woT, k_weT, v_weT, d_hbond, d_x, d_q, d_trow_k, d_tsrc_k,
      d_trow_v, d_tsrc_v, slots, B * Nl, nullptr, 0, d_pre};
  const cudaStream_t s = (cudaStream_t)stream;
  bool head = false;
  cudaError_t err = bond_head_route(H, n_heads, Nl, &head);
  if (err != cudaSuccess) return (int)err;
  if (head) {
    if (d_pre == nullptr) return (int)cudaErrorInvalidValue;
    switch (H) {
      case 32: err = launch_bwd_head<32>(a, G, s); break;
      case 64: err = launch_bwd_head<64>(a, G, s); break;
      default: err = launch_bwd_head<128>(a, G, s); break;
    }
  } else {
    *row = 1;
    err = rowbwd::launch_rows(bwd_kernel(H, false), bwd_kernel(H, true), a,
                              G, bond_bwd_floats(Nl, H, n_heads), scratch,
                              route, s);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t P = rowbwd::branch_slot_floats(H, H, H) +
                   rowbwd::branch_slot_floats(H, H, pos ? n_heads : H);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P, s);
}
