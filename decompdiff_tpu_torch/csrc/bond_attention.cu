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
// one node-mode forward is ~1.0 GFLOP of per-pair [H, H] products against
// ~5 MB of inputs and output, as chip_smoke.py counts them, so FP32
// CUDA-core throughput bounds it. The backward adds two products per
// forward product (d_h_bond = d pre We^T and d We = h_bond^T d pre among
// them), so it is bound the same way.
//
// Forward design: one block per (complex, atom i), one thread per channel;
// sources j go in chunks of 16 (row_attention.cuh). The chunk's h_bond rows
// are staged in shared memory and multiplied by We in-kernel; the relative
// vectors of pos mode are formed from the coordinates in-kernel instead of
// reading a [B, Nl, Nl, 3] tensor. Only B * Nl blocks exist at these
// shapes, fewer than two waves on 132 SMs: a later version should split
// rows or batch several layers' calls. At H = 128 it takes 174 registers a
// thread, so blocks of H > 256 threads are compiled for 1024 threads (at
// most 64 registers) to launch at all.
//
// Backward design (row_attention_bwd.cuh): one block per row as well (the
// grid is capped at two blocks per SM, each looping over rows), every
// per-pair intermediate recomputed in shared memory. The TPU kernel holds a
// whole complex per program and sums the column cotangents d t_src[j] and,
// in pos mode, d x[j] in-program; a block per complex would give only B=8
// blocks here, so those two are atomicAdds into zeroed buffers instead
// (order varies between runs, within float32 rounding). d h_bond is per
// pair and written directly.
#include "row_attention_bwd.cuh"

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

// The chunk code of the forward and the backward kernel. It is written as
// macros over the caller's locals (A the BondArgs; c, H, Nl, pos, row, b,
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

// WIDE: the block may have up to 1024 threads (H > 256; at most 64
// registers a thread).
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : 256)
    bond_attention_kernel(BondArgs a) {
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
};

__global__ void bond_attention_bwd_kernel(BondBwdArgs a) {
  using namespace rowbwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;

  const BondArgs& f = a.f;
  const int H = f.H, Nl = f.Nl, nh = f.n_heads;
  const bool pos = f.pos != 0;
  const int c = threadIdx.x;
  float* Xs = smem;  // [CH][H] h_bond rows of the chunk
  const RowSmem s = carve(smem + CH * H, Nl, H, nh);
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

}  // namespace

extern "C" int bond_attention_fwd(
    const float* h_bond, const float* x, const float* mask, const float* q,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb,
    float* out, int B, int Nl, int H, int n_heads, int pos, void* stream) {
  if (B * Nl == 0) return 0;
  BondArgs a{h_bond, x, mask, q,
             Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
             Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
             out, Nl, H, n_heads, pos};
  const size_t smem = smem_bytes(H, n_heads, 1);
  void (*kernel)(BondArgs) = H > 256 ? bond_attention_kernel<true>
                                     : bond_attention_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * Nl, H, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Backward: G blocks over the B*Nl rows, then the fixed-order slot sum into
// d_params ([k: w_feat, wo, bo, ln_scale, ln_bias | v: the same]).
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
    int B, int Nl, int H, int n_heads, int pos, int G, void* stream) {
  if (B * Nl == 0 || G <= 0) return 0;
  BondBwdArgs a{
      BondArgs{h_bond, x, mask, q,
               Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
               Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
               nullptr, Nl, H, n_heads, pos},
      g, k_woT, v_woT, k_weT, v_weT, d_hbond, d_x, d_q, d_trow_k, d_tsrc_k,
      d_trow_v, d_tsrc_v, slots, B * Nl};
  const size_t smem =
      sizeof(float) * (CH * H + rowbwd::row_smem_floats(Nl, H, n_heads));
  cudaError_t err = allow_smem(bond_attention_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bond_attention_bwd_kernel<<<G, H, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t P = rowbwd::branch_slot_floats(H, H, H) +
                   rowbwd::branch_slot_floats(H, H, pos ? n_heads : H);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P,
                                    (cudaStream_t)stream);
}
