// Dense bond-graph attention, node mode and pos mode, for sm_90a.
//
// Replaces: the Pallas TPU kernel decompdiff_tpu/ops/pallas/bond_kernel.py
//   (_bond_fwd_call :128 -> _bond_kernel :30-86), forward only.
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
// one node-mode call is ~1.0 GFLOP of per-pair [H, H] products against
// ~5 MB of inputs and output, as chip_smoke.py counts them, so FP32
// CUDA-core throughput bounds it.
//
// Design: one block per (complex, atom i), one thread per channel; sources j
// go in chunks of 16 (row_attention.cuh). The chunk's h_bond rows are staged
// in shared memory and multiplied by We in-kernel; the relative vectors of
// pos mode are formed from the coordinates in-kernel instead of reading a
// [B, Nl, Nl, 3] tensor. Only B * Nl blocks exist at these shapes, fewer
// than two waves on 132 SMs: a later version should split rows or batch
// several layers' calls.
#include "row_attention.cuh"

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

__global__ void bond_attention_kernel(BondArgs a) {
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
  const float* mrow = a.mask + (size_t)row * Nl;
  float* out_row = a.out + (size_t)row * (pos ? 3 : H);

  int any = 0;
  for (int t = c; t < Nl; t += blockDim.x) any |= mrow[t] > 0.5f;
  if (!__syncthreads_or(any)) {
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
    if (c < CH) {
      const int j = m0 + c;
      const bool in = c < nm;
      cs.src[c] = in ? j : 0;
      cs.valid[c] = in && mrow[j] > 0.5f;
      cs.ew[c] = 1.f;
      for (int d = 0; d < 3; ++d)
        cs.rel[c * 3 + d] =
            (pos && in) ? a.x[(size_t)row * 3 + d] -
                              a.x[((size_t)b * Nl + j) * 3 + d]
                        : 0.f;
    }
#pragma unroll
    for (int m = 0; m < CH; ++m)
      Xs[m * H + c] =
          m < nm ? a.h_bond[((size_t)row * Nl + m0 + m) * H + c] : 0.f;
    __syncthreads();

    float acc[CH];
    matvec(Xs, a.k.w_feat, H, H, c, acc);
#pragma unroll
    for (int m = 0; m < CH; ++m)
      Yk[m * H + c] =
          acc[m] + tk + __ldg(a.k.t_src + ((size_t)b * Nl + cs.src[m]) * H + c);
    matvec(Xs, a.v.w_feat, H, H, c, acc);
#pragma unroll
    for (int m = 0; m < CH; ++m)
      Yv[m * H + c] =
          acc[m] + tv + __ldg(a.v.t_src + ((size_t)b * Nl + cs.src[m]) * H + c);
    __syncthreads();
    finish_chunk(Yk, Yv, Vs, a.k, a.v, cs, nm, H, a.n_heads, pos, q_c, scale,
                 st);
  }
  finalize(st, out_row, Vs, H, a.n_heads, pos);
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
  cudaError_t err = allow_smem(bond_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bond_attention_kernel<<<B * Nl, H, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
