// kNN edge attention, node mode (x2h) and pos mode (h2x), for sm_90a.
//
// Replaces: the Pallas TPU kernel decompdiff_tpu/ops/pallas/edge_kernel.py
//   (_edge_fwd_call :540 -> _edge_kernel :152-250), forward only.
//
// Computes, per destination node i and each of its K kNN sources s:
//   edge_type = one-hot (src ligand?, dst ligand?) [+ one-hot same group]
//   pre_m     = [outer(edge_type, RBF20(|x_i - x_s|)), edge_type] @ We_m
//               + t_row_m[i] + t_src_m[s]                      (m = k, v)
//   k, v      = relu(LayerNorm(pre_m)) @ Wo_m + bo_m ;  v *= e_w
//   node mode: out[i] = sum_k softmax_k(q[i] . k / sqrt(hd)) v  [H]
//   pos mode:  out[i] = sum_k mean_h(alpha v) (x_i - x_s)        [3]
// t_src = h @ Wj is projected per node before the launch and gathered here
// (K times fewer operations than projecting every gathered row).
//
// Bound on an H100: operations. At the released shapes (B=8, N=352, K=32,
// H=128) one node-mode call is ~6.9 GFLOP of per-edge products (the two
// [H, H] second linears dominate; pos mode ~4.3 GFLOP) against ~10 MB of
// inputs and output, as chip_smoke.py counts them, so FP32 CUDA-core
// throughput (67 TFLOP/s) bounds it, not the 3.35 TB/s of device memory.
//
// Design: one block per destination node, one thread per channel; sources
// go in chunks of 16 (row_attention.cuh). The edge-feature product uses the
// one-hot structure of edge_type: for each type only the sources of that
// type accumulate its 20 RBF rows and constant row, with the type's weights
// held in registers, so the 84- (or 126-) row product costs 21 (or 42)
// multiply-adds per channel and edge. Every per-edge intermediate lives in
// registers or shared memory; only the [B, N, H] (or [B, N, 3]) output is
// written. Simple first version: no tensor cores, weights through the
// read-only cache rather than staged in shared memory.
#include "row_attention.cuh"

using namespace rowattn;

namespace {

__constant__ float kRbfOffsets[20] = {0.f, 1.f, 1.25f, 1.5f, 1.75f, 2.f, 2.25f,
                                      2.5f, 2.75f, 3.f, 3.5f, 4.f, 4.5f, 5.f,
                                      5.5f, 6.f, 7.f, 8.f, 9.f, 10.f};
constexpr int R = 20;  // RBF features per edge type

struct EdgeArgs {
  const float* x;      // [B, N, 3]
  const float* lig;    // [B, N]
  const float* group;  // [B, N] or null (4 edge types)
  const int* idx;      // [B, N, K]
  const float* mask;   // [B, N, K]
  const float* ew;     // [B, N, K]
  const float* q;      // [B, N, H]
  Branch k, v;
  float* out;          // [B, N, H] or [B, N, 3]
  int N, K, H, n_heads, n_types, pos;
};

__global__ void edge_attention_kernel(EdgeArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;
  __shared__ float s_rbf[CH][R];
  __shared__ int s_ta[CH], s_tb[CH];

  const int H = a.H, K = a.K, N = a.N, F = a.n_types;
  const bool pos = a.pos != 0;
  float* Yk = smem;
  float* Yv = Yk + CH * H;
  float* Vs = Yv + CH * H;
  const int row = blockIdx.x;  // b * N + i
  const int b = row / N;
  const int c = threadIdx.x;
  const float* mrow = a.mask + (size_t)row * K;
  float* out_row = a.out + (size_t)row * (pos ? 3 : H);

  int any = 0;
  for (int t = c; t < K; t += blockDim.x) any |= mrow[t] > 0.5f;
  if (!__syncthreads_or(any)) {
    zero_row(out_row, pos);
    return;
  }

  const float q_c = a.q[(size_t)row * H + c];
  const float tk = a.k.t_row[(size_t)row * H + c];
  const float tv = a.v.t_row[(size_t)row * H + c];
  const float x0 = a.x[row * 3 + 0], x1 = a.x[row * 3 + 1],
              x2 = a.x[row * 3 + 2];
  const bool lig_d = a.lig[row] > 0.5f;
  const float g_d = a.group ? a.group[row] : 0.f;
  const float scale = 1.f / sqrtf((float)(H / a.n_heads));
  RowState st;

  for (int m0 = 0; m0 < K; m0 += CH) {
    const int nm = min(CH, K - m0);
    if (c < CH) {
      // per-edge scalars: source, validity, geometry, RBF and edge types
      int s = 0, ok = 0, ta = 3, tb = -1;
      float r0 = 0.f, r1 = 0.f, r2 = 0.f, d = 0.f, w = 1.f;
      if (c < nm) {
        const size_t e = (size_t)row * K + m0 + c;
        s = a.idx[e];
        const bool in_range = s >= 0 && s < N;
        ok = in_range && mrow[m0 + c] > 0.5f;
        if (!in_range) s = 0;
        const float* xs = a.x + ((size_t)b * N + s) * 3;
        r0 = x0 - xs[0];
        r1 = x1 - xs[1];
        r2 = x2 - xs[2];
        d = sqrtf(fmaxf(r0 * r0 + r1 * r1 + r2 * r2, 1e-12f));
        w = a.ew[e];
        const bool lig_s = a.lig[(size_t)b * N + s] > 0.5f;
        ta = lig_s ? (lig_d ? 0 : 1) : (lig_d ? 2 : 3);
        if (a.group) tb = 4 + (a.group[(size_t)b * N + s] == g_d ? 1 : 0);
      }
      cs.src[c] = s;
      cs.valid[c] = ok;
      cs.ew[c] = w;
      cs.rel[c * 3 + 0] = r0;
      cs.rel[c * 3 + 1] = r1;
      cs.rel[c * 3 + 2] = r2;
      s_ta[c] = ta;
      s_tb[c] = tb;
      for (int r = 0; r < R; ++r) {
        const float u = d - kRbfOffsets[r];
        s_rbf[c][r] = expf(-0.5f * u * u);
      }
    }
    __syncthreads();

    float pk[CH], pv[CH];
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const size_t srow = ((size_t)b * N + cs.src[m]) * H + c;
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
        if (s_ta[m] != t && s_tb[m] != t) continue;  // uniform over the block
        float sk = ck, sv = cv;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sk = fmaf(s_rbf[m][r], wk[r], sk);
          sv = fmaf(s_rbf[m][r], wv[r], sv);
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
    __syncthreads();
    finish_chunk(Yk, Yv, Vs, a.k, a.v, cs, nm, H, a.n_heads, pos, q_c, scale,
                 st);
  }
  finalize(st, out_row, Vs, H, a.n_heads, pos);
}

}  // namespace

extern "C" int edge_attention_fwd(
    const float* x, const float* lig, const float* group, const int* idx,
    const float* mask, const float* ew, const float* q,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb,
    float* out, int B, int N, int K, int H, int n_heads, int n_types, int pos,
    void* stream) {
  if (B * N == 0) return 0;
  EdgeArgs a{x, lig, group, idx, mask, ew, q,
             Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
             Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
             out, N, K, H, n_heads, n_types, pos};
  const size_t smem = smem_bytes(H, n_heads, 0);
  cudaError_t err = allow_smem(edge_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  edge_attention_kernel<<<B * N, H, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
