// Bond-triplet angular attention for sm_90a.
//
// Replaces: the Pallas TPU kernel decompdiff_tpu/ops/pallas/triplet_kernel.py
//   (_fwd_call :172 -> _kernel :94-162), forward only.
//
// Computes, per bond edge (j -> i) and every third ligand atom k:
//   ang   = [a, sin(f a), cos(f a)], a = angle[i, j, k], f = 1,2,3,1,1/2,1/3
//   pre_m = ang @ Wa_m + t_src_m[j, k] + t_row_m[i, j]             (m = k, v)
//   k, v  = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
//   out[i, j] = sum_k softmax_k(q[i, j] . k / sqrt(hd)) v            [H]
// under bond[i, j] * bond[j, k] * (k != i). t_src (with the angular bias)
// and t_row are the factorized O(Nl^2) terms, computed before the launch.
//
// Bound on an H100: operations. At the released shapes (B=8, Nl=32, H=128)
// one call is ~17 GFLOP of per-triplet products (the two [H, H] second
// linears are 90% of it) against ~26 MB of inputs and output, as
// chip_smoke.py counts them; FP32 CUDA-core throughput bounds it, and it is
// the largest kernel of a denoiser call.
//
// Design: one block per (complex, i, j), one thread per channel; the k axis
// goes in chunks of 16 (row_attention.cuh). The 13-wide angular code is
// built in shared memory with sincosf (no polynomial) and projected with
// Wa's column held in registers; no O(Nl^3 H) intermediate leaves the SM.
// A row whose bond (j -> i) is masked writes zeros without computing.
#include "row_attention.cuh"

using namespace rowattn;

namespace {

constexpr int A = 13;  // angular code width
__constant__ float kFreqs[6] = {1.f, 2.f, 3.f, 1.f, 0.5f, 1.f / 3.f};

struct TripletArgs {
  const float* angle;  // [B, Nl, Nl, Nl]
  const float* mask;   // [B, Nl, Nl]
  const float* q;      // [B, Nl, Nl, H]
  Branch k, v;
  float* out;          // [B, Nl, Nl, H]
  int Nl, H, n_heads;
};

__global__ void triplet_attention_kernel(TripletArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;
  __shared__ float s_ang[CH][A];

  const int H = a.H, Nl = a.Nl;
  float* Yk = smem;
  float* Yv = Yk + CH * H;
  float* Vs = Yv + CH * H;
  const int row = blockIdx.x;  // (b * Nl + i) * Nl + j
  const int bi = row / Nl;
  const int b = bi / Nl, i = bi % Nl, j = row % Nl;
  const int c = threadIdx.x;
  const float* mrow_j = a.mask + ((size_t)b * Nl + j) * Nl;  // bonds k -> j
  float* out_row = a.out + (size_t)row * H;

  int any = 0;
  if (a.mask[row] > 0.5f)
    for (int t = c; t < Nl; t += blockDim.x) any |= t != i && mrow_j[t] > 0.5f;
  if (!__syncthreads_or(any)) {
    zero_row(out_row, false);
    return;
  }

  const float q_c = a.q[(size_t)row * H + c];
  const float tk = a.k.t_row[(size_t)row * H + c];
  const float tv = a.v.t_row[(size_t)row * H + c];
  float wak[A], wav[A];
#pragma unroll
  for (int t = 0; t < A; ++t) {
    wak[t] = __ldg(a.k.w_feat + (size_t)t * H + c);
    wav[t] = __ldg(a.v.w_feat + (size_t)t * H + c);
  }
  const float scale = 1.f / sqrtf((float)(H / a.n_heads));
  RowState st;

  for (int m0 = 0; m0 < Nl; m0 += CH) {
    const int nm = min(CH, Nl - m0);
    if (c < CH) {
      const int kk = m0 + c;
      const bool in = c < nm;
      cs.src[c] = in ? kk : 0;
      cs.valid[c] = in && kk != i && mrow_j[kk] > 0.5f;
      cs.ew[c] = 1.f;
      const float ang = in ? a.angle[(size_t)row * Nl + kk] : 0.f;
      s_ang[c][0] = ang;
      for (int t = 0; t < 6; ++t) {
        float s, co;
        sincosf(ang * kFreqs[t], &s, &co);
        s_ang[c][1 + t] = s;
        s_ang[c][7 + t] = co;
      }
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const size_t srow = (((size_t)b * Nl + j) * Nl + cs.src[m]) * H + c;
      float pk = tk + __ldg(a.k.t_src + srow);
      float pv = tv + __ldg(a.v.t_src + srow);
#pragma unroll
      for (int t = 0; t < A; ++t) {
        pk = fmaf(s_ang[m][t], wak[t], pk);
        pv = fmaf(s_ang[m][t], wav[t], pv);
      }
      Yk[m * H + c] = pk;
      Yv[m * H + c] = pv;
    }
    __syncthreads();
    finish_chunk(Yk, Yv, Vs, a.k, a.v, cs, nm, H, a.n_heads, false, q_c,
                 scale, st);
  }
  finalize(st, out_row, Vs, H, a.n_heads, false);
}

}  // namespace

extern "C" int triplet_attention_fwd(
    const float* angle, const float* mask, const float* q,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb,
    float* out, int B, int Nl, int H, int n_heads, void* stream) {
  if (B * Nl == 0) return 0;
  TripletArgs a{angle, mask, q,
                Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
                Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
                out, Nl, H, n_heads};
  const size_t smem = smem_bytes(H, n_heads, 0);
  cudaError_t err = allow_smem(triplet_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  triplet_attention_kernel<<<B * Nl * Nl, H, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
