// Bond-triplet angular attention for sm_90a: forward and backward.
//
// Replaces: the Pallas TPU kernels decompdiff_tpu/ops/pallas/triplet_kernel.py
//   forward  _fwd_call :172 -> _kernel :94-162,
//   backward _bwd_call :371 -> _bwd_kernel :237-368.
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
// one forward is ~17 GFLOP of per-triplet products (the two [H, H] second
// linears are 90% of it) against ~26 MB of inputs and output, as
// chip_smoke.py counts them; FP32 CUDA-core throughput bounds it, and it is
// the largest kernel of a denoiser call. The backward recomputes the
// forward and adds two products per forward product (~52 GFLOP), still
// against O(Nl^3) bytes, so it is bound the same way.
//
// Forward design: one block per (complex, i, j), one thread per channel;
// the k axis goes in chunks of 16 (row_attention.cuh). The 13-wide angular
// code is built in shared memory with sincosf (no polynomial) and projected
// with Wa's column held in registers; no O(Nl^3 H) intermediate leaves the
// SM. A row whose bond (j -> i) is masked writes zeros without computing.
//
// Backward design (row_attention_bwd.cuh): the TPU kernel sums
// d t_src[j, k] = sum_i d pre[i, j, k] over its sequential grid. Here a
// block owns one (complex, j) at a time and loops over the rows i, keeping
// d t_src[j, :, :] of both branches ([Nl][H] each) in shared memory, so the
// sum is deterministic and written once; d t_row, d q and d angle are per
// row and written directly. d Wa stays in registers per thread until the
// block ends. Every per-triplet intermediate is recomputed in shared memory.
#include "row_attention_bwd.cuh"

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

// Threads c < CH: validity and angular code of sources k = m0 .. m0+nm-1 of
// row (b, i, j), and with dang the code's derivative in the angle.
__device__ __forceinline__ void triplet_chunk_setup(
    const TripletArgs& a, ChunkSources& cs, float (*ang)[A], float (*dang)[A],
    int row, int i, const float* mrow_j, int m0, int nm) {
  const int c = threadIdx.x;
  if (c >= CH) return;
  const int kk = m0 + c;
  const bool in = c < nm;
  cs.src[c] = in ? kk : 0;
  cs.valid[c] = in && kk != i && mrow_j[kk] > 0.5f;
  cs.ew[c] = 1.f;
  const float x = in ? a.angle[(size_t)row * a.Nl + kk] : 0.f;
  ang[c][0] = x;
  if (dang) dang[c][0] = 1.f;
  for (int t = 0; t < 6; ++t) {
    float s, co;
    sincosf(x * kFreqs[t], &s, &co);
    ang[c][1 + t] = s;
    ang[c][7 + t] = co;
    if (dang) {
      dang[c][1 + t] = kFreqs[t] * co;
      dang[c][7 + t] = -kFreqs[t] * s;
    }
  }
}

// Every thread: the first-linear outputs of the chunk for channel c.
__device__ __forceinline__ void triplet_chunk_pre(
    const TripletArgs& a, const ChunkSources& cs, const float (*ang)[A],
    const float (&wak)[A], const float (&wav)[A], int b, int j, float tk,
    float tv, float* Yk, float* Yv) {
  const int c = threadIdx.x, H = a.H, Nl = a.Nl;
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const size_t srow = (((size_t)b * Nl + j) * Nl + cs.src[m]) * H + c;
    float pk = tk + __ldg(a.k.t_src + srow);
    float pv = tv + __ldg(a.v.t_src + srow);
#pragma unroll
    for (int t = 0; t < A; ++t) {
      pk = fmaf(ang[m][t], wak[t], pk);
      pv = fmaf(ang[m][t], wav[t], pv);
    }
    Yk[m * H + c] = pk;
    Yv[m * H + c] = pv;
  }
}

// True if bond (j -> i) is real and some k != i has a bond (k -> j).
__device__ __forceinline__ bool row_has_source(const TripletArgs& a, int row,
                                               int i, const float* mrow_j) {
  int any = 0;
  if (a.mask[row] > 0.5f)
    for (int t = threadIdx.x; t < a.Nl; t += blockDim.x)
      any |= t != i && mrow_j[t] > 0.5f;
  return __syncthreads_or(any);
}

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

  if (!row_has_source(a, row, i, mrow_j)) {
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
    triplet_chunk_setup(a, cs, s_ang, nullptr, row, i, mrow_j, m0, nm);
    __syncthreads();
    triplet_chunk_pre(a, cs, s_ang, wak, wav, b, j, tk, tv, Yk, Yv);
    __syncthreads();
    finish_chunk(Yk, Yv, Vs, a.k, a.v, cs, nm, H, a.n_heads, false, q_c,
                 scale, st);
  }
  finalize(st, out_row, Vs, H, a.n_heads, false);
}

struct TripletBwdArgs {
  TripletArgs f;         // forward inputs (f.out unused)
  const float* g;        // [B, Nl, Nl, H] output cotangent
  const float* woT_k;    // [H, H] transposed Wo_k
  const float* woT_v;    // [H, H] transposed Wo_v
  float* d_angle;        // [B, Nl, Nl, Nl] zeroed
  float* d_q;            // [B, Nl, Nl, H]
  float* d_trow_k;       // [B, Nl, Nl, H]  (i, j)
  float* d_tsrc_k;       // [B, Nl, Nl, H]  (j, k)
  float* d_trow_v;
  float* d_tsrc_v;
  float* slots;          // [gridDim.x][P] zeroed parameter-gradient slots
  int items;             // B * Nl work items (b, j)
};

__global__ void triplet_attention_bwd_kernel(TripletBwdArgs a) {
  using namespace rowbwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;
  __shared__ float s_ang[CH][A];
  __shared__ float s_dang[CH][A];

  const TripletArgs& f = a.f;
  const int H = f.H, Nl = f.Nl, nh = f.n_heads;
  const int c = threadIdx.x;
  float* TSk = smem;                     // [Nl][H] d t_src[j, k] sums
  float* TSv = TSk + (size_t)Nl * H;
  const RowSmem s = carve(TSv + (size_t)Nl * H, Nl, H, nh);
  const float scale = 1.f / sqrtf((float)(H / nh));
  GradSlot sk, sv;
  block_slots(a.slots, A, H, H, sk, sv);
  SmallGrads acc;
  float wak[A], wav[A], gwak[A], gwav[A];
#pragma unroll
  for (int t = 0; t < A; ++t) {
    wak[t] = __ldg(f.k.w_feat + (size_t)t * H + c);
    wav[t] = __ldg(f.v.w_feat + (size_t)t * H + c);
    gwak[t] = 0.f;
    gwav[t] = 0.f;
  }

  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int b = item / Nl, j = item % Nl;
    const float* mrow_j = f.mask + ((size_t)b * Nl + j) * Nl;
    for (int kk = 0; kk < Nl; ++kk) {  // column c is this thread's alone
      TSk[kk * H + c] = 0.f;
      TSv[kk * H + c] = 0.f;
    }
    for (int i = 0; i < Nl; ++i) {
      const int row = (b * Nl + i) * Nl + j;
      if (!row_has_source(f, row, i, mrow_j)) {
        a.d_q[(size_t)row * H + c] = 0.f;
        a.d_trow_k[(size_t)row * H + c] = 0.f;
        a.d_trow_v[(size_t)row * H + c] = 0.f;
        continue;
      }
      const float q_c = f.q[(size_t)row * H + c];
      const float tk = f.k.t_row[(size_t)row * H + c];
      const float tv = f.v.t_row[(size_t)row * H + c];
      const float g_c = a.g[(size_t)row * H + c];

      // pass A
      for (int m0 = 0; m0 < Nl; m0 += CH) {
        const int nm = min(CH, Nl - m0);
        triplet_chunk_setup(f, cs, s_ang, nullptr, row, i, mrow_j, m0, nm);
        if (c < nm) {
          s.VL[m0 + c] = cs.valid[c] ? 1.f : 0.f;
          s.EW[m0 + c] = 1.f;
          s.GR[m0 + c] = 0.f;
        }
        __syncthreads();
        triplet_chunk_pre(f, cs, s_ang, wak, wav, b, j, tk, tv, s.Yk, s.Yv);
        __syncthreads();
        pass_a_chunk(s, f.k, f.v, m0, nm, H, nh, false, q_c, g_c, scale);
      }
      head_stage(s, Nl, nh, false);
      a.d_q[(size_t)row * H + c] = row_d_q(s, Nl, H, nh, scale);

      // pass B
      float trow_k = 0.f, trow_v = 0.f;
      for (int m0 = 0; m0 < Nl; m0 += CH) {
        const int nm = min(CH, Nl - m0);
        triplet_chunk_setup(f, cs, s_ang, s_dang, row, i, mrow_j, m0, nm);
        __syncthreads();
        triplet_chunk_pre(f, cs, s_ang, wak, wav, b, j, tk, tv, s.Yk, s.Yv);
        __syncthreads();
        pass_b_chunk(s, f.k, f.v, a.woT_k, a.woT_v, sk, sv, acc, m0, nm, H,
                     nh, false, q_c, g_c, scale, trow_k, trow_v);

        float sd[CH];
#pragma unroll
        for (int m = 0; m < CH; ++m) {
          sd[m] = 0.f;
          if (m >= nm || !cs.valid[m]) continue;  // uniform over the block
          const float dk = s.Dk[m * H + c], dv = s.Dv[m * H + c];
          TSk[(m0 + m) * H + c] += dk;
          TSv[(m0 + m) * H + c] += dv;
          float e = 0.f;
#pragma unroll
          for (int t = 0; t < A; ++t) {
            gwak[t] = fmaf(s_ang[m][t], dk, gwak[t]);
            gwav[t] = fmaf(s_ang[m][t], dv, gwav[t]);
            e = fmaf(s_dang[m][t], fmaf(dk, wak[t], dv * wav[t]), e);
          }
          sd[m] = e;
        }
        const float d_ang = block_sum_ch(sd, s.RED);
        if (c < nm && cs.valid[c])
          a.d_angle[(size_t)row * Nl + m0 + c] = d_ang;
        __syncthreads();  // the next chunk overwrites cs and the buffers
      }
      a.d_trow_k[(size_t)row * H + c] = trow_k;
      a.d_trow_v[(size_t)row * H + c] = trow_v;
    }
    for (int kk = 0; kk < Nl; ++kk) {
      const size_t o = (((size_t)b * Nl + j) * Nl + kk) * H + c;
      a.d_tsrc_k[o] = TSk[kk * H + c];
      a.d_tsrc_v[o] = TSv[kk * H + c];
    }
  }
#pragma unroll
  for (int t = 0; t < A; ++t) {
    sk.wfeat[(size_t)t * H + c] = gwak[t];
    sv.wfeat[(size_t)t * H + c] = gwav[t];
  }
  flush_small(acc, sk, sv, nh, false);
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

// Backward: G blocks over the B*Nl (complex, j) items, then the fixed-order
// slot sum into d_params ([k: w_feat, wo, bo, ln_scale, ln_bias | v: same]).
extern "C" int triplet_attention_bwd(
    const float* angle, const float* mask, const float* q, const float* g,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb, const float* k_woT,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb, const float* v_woT,
    float* d_angle, float* d_q, float* d_trow_k, float* d_tsrc_k,
    float* d_trow_v, float* d_tsrc_v, float* slots, float* d_params,
    int B, int Nl, int H, int n_heads, int G, void* stream) {
  if (B * Nl == 0 || G <= 0) return 0;
  TripletBwdArgs a{
      TripletArgs{angle, mask, q,
                  Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
                  Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
                  nullptr, Nl, H, n_heads},
      g, k_woT, v_woT, d_angle, d_q, d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v,
      slots, B * Nl};
  const size_t smem = sizeof(float) * (2 * (size_t)Nl * H +
                                       rowbwd::row_smem_floats(Nl, H, n_heads));
  cudaError_t err = allow_smem(triplet_attention_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  triplet_attention_bwd_kernel<<<G, H, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t P = 2 * rowbwd::branch_slot_floats(A, H, H);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P,
                                    (cudaStream_t)stream);
}
