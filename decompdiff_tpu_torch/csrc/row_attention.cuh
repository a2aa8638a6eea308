// What the three attention kernels (edge, bond, triplet) share.
//
// Each kernel runs one thread block per destination row with one thread per
// hidden channel (blockDim.x == H). A row's sources are taken in chunks of
// CH: the kernel writes the chunk's first-linear outputs `pre` for the k and
// v branches into shared memory (Yk, Yv, [CH][H] each), then finish_chunk
//   * applies LayerNorm (eps 1e-5), scale, bias and relu, one warp per source
//     row, reduced with warp shuffles;
//   * multiplies by Wo (thread c owns output column c and keeps CH
//     accumulators in registers; rows are read from shared memory as float4,
//     Wo through the read-only cache);
//   * forms each head's logit q . k / sqrt(hd) by shuffles over the head's hd
//     lanes and folds it into an online softmax.
// Masking matches the TPU kernels: the running max starts at -1e29 (their
// clamp), masked sources contribute nothing, and the sum is clamped at 1e-16,
// so a row without a valid source gives exactly 0. No block depends on
// another.
//
// The edge kernel's node mode has an optional m-gate (uni_o2, ew_net_type
// 'm'): v <- v * sigmoid(v . wm + bm) per source, before the edge weight.
// It is a template parameter of finish_chunk (and of the backward passes),
// so the kernels without it compile to the code they had before it existed.
// So is BF16, the triplet forward's `bf16` option: the second linears take
// y and Wo rounded to bf16 (exact products, float32 sums).
//
// The edge and triplet forwards run on this chunk body at the widths their
// tensor-core kernels (row_mma.cuh) do not take; the bond forward at every
// width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rowattn {

constexpr int CH = 16;  // sources per chunk

struct Branch {
  const float* t_row;   // per-row term of the first linear (bias folded in)
  const float* t_src;   // per-source term of the first linear
  const float* w_feat;  // per-pair feature projection [F][H]
  const float* wo;      // second linear [H][Dout]
  const float* bo;      // [Dout]
  const float* lns;     // LayerNorm scale [H]
  const float* lnb;     // LayerNorm bias [H]
};

// Per-chunk source data that finish_chunk reads (filled by the kernel).
struct ChunkSources {
  int valid[CH];
  int src[CH];
  float ew[CH];      // edge weight multiplying v (1 where there is none)
  float rel[CH * 3]; // x_dst - x_src, pos mode only
};

// One thread's online-softmax state: its head's running max and sum, and
// its accumulators (node mode: acc[0] is channel c; pos mode: 3 coordinates).
struct RowState {
  float m = -1e29f;
  float l = 0.f;
  float acc[3] = {0.f, 0.f, 0.f};
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Returns, in threads 0 .. CH-1, the block-wide sum of vals[threadIdx.x].
// RED is [blockDim.x / 32][CH] floats of shared memory. Contains barriers.
__device__ __forceinline__ float block_sum_ch(const float (&vals)[CH],
                                              float* RED) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const float t = warp_sum(vals[m]);
    if (lane == 0) RED[warp * CH + m] = t;
  }
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < CH)
    for (int w = 0; w < n_warps; ++w) t += RED[w * CH + threadIdx.x];
  __syncthreads();
  return t;
}

// The m-gate's parameters and, in the forward, its shared scratch.
struct Gate {
  const float* wm = nullptr;  // [H]
  const float* bm = nullptr;  // [1]
  float* red = nullptr;       // shared [H/32][CH]: block_sum_ch scratch
  float* g = nullptr;         // shared [CH]: the chunk's gates (forward)
};

// Threads c < CH: the gate sigmoid(v_c . wm + bm) of source c of a chunk,
// where thread j holds channel j of every source's v as vr[m] + bv. Every
// thread must call it (it contains barriers).
__device__ __forceinline__ float chunk_gate(const float (&vr)[CH], float bv,
                                           const Gate& gt, float* red) {
  const float w = __ldg(gt.wm + threadIdx.x);
  float part[CH];
#pragma unroll
  for (int m = 0; m < CH; ++m) part[m] = (vr[m] + bv) * w;
  const float s = block_sum_ch(part, red) + __ldg(gt.bm);
  return 1.f / (1.f + expf(-s));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// In place: rows [0, CH) of P [CH][H] <- relu(LayerNorm(row) * lns + lnb),
// rounded to bf16 with BF16.
template <bool BF16 = false>
__device__ __forceinline__ void ln_relu_rows(float* P, int H,
                                             const float* __restrict__ lns,
                                             const float* __restrict__ lnb) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int m = threadIdx.x >> 5; m < CH; m += n_warps) {
    float* row = P + m * H;
    float s = 0.f;
    for (int c = lane; c < H; c += 32) s += row[c];
    const float mean = warp_sum(s) / H;
    float s2 = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float d = row[c] - mean;
      s2 += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s2) / H + 1e-5f);
    for (int c = lane; c < H; c += 32) {
      const float y = fmaxf(
          (row[c] - mean) * rstd * __ldg(lns + c) + __ldg(lnb + c), 0.f);
      row[c] = BF16 ? round_bf16(y) : y;
    }
  }
}

// acc[m] = sum_j X[m][j] * W[j][col] for the CH rows of X [CH][H] (shared);
// with BF16, W rounded to bf16.
template <bool BF16 = false>
__device__ __forceinline__ void matvec(const float* X,
                                       const float* __restrict__ W, int H,
                                       int ld, int col, float (&acc)[CH]) {
#pragma unroll
  for (int m = 0; m < CH; ++m) acc[m] = 0.f;
  for (int j = 0; j < H; j += 4) {
    float w0 = __ldg(W + (size_t)(j + 0) * ld + col);
    float w1 = __ldg(W + (size_t)(j + 1) * ld + col);
    float w2 = __ldg(W + (size_t)(j + 2) * ld + col);
    float w3 = __ldg(W + (size_t)(j + 3) * ld + col);
    if (BF16) {
      w0 = round_bf16(w0);
      w1 = round_bf16(w1);
      w2 = round_bf16(w2);
      w3 = round_bf16(w3);
    }
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const float4 x = *reinterpret_cast<const float4*>(X + m * H + j);
      acc[m] = fmaf(x.x, w0, acc[m]);
      acc[m] = fmaf(x.y, w1, acc[m]);
      acc[m] = fmaf(x.z, w2, acc[m]);
      acc[m] = fmaf(x.w, w3, acc[m]);
    }
  }
}

// LayerNorm/relu, second linear, logits and online softmax for one chunk of
// nm sources whose `pre` rows are in Yk and Yv. Vs holds [CH][heads] v
// outputs in pos mode. GATE (node mode only) applies the m-gate `gt`; BF16
// (node mode only) rounds y and Wo to bf16 before the second linears. Ends
// with a barrier, so the caller may overwrite the shared buffers for the
// next chunk.
template <bool GATE = false, bool BF16 = false>
__device__ __forceinline__ void finish_chunk(
    float* Yk, float* Yv, float* Vs, const Branch& k, const Branch& v,
    const ChunkSources& cs, int nm, int H, int n_heads, bool pos, float q_c,
    float scale, RowState& st, const Gate& gt = Gate{}) {
  const int c = threadIdx.x;
  ln_relu_rows<BF16>(Yk, H, k.lns, k.lnb);
  ln_relu_rows<BF16>(Yv, H, v.lns, v.lnb);
  __syncthreads();

  float kr[CH];
  matvec<BF16>(Yk, k.wo, H, H, c, kr);
  const float bk = __ldg(k.bo + c);
  float vr[CH];
  float bv = 0.f;
  if (!pos) {
    matvec<BF16>(Yv, v.wo, H, H, c, vr);
    bv = __ldg(v.bo + c);
  } else {
    // v has one output per head: CH * heads dot products shared by the block
    for (int p = c; p < CH * n_heads; p += blockDim.x) {
      const int m = p / n_heads, h = p % n_heads;
      float a = __ldg(v.bo + h);
      for (int j = 0; j < H; ++j)
        a = fmaf(Yv[m * H + j], __ldg(v.wo + (size_t)j * n_heads + h), a);
      Vs[p] = a * cs.ew[m];
    }
    __syncthreads();
  }
  if constexpr (GATE) {
    const float g = chunk_gate(vr, bv, gt, gt.red);
    if (c < CH) gt.g[c] = g;
    __syncthreads();
  }

  const int hd = H / n_heads;
  const int head = c / hd;
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    float p = q_c * (kr[m] + bk);
    for (int o = hd >> 1; o > 0; o >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, o);
    if (m >= nm || !cs.valid[m]) continue;  // uniform over the block
    const float logit = p * scale;
    const float mn = fmaxf(st.m, logit);
    const float sc = expf(st.m - mn);
    const float e = expf(logit - mn);
    st.l = st.l * sc + e;
    st.m = mn;
    if (!pos) {
      if constexpr (GATE)
        st.acc[0] = st.acc[0] * sc + e * ((vr[m] + bv) * gt.g[m]) * cs.ew[m];
      else
        st.acc[0] = st.acc[0] * sc + e * (vr[m] + bv) * cs.ew[m];
    } else {
      const float w = e * Vs[m * n_heads + head];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        st.acc[d] = st.acc[d] * sc + w * cs.rel[m * 3 + d];
    }
  }
  __syncthreads();
}

// Writes the row's output: node mode out_row[c]; pos mode the mean over
// heads of each head's sum_k alpha v rel, reduced in a fixed order through
// `red` (>= heads * 3 floats of shared memory).
__device__ __forceinline__ void finalize(const RowState& st, float* out_row,
                                         float* red, int H, int n_heads,
                                         bool pos) {
  const int c = threadIdx.x;
  const float inv = 1.f / fmaxf(st.l, 1e-16f);
  if (!pos) {
    out_row[c] = st.acc[0] * inv;
    return;
  }
  const int hd = H / n_heads;
  if (c % hd == 0) {
    const int h = c / hd;
    for (int d = 0; d < 3; ++d) red[h * 3 + d] = st.acc[d] * inv;
  }
  __syncthreads();
  if (c < 3) {
    float s = 0.f;
    for (int h = 0; h < n_heads; ++h) s += red[h * 3 + c];
    out_row[c] = s / n_heads;
  }
}

// Zero output for a row without any valid source.
__device__ __forceinline__ void zero_row(float* out_row, bool pos) {
  if (!pos || threadIdx.x < 3) out_row[threadIdx.x] = 0.f;
}

// Dynamic shared memory of a kernel with `extra_rows` more [CH][H] buffers
// than Yk and Yv, plus the [CH][heads] Vs buffer.
inline size_t smem_bytes(int H, int n_heads, int extra_rows) {
  return sizeof(float) * ((size_t)(2 + extra_rows) * CH * H +
                          (size_t)CH * n_heads);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rowattn
