// What the three backward kernels (edge, bond, triplet) share.
//
// The backward of one destination row recomputes everything from the saved
// forward inputs; no per-source intermediate is read from device memory.
// Like the forward (row_attention.cuh), one thread owns one hidden channel
// and sources go in chunks of CH. A row takes two passes over its M sources:
//
//   pass A  per chunk: first linear (kernel-specific), LayerNorm/relu, the
//           second linears, and per (source, head) the logit and the part of
//           d alpha that depends on v. k of every source stays in shared
//           memory (Ks, [M][H]).
//   heads   per head: the masked softmax from the logits (the TPU kernels'
//           constants: max clamped at -1e29, sum at 1e-16), alpha, and
//           d logit = alpha (d alpha - sum_m alpha d alpha); per source d e_w
//           and, in pos mode, the coefficient of d rel.
//   pass B  per chunk: first linear and LayerNorm again (keeping xhat and
//           1/std), d of the second linears' outputs, the parameter
//           gradients of the second linears, d y = d_o Wo^T, the relu and
//           LayerNorm backward down to d pre; then the kernel's own part
//           (d t_src, d w_feat, the feature chain back to x or angle).
//
// Where the row buffers live: in dynamic shared memory when they fit beside
// the kernel's static arrays under the opt-in limit of a block, else in a
// device-memory scratch of a fixed number of floats per block that the
// caller allocates (SCRATCH). Every access to them is generic-address C++
// (float4 loads in matvec, no ld.shared), and the block barriers order the
// block's device-memory writes as they order its shared ones; so the same
// code runs from either base. The choice is a template parameter, so the
// shared-memory build compiles to the code it had before the scratch
// existed. Blocks of more than 256 threads (H > 256) take a 1024-thread
// build: each kernel's body is a device function, called by a kernel
// without a launch bound (H <= 256: as before, so it keeps its machine
// code; shared memory or scratch) and by one bound to 1024 threads and one
// block per SM (at most 64 registers a thread; without the block count
// ptxas gave the triplet's 32), which always takes the scratch: at the
// widths the configs use (H >= 512) the row buffers exceed shared memory
// anyway, and one route per build keeps each build to one tested variant.
//
// Parameter gradients are summed across rows in a per-block slot: registers
// for the small vectors, and for the matrices additions into the block's own
// slot in device memory (slot_add). After the main kernel, reduce_slots adds
// the slots in a fixed order, so every parameter gradient is deterministic.
//
// With the m-gate (GATE, edge node mode), v = vraw * g with g = sigmoid(s),
// s = vraw . wm + bm: pass A also keeps g and vraw per source, the heads
// stage forms d s = e_w g (1 - g) sum_h alpha sum_{c in head} g_c vraw_c,
// and pass B takes d vraw = d v g + d s wm.
#pragma once

#include "row_attention.cuh"

namespace rowbwd {

using namespace rowattn;

// One branch's parameter gradients inside a block's slot:
// [w_feat F*H | wo H*dout | bo dout | ln_scale H | ln_bias H].
struct GradSlot {
  float* wfeat;
  float* wo;
  float* bo;
  float* lns;
  float* lnb;
};

inline size_t branch_slot_floats(int F, int H, int dout) {
  return (size_t)F * H + (size_t)H * dout + dout + 2 * (size_t)H;
}

__device__ __forceinline__ GradSlot make_slot(float* base, int F, int H,
                                              int dout) {
  GradSlot s;
  s.wfeat = base;
  s.wo = s.wfeat + (size_t)F * H;
  s.bo = s.wo + (size_t)H * dout;
  s.lns = s.bo + dout;
  s.lnb = s.lns + H;
  return s;
}

// Adds v to an element of the block's slot. Only the calling thread ever
// updates that element, so its sum is taken in program order and is
// deterministic; as an atomic whose result is unused it compiles to a
// reduction (RED) that does not wait for the element's old value, where a
// load-add-store would stall on device-memory latency once per element.
__device__ __forceinline__ void slot_add(float* p, float v) { atomicAdd(p, v); }

// The k and v slots of this block: slots is [gridDim.x][Pk + Pv + extra],
// with `extra` floats of a kernel's own after the v slot.
__device__ __forceinline__ void block_slots(float* slots, int F, int H,
                                            int dout_v, GradSlot& sk,
                                            GradSlot& sv, int extra = 0) {
  const size_t pk = (size_t)F * H + (size_t)H * H + 3 * (size_t)H;
  const size_t pv = (size_t)F * H + (size_t)H * dout_v + dout_v + 2 * (size_t)H;
  float* base = slots + (size_t)blockIdx.x * (pk + pv + extra);
  sk = make_slot(base, F, H, H);
  sv = make_slot(base + pk, F, H, dout_v);
}

// Per-thread running sums of the small parameter gradients of both
// branches, stored into the block's slot once, at the end.
struct SmallGrads {
  float bo_k = 0.f, lns_k = 0.f, lnb_k = 0.f;
  float bo_v = 0.f, lns_v = 0.f, lnb_v = 0.f;
};

// Shared memory of one row's backward.
struct RowSmem {
  float* Yk;   // [CH][H] first-linear output, then y
  float* Yv;
  float* Xk;   // [CH][H] xhat
  float* Xv;
  float* Dk;   // [CH][H] d_o, then d xhat, then d pre (pos-mode v: d_o is
  float* Dv;   //   [CH][heads])
  float* Ks;   // [M][H] k of every source, bias included
  float* LG;   // [M][heads] logits, then alpha
  float* AUX;  // [M][heads] node: sum_{c in head} g_c vraw_c; pos: vraw
  float* DH;   // [M][heads] d logit
  float* VL;   // [M] 1 for a valid source
  float* EW;   // [M] edge weight (1 without one)
  float* GR;   // [M] pos mode: rel . g
  float* WR;   // [M] pos mode: d rel = WR * g
  float* DEW;  // [M] d e_w
  float* RS;   // [2][CH] 1/std of the k and v rows
  float* RED;  // [H/32][CH] cross-warp sums
  float* GT;   // [M] gate g (GATE only)
  float* DS;   // [M] d s, the gate's input (GATE only)
  float* VR;   // [M][H] vraw, v before the gate (GATE only)
};

inline size_t row_smem_floats(int M, int H, int n_heads, bool gate = false) {
  return (size_t)6 * CH * H + (size_t)M * H + (size_t)3 * M * n_heads +
         (size_t)5 * M + 2 * CH + (size_t)(H / 32) * CH +
         (gate ? (size_t)M * H + 2 * (size_t)M : 0);
}

// Lays out RowSmem from p (16-byte aligned; the [.][H] buffers that matvec
// reads as float4 come first so they stay aligned; the gate's buffers last).
__device__ __forceinline__ RowSmem carve(float* p, int M, int H,
                                         int n_heads, bool gate = false) {
  RowSmem s;
  s.Yk = p;
  s.Yv = s.Yk + CH * H;
  s.Xk = s.Yv + CH * H;
  s.Xv = s.Xk + CH * H;
  s.Dk = s.Xv + CH * H;
  s.Dv = s.Dk + CH * H;
  s.Ks = s.Dv + CH * H;
  s.LG = s.Ks + (size_t)M * H;
  s.AUX = s.LG + (size_t)M * n_heads;
  s.DH = s.AUX + (size_t)M * n_heads;
  s.VL = s.DH + (size_t)M * n_heads;
  s.EW = s.VL + M;
  s.GR = s.EW + M;
  s.WR = s.GR + M;
  s.DEW = s.WR + M;
  s.RS = s.DEW + M;
  s.RED = s.RS + 2 * CH;
  s.GT = gate ? s.RED + (H / 32) * CH : nullptr;
  s.DS = gate ? s.GT + M : nullptr;
  s.VR = gate ? s.DS + M : nullptr;
  return s;
}

// LayerNorm of the CH rows of P keeping what the backward needs:
// X <- xhat, rs <- 1/std, P <- relu(xhat * lns + lnb). Same arithmetic as
// ln_relu_rows.
__device__ __forceinline__ void ln_fwd_rows(float* P, float* X, float* rs,
                                            int H,
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
      const float xh = (row[c] - mean) * rstd;
      X[m * H + c] = xh;
      row[c] = fmaxf(xh * __ldg(lns + c) + __ldg(lnb + c), 0.f);
    }
    if (lane == 0) rs[m] = rstd;
  }
}

// In place, per row m: D <- rs_m * (D - mean(D) - X * mean(D * X)), the
// LayerNorm backward from d xhat to d pre.
__device__ __forceinline__ void ln_bwd_rows(float* D, const float* X,
                                            const float* rs, int H) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int m = threadIdx.x >> 5; m < CH; m += n_warps) {
    float* row = D + m * H;
    const float* xr = X + m * H;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < H; c += 32) {
      s1 += row[c];
      s2 += row[c] * xr[c];
    }
    const float m1 = warp_sum(s1) / H, m2 = warp_sum(s2) / H;
    const float r = rs[m];
    for (int c = lane; c < H; c += 32) row[c] = r * (row[c] - m1 - xr[c] * m2);
  }
}

// Pass A of one chunk of nm sources starting at m0, whose first-linear
// outputs are in Yk and Yv; with GATE also the gate and vraw of each source.
// Ends with a barrier.
template <bool GATE = false>
__device__ __forceinline__ void pass_a_chunk(const RowSmem& s, const Branch& k,
                                             const Branch& v, int m0, int nm,
                                             int H, int n_heads, bool pos,
                                             float q_c, float g_c, float scale,
                                             const Gate& gt = Gate{}) {
  const int c = threadIdx.x;
  ln_relu_rows(s.Yk, H, k.lns, k.lnb);
  ln_relu_rows(s.Yv, H, v.lns, v.lnb);
  __syncthreads();

  float kr[CH];
  matvec(s.Yk, k.wo, H, H, c, kr);
  const float bk = __ldg(k.bo + c);
  float vr[CH];
  float bv = 0.f;
  if (!pos) {
    matvec(s.Yv, v.wo, H, H, c, vr);
    bv = __ldg(v.bo + c);
  } else {
    for (int p = c; p < CH * n_heads; p += blockDim.x) {
      const int m = p / n_heads, h = p % n_heads;
      float a = __ldg(v.bo + h);
      for (int j = 0; j < H; ++j)
        a = fmaf(s.Yv[m * H + j], __ldg(v.wo + (size_t)j * n_heads + h), a);
      if (m < nm) s.AUX[(m0 + m) * n_heads + h] = a;
    }
  }
  if constexpr (GATE) {
    const float g = chunk_gate(vr, bv, gt, s.RED);
    if (c < nm) s.GT[m0 + c] = g;
#pragma unroll
    for (int m = 0; m < CH; ++m)
      if (m < nm) s.VR[(m0 + m) * H + c] = vr[m] + bv;
  }

  const int hd = H / n_heads;
  const int head = c / hd;
  const bool lead = c % hd == 0;
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const float kk = kr[m] + bk;
    float p = q_c * kk;
    float a = pos ? 0.f : g_c * (vr[m] + bv);
    for (int o = hd >> 1; o > 0; o >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, o);
      a += __shfl_xor_sync(0xffffffffu, a, o);
    }
    if (m < nm) {
      s.Ks[(m0 + m) * H + c] = kk;
      if (lead) {
        s.LG[(m0 + m) * n_heads + head] = p * scale;
        if (!pos) s.AUX[(m0 + m) * n_heads + head] = a;
      }
    }
  }
  __syncthreads();
}

// d alpha of source m, head h, from what pass A stored.
template <bool GATE = false>
__device__ __forceinline__ float d_alpha(const RowSmem& s, int m, int h,
                                         int n_heads, bool pos) {
  float a = s.AUX[m * n_heads + h] * s.EW[m];
  if constexpr (GATE) a *= s.GT[m];
  return pos ? a * s.GR[m] / n_heads : a;
}

// Softmax and its backward over the row's M sources; with GATE also d s.
// Ends with a barrier.
template <bool GATE = false>
__device__ __forceinline__ void head_stage(const RowSmem& s, int M,
                                           int n_heads, bool pos) {
  for (int h = threadIdx.x; h < n_heads; h += blockDim.x) {
    float mx = -1e29f;
    for (int m = 0; m < M; ++m)
      if (s.VL[m] != 0.f) mx = fmaxf(mx, s.LG[m * n_heads + h]);
    float l = 0.f;
    for (int m = 0; m < M; ++m)
      if (s.VL[m] != 0.f) l += expf(s.LG[m * n_heads + h] - mx);
    const float inv = 1.f / fmaxf(l, 1e-16f);
    float sd = 0.f;
    for (int m = 0; m < M; ++m) {
      const bool ok = s.VL[m] != 0.f;
      const float alpha = ok ? expf(s.LG[m * n_heads + h] - mx) * inv : 0.f;
      s.LG[m * n_heads + h] = alpha;
      if (ok) sd += alpha * d_alpha<GATE>(s, m, h, n_heads, pos);
    }
    for (int m = 0; m < M; ++m)
      s.DH[m * n_heads + h] =
          s.VL[m] != 0.f
              ? s.LG[m * n_heads + h] *
                    (d_alpha<GATE>(s, m, h, n_heads, pos) - sd)
              : 0.f;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float dew = 0.f;
    if (s.VL[m] != 0.f)
      for (int h = 0; h < n_heads; ++h)
        dew += s.LG[m * n_heads + h] * s.AUX[m * n_heads + h];
    // node: d e_w = sum_h alpha sum_{c in head} g_c vraw_c (times the gate)
    // pos:  d e_w = sum_h alpha vraw (rel . g) / heads, and
    //       d rel = g sum_h alpha vraw e_w / heads
    if constexpr (GATE) {
      const float gate = s.GT[m];
      s.DS[m] = s.EW[m] * dew * gate * (1.f - gate);
      dew *= gate;
    }
    s.DEW[m] = pos ? dew * s.GR[m] / n_heads : dew;
    s.WR[m] = pos ? dew * s.EW[m] / n_heads : 0.f;
  }
  __syncthreads();
}

// d q of the row: scale * sum_m d logit[m, head(c)] k[m, c].
__device__ __forceinline__ float row_d_q(const RowSmem& s, int M, int H,
                                         int n_heads, float scale) {
  const int c = threadIdx.x;
  const int head = c / (H / n_heads);
  float dq = 0.f;
  for (int m = 0; m < M; ++m)
    dq = fmaf(s.DH[m * n_heads + head], s.Ks[m * H + c], dq);
  return dq * scale;
}

// Pass B of one chunk whose first-linear outputs are in Yk and Yv: leaves
// d pre of both branches in Dk and Dv (zero for masked sources and rows past
// nm), adds the chunk's second-linear parameter gradients to the slots and
// the small sums, and d pre to the row sums trow_k / trow_v. woT_k and
// woT_v are the transposed [dout][H] second linears (woT_v unused in pos
// mode). With GATE, d vraw takes the gate's chain. Ends with a barrier.
template <bool GATE = false>
__device__ __forceinline__ void pass_b_chunk(
    const RowSmem& s, const Branch& k, const Branch& v,
    const float* __restrict__ woT_k, const float* __restrict__ woT_v,
    const GradSlot& sk, const GradSlot& sv, SmallGrads& acc, int m0, int nm,
    int H, int n_heads, bool pos, float q_c, float g_c, float scale,
    float& trow_k, float& trow_v, const Gate& gt = Gate{}) {
  const int c = threadIdx.x;
  const int head = c / (H / n_heads);
  ln_fwd_rows(s.Yk, s.Xk, s.RS, H, k.lns, k.lnb);
  ln_fwd_rows(s.Yv, s.Xv, s.RS + CH, H, v.lns, v.lnb);

  // d of the second linears' outputs
  float dko[CH], dvo[CH];
  float wm_c = 0.f;
  if constexpr (GATE) wm_c = __ldg(gt.wm + c);
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int mm = m0 + m;
    dko[m] = m < nm ? s.DH[mm * n_heads + head] * scale * q_c : 0.f;
    dvo[m] = (!pos && m < nm) ? s.LG[mm * n_heads + head] * g_c * s.EW[mm]
                              : 0.f;
    if constexpr (GATE)
      if (m < nm) dvo[m] = dvo[m] * s.GT[mm] + s.DS[mm] * wm_c;
    s.Dk[m * H + c] = dko[m];
    if (!pos) s.Dv[m * H + c] = dvo[m];
  }
  if (pos)
    for (int p = c; p < CH * n_heads; p += blockDim.x) {
      const int m = p / n_heads, h = p % n_heads, mm = m0 + m;
      s.Dv[p] = m < nm ? s.LG[mm * n_heads + h] * s.GR[mm] * s.EW[mm] /
                             n_heads
                       : 0.f;
    }
  __syncthreads();

  // bias gradients and d Wo = y^T d_o (thread c owns column c)
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    acc.bo_k += dko[m];
    acc.bo_v += dvo[m];
  }
  if (pos && c < n_heads)
    for (int m = 0; m < CH; ++m) acc.bo_v += s.Dv[m * n_heads + c];
  for (int j = 0; j < H; ++j) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      a = fmaf(s.Yk[m * H + j], dko[m], a);
      b = fmaf(s.Yv[m * H + j], dvo[m], b);
    }
    slot_add(sk.wo + (size_t)j * H + c, a);
    if (!pos) slot_add(sv.wo + (size_t)j * H + c, b);
  }
  if (pos)
    for (int p = c; p < H * n_heads; p += blockDim.x) {
      const int j = p / n_heads, h = p % n_heads;
      float a = 0.f;
      for (int m = 0; m < CH; ++m)
        a = fmaf(s.Yv[m * H + j], s.Dv[m * n_heads + h], a);
      slot_add(sv.wo + p, a);
    }

  // d y = d_o Wo^T (thread c computes channel c of each row)
  float dyk[CH], dyv[CH];
  matvec(s.Dk, woT_k, H, H, c, dyk);
  if (!pos) {
    matvec(s.Dv, woT_v, H, H, c, dyv);
  } else {
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      float a = 0.f;
      for (int h = 0; h < n_heads; ++h)
        a = fmaf(s.Dv[m * n_heads + h], __ldg(v.wo + (size_t)c * n_heads + h),
                 a);
      dyv[m] = a;
    }
  }
  __syncthreads();  // Dk and Dv are overwritten below

  // relu, LayerNorm scale and bias
  const float lsk = __ldg(k.lns + c), lsv = __ldg(v.lns + c);
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const float uk = s.Yk[m * H + c] > 0.f ? dyk[m] : 0.f;
    const float uv = s.Yv[m * H + c] > 0.f ? dyv[m] : 0.f;
    acc.lns_k = fmaf(uk, s.Xk[m * H + c], acc.lns_k);
    acc.lnb_k += uk;
    acc.lns_v = fmaf(uv, s.Xv[m * H + c], acc.lns_v);
    acc.lnb_v += uv;
    s.Dk[m * H + c] = uk * lsk;
    s.Dv[m * H + c] = uv * lsv;
  }
  __syncthreads();
  ln_bwd_rows(s.Dk, s.Xk, s.RS, H);
  ln_bwd_rows(s.Dv, s.Xv, s.RS + CH, H);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    trow_k += s.Dk[m * H + c];
    trow_v += s.Dv[m * H + c];
  }
}

// Stores the block's small parameter-gradient sums into its slot.
__device__ __forceinline__ void flush_small(const SmallGrads& acc,
                                            const GradSlot& sk,
                                            const GradSlot& sv, int n_heads,
                                            bool pos) {
  const int c = threadIdx.x;
  sk.bo[c] = acc.bo_k;
  sk.lns[c] = acc.lns_k;
  sk.lnb[c] = acc.lnb_k;
  if (!pos || c < n_heads) sv.bo[c] = acc.bo_v;
  sv.lns[c] = acc.lns_v;
  sv.lnb[c] = acc.lnb_v;
}

// Floats per block of the device-memory scratch for a backward kernel of
// width H whose row buffers take `floats`: 0 when they stay in shared
// memory (H <= 256, and they fit beside the kernel's static arrays), else a
// multiple of 32, so every block's base stays 128-byte aligned.
template <typename Kernel>
inline cudaError_t scratch_floats(Kernel kernel, int H, size_t floats,
                                  int* per_block) {
  bool fits = false;
  if (H <= 256) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    fits = sizeof(float) * floats + attr.sharedSizeBytes <= (size_t)optin;
  }
  *per_block = fits ? 0 : (int)((floats + 31) & ~(size_t)31);
  return cudaSuccess;
}

// The row buffers of block blockIdx.x: the scratch's share, or the dynamic
// shared memory.
template <bool SCRATCH>
__device__ __forceinline__ float* row_base(float* smem, float* scratch,
                                           int per_block) {
  return SCRATCH ? scratch + (size_t)blockIdx.x * per_block : smem;
}

// Launches a backward kernel over G blocks of H threads (a.f.H) with its
// `floats` row buffers in shared memory (in_smem) or, when they do not fit,
// in `scratch` (in_scratch, which then must hold G * per_block floats from
// scratch_floats). *route: 1 for the scratch, else 0.
template <typename Args>
inline cudaError_t launch_rows(void (*in_smem)(Args),
                               void (*in_scratch)(Args), Args& a, int G,
                               size_t floats, float* scratch, int* route,
                               cudaStream_t stream) {
  int per_block = 0;
  cudaError_t err = scratch_floats(in_smem, a.f.H, floats, &per_block);
  if (err != cudaSuccess) return err;
  *route = per_block > 0;
  if (per_block > 0) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    a.scratch = scratch;
    a.per_block = per_block;
    in_scratch<<<G, a.f.H, 0, stream>>>(a);
  } else {
    const size_t bytes = sizeof(float) * floats;
    err = allow_smem(in_smem, bytes);
    if (err != cudaSuccess) return err;
    in_smem<<<G, a.f.H, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

// out[p] = sum over the G slots of slots[g][p], in slot order.
__global__ void reduce_slots(const float* __restrict__ slots,
                             float* __restrict__ out, int G, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float t = 0.f;
  for (int g = 0; g < G; ++g) t += slots[(size_t)g * P + p];
  out[p] = t;
}

inline cudaError_t launch_reduce(const float* slots, float* out, int G,
                                 size_t P, cudaStream_t stream) {
  const int threads = 256;
  reduce_slots<<<(unsigned)((P + threads - 1) / threads), threads, 0,
                 stream>>>(slots, out, G, (int)P);
  return cudaGetLastError();
}

}  // namespace rowbwd
