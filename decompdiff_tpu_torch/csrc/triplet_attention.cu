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
// one forward is ~19 GFLOP of per-triplet products against ~26 MB of
// inputs and output, as chip_smoke.py counts them; the two [H, H] second
// linears are ~17 GFLOP of it, and the largest kernel of a denoiser call.
// The backward, head-factorized (head_bwd.cuh), needs no per-triplet
// [H, H] product: ~13 GFLOP at those shapes (chip_smoke.py), against
// O(Nl^3) bytes.
//
// Forward design, H in 32, 64, 128 (wgmma.cuh): a persistent grid of one
// block per SM, two warpgroups that never wait for each other once the
// block has staged Wo_k and Wo_v (bf16 hi + lo) and Wa_k and Wa_v (fp16 hi
// + lo, 13 rows padded to 16) as wgmma B operands. A warpgroup's unit is
// half the rows i of an item (b, j): it copies the item's t_src rows of both
// branches into its own shared memory (when the layout fits; else it reads
// them through the cache), then walks tiles of 2 rows i x 32 sources k, 64
// pair rows, wgmma's M (more k: an online softmax across chunks of 32);
// warp w holds the pair rows (i0 + w / 2, k0 + 16 (w % 2) + [0, 16)). At a
// tile's start each warp copies its row's q into its shared memory
// (cp.async; when the layout fits). Per chunk, in turn:
//   1. the 13-wide angular code of the warp's rows, once for both branches
//      (sincosf over the warp's lanes), as fp16 A registers hi + lo;
//   2. k: pre = t_row + t_src in the accumulator layout, += ang @ Wa_k on
//      the tensor cores (three passes); LayerNorm and relu in registers
//      (four lanes hold a row: two shuffles a sum), split into bf16 hi + lo
//      A registers; k = y Wo_k + bo_k as wgmma m64nHk16 with A from
//      registers, its accumulator started at bo_k;
//   3. the logits q . k (at a head width of 8, a head's column block summed
//      over the row's four lanes by halving) and the online softmax of the
//      warp's 16 sources (lanes over heads);
//   4. v: the same pre and LayerNorm, y_v Wo_v, and sum e v over the warp's
//      rows, kept as H / 32 columns a lane.
// The two warps of a row i keep their own softmax states and merge them at
// the end of the tile through shared memory (a 128-thread named barrier).
// So one warpgroup's CUDA-core stages run while the other's products hold
// the tensor cores. Inside a warpgroup the stages run in turn: y_v held
// across the k product and the logits took the registers that the loads of
// q and bo_k needed, and those loads then waited one after another. The
// three passes stay: y and Wo in bf16 hi + lo, the lo*lo term dropped, keep
// each product within about 2^-16 relative, the float32 contract; `bf16`
// (the `pallas_bf16` option of the TPU kernel, triplet_kernel.py:121-126)
// is the single hi*hi pass of the second linears. The angular product takes
// fp16 hi + lo (2^-22; the code lies in [-pi, pi], Wa far inside fp16's
// range): in bf16 it moved y enough that, with `bf16`, y rounded to the
// other bf16 neighbour 40x as often as from a float32 product (PERF.md).
// Shared memory at H = 128, 16 heads: Wo 128 KB, Wa 16 KB, per warp 1.8 KB
// (its row's q, the logits and weights of its rows, rescale factors), per
// warpgroup 2.5 KB for the merge: 163.5 KB. The unit's t_src (32 KB a
// warpgroup at Nl = 32) would make it 227.5 KB, over the 227 KB, so there
// t_src is read through the cache (staged with `bf16`, and at H = 32, 64);
// q in shared memory gained more than t_src did (PERF.md). No O(Nl^3 H)
// intermediate leaves the SM; a chunk without a valid triplet is skipped,
// and a row without one writes zeros.
// What bounds it (clock64 phase counts of thread 0 of each warpgroup, B =
// 100, Nl = 32, an H100; PERF.md): no one phase; the CUDA-core stages of a
// warpgroup in turn. The angular code takes 15% of the cycles, the two
// pre's 19%, the two LayerNorms 18%, the logits and the softmax 18%, the
// merge 7%, the issue of the products and the waits for them 20%. H = 128
// runs at 255 registers with 156 B of spill stores (bf16: 76 B).
//
// Forward design at every other width (a multiple of 32 up to 1024 whose
// head width divides 32; row_attention.cuh): one block per (complex, i, j),
// one thread per channel; the k axis goes in chunks of 16. The 13-wide
// angular code is built in shared memory with sincosf and projected with
// Wa's column held in registers; the second linears read Wo through the
// cache (with `bf16`, y and Wo rounded to bf16 first). A row whose bond
// (j -> i) is masked writes zeros without computing. The blocks of
// H > 256 threads are compiled for 1024 threads (at most 64 registers).
//
// Backward: the TPU kernel sums d t_src[j, k] = sum_i d pre[i, j, k] over
// its sequential grid. Here a block owns one (complex, j) at a time and
// loops over the rows i, keeping d t_src[j, :, :] of both branches ([Nl][H]
// each) in shared memory, so the sum is deterministic and written once;
// d t_row, d q and d angle are per row and written directly. Parameter
// gradients are summed per block and then over the blocks' slots in a fixed
// order, so two launches give bitwise-equal gradients.
//
// Backward design, H in 32, 64, 128 with at most 16 heads and Nl up to 64
// (head_bwd.cuh): the output cotangent factorizes by head, so the [H, H]
// products move to the row (Qk, Gv, d q, d Wo: five per row) and the
// per-triplet ones shrink to heads-wide products. A
// persistent grid of one 512-thread block per SM over the items (b, j); a
// row i goes in chunks of 32 sources k: pass A rebuilds pre of both
// branches (the angular code, Wa, t_row, t_src), LayerNorm and relu, and
// keeps logit and d alpha per (source, head) in shared memory; the softmax
// and its backward per head give alpha and dh; pass B rebuilds pre again
// and forms the head sums Yd, Ya, d y, the relu and LayerNorm backward to
// d pre, d t_src, d t_row, d Wa and d angle. d Wo of both branches stays in
// shared memory ([H][H + 1] each, 129 KB at H = 128) until the block ends.
// The item's d t_src rows ([2][Nl][H]) accumulate in place in the outputs,
// through L2: beside d Wo in shared memory they would fit at H = 128 only up
// to 48 atoms, short of the ligand ladder's 64-atom bucket.
// The logits and d alpha run on the tensor cores (three tf32 passes), the
// other heads-wide products on the CUDA cores. What bounds it (clock64
// phase counts at the released shapes, an H100, PERF.md): latency between
// the block's barriers more than any unit's rate; the per-row Qk, Gv and
// d q read both Wo through L2 for every row (no room beside the d Wo sums:
// about a fifth of the cycles), and rebuilding pre (four times a row) and
// the CUDA-core products and sums, each shared-memory value feeding two
// multiply-adds, take most of the rest.
//
// Backward design at every other width (row_attention_bwd.cuh): one row per
// block iteration, one thread per channel, two blocks per SM; every
// per-triplet intermediate is recomputed in shared memory, or, where the
// d t_src sums and row buffers do not fit there (H >= 512, or Nl above 40
// at H = 256), in a device-memory scratch that the wrapper allocates;
// blocks of H > 256 threads take a 1024-thread build.
#include "head_bwd.cuh"
#include "row_attention_bwd.cuh"
#include "row_mma.cuh"
#include "wgmma.cuh"

using namespace rowattn;

namespace {

constexpr int A = 13;   // angular code width
constexpr int AP = 16;  // its row stride in the backward's shared memory
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

// ---------------------------------------------------------------------------
// forward, H in 32, 64, 128: two warpgroups on wgmma (wgmma.cuh)
// ---------------------------------------------------------------------------

namespace rm = rowmma;

namespace pipe {

constexpr int THREADS = 256;  // two warpgroups, each on its own tiles
constexpr int GROUPS = THREADS / 128;
constexpr int KC = 32;        // sources per chunk
constexpr int TI = 2;         // rows i per tile: TI * KC = 64, wgmma's M

// Offsets into the forward kernel's dynamic shared memory; the launcher
// builds the same layout to size the launch. Per warp: E [16][e_ld] (the
// angular code of its 16 pair rows, then their logits and weights, at the
// tile's end its softmax state) and SC [NH] (the chunk's rescale factors);
// per warpgroup: TS [2][Nl][H] (the unit's t_src of both branches, when
// staged), MG [2][TI][H] and ML [2][TI][2][NH] (the odd warps' states for
// the merge, two slots).
struct Layout {
  size_t wo, wa, warp, group, warp_bytes, group_bytes, mg, ml, bytes;
  int e_ld;
  __host__ __device__ Layout(int H, int NH, int Nl, bool split, bool stage,
                             bool qs) {
    e_ld = (NH > 16 ? NH : 16) + 4;
    rm::Carve c;
    wo = c.take(sizeof(rm::bf16) * H * H * (split ? 4 : 2));
    wa = c.take(sizeof(__half) * 16 * H * 4);
    warp_bytes =
        (sizeof(float) * ((qs ? H : 0) + 16 * e_ld + NH) + 15) & ~(size_t)15;
    warp = c.take(warp_bytes * 4 * GROUPS);
    mg = stage ? sizeof(float) * 2 * (size_t)Nl * H : 0;
    ml = mg + sizeof(float) * 2 * TI * H;
    group_bytes = ml + sizeof(float) * 2 * TI * 2 * NH;
    group = c.take(group_bytes * GROUPS);
    bytes = c.off;
  }
};

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(grp + 1) : "memory");
}

// BYTES (4 or 16) from global g to shared s, asynchronously (cp.async);
// wait_copies() returns once this thread's copies have landed.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(s)),
               "l"(g), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x = h + l in bf16 (to about 2^-16) or fp16 (2^-22).
__device__ __forceinline__ void split1(float x, rm::bf16& h, rm::bf16& l) {
  h = __float2bfloat16_rn(x);
  l = __float2bfloat16_rn(x - __bfloat162float(h));
}
__device__ __forceinline__ void split1(float x, __half& h, __half& l) {
  h = __float2half_rn(x);
  l = __float2half_rn(x - __half2float(h));
}

// B = the first kv rows of w ([kv][N] row-major; zero below) as a K x N
// wgmma operand (wgmma.cuh) of 16-bit T, split into hi and lo (lo null: hi
// only). Every thread of the block; no barrier.
template <int K, int N, typename T>
__device__ __forceinline__ void stage_b(const float* __restrict__ w, int kv,
                                        T* hi, T* lo) {
  for (int e = threadIdx.x; e < K * N; e += THREADS) {
    const int k = e / N, n = e - k * N;
    T h, l;
    split1(k < kv ? __ldg(w + e) : 0.f, h, l);
    const int o = wgmma::b_offset(k, n, K);
    hi[o] = h;
    if (lo) lo[o] = l;
  }
}

// (x, y) -> bf16x2 hi and lo, x + y = hi + lo to about 2^-16.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = wgmma::pack(h);
  lo = wgmma::pack(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// The same in fp16: to about 2^-22.
__device__ __forceinline__ void split2h(float x, float y, uint32_t& hi,
                                        uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 f = __half22float2(h);
  hi = wgmma::pack(h);
  lo = wgmma::pack(__floats2half2_rn(x - f.x, y - f.y));
}

// relu(LayerNorm(x) * lns + lnb) of the thread's two rows of an m64nH
// accumulator x (rows g and g + 8: four lanes hold a row), as the A
// registers of the next product: hi and, with SPLIT, lo.
template <int H, bool SPLIT>
__device__ __forceinline__ void ln_split(const float (&x)[H / 2],
                                         const float* __restrict__ lns,
                                         const float* __restrict__ lnb,
                                         uint32_t (&hi)[H / 4],
                                         uint32_t (&lo)[H / 4]) {
  constexpr int NJ = H / 8;
  const int t4 = threadIdx.x & 3;
  float mean[2], rstd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.f;
#pragma unroll
    for (int jb = 0; jb < NJ; ++jb)
      s += x[4 * jb + 2 * r] + x[4 * jb + 2 * r + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    mean[r] = s / H;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s2 = 0.f;
#pragma unroll
    for (int jb = 0; jb < NJ; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = x[4 * jb + 2 * r + e] - mean[r];
        s2 = fmaf(d, d, s2);
      }
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    rstd[r] = rsqrtf(s2 / H + 1e-5f);
  }
#pragma unroll
  for (int jb = 0; jb < NJ; ++jb) {
    const int c = 8 * jb + 2 * t4;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(lns + c));
    const float2 bi = __ldg(reinterpret_cast<const float2*>(lnb + c));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float y0 = fmaxf(
          (x[4 * jb + 2 * r] - mean[r]) * rstd[r] * sc.x + bi.x, 0.f);
      const float y1 = fmaxf(
          (x[4 * jb + 2 * r + 1] - mean[r]) * rstd[r] * sc.y + bi.y, 0.f);
      if (SPLIT)
        split2(y0, y1, hi[2 * jb + r], lo[2 * jb + r]);
      else
        hi[2 * jb + r] = wgmma::pack(__floats2bfloat162_rn(y0, y1));
    }
  }
}

// d = A B over H (A: the 64 x H tile in registers, B: an H x H operand at
// descriptors bh, bl): SPLIT lo*hi + hi*lo + hi*hi (float32 accuracy), else
// hi*hi. Issues the products; the caller commits and waits. keep: d's
// values are added to (else overwritten).
template <int H, bool SPLIT>
__device__ __forceinline__ void tile_product(float (&d)[H / 2],
                                             const uint32_t (&hi)[H / 4],
                                             const uint32_t (&lo)[H / 4],
                                             uint64_t bh, uint64_t bl,
                                             bool keep) {
  using M = wgmma::Mma<H>;
#pragma unroll
  for (int s = 0; s < H / 16; ++s)
    if (SPLIT)
      M::rs(d, lo[4 * s], lo[4 * s + 1], lo[4 * s + 2], lo[4 * s + 3],
            bh + 16 * s, keep || s > 0);
#pragma unroll
  for (int s = 0; s < H / 16; ++s)
    if (SPLIT)
      M::rs(d, hi[4 * s], hi[4 * s + 1], hi[4 * s + 2], hi[4 * s + 3],
            bl + 16 * s, 1);
#pragma unroll
  for (int s = 0; s < H / 16; ++s)
    M::rs(d, hi[4 * s], hi[4 * s + 1], hi[4 * s + 2], hi[4 * s + 3],
          bh + 16 * s, keep || SPLIT || s > 0);
}

// pre = t_row + t_src + ang @ Wa of one branch for the thread's two rows
// of the tile, in the accumulator layout: tr the row's t_row, ts the
// unit's t_src, the sources' rows at sa, sb (columns swizzled by xa, xb
// when staged); the angular code in A registers ah + al (fp16), Wa at
// descriptors dhi, dlo.
template <int H>
__device__ __forceinline__ void tile_pre(float (&p)[H / 2],
                                         const float* __restrict__ tr,
                                         const float* ts, int sa, int sb,
                                         int xa, int xb,
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint64_t dhi, uint64_t dlo) {
  using MA = wgmma::Mma<H, true>;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int jb = 0; jb < H / 8; ++jb) {
    const int c = 8 * jb + 2 * t4;
    const float2 r = __ldg(reinterpret_cast<const float2*>(tr + c));
    const float2 x = *reinterpret_cast<const float2*>(ts + sa + (c ^ xa));
    const float2 y = *reinterpret_cast<const float2*>(ts + sb + (c ^ xb));
    p[4 * jb] = r.x + x.x;
    p[4 * jb + 1] = r.y + x.y;
    p[4 * jb + 2] = r.x + y.x;
    p[4 * jb + 3] = r.y + y.y;
  }
  wgmma::fence();
  MA::rs(p, al[0], al[1], al[2], al[3], dhi, 1);
  MA::rs(p, ah[0], ah[1], ah[2], ah[3], dlo, 1);
  MA::rs(p, ah[0], ah[1], ah[2], ah[3], dhi, 1);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_regs(p);
}

// The sources of a chunk whose bits are set (bit k - k0) without source
// i, for a row i with bond mask m (0 if the bond j -> i is absent).
__device__ __forceinline__ unsigned row_bits(unsigned bits, float m, int d) {
  if (!(m > 0.5f)) return 0u;
  return d >= 0 && d < KC ? bits & ~(1u << d) : bits;
}

// x[0, n) += partner's x[n, 2n) (or the reverse: `up` keeps the upper half
// in x[0, n)) of the lane `lane ^ m`.
template <int N, int S>
__device__ __forceinline__ void halve(float (&x)[S], int m, bool up) {
  static_assert(2 * N <= S, "two halves of N");
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const float send = up ? x[t] : x[t + N];
    const float keep = up ? x[t + N] : x[t];
    x[t] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

}  // namespace pipe

// Persistent, two warpgroups a block, each on its own units: unit u is item
// (b, j) = u / 2 and half u % 2 of its tiles of TI rows i. A warpgroup
// stages its unit's t_src rows in shared memory (stage != 0), then per tile
// walks the sources in chunks of KC; warp w of the group holds the pair
// rows (i0 + w / 2, k0 + 16 (w % 2) + [0, 16)).
template <int H, bool BF16>
__global__ void __launch_bounds__(pipe::THREADS, 1)
    triplet_attention_kernel_ws(TripletArgs a, int units, int stage,
                                int qs) {
  using namespace pipe;
  constexpr int NJ = H / 8;   // 8-column blocks of a row
  constexpr int NA = H / 2;   // accumulator floats of a 64 x H tile
  constexpr int NR = H / 4;   // A registers of a 64 x H tile
  constexpr int CPT = H / 32; // output columns of a lane
  constexpr bool SPLIT = !BF16;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int Nl = a.Nl, NH = a.n_heads, hd = H / NH;
  const Layout lay(H, NH, Nl, SPLIT, stage != 0, qs != 0);
  const int tid = threadIdx.x, grp = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  rm::bf16* wo = reinterpret_cast<rm::bf16*>(dyn + lay.wo);
  __half* wa = reinterpret_cast<__half*>(dyn + lay.wa);
  rm::bf16* wvo = wo + (SPLIT ? 2 : 1) * H * H;
  stage_b<H, H>(a.k.wo, H, wo, SPLIT ? wo + H * H : nullptr);
  stage_b<H, H>(a.v.wo, H, wvo, SPLIT ? wvo + H * H : nullptr);
  stage_b<16, H>(a.k.w_feat, A, wa, wa + 16 * H);
  stage_b<16, H>(a.v.w_feat, A, wa + 32 * H, wa + 48 * H);
  wgmma::fence_smem();
  __syncthreads();  // the block's only barrier
  const uint64_t dk_hi = wgmma::b_desc(wo, H), dv_hi = wgmma::b_desc(wvo, H);
  const uint64_t dk_lo = SPLIT ? wgmma::b_desc(wo + H * H, H) : 0;
  const uint64_t dv_lo = SPLIT ? wgmma::b_desc(wvo + H * H, H) : 0;
  const uint64_t dak_hi = wgmma::b_desc(wa, 16);
  const uint64_t dak_lo = wgmma::b_desc(wa + 16 * H, 16);
  const uint64_t dav_hi = wgmma::b_desc(wa + 32 * H, 16);
  const uint64_t dav_lo = wgmma::b_desc(wa + 48 * H, 16);

  const int ld = lay.e_ld;
  float* QS = reinterpret_cast<float*>(dyn + lay.warp +
                                       lay.warp_bytes * (tid >> 5));
  float* E = QS + (qs ? H : 0);
  const bool q16 = (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
  float* SC = E + 16 * ld;
  unsigned char* gb = dyn + lay.group + lay.group_bytes * grp;
  float* TS = reinterpret_cast<float*>(gb);
  float* MG = reinterpret_cast<float*>(gb + lay.mg);
  float* ML = reinterpret_cast<float*>(gb + lay.ml);
  const float scale = 1.f / sqrtf((float)hd);
  const int hs = __ffs(hd) - 1;  // hd = 2^hs
  // the softmax map: LPH lanes a head, HPP heads a pass; lane: head
  // lane / LPH of a pass, rows (lane % LPH) RPL + [0, RPL) of the warp's 16
  const int LPH = min(max(32 / NH, 1), 16), HPP = 32 / LPH, RPL = 16 / LPH;
  const int hl = lane / LPH, r0 = (lane % LPH) * RPL;
  const int il = warp >> 1, kh = 16 * (warp & 1);
  const int rv = ((g & 1) << 2) | (g & 2) | ((g >> 2) & 1);  // rev3(g)
  const int n_tiles = (Nl + TI - 1) / TI, half0 = (n_tiles + 1) / 2;
  int slot = 0;

  for (int u = blockIdx.x * GROUPS + grp; u < units;
       u += gridDim.x * GROUPS) {
    const int item = u >> 1, b = item / Nl, j = item - b * Nl;
    const int tb = (u & 1) ? half0 : 0, te = (u & 1) ? n_tiles : half0;
    if (tb >= te) continue;
    const float* mrow_j = a.mask + ((size_t)b * Nl + j) * Nl;  // bonds k -> j
    const size_t src0 = ((size_t)b * Nl + j) * Nl * H;
    const float* tsk = a.k.t_src + src0;
    const float* tsv = a.v.t_src + src0;
    int swz = 0;  // TS rows: column c of row k at c ^ 8 (k & 3)
    if (stage) {
      group_sync(grp);  // the last unit is done with TS
      const int n = Nl * H;
      if (((reinterpret_cast<uintptr_t>(tsk) |
            reinterpret_cast<uintptr_t>(tsv)) & 15) == 0) {
        for (int e = tid & 127; e < n / 2; e += 128) {
          const int br = e >= n / 4, f = 4 * e - br * n, k = f / H;
          const float4 x = __ldg(reinterpret_cast<const float4*>(
              (br ? tsv : tsk) + f));
          *reinterpret_cast<float4*>(TS + br * n + k * H +
                                     ((f - k * H) ^ ((k & 3) << 3))) = x;
        }
      } else {
        for (int e = tid & 127; e < 2 * n; e += 128) {
          const int br = e >= n, f = e - br * n, k = f / H;
          TS[br * n + k * H + ((f - k * H) ^ ((k & 3) << 3))] =
              __ldg((br ? tsv : tsk) + f);
        }
      }
      group_sync(grp);
      tsk = TS;
      tsv = TS + n;
      swz = 3;
    }

    for (int t = tb; t < te; ++t) {
      const int i0 = TI * t, i = i0 + il;
      // rows (b, i, j) of out, q, t_row: row0 for i0, Nl apart
      const size_t row0 = ((size_t)b * Nl + i0) * Nl + j;
      const size_t row = row0 + (i < Nl ? (size_t)il * Nl : 0);
      const float m0 = a.mask[row0];
      const float m1 = i0 + 1 < Nl ? a.mask[row0 + Nl] : 0.f;
      if (qs) {  // the row's q into QS, read by the logits
        wait_copies();  // the last tile's copy has landed
        const float* qrow = a.q + row * H;
        if (q16)
          for (int c = 4 * lane; c < H; c += 128)
            copy_async<16>(QS + c, qrow + c);
        else
          for (int c = lane; c < H; c += 32) copy_async<4>(QS + c, qrow + c);
      }
      float m_own[4], l_own[4], acc[CPT];
#pragma unroll
      for (int s = 0; s < 4; ++s) m_own[s] = -1e29f, l_own[s] = 0.f;
#pragma unroll
      for (int s = 0; s < CPT; ++s) acc[s] = 0.f;

      for (int k0 = 0; k0 < Nl; k0 += KC) {
        const int kk = k0 + lane;
        const unsigned bits =
            __ballot_sync(0xffffffffu, kk < Nl && mrow_j[kk] > 0.5f);
        const unsigned b0 = row_bits(bits, m0, i0 - k0);
        const unsigned b1 = i0 + 1 < Nl ? row_bits(bits, m1, i0 + 1 - k0) : 0u;
        if (!(b0 | b1)) continue;  // no triplet: the same in every warp
        const unsigned vmask = ((il ? b1 : b0) >> kh) & 0xffffu;

        // the angular code of the warp's rows, once for both branches
        for (int w2 = lane; w2 < 16 * 7; w2 += 32) {
          const int r = w2 / 7, f = w2 - 7 * r, k = k0 + kh + r;
          const float x = i < Nl && k < Nl ? __ldg(a.angle + row * Nl + k)
                                           : 0.f;
          float* er = E + r * ld;
          if (f == 6) {
            er[0] = x;
            er[13] = er[14] = er[15] = 0.f;
          } else {
            float s, co;
            sincosf(x * kFreqs[f], &s, &co);
            er[1 + f] = s;
            er[7 + f] = co;
          }
        }
        __syncwarp();
        uint32_t ah[4], al[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float2 x = *reinterpret_cast<const float2*>(
              E + (g + 8 * (s & 1)) * ld + 8 * (s >> 1) + 2 * t4);
          split2h(x.x, x.y, ah[s], al[s]);
        }

        // the sources of the thread's rows g, g + 8 of the warp's 16
        const int ka = min(k0 + kh + g, Nl - 1);
        const int kb = min(k0 + kh + g + 8, Nl - 1);
        const int sa = ka * H, sb = kb * H;
        const int xa = (ka & swz) << 3, xb = (kb & swz) << 3;

        // k: pre, y, then k = y Wo_k + bo_k on the tensor cores
        float pk[NA];
        tile_pre<H>(pk, a.k.t_row + row * H, tsk, sa, sb, xa, xb, ah, al,
                    dak_hi, dak_lo);
        uint32_t yh[NR], yl[NR];
        ln_split<H, SPLIT>(pk, a.k.lns, a.k.lnb, yh, yl);
        float ak[NA];  // the product adds to bo_k, set by column
#pragma unroll
        for (int jb = 0; jb < NJ; ++jb) {
          const float2 bo = __ldg(
              reinterpret_cast<const float2*>(a.k.bo + 8 * jb + 2 * t4));
          ak[4 * jb] = ak[4 * jb + 2] = bo.x;
          ak[4 * jb + 1] = ak[4 * jb + 3] = bo.y;
        }
        wgmma::fence();
        tile_product<H, SPLIT>(ak, yh, yl, dk_hi, dk_lo, true);
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::fence_regs(ak);
        wgmma::fence_regs(yh);
        if (SPLIT) wgmma::fence_regs(yl);

        // logits of the warp's rows into E: scale q . k, a head's columns
        // summed in the thread (pairs), over lanes (t4: xor 1, 2) and over
        // blocks
        wait_copies();  // q in QS
        __syncwarp();   // every lane's: QS; every lane is done with E
        if (hs == 3) {  // a head a block: sums over the row's four lanes
                        // by halving, NJ / 4 heads a lane
          float x[2 * NJ];
#pragma unroll
          for (int jb = 0; jb < NJ; ++jb) {
            const int c = 8 * jb + 2 * t4;
            const float2 qv =
                qs ? *reinterpret_cast<const float2*>(QS + c)
                   : __ldg(reinterpret_cast<const float2*>(a.q + row * H + c));
#pragma unroll
            for (int r = 0; r < 2; ++r)
              x[2 * jb + r] = fmaf(qv.x, ak[4 * jb + 2 * r],
                                   qv.y * ak[4 * jb + 2 * r + 1]);
          }
          halve<NJ>(x, 1, t4 & 1);
          halve<NJ / 2>(x, 2, t4 >> 1);
          const int h0 = (t4 & 1) * (NJ / 2) + (t4 >> 1) * (NJ / 4);
#pragma unroll
          for (int u = 0; u < NJ / 4; ++u)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              E[(g + 8 * r) * ld + h0 + u] = x[2 * u + r] * scale;
        } else {
          const float* qr = a.q + row * H;
          float run[2] = {0.f, 0.f};
#pragma unroll
          for (int jb = 0; jb < NJ; ++jb) {
            const int c = 8 * jb + 2 * t4;
            const float2 qv =
                qs ? *reinterpret_cast<const float2*>(QS + c)
                   : __ldg(reinterpret_cast<const float2*>(qr + c));
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float s0 = qv.x * ak[4 * jb + 2 * r];
              const float s1 = qv.y * ak[4 * jb + 2 * r + 1];
              float* er = E + (g + 8 * r) * ld;
              if (hs == 0) {  // a head a column
                er[c] = s0 * scale;
                er[c + 1] = s1 * scale;
                continue;
              }
              float p = s0 + s1;
              if (hs >= 2) p += __shfl_xor_sync(0xffffffffu, p, 1);
              if (hs >= 3) p += __shfl_xor_sync(0xffffffffu, p, 2);
              run[r] += p;
              if (((8 * (jb + 1)) & (hd - 1)) == 0) {  // the head's last block
                if (hs >= 3 ? t4 == 0 : (c & (hd - 1)) == 0)
                  er[c >> hs] = run[r] * scale;
                run[r] = 0.f;
              }
            }
          }
        }
        __syncwarp();
        // the online softmax of each head over the warp's rows: LPH lanes a
        // head, HPP heads a pass
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (HPP * s >= NH) break;
          const int h = hl + HPP * s;
          const bool hv = h < NH;
          float* col = E + h;
          float mc = -3.0e38f;
          for (int q = 0; q < RPL; ++q) {
            const int r = r0 + q;
            if (hv && ((vmask >> r) & 1u)) mc = fmaxf(mc, col[r * ld]);
          }
          for (int o = 1; o < LPH; o <<= 1)
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
          const float m_new = fmaxf(m_own[s], mc);
          const float sc = expf(m_own[s] - m_new);
          float ls = 0.f;
          for (int q = 0; q < RPL; ++q) {
            const int r = r0 + q;
            const float e = hv && ((vmask >> r) & 1u)
                                ? expf(col[r * ld] - m_new)
                                : 0.f;
            if (hv) col[r * ld] = e;
            ls += e;
          }
          for (int o = 1; o < LPH; o <<= 1)
            ls += __shfl_xor_sync(0xffffffffu, ls, o);
          l_own[s] = l_own[s] * sc + ls;
          m_own[s] = m_new;
          if (hv && lane % LPH == 0) SC[h] = sc;
        }
        __syncwarp();

        // v: pre, y, y Wo_v on the tensor cores, then the sum over the
        // thread's two rows of e v per column
        float pv[NA];
        tile_pre<H>(pv, a.v.t_row + row * H, tsv, sa, sb, xa, xb, ah, al,
                    dav_hi, dav_lo);
        uint32_t zh[NR], zl[NR];
        ln_split<H, SPLIT>(pv, a.v.lns, a.v.lnb, zh, zl);
        float av[NA];
        wgmma::fence();
        tile_product<H, SPLIT>(av, zh, zl, dv_hi, dv_lo, false);
        wgmma::commit();
        float a32[2 * NJ];
        if (hs == 3) {  // one head a block: e of rows g, g + 8 by block
          float ea[NJ], eb[NJ];
#pragma unroll
          for (int jq = 0; jq < NJ / 4; ++jq) {
            const float4 x =
                *reinterpret_cast<const float4*>(E + g * ld + 4 * jq);
            const float4 y =
                *reinterpret_cast<const float4*>(E + (g + 8) * ld + 4 * jq);
            ea[4 * jq] = x.x, ea[4 * jq + 1] = x.y, ea[4 * jq + 2] = x.z,
            ea[4 * jq + 3] = x.w;
            eb[4 * jq] = y.x, eb[4 * jq + 1] = y.y, eb[4 * jq + 2] = y.z,
            eb[4 * jq + 3] = y.w;
          }
          wgmma::wait<0>();
          wgmma::fence_regs(av);
#pragma unroll
          for (int jb = 0; jb < NJ; ++jb)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              a32[2 * jb + e] =
                  fmaf(ea[jb], av[4 * jb + e], eb[jb] * av[4 * jb + 2 + e]);
        } else {
          wgmma::wait<0>();
          wgmma::fence_regs(av);
#pragma unroll
          for (int jb = 0; jb < NJ; ++jb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int h = (8 * jb + 2 * t4 + e) >> hs;
              a32[2 * jb + e] = fmaf(E[g * ld + h], av[4 * jb + e],
                                     E[(g + 8) * ld + h] * av[4 * jb + 2 + e]);
            }
        }
        wgmma::fence_regs(zh);
        if (SPLIT) wgmma::fence_regs(zl);
        // over the warp's 16 rows: each lane keeps CPT columns
        halve<NJ>(a32, 4, g & 1);
        halve<NJ / 2>(a32, 8, (g >> 1) & 1);
        halve<NJ / 4>(a32, 16, (g >> 2) & 1);
#pragma unroll
        for (int s = 0; s < CPT; ++s) {
          const int v = CPT * rv + s, c = 8 * (v >> 1) + 2 * t4 + (v & 1);
          acc[s] = fmaf(acc[s], SC[c >> hs], a32[s]);
        }
        __syncwarp();  // E and SC are rewritten by the next chunk
      }

      // the warp pair of row i: merge the two softmax states; out =
      // sum alpha y Wo_v + bo_v (0 for a row without a source). The odd
      // warp publishes its state (m, l by head, its columns of the sum);
      // the even warp keeps its own m, l in E.
      float* mg = MG + (slot * TI + il) * H;
      float* wm = (warp & 1) ? ML + (slot * TI + il) * 2 * NH : E;
      float* wl = (warp & 1) ? wm + NH : E + ld;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (HPP * s >= NH) break;
        const int h = hl + HPP * s;
        if (h < NH && lane % LPH == 0) {
          wm[h] = m_own[s];
          wl[h] = l_own[s];
        }
      }
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int v = CPT * rv + s, c = 8 * (v >> 1) + 2 * t4 + (v & 1);
        if (warp & 1) mg[c] = acc[s];
      }
      group_sync(grp);
      if (!(warp & 1) && i < Nl) {
        const float* pm = ML + (slot * TI + il) * 2 * NH;
#pragma unroll
        for (int s = 0; s < CPT; ++s) {
          const int v = CPT * rv + s, c = 8 * (v >> 1) + 2 * t4 + (v & 1);
          const int h = c >> hs;
          const float ma = E[h], mb = pm[h], mx = fmaxf(ma, mb);
          const float fa = expf(ma - mx), fb = expf(mb - mx);
          const float l = E[ld + h] * fa + pm[NH + h] * fb;
          a.out[row * H + c] =
              fmaf(acc[s], fa, mg[c] * fb) * (1.f / fmaxf(l, 1e-16f)) +
              (l > 0.f ? __ldg(a.v.bo + c) : 0.f);
        }
      }
      __syncwarp();  // the even warp has read its state from E
      slot ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// forward at the other widths: per-row kernel of row_attention.cuh
// ---------------------------------------------------------------------------

// One block per row (b, i, j), one thread per channel. WIDE: the block may
// have up to 1024 threads (H > 256).
template <bool BF16, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : 256)
    triplet_attention_row_kernel(TripletArgs a) {
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
    finish_chunk<false, BF16>(Yk, Yv, Vs, a.k, a.v, cs, nm, H, a.n_heads,
                              false, q_c, scale, st);
  }
  finalize(st, out_row, Vs, H, a.n_heads, false);
}

template <bool BF16, bool WIDE>
cudaError_t launch_row(const TripletArgs& a, int rows, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err =
      allow_smem(triplet_attention_row_kernel<BF16, WIDE>, smem);
  if (err != cudaSuccess) return err;
  triplet_attention_row_kernel<BF16, WIDE><<<rows, a.H, smem, stream>>>(a);
  return cudaGetLastError();
}

// The per-row forward: [CH][H] pre of both branches and [CH][heads] scratch.
cudaError_t launch_fwd_row(const TripletArgs& a, int B, bool bf16,
                           cudaStream_t stream) {
  const size_t smem = smem_bytes(a.H, a.n_heads, 0);
  const int rows = B * a.Nl * a.Nl;
  const bool wide = a.H > 256;
  if (bf16)
    return wide ? launch_row<true, true>(a, rows, smem, stream)
                : launch_row<true, false>(a, rows, smem, stream);
  return wide ? launch_row<false, true>(a, rows, smem, stream)
              : launch_row<false, false>(a, rows, smem, stream);
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
  float* scratch;        // row buffers in device memory (SCRATCH kernels)
  int per_block;         //   floats of them per block
};

// The row buffers: the d t_src sums of both branches, then RowSmem.
inline size_t triplet_bwd_floats(int Nl, int H, int n_heads) {
  return 2 * (size_t)Nl * H + rowbwd::row_smem_floats(Nl, H, n_heads);
}

// The backward of the rows of block blockIdx.x. SCRATCH: the row buffers in
// a.scratch (row_attention_bwd.cuh).
template <bool SCRATCH>
__device__ __forceinline__ void triplet_bwd_rows(const TripletBwdArgs& a) {
  using namespace rowbwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChunkSources cs;
  __shared__ float s_ang[CH][A];
  __shared__ float s_dang[CH][A];

  const TripletArgs& f = a.f;
  const int H = f.H, Nl = f.Nl, nh = f.n_heads;
  const int c = threadIdx.x;
  // [Nl][H] d t_src[j, k] sums
  float* TSk = row_base<SCRATCH>(smem, a.scratch, a.per_block);
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

// The 256-thread build (H <= 256) and the 1024-thread build
// (row_attention_bwd.cuh).
template <bool SCRATCH>
__global__ void triplet_attention_bwd_kernel(TripletBwdArgs a) {
  triplet_bwd_rows<SCRATCH>(a);
}

__global__ void __launch_bounds__(1024, 1)
    triplet_attention_bwd_wide_kernel(TripletBwdArgs a) {
  triplet_bwd_rows<true>(a);
}

// ---------------------------------------------------------------------------
// backward, H in 32, 64, 128: head-factorized (head_bwd.cuh)
// ---------------------------------------------------------------------------

namespace hb = headbwd;

// Offsets into the head-factorized backward's dynamic shared memory, fixed
// at compile time (sized for NLMAX atoms and MAXNH heads) so that no
// register holds them. NLMAX is the top of the ligand ladder
// (data/collate.py).
template <int H>
struct HeadLayout {
  static constexpr int NLMAX = 64;
  static constexpr size_t F = sizeof(float);
  static constexpr size_t dwo = 0;                                // [2][H][MS]
  static constexpr size_t tile =                         // [KC][tstride]
      dwo + F * 2 * H * hb::mstride(H);
  static constexpr size_t m = tile + F * hb::KC * hb::tstride(H);
  static constexpr size_t lg = m + F * 2 * hb::MAXNH * hb::mstride(H);
  static constexpr size_t da = lg + F * NLMAX * hb::MAXNH;        // [Nl][NH]
  static constexpr size_t vl = da + F * NLMAX * hb::MAXNH;
  static constexpr size_t ang = vl + sizeof(int) * NLMAX;         // [KC][AP]
  static constexpr size_t dco = ang + F * hb::KC * AP;
  static constexpr size_t qg = dco + F * hb::KC * AP;             // q | g
  static constexpr size_t hs = qg + F * 2 * H;                    // qb|gb|S
  static constexpr size_t bytes = hs + F * 4 * hb::MAXNH;
  static_assert(tile % 16 == 0 && m % 16 == 0 && lg % 16 == 0, "aligned");
};

// The angular code of the chunk's sources k0 + r, r < KC, of row `row`
// (x = 0 past the atoms), with its derivative in the angle (dco) or the
// sources' validity (VL, for k < Nl). No barrier.
__device__ __forceinline__ void head_chunk_setup(const TripletArgs& f,
                                                 size_t row, int i,
                                                 const float* mrow_j, int k0,
                                                 float (*ang)[AP],
                                                 float (*dco)[AP], int* VL) {
  const int Nl = f.Nl;
  for (int u = threadIdx.x; u < hb::KC * 7; u += hb::THREADS) {
    const int r = u / 7, fq = u - r * 7, k = k0 + r;
    const bool in = k < Nl;
    const float x = in ? f.angle[row * Nl + k] : 0.f;
    if (fq == 6) {
      ang[r][0] = x;
      for (int t = A; t < AP; ++t) ang[r][t] = 0.f;
      if (dco) dco[r][0] = 1.f;
      if (VL && in) VL[k] = k != i && mrow_j[k] > 0.5f;
    } else {
      float s, co;
      sincosf(x * kFreqs[fq], &s, &co);
      ang[r][1 + fq] = s;
      ang[r][7 + fq] = co;
      if (dco) {
        dco[r][1 + fq] = kFreqs[fq] * co;
        dco[r][7 + fq] = -kFreqs[fq] * s;
      }
    }
  }
}

// Warp map, one branch: pre of the pair rows r_s = warp + WARPS s (sources
// k0 + r_s, clamped to the atoms) = t_row + t_src[k] + ang[r_s] @ Wa, then
// its LayerNorm: xh = xhat, rs = 1 / std, y = relu(xhat lns + lnb). No
// barrier.
template <int H>
__device__ __forceinline__ void head_tile_pre(
    const float (*ang)[AP], const Branch& br, const float* wa,
    const float* t_row, const float* ts, int k0, int Nl,
    float (&xh)[hb::RW][H / 32], float (&rs)[hb::RW],
    float (&y)[hb::RW][H / 32]) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[hb::RW][NV];
#pragma unroll
  for (int s = 0; s < hb::RW; ++s) {
    const float* tsr = ts + (size_t)min(k0 + warp + hb::WARPS * s, Nl - 1) * H;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      x[s][v] = __ldg(t_row + lane + 32 * v) + __ldg(tsr + lane + 32 * v);
  }
#pragma unroll
  for (int t = 0; t < A; ++t)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float w = __ldg(wa + t * H + lane + 32 * v);
#pragma unroll
      for (int s = 0; s < hb::RW; ++s)
        x[s][v] = fmaf(ang[warp + hb::WARPS * s][t], w, x[s][v]);
    }
#pragma unroll
  for (int s = 0; s < hb::RW; ++s) {
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) sum += x[s][v];
    const float mean = rm::warp_sum(sum) / H;
    float s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float d = x[s][v] - mean;
      s2 += d * d;
    }
    rs[s] = rsqrtf(rm::warp_sum(s2) / H + 1e-5f);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xh[s][v] = (x[s][v] - mean) * rs[s];
      y[s][v] = fmaxf(xh[s][v] * __ldg(br.lns + lane + 32 * v) +
                          __ldg(br.lnb + lane + 32 * v),
                      0.f);
    }
  }
}

// What pass B of one branch adds to: the block's sums over its rows (d Wa
// rows t = part NT + s in the channel map, d ln_scale and d ln_bias of the
// lanes' channels in the warp map) and the row's (Y: Yd or Ya of the
// thread's heads, trow: sum over the sources of d pre at its channel).
template <int H>
struct HeadBranchSums {
  static constexpr int NT = (A + hb::Map<H>::P - 1) / hb::Map<H>::P;
  static_assert(NT * hb::Map<H>::P <= AP && AP % NT == 0,
                "a part's code rows are NT aligned floats of a row of ang");
  float wa[NT];
  float lns[H / 32], lnb[H / 32];
  float Y[hb::MAXHP];
  float trow;
};

// Pass B of one branch over a chunk (sources k0 .. k0 + KC - 1): y again,
// the row's head sums Y += C^T y (channel map, over the tile T), d y = cf C M
// (M: Qk or Gv, C: dh or alpha [Nl][NH]), the relu and LayerNorm backward
// to d pre, added to the item's d t_src rows TS (device memory: a thread
// owns the same elements in every row of the item, so each is summed by one
// thread in row order) and, through dco and Wa, to e[s]
// (d angle of the pair rows), then d Wa and d t_row (channel map, over T).
// Contains block barriers and ends with one.
template <int H>
__device__ __forceinline__ void head_branch_back(
    const float (*ang)[AP], const float (*dco)[AP], const Branch& br,
    const float* wa, const float* t_row, const float* ts, const float* M,
    const float* C,
    float cf, int k0, int Nl, int NH, float* T, float* TS,
    HeadBranchSums<H>& acc, float (&e)[hb::RW]) {
  constexpr int NV = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x % H, part = threadIdx.x / H;
  const int nr = min(hb::KC, Nl - k0);
  float xh[hb::RW][NV], rs[hb::RW], dp[hb::RW][NV];
  unsigned gate = 0;  // bit s NV + v: y[s][v] > 0
  {
    float y[hb::RW][NV];
    head_tile_pre<H>(ang, br, wa, t_row, ts, k0, Nl, xh, rs, y);
#pragma unroll
    for (int s = 0; s < hb::RW; ++s)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        T[(warp + hb::WARPS * s) * hb::tstride(H) + lane + 32 * v] = y[s][v];
        gate |= (y[s][v] > 0.f ? 1u : 0u) << (s * NV + v);
      }
  }
  __syncthreads();
  hb::accumulate_heads<H>(acc.Y, T, C, k0, nr, NH);
  __syncthreads();  // T is overwritten below

  hb::head_expand<H>(dp, M, C, cf, k0, Nl, NH);
#pragma unroll
  for (int s = 0; s < hb::RW; ++s) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float du = (gate >> (s * NV + v)) & 1u ? dp[s][v] : 0.f;
      acc.lns[v] = fmaf(du, xh[s][v], acc.lns[v]);
      acc.lnb[v] += du;
      const float dx = du * __ldg(br.lns + lane + 32 * v);
      dp[s][v] = dx;
      s1 += dx;
      s2 = fmaf(dx, xh[s][v], s2);
    }
    const float m1 = rm::warp_sum(s1) / H, m2 = rm::warp_sum(s2) / H;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      dp[s][v] = rs[s] * (dp[s][v] - m1 - xh[s][v] * m2);
      T[(warp + hb::WARPS * s) * hb::tstride(H) + lane + 32 * v] = dp[s][v];
    }
  }
  // the item's d t_src rows += d pre, read here and written after the
  // angle's chain, which hides the reads' latency from device memory
  float ts_old[hb::RW][NV];
#pragma unroll
  for (int s = 0; s < hb::RW; ++s)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int k = k0 + warp + hb::WARPS * s;
      ts_old[s][v] = k < Nl ? TS[(size_t)k * H + lane + 32 * v] : 0.f;
    }
  // the angle's chain: e[s] += sum_t dco[r_s][t] (d pre . Wa[t])
#pragma unroll
  for (int t = 0; t < A; ++t)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float w = __ldg(wa + t * H + lane + 32 * v);
#pragma unroll
      for (int s = 0; s < hb::RW; ++s)
        e[s] = fmaf(dco[warp + hb::WARPS * s][t] * w, dp[s][v], e[s]);
    }
#pragma unroll
  for (int s = 0; s < hb::RW; ++s)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int k = k0 + warp + hb::WARPS * s;
      if (k < Nl) TS[(size_t)k * H + lane + 32 * v] = ts_old[s][v] + dp[s][v];
    }
  __syncthreads();
  constexpr int NT = HeadBranchSums<H>::NT;
  for (int r = 0; r < nr; ++r) {
    const float d = T[r * hb::tstride(H) + c];
    acc.trow += d;
    float a[NT];  // ang[r][part NT + s]; rows past A are 0
    if constexpr (NT == 4) {
      const float4 a4 = reinterpret_cast<const float4*>(ang[r])[part];
      a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
    } else {
#pragma unroll
      for (int s = 0; s < NT; ++s) a[s] = ang[r][part * NT + s];
    }
#pragma unroll
    for (int s = 0; s < NT; ++s) acc.wa[s] = fmaf(a[s], d, acc.wa[s]);
  }
  __syncthreads();
}

// Persistent: block g takes work items (b, j) = g, g + gridDim.x, ...; the
// item's d t_src rows of both branches are summed in place in the outputs
// d_tsrc_k, d_tsrc_v, zeroed at the item's start, and the block's d Wo of
// both branches stays in shared memory, transposed, until the block ends.
template <int H>
__global__ void __launch_bounds__(hb::THREADS, 1)
    triplet_attention_bwd_head_kernel(TripletBwdArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  constexpr int MS = hb::mstride(H), NV = H / 32, P = hb::Map<H>::P;
  const TripletArgs& f = a.f;
  const int Nl = f.Nl, NH = f.n_heads, hd = H / NH;
  using lay = HeadLayout<H>;
  float* DWk = reinterpret_cast<float*>(dyn + lay::dwo);  // [H][MS] d Wo^T
  float* DWv = DWk + H * MS;
  float* T = reinterpret_cast<float*>(dyn + lay::tile);   // [KC][H + 4]
  float* M = reinterpret_cast<float*>(dyn + lay::m);      // Qk | Gv, then Yd
  float* LG = reinterpret_cast<float*>(dyn + lay::lg);    // [Nl][NH]
  float* DA = reinterpret_cast<float*>(dyn + lay::da);
  int* VL = reinterpret_cast<int*>(dyn + lay::vl);
  float(*ang)[AP] = reinterpret_cast<float(*)[AP]>(dyn + lay::ang);
  float(*dco)[AP] = reinterpret_cast<float(*)[AP]>(dyn + lay::dco);
  float* QR = reinterpret_cast<float*>(dyn + lay::qg);    // q, g of the row
  float* GR = QR + H;
  float* HS = reinterpret_cast<float*>(dyn + lay::hs);    // qb | gb | S
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % H, part = tid / H;
  const float scale = 1.f / sqrtf((float)hd);

  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;
  const float* wak = f.k.w_feat;
  const float* wav = f.v.w_feat;
  HeadBranchSums<H> sk{}, sv{};
  float bo_k = 0.f, bo_v = 0.f;

  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int b = item / Nl, j = item % Nl;
    const float* mrow_j = f.mask + ((size_t)b * Nl + j) * Nl;  // bonds k -> j
    const size_t src0 = ((size_t)b * Nl + j) * Nl * H;
    // the item's d t_src rows, [Nl][H] each; the first row's barrier
    // orders these zeros before any sum
    float* TSk = a.d_tsrc_k + src0;
    float* TSv = a.d_tsrc_v + src0;
    for (int e = tid; e < Nl * H; e += hb::THREADS) TSk[e] = TSv[e] = 0.f;

    for (int i = 0; i < Nl; ++i) {
      const size_t row = ((size_t)b * Nl + i) * Nl + j;
      // a barrier too: the last row is done with the buffers
      if (!row_has_source(f, (int)row, i, mrow_j)) {
        if (tid < H) {
          a.d_q[row * H + tid] = 0.f;
          a.d_trow_k[row * H + tid] = 0.f;
          a.d_trow_v[row * H + tid] = 0.f;
        }
        continue;
      }
      if (tid < H) {
        QR[tid] = f.q[row * H + tid];
        GR[tid] = a.g[row * H + tid];
      }
      __syncthreads();
      hb::row_matrices<H>(f.k.wo, f.v.wo, f.k.bo, f.v.bo, QR, GR, NH, M, HS,
                          HS + hb::MAXNH);

      // pass A: logits and d alpha of every source
      for (int k0 = 0; k0 < Nl; k0 += hb::KC) {
        __syncthreads();  // M and HS written; the last chunk is done
        head_chunk_setup(f, row, i, mrow_j, k0, ang, nullptr, VL);
        __syncthreads();
        // y of each branch through the tile T, its heads-wide products on
        // the tensor cores
        for (int br = 0; br < 2; ++br) {
          float xh[hb::RW][NV], rs[hb::RW], y[hb::RW][NV];
          const Branch& bp = br ? f.v : f.k;
          head_tile_pre<H>(ang, bp, br ? wav : wak, bp.t_row + row * H,
                           bp.t_src + src0, k0, Nl, xh, rs, y);
          if (br) __syncthreads();  // the k products are done with T
#pragma unroll
          for (int s = 0; s < hb::RW; ++s)
#pragma unroll
            for (int v = 0; v < NV; ++v)
              T[(warp + hb::WARPS * s) * hb::tstride(H) + lane + 32 * v] =
                  y[s][v];
          __syncthreads();
          hb::head_products_tc<H>(T, M + br * NH * MS, NH, k0, Nl,
                                  br ? 1.f : scale, HS + br * hb::MAXNH,
                                  br ? DA : LG);
        }
      }
      __syncthreads();
      hb::head_softmax(LG, DA, VL, Nl, NH, HS + 2 * hb::MAXNH);

      // pass B
#pragma unroll
      for (int u = 0; u < hb::MAXHP; ++u) sk.Y[u] = sv.Y[u] = 0.f;
      sk.trow = sv.trow = 0.f;
      for (int k0 = 0; k0 < Nl; k0 += hb::KC) {
        __syncthreads();  // alpha and dh written; the last chunk is done
        head_chunk_setup(f, row, i, mrow_j, k0, ang, dco, nullptr);
        __syncthreads();
        float e[hb::RW] = {};
        head_branch_back<H>(ang, dco, f.k, wak, f.k.t_row + row * H,
                            f.k.t_src + src0, M, DA, scale, k0, Nl, NH, T,
                            TSk, sk, e);
        head_branch_back<H>(ang, dco, f.v, wav, f.v.t_row + row * H,
                            f.v.t_src + src0, M + NH * MS, LG, 1.f, k0, Nl,
                            NH, T, TSv, sv, e);
#pragma unroll
        for (int s = 0; s < hb::RW; ++s) {
          const float d = rm::warp_sum(e[s]);
          const int k = k0 + warp + hb::WARPS * s;
          if (lane == 0 && k < Nl) a.d_angle[row * Nl + k] = d;
        }
      }

      // the row's d t_row, d bo, d Wo and d q
      const float* S = HS + 2 * hb::MAXNH;
      if (tid < H) {
        a.d_trow_k[row * H + c] = sk.trow;
        a.d_trow_v[row * H + c] = sv.trow;
        bo_k = fmaf(scale * QR[c], S[c / hd], bo_k);
        bo_v = fmaf(GR[c], S[hb::MAXNH + c / hd], bo_v);
      }
      hb::update_dwo<H>(DWk, sk.Y, QR, scale, NH);
      hb::update_dwo<H>(DWv, sv.Y, GR, 1.f, NH);
      hb::store_heads<H>(M, sk.Y, NH);  // M is free: pass B ended in a barrier
      __syncthreads();
      hb::dq_partial<H>(T, M, f.k.wo, NH);
      __syncthreads();
      if (tid < H) {
        float t = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) t += T[p * H + c];
        a.d_q[row * H + c] = scale * (t + __ldg(f.k.bo + c) * S[c / hd]);
      }
    }
  }

  // the block's slot
  rowbwd::GradSlot gk, gv;
  rowbwd::block_slots(a.slots, A, H, H, gk, gv);
#pragma unroll
  for (int s = 0; s < HeadBranchSums<H>::NT; ++s) {
    const int t = part * HeadBranchSums<H>::NT + s;
    if (t < A) {
      gk.wfeat[t * H + c] = sk.wa[s];
      gv.wfeat[t * H + c] = sv.wa[s];
    }
  }
  if (tid < H) {
    gk.bo[c] = bo_k;
    gv.bo[c] = bo_v;
  }
  __syncthreads();
  for (int e = tid; e < H * H; e += hb::THREADS) {
    const int jj = e / H, cc = e - jj * H;
    gk.wo[e] = DWk[cc * MS + jj];
    gv.wo[e] = DWv[cc * MS + jj];
  }
  __syncthreads();  // DWk holds the warps' LayerNorm sums next
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int cc = lane + 32 * v;
    DWk[(warp * 4 + 0) * H + cc] = sk.lns[v];
    DWk[(warp * 4 + 1) * H + cc] = sk.lnb[v];
    DWk[(warp * 4 + 2) * H + cc] = sv.lns[v];
    DWk[(warp * 4 + 3) * H + cc] = sv.lnb[v];
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
// at most MAXNH heads, at most NLMAX atoms, and its layout within a block's
// shared memory.
template <int H>
cudaError_t head_fits(int NH, int Nl, bool* ok) {
  *ok = false;
  if (!hb::heads_ok(NH) || Nl > HeadLayout<H>::NLMAX) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *ok = err == cudaSuccess && HeadLayout<H>::bytes <= (size_t)optin;
  return err;
}

cudaError_t head_route(int H, int NH, int Nl, bool* ok) {
  switch (H) {
    case 32: return head_fits<32>(NH, Nl, ok);
    case 64: return head_fits<64>(NH, Nl, ok);
    case 128: return head_fits<128>(NH, Nl, ok);
    default: *ok = false; return cudaSuccess;
  }
}

template <int H>
cudaError_t launch_bwd_head(const TripletBwdArgs& a, int G,
                            cudaStream_t stream) {
  constexpr size_t smem = HeadLayout<H>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      triplet_attention_bwd_head_kernel<H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  triplet_attention_bwd_head_kernel<H><<<G, hb::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One block of two warpgroups per SM (at most one per item: two units).
// t_src is staged when the whole layout fits the block's shared memory.
template <int H>
cudaError_t launch_fwd(const TripletArgs& a, int B, bool bf16,
                       cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const bool stage = pipe::Layout(H, a.n_heads, a.Nl, !bf16, true, true)
                         .bytes <= (size_t)optin;
  const bool qs = pipe::Layout(H, a.n_heads, a.Nl, !bf16, false, true)
                      .bytes <= (size_t)optin;
  const size_t smem =
      pipe::Layout(H, a.n_heads, a.Nl, !bf16, stage, qs).bytes;
  void (*kernel)(TripletArgs, int, int, int) =
      bf16 ? triplet_attention_kernel_ws<H, true>
           : triplet_attention_kernel_ws<H, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<std::min(sms, B * a.Nl), pipe::THREADS, smem, stream>>>(
      a, 2 * B * a.Nl, stage, qs);
  return cudaGetLastError();
}

// The backward kernel of width H, with its row buffers in the scratch or
// in shared memory (H <= 256; the 1024-thread build always takes the
// scratch).
using TripletBwdKernel = void (*)(TripletBwdArgs);
TripletBwdKernel bwd_kernel(int H, bool scratch) {
  if (H > 256) return triplet_attention_bwd_wide_kernel;
  return scratch ? triplet_attention_bwd_kernel<true>
                 : triplet_attention_bwd_kernel<false>;
}

}  // namespace


// Forward. bf16 != 0: the second linears on bf16-rounded y and Wo (the TPU
// kernel's `bf16` option); otherwise float32 accuracy. H in 32, 64, 128:
// the tensor-core kernel; any other width the wrapper admits: the per-row
// kernel. *row: 1 when the per-row kernel was launched, else 0 (the
// wrapper counts the route from it).
extern "C" int triplet_attention_fwd(
    const float* angle, const float* mask, const float* q,
    const float* k_row, const float* k_src, const float* k_feat,
    const float* k_wo, const float* k_bo, const float* k_lns,
    const float* k_lnb,
    const float* v_row, const float* v_src, const float* v_feat,
    const float* v_wo, const float* v_bo, const float* v_lns,
    const float* v_lnb,
    float* out, int* row, int B, int Nl, int H, int n_heads, int bf16,
    void* stream) {
  *row = 0;
  if (B * Nl == 0) return 0;
  TripletArgs a{angle, mask, q,
                Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
                Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
                out, Nl, H, n_heads};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 32: return (int)launch_fwd<32>(a, B, bf16 != 0, s);
    case 64: return (int)launch_fwd<64>(a, B, bf16 != 0, s);
    case 128: return (int)launch_fwd<128>(a, B, bf16 != 0, s);
    default: *row = 1; return (int)launch_fwd_row(a, B, bf16 != 0, s);
  }
}

// Floats per block of the device-memory scratch that the backward needs at
// these sizes (0: its row buffers fit in shared memory).
extern "C" int triplet_attention_bwd_scratch(int* per_block, int Nl, int H,
                                             int n_heads) {
  bool head = false;
  *per_block = 0;
  cudaError_t err = head_route(H, n_heads, Nl, &head);
  if (err != cudaSuccess || head) return (int)err;
  return (int)rowbwd::scratch_floats(
      bwd_kernel(H, false), H, triplet_bwd_floats(Nl, H, n_heads),
      per_block);
}

// Whether the backward at these sizes runs the per-row kernel (*row = 1) or
// the head-factorized one (*row = 0): the wrapper sizes the launch from it.
extern "C" int triplet_attention_bwd_route(int* row, int Nl, int H,
                                           int n_heads) {
  bool head = false;
  const cudaError_t err = head_route(H, n_heads, Nl, &head);
  *row = !head;
  return (int)err;
}

// Backward: G blocks over the B*Nl (complex, j) items, then the fixed-order
// slot sum into d_params ([k: w_feat, wo, bo, ln_scale, ln_bias | v: same]).
// H in 32, 64, 128 with at most 16 heads and Nl up to 64: the
// head-factorized kernel, one block per SM, d t_src summed in place in
// d_tsrc_k and d_tsrc_v; any other
// width: the per-row kernel, two blocks per SM, which alone reads k_woT and
// v_woT (the transposed Wo) and the scratch: G times
// triplet_attention_bwd_scratch's floats, or null when that is 0.
// *route: 1 when the row buffers went to the scratch, else 0; *row: 1 when
// the per-row kernel was launched, else 0.
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
    float* scratch, int* route, int* row, int B, int Nl, int H, int n_heads,
    int G, void* stream) {
  *route = 0;
  *row = 0;
  if (B * Nl == 0 || G <= 0) return 0;
  TripletBwdArgs a{
      TripletArgs{angle, mask, q,
                  Branch{k_row, k_src, k_feat, k_wo, k_bo, k_lns, k_lnb},
                  Branch{v_row, v_src, v_feat, v_wo, v_bo, v_lns, v_lnb},
                  nullptr, Nl, H, n_heads},
      g, k_woT, v_woT, d_angle, d_q, d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v,
      slots, B * Nl, nullptr, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  bool head = false;
  cudaError_t err = head_route(H, n_heads, Nl, &head);
  if (err != cudaSuccess) return (int)err;
  if (head) {
    switch (H) {
      case 32: err = launch_bwd_head<32>(a, G, s); break;
      case 64: err = launch_bwd_head<64>(a, G, s); break;
      default: err = launch_bwd_head<128>(a, G, s); break;
    }
  } else {
    *row = 1;
    err = rowbwd::launch_rows(bwd_kernel(H, false), bwd_kernel(H, true), a,
                              G, triplet_bwd_floats(Nl, H, n_heads), scratch,
                              route, s);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t P = 2 * rowbwd::branch_slot_floats(A, H, H);
  return (int)rowbwd::launch_reduce(slots, d_params, G, P, s);
}
