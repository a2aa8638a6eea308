// Adam over many float32 tensors in one launch, for sm_90a: the training
// step's optimizer update (ops/multi_tensor_adam.py).
//
// Replaces no Pallas kernel: the JAX package's optax adam is XLA's fused
// elementwise code. This kernel is torch.optim.Adam's update with L2 weight
// decay, for each tensor p with gradient g, moments m and v, and step count
// s (the steps taken before this one), t = s + 1:
//   g = g + weight_decay p
//   m = beta1 m + (1 - beta1) g
//   v = beta2 v + (1 - beta2) g^2
//   p = p - lr / (1 - beta1^t) m / (sqrt(v) / sqrt(1 - beta2^t) + eps)
//   s = s + 1
// in float32, the bias corrections formed in double from s and beta as
// given (torch's fused Adam rounds beta to float32 before the power, which
// shrinks every update by about 6e-6 of itself).
//
// Bound on an H100: bytes. The released denoiser's 704 tensors hold 4.98 M
// parameters; an update reads p, g, m, v and writes p, m, v, 28 bytes a
// parameter, 139 MB, about 0.04 ms at 3.35 TB/s.
//
// Design: one table on the device (int64, built by the wrapper, which
// launches it again while the tensors keep their addresses) holds, per
// tensor, the addresses of p, m, v, s and g and the element count, then
// per block the tensor it works on and the first element of its chunk of
// `chunk` elements (CHUNK in the wrapper). Launch 1 runs one block per
// chunk of every tensor; each block forms its tensor's bias corrections
// once from s and loops over its chunk. Launch 2 adds 1 to every step
// count, after every block of launch 1 has read them (stream order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// table: [p][m][v][s][g] addresses (5 n), numel (n), then per block its
// tensor (n_blocks) and its first element (n_blocks)
__global__ void __launch_bounds__(kThreads)
multi_tensor_adam_kernel(const int64_t* __restrict__ table, int n,
                         int n_blocks, int chunk, double lr, double beta1,
                         double beta2, double eps, double weight_decay) {
  const int64_t* numel = table + 5 * n;
  const int ti = static_cast<int>(numel[n + blockIdx.x]);
  const int64_t start = numel[n + n_blocks + blockIdx.x];
  const int64_t end = start + chunk;
  const int64_t stop = end < numel[ti] ? end : numel[ti];
  float* p = reinterpret_cast<float*>(table[ti]);
  float* m = reinterpret_cast<float*>(table[n + ti]);
  float* v = reinterpret_cast<float*>(table[2 * n + ti]);
  const float* s = reinterpret_cast<const float*>(table[3 * n + ti]);
  const float* g = reinterpret_cast<const float*>(table[4 * n + ti]);
  const double t = static_cast<double>(*s) + 1.0;
  const float step_size = static_cast<float>(lr / (1.0 - pow(beta1, t)));
  const float c2_sqrt = static_cast<float>(sqrt(1.0 - pow(beta2, t)));
  const float b1 = static_cast<float>(beta1);
  const float b2 = static_cast<float>(beta2);
  const float a1 = static_cast<float>(1.0 - beta1);
  const float a2 = static_cast<float>(1.0 - beta2);
  const float wd = static_cast<float>(weight_decay);
  const float e = static_cast<float>(eps);
  for (int64_t i = start + threadIdx.x; i < stop; i += kThreads) {
    const float pi = p[i];
    float gi = g[i];
    if (wd != 0.f) gi = gi + wd * pi;
    const float mi = b1 * m[i] + a1 * gi;
    const float vi = b2 * v[i] + a2 * gi * gi;
    m[i] = mi;
    v[i] = vi;
    p[i] = pi - step_size * mi / (sqrtf(vi) / c2_sqrt + e);
  }
}

__global__ void multi_tensor_adam_step_kernel(const int64_t* __restrict__ table,
                                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) *reinterpret_cast<float*>(table[3 * n + i]) += 1.f;
}

}  // namespace

// One Adam step of the n tensors the device `table` describes (layout
// above), n_blocks chunks of `chunk` elements, on `stream`.
extern "C" int multi_tensor_adam(const int64_t* table, int n, int n_blocks,
                                 int chunk, double lr, double beta1,
                                 double beta2, double eps,
                                 double weight_decay, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_blocks > 0) {
    multi_tensor_adam_kernel<<<n_blocks, kThreads, 0, s>>>(
        table, n, n_blocks, chunk, lr, beta1, beta2, eps, weight_decay);
  }
  multi_tensor_adam_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                  s>>>(table, n);
  return (int)cudaGetLastError();
}
