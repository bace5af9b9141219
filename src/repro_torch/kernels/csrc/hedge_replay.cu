// Hedge weight-update replay (paper Alg. 4 over a precomputed cost tensor),
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/weight_update.py::hedge_replay
// (_hedge_kernel via _hedge_call). Plain C interface, loaded with ctypes by
// repro_torch/kernels/weight_update.py, which also holds the plain PyTorch
// version.
//
// Two passes per (scenario s, schedule k) instance b = s * K + k:
//   1. trajectory: sequential over the J update events,
//        logw <- logw - eta[k, j] * C[s, j, :];  logw <- logw - max(logw),
//      every state stored to a global (S*K, J+1, P) scratch. One block per
//      instance, one thread per policy lane, one block-wide max per step.
//      The TPU kept this trajectory in VMEM; at J = 10000, P = 175 it is
//      7 MB per instance, far beyond one SM's 227 KB of shared memory, so
//      it lives in device memory (and mostly in L2).
//   2. sampling: one warp per (instance, job j): read trajectory row
//      n_done[j] (delayed feedback), softmax, inclusive cumsum, inverse-CDF
//      draw count(cdf <= u[s, j] * total) clamped to P - 1, and the chosen
//      probability and the expected cost sum(p * C[s, j, :]).
// Bound: pass 1 is a chain of J dependent steps (latency: one load, one
// block reduction and one barrier per step), not bytes or operations; the
// next step's cost row is loaded before the current reduction to overlap
// the two. The one-hot matmul gathers and triangular-matmul cumsum of the
// TPU kernel become direct loads and a warp scan. Built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSampleWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// grid (S*K); block: P rounded up to a warp multiple (<= 1024).
__global__ void trajectory_kernel(const float* __restrict__ C,
                                  const float* __restrict__ etas,
                                  float* __restrict__ traj,
                                  float* __restrict__ logw_out, int K, int J,
                                  int P, float logw0) {
  __shared__ float red[2][kWarp];
  const int b = blockIdx.x;
  const int s = b / K;
  const int k = b % K;
  const int p = threadIdx.x;
  const int lane = p % kWarp;
  const int warp = p / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const bool real = p < P;
  const float* Cs = C + (size_t)s * J * P;
  const float* eta = etas + (size_t)k * J;
  float* tb = traj + (size_t)b * (J + 1) * P;
  float lw = real ? logw0 : -INFINITY;
  if (real) tb[p] = lw;
  float c_next = (real && J > 0) ? Cs[p] : 0.f;
  float e_next = J > 0 ? eta[0] : 0.f;
  int par = 0;
  for (int i = 0; i < J; ++i) {
    const float c = c_next;
    const float e = e_next;
    if (i + 1 < J) {
      if (real) c_next = Cs[(size_t)(i + 1) * P + p];
      e_next = eta[i + 1];
    }
    if (real) lw = lw - e * c;
    float m = warp_max(real ? lw : -INFINITY);
    if (lane == 0) red[par][warp] = m;
    __syncthreads();
    m = warp_max(lane < n_warps ? red[par][lane] : -INFINITY);
    par ^= 1;
    if (real) {
      lw = lw - m;
      tb[(size_t)(i + 1) * P + p] = lw;
    }
  }
  if (real) logw_out[(size_t)b * P + p] = lw;
}

// grid (ceil(J / kSampleWarps), S*K); one warp per (instance, job).
__global__ void __launch_bounds__(kSampleWarps * kWarp)
sample_kernel(const float* __restrict__ C, const float* __restrict__ traj,
              const float* __restrict__ u, const int* __restrict__ n_done,
              int* __restrict__ chosen, float* __restrict__ p_chosen,
              float* __restrict__ expected, int K, int J, int P) {
  const int lane = threadIdx.x % kWarp;
  const int j = blockIdx.x * kSampleWarps + threadIdx.x / kWarp;
  if (j >= J) return;
  const int b = blockIdx.y;
  const int s = b / K;
  const float* lw = traj + ((size_t)b * (J + 1) + n_done[j]) * P;
  const float* c = C + ((size_t)s * J + j) * P;
  // Lane l owns the contiguous policies [lo, hi): the cumsum runs in order.
  const int chunk = (P + kWarp - 1) / kWarp;
  const int lo = min(lane * chunk, P);
  const int hi = min(lo + chunk, P);
  float m = -INFINITY;
  for (int i = lo; i < hi; ++i) m = fmaxf(m, lw[i]);
  m = warp_max(m);
  float local = 0.f;
  for (int i = lo; i < hi; ++i) local += expf(lw[i] - m);
  const float total_w = warp_sum(local);
  // Normalized probabilities, their in-lane sum and the expected cost.
  float psum = 0.f, ec = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float pi = expf(lw[i] - m) / total_w;
    psum += pi;
    ec += pi * c[i];
  }
  ec = warp_sum(ec);
  // Exclusive prefix of the lanes' sums (inclusive warp scan minus own).
  float incl = psum;
  for (int o = 1; o < kWarp; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const float total = __shfl_sync(kFull, incl, kWarp - 1);
  const float thresh = u[(size_t)s * J + j] * total;
  float cdf = incl - psum;
  int count = 0;
  for (int i = lo; i < hi; ++i) {
    cdf += expf(lw[i] - m) / total_w;
    count += cdf <= thresh ? 1 : 0;
  }
  count = warp_sum_int(count);
  if (lane == 0) {
    const int ch = min(count, P - 1);
    const size_t o = (size_t)b * J + j;
    chosen[o] = ch;
    p_chosen[o] = expf(lw[ch] - m) / total_w;
    expected[o] = ec;
  }
}

}  // namespace

// C: (S, J, P); etas: (K, J); u: (S, J); n_done: (J,); traj: (S*K, J+1, P)
// scratch; outputs chosen/p_chosen/expected (S*K, J) and logw (S*K, P).
extern "C" int hedge_replay_launch(const float* C, const float* etas,
                                   const float* u, const int* n_done,
                                   float* traj, int* chosen, float* p_chosen,
                                   float* expected, float* logw, int S, int K,
                                   int J, int P, float logw0,
                                   cudaStream_t stream) {
  if (S <= 0 || K <= 0) return 0;
  if (P < 1 || P > 1024 || S * K > 65535) return (int)cudaErrorInvalidValue;
  const int threads = (P + kWarp - 1) / kWarp * kWarp;
  trajectory_kernel<<<S * K, threads, 0, stream>>>(C, etas, traj, logw, K, J,
                                                   P, logw0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || J <= 0) return (int)err;
  const dim3 grid((J + kSampleWarps - 1) / kSampleWarps, S * K);
  sample_kernel<<<grid, kSampleWarps * kWarp, 0, stream>>>(
      C, traj, u, n_done, chosen, p_chosen, expected, K, J, P);
  return (int)cudaGetLastError();
}
