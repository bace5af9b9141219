// Hedge weight-update replay (paper Alg. 4 over a precomputed cost tensor),
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/weight_update.py::hedge_replay
// (_hedge_kernel via _hedge_call). Plain C interface, loaded with ctypes by
// repro_torch/kernels/weight_update.py, which also holds the plain PyTorch
// version and chooses the blocks (hedge_plan); this file lays out the
// registers and the ring (hedge_replay_ring reports the layout).
//
// Two passes per (scenario s, schedule k) instance b = s * K + k:
//   1. trajectory: sequential over the J update events,
//        logw <- logw - eta[k, j] * C[s, j, :];  logw <- logw - max(logw),
//      every state stored to a global (S*K, J+1, P) scratch (7 MB per
//      instance at J = 10000, P = 175: it cannot stay on chip).
//   2. sampling: one warp per (instance, job j): read trajectory row
//      n_done[j] (delayed feedback), softmax, inclusive cumsum, inverse-CDF
//      draw count(cdf <= u[s, j] * total) clamped to P - 1, and the chosen
//      probability and the expected cost sum(p * C[s, j, :]).
//
// What bounds pass 1 is the dependency chain of one step, J times over:
// not bytes, not operations. A block per instance (one thread per policy)
// would put two shuffle-tree maxes, a shared-memory round trip, a block
// barrier and a global load on that chain. This kernel keeps it to
// register operations and one warp instruction:
// * one warp per instance; its P log-weights live in registers, NJ per
//   lane (policy p = j * 32 + lane), so the step's products and
//   subtractions are independent register operations;
// * the step's max is an in-lane fmaxf tree, then __reduce_max_sync
//   (redux.sync) over the lanes on the order-preserving integer image of
//   the float, i ^ ((i >> 31) & 0x7fffffff), its own inverse: exact, as a
//   max is in any order;
// * the cost rows come from a shared-memory ring of kStages stages of
//   `rows` rows, filled kStages - 1 stages ahead by cp.async (16-byte
//   copies where the stage's source is aligned, 4-byte ones elsewhere);
//   a block holds the warps of up to four schedules of one scenario,
//   which share C[s]: one barrier per stage, none per step. The etas of a
//   stage sit one per lane, loaded a stage ahead, and reach the step by
//   shuffle; the next step's row and eta are read while a step runs;
// * each state is stored a step late, while the next step's redux.sync
//   runs, so no store waits for the chain's result.
// The one-hot matmul gathers and triangular-matmul cumsum of the TPU
// kernel become direct loads and a warp scan in pass 2. Built with
// -fmad=false: each product and difference rounds as in the plain version,
// so the trajectory is bit-equal to it (up to the sign of a zero).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSampleWarps = 8;
constexpr int kStages = 4;         // ring stages
constexpr int kMaxBlockWarps = 4;  // one schedule per warp scheduler
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

// The order-preserving integer image of a float (and its inverse): signed
// integer order on the images is the float order, -0 just below +0.
__device__ __forceinline__ int ordered(int i) {
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy `count` floats from global src to shared dst (16-byte aligned)
// with cp.async, shared by the block's threads; one commit group per call.
__device__ __forceinline__ void fill_stage(float* dst, const float* src,
                                           int count) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = count & ~3;
    for (int q = 4 * tid; q < head; q += 4 * nt)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + q)), "l"(src + q));
  }
  for (int q = head + tid; q < count; q += nt)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst + q)), "l"(src + q));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Rows per ring stage for nj values per lane: 32 up to 384 policies, 16 up
// to 768, 8 above, so that four stages fit a block's shared memory; a
// stage's etas are one per lane, so at most 32.
__host__ __device__ constexpr int rows_for(int nj) {
  return nj <= 12 ? 32 : nj <= 24 ? 16 : 8;
}
template <int NJ>
constexpr int kRows = rows_for(NJ);

// The values per lane the kernel is built for; a launch takes the least
// that holds P.
constexpr int kLaneCounts[] = {1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32};

int lanes_for(int P) {
  for (int n : kLaneCounts)
    if (n * kWarp >= P) return n;
  return 0;
}

// A ring stage's stride in floats (its rows of P, padded to 16 bytes) and
// the ring's bytes.
int stage_stride(int nj, int P) { return (rows_for(nj) * P + 3) / 4 * 4; }
int ring_bytes(int nj, int P) {
  return (int)sizeof(float) * kStages * stage_stride(nj, P);
}

// Row `row` of a stage into c: policy p = j * 32 + lane, 0 past P.
template <int NJ>
__device__ __forceinline__ void load_row(float (&c)[NJ], const float* row,
                                         int P, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int p = j * kWarp + lane;
    c[j] = p < P ? row[p] : 0.f;
  }
}

// The state lw to trajectory row `out`.
template <int NJ>
__device__ __forceinline__ void store_row(const float (&lw)[NJ], float* out,
                                          int P, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int p = j * kWarp + lane;
    if (p < P) out[p] = lw[j];
  }
}

// One update event of one instance: lw <- lw - e * c, lw <- lw - max(lw).
// The state entering the step is stored to its trajectory row `prev` while
// redux.sync runs, a step late, so no store waits for the chain's result.
// A slot past P holds -inf with c = 0, so it stays -inf with no select on
// the chain. The chain: one subtraction, the in-lane fmaxf tree, the
// integer map, redux.sync, the map back, the second subtraction.
template <int NJ>
__device__ __forceinline__ void hedge_step(float (&lw)[NJ],
                                           const float (&c)[NJ], float e,
                                           float* __restrict__ prev, int P,
                                           int lane) {
  float x[NJ], m[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    x[j] = lw[j] - e * c[j];
    m[j] = x[j];
  }
#pragma unroll
  for (int w = 1; w < NJ; w *= 2)
#pragma unroll
    for (int j = 0; j + w < NJ; j += 2 * w) m[j] = fmaxf(m[j], m[j + w]);
  const int top = __reduce_max_sync(kFull, ordered(__float_as_int(m[0])));
  store_row(lw, prev, P, lane);
  const float mx = __int_as_float(ordered(top));
#pragma unroll
  for (int j = 0; j < NJ; ++j) lw[j] = x[j] - mx;
}

// grid (S * groups); block warps * 32 threads, warp w of group g runs
// schedule k = g * warps + w (none if k >= K); dynamic shared memory: the
// cost ring, kStages stages of stage_stride(NJ, P) floats. The barrier at
// each stage's start lets the slot that stage t - 1 used be refilled.
// NJ >= ceil(P / 32).
template <int NJ>
__global__ void __launch_bounds__(kMaxBlockWarps * kWarp)
trajectory_kernel(const float* __restrict__ C, const float* __restrict__ etas,
                  float* __restrict__ traj, float* __restrict__ logw_out,
                  int K, int J, int P, int groups, int stride, float logw0) {
  constexpr int rows = kRows<NJ>;
  extern __shared__ __align__(16) float ring[];
  const int s = blockIdx.x / groups;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int k = blockIdx.x % groups * (blockDim.x / kWarp) + warp;
  const bool has = k < K;
  const float* Cs = C + (size_t)s * J * P;
  const int n_stages = (J + rows - 1) / rows;
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages)
      fill_stage(ring + t * stride, Cs + (size_t)t * rows * P,
                 min(rows, J - t * rows) * P);
    commit();
  }
  const size_t b = (size_t)s * K + (has ? k : 0);
  float* tb = traj + b * (size_t)(J + 1) * P;
  const float* eta = etas + (size_t)(has ? k : 0) * J;
  float lw[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int p = j * kWarp + lane;
    lw[j] = p < P ? logw0 : -INFINITY;
  }
  // Lane l holds eta[k, t * rows + l] of the stage t being stepped.
  float e_next = has && lane < rows && lane < J ? __ldg(eta + lane) : 0.f;
  for (int t = 0; t < n_stages; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    const int tf = t + kStages - 1;     // refill the slot stage t-1 used
    if (tf < n_stages)
      fill_stage(ring + (tf % kStages) * stride,
                 Cs + (size_t)tf * rows * P, min(rows, J - tf * rows) * P);
    commit();
    const float e_cur = e_next;
    const int i0 = t * rows;
    if (has && t + 1 < n_stages && lane < rows && i0 + rows + lane < J)
      e_next = __ldg(eta + i0 + rows + lane);
    if (!has) continue;
    const float* cr = ring + (t % kStages) * stride;
    float* out = tb + (size_t)i0 * P;    // row i0 + r, stored in step r
    float c[NJ];
    load_row(c, cr, P, lane);
    float e = __shfl_sync(kFull, e_cur, 0);
    if (J - i0 >= rows) {
      // A full stage, unrolled: the next step's row and eta are read
      // while this step's chain runs.
#pragma unroll
      for (int r = 0; r < rows; ++r) {
        float cn[NJ];
        float en = 0.f;
        if (r + 1 < rows) {
          load_row(cn, cr + (r + 1) * P, P, lane);
          en = __shfl_sync(kFull, e_cur, r + 1);
        }
        hedge_step(lw, c, e, out + r * P, P, lane);
        if (r + 1 < rows) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) c[j] = cn[j];
          e = en;
        }
      }
    } else {
      for (int r = 0; r < J - i0; ++r) {    // the last, partial stage
        hedge_step(lw, c, e, out + r * P, P, lane);
        if (r + 1 < J - i0) {
          load_row(c, cr + (r + 1) * P, P, lane);
          e = __shfl_sync(kFull, e_cur, r + 1);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (!has) return;
  store_row(lw, tb + (size_t)J * P, P, lane);
  store_row(lw, logw_out + b * P, P, lane);
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

template <int NJ>
cudaError_t launch_trajectory(const float* C, const float* etas, float* traj,
                              float* logw, int S, int K, int J, int P,
                              int groups, int warps, float logw0,
                              cudaStream_t stream) {
  const int smem_bytes = ring_bytes(NJ, P);
  cudaError_t err = cudaFuncSetAttribute(
      trajectory_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  trajectory_kernel<NJ><<<S * groups, warps * kWarp, smem_bytes, stream>>>(
      C, etas, traj, logw, K, J, P, groups, stage_stride(NJ, P), logw0);
  return cudaGetLastError();
}

}  // namespace

// The trajectory pass's layout for P policies: out[0] values per lane,
// out[1] rows per ring stage, out[2] a stage's bytes, out[3] the ring's
// (the dynamic shared memory per block).
extern "C" int hedge_replay_ring(int P, int* out) {
  if (P < 1 || P > 1024) return (int)cudaErrorInvalidValue;
  const int nj = lanes_for(P);
  out[0] = nj;
  out[1] = rows_for(nj);
  out[2] = (int)sizeof(float) * stage_stride(nj, P);
  out[3] = ring_bytes(nj, P);
  return 0;
}

// C: (S, J, P); etas: (K, J); u: (S, J); n_done: (J,); traj: (S*K, J+1, P)
// scratch; outputs chosen/p_chosen/expected (S*K, J) and logw (S*K, P).
// groups (blocks per scenario) and warps (per block) come from hedge_plan
// (repro_torch/kernels/weight_update.py).
extern "C" int hedge_replay_launch(const float* C, const float* etas,
                                   const float* u, const int* n_done,
                                   float* traj, int* chosen, float* p_chosen,
                                   float* expected, float* logw, int S, int K,
                                   int J, int P, float logw0, int groups,
                                   int warps, cudaStream_t stream) {
  if (S <= 0 || K <= 0) return 0;
  if (P < 1 || P > 1024 || S * K > 65535 || warps < 1 ||
      warps > kMaxBlockWarps || groups * warps < K)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define HEDGE_NJ(N)                                                        \
  case N:                                                                  \
    err = launch_trajectory<N>(C, etas, traj, logw, S, K, J, P, groups,    \
                               warps, logw0, stream);                      \
    break;
  switch (lanes_for(P)) {
    HEDGE_NJ(1) HEDGE_NJ(2) HEDGE_NJ(3) HEDGE_NJ(4) HEDGE_NJ(5) HEDGE_NJ(6)
    HEDGE_NJ(7) HEDGE_NJ(8) HEDGE_NJ(12) HEDGE_NJ(16) HEDGE_NJ(24)
    HEDGE_NJ(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HEDGE_NJ
  if (err != cudaSuccess || J <= 0) return (int)err;
  const dim3 grid((J + kSampleWarps - 1) / kSampleWarps, S * K);
  sample_kernel<<<grid, kSampleWarps * kWarp, 0, stream>>>(
      C, traj, u, n_done, chosen, p_chosen, expected, K, J, P);
  return (int)cudaGetLastError();
}
