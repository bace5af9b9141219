// Closed-form task costs over a realized spot market, for sm_90a.
//
// Replaces the TPU kernels repro/kernels/policy_cost.py::policy_cost_chain
// (_chain_kernel) and ::policy_cost (_kernel). Plain C interface, loaded
// with ctypes by repro_torch/kernels/policy_cost.py, which also holds the
// plain PyTorch version of both functions and the chain route rule
// (chain_plan).
//
// Each active task does two dependent binary searches (16 probes each at
// 33k slots) and eight point loads into its (bid, scenario)'s cumulative
// arrays A, C, H = k*slot - A; the plan tensors are streamed once (the
// bytes bound). Three kernels:
//
// * chain_smem_kernel, the chain route wherever A fits a block's shared
//   memory (232448 bytes: up to 58111 slots). What bounds a chain row is
//   latency: about 49 x 32 dependent probes, and a plan entry read from
//   device memory per window. The kernel takes the probes out of L2: one
//   block serves one (bid, scenario), stages its A into shared memory once
//   and walks that pair's rows (persistent, about one block per SM), so
//   every probe is a shared-memory read; H is not read at all: a probe
//   computes H[i] = (float)i * slot - A[i], the same f32 product and
//   subtraction as h_cum, so the searches see H bit for bit and keep
//   lower_bound's probe sequence. Window k + 1's plan entries are loaded
//   while window k is costed. C stays in global memory (two adjacent pairs
//   per active task, through L2). A task with z_t <= eps, or whose window
//   has elapsed, skips the closed form and its loads: its outputs are
//   fixed (zeros, finish = start), so the skip is exact. With A taking
//   132 KB at Table 6's horizon, a block of 1024 threads (32 warps) is all
//   an SM holds; the block size is this file's, and the launch sizes the
//   shared memory from n_slots and trims blocks that would find no row.
// * chain_kernel, the route for a horizon whose A does not fit: one thread
//   per (bid, scenario, row), A and H read from global memory.
// * task_kernel, planned starts: one thread per (scenario, task), A and H
//   from global memory.
//
// Plans arrive window-major ((B, Sp, L, R)), so a warp's loads of one
// window are coalesced; shared plans are read through a scenario stride of
// 0. Numerics follow _chain_kernel exactly: positions are lower_bound over
// the n+1 unpadded entries (torch.searchsorted side="left"), a position
// past n means +inf, an A target <= 0 means t = 0. Built with -fmad=false
// so every product and sum rounds as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemThreads = 1024;

struct Params {
  int n;            // n_slots; the cumulative arrays hold n + 1 entries
  float slot, inv_slot, p_od, flex_rel, flex_abs, eps;
};

// How a task reads A and H: both from global memory ...
struct GlobalAH {
  const float* A;
  const float* H;
  __device__ __forceinline__ float a(int i) const { return __ldg(A + i); }
  __device__ __forceinline__ float h(int i) const { return __ldg(H + i); }
};

// ... or A from shared memory and H computed from it, as h_cum does.
struct SharedA {
  const float* A;
  float slot;
  __device__ __forceinline__ float a(int i) const { return A[i]; }
  __device__ __forceinline__ float h(int i) const {
    return (float)i * slot - A[i];
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// First index i in [0, n1) with !(x[i] < v): the count of leading entries
// below v on a non-decreasing array (x = A, or H if kH). Same loop as
// ATen's searchsorted.
template <bool kH, class AH>
__device__ __forceinline__ int lower_bound(const AH& ah, int n1, float v) {
  int lo = 0, hi = n1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const float x = kH ? ah.h(mid) : ah.a(mid);
    if (!(x >= v)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Float -> slot index, truncating toward zero like astype(int) / .to(int64).
__device__ __forceinline__ int slot_index(float t, const Params& p) {
  const float q = t * p.inv_slot;
  if (!(q > 0.f)) return 0;
  return q >= (float)p.n ? p.n - 1 : clampi((int)q, 0, p.n - 1);
}

__device__ __forceinline__ float interp(float c0, float c1, float frac,
                                        const Params& p) {
  return c0 + (c1 - c0) * p.inv_slot * frac;
}

struct TaskCost {
  float sc, oc, sw, ow, fin;
};

template <class AH>
__device__ TaskCost task_cost(const AH& ah, const float* __restrict__ C,
                              float start, float end, float z_t, float d_eff,
                              const Params& p) {
  const int n = p.n;
  const float need = z_t / (d_eff > 0.f ? d_eff : 1.f);
  const int k0 = slot_index(start, p);
  const float frac = start - (float)k0 * p.slot;
  const float A0 = interp(ah.a(k0), ah.a(k0 + 1), frac, p);
  const float C0 = interp(__ldg(C + k0), __ldg(C + k0 + 1), frac, p);
  const float H0 = start - A0;
  const float h_target = H0 + (end - start) - need;
  const float a_target = A0 + need;
  const int cnt_h = lower_bound<true>(ah, n + 1, h_target);
  const int cnt_a = lower_bound<false>(ah, n + 1, a_target);
  const int i_h = clampi(cnt_h, 1, n);
  const int i_a = clampi(cnt_a, 1, n);
  const bool no_flex = (end - start) - need <=
      fmaxf(fmaxf(p.flex_rel * (end - start), p.flex_abs * end), p.eps);
  float t_turn = (float)(i_h - 1) * p.slot + (h_target - ah.h(i_h - 1));
  if (no_flex) t_turn = start;
  if (cnt_h > n && !no_flex) t_turn = INFINITY;
  float t_fin = (float)(i_a - 1) * p.slot + (a_target - ah.a(i_a - 1));
  if (a_target <= 0.f) t_fin = 0.f;
  if (cnt_a > n) t_fin = INFINITY;
  const bool on_spot = t_fin <= t_turn;
  const float t_end = fminf(on_spot ? t_fin : t_turn, end);
  const int ke = slot_index(t_end, p);
  const float frace = t_end - (float)ke * p.slot;
  const float A_end = interp(ah.a(ke), ah.a(ke + 1), frace, p);
  const float C_end = interp(__ldg(C + ke), __ldg(C + ke + 1), frace, p);
  const bool active = z_t > p.eps;
  const float spot_work = fminf(d_eff * fmaxf(A_end - A0, 0.f), z_t);
  const float spot_cost = d_eff * fmaxf(C_end - C0, 0.f);
  const float od_work = z_t - spot_work;
  TaskCost out;
  out.sc = active ? spot_cost : 0.f;
  out.oc = active ? p.p_od * od_work : 0.f;
  out.sw = active ? spot_work : 0.f;
  out.ow = active ? od_work : 0.f;
  out.fin = active ? (on_spot ? t_fin : end) : start;
  return out;
}

// grid (blocks per pair, S, B), kSmemThreads threads, (n+1) floats of
// dynamic shared memory; one block per (bid, scenario) slice of rows.
__global__ void __launch_bounds__(kSmemThreads, 1)
chain_smem_kernel(const float* __restrict__ A, const float* __restrict__ C,
                  const float* __restrict__ arrival,
                  const float* __restrict__ ends, const float* __restrict__ z,
                  const float* __restrict__ d, const float* __restrict__ pins,
                  float* __restrict__ out, int B, int S, int Sp, int R, int L,
                  Params p) {
  extern __shared__ float A_s[];
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const size_t view = ((size_t)b * S + s) * (size_t)(p.n + 1);
  for (int i = threadIdx.x; i <= p.n; i += kSmemThreads)
    A_s[i] = __ldg(A + view + i);
  __syncthreads();
  const SharedA ah{A_s, p.slot};
  const float* Cb = C + view;
  const size_t plane = (size_t)B * S * R;
  for (int r = blockIdx.x * kSmemThreads + threadIdx.x; r < R;
       r += gridDim.x * kSmemThreads) {
    const float* ends_b = ends + (size_t)b * L * R + r;
    const size_t plan = ((size_t)b * Sp + (Sp == 1 ? 0 : s)) * L * R + r;
    float cur = arrival[(size_t)b * R + r];
    float sc = 0.f, oc = 0.f, sw = 0.f, ow = 0.f;
    // Window k + 1's plan entries are loaded while window k is costed, so
    // the device-memory latency of the plan stream stays off the chain.
    float end_n = 0.f, z_n = 0.f, pin_n = 0.f, d_n = 0.f;
    if (L > 0) {
      end_n = ends_b[0];
      z_n = z[plan];
      pin_n = pins[plan];
      d_n = z_n > p.eps ? d[plan] : 0.f;
    }
    for (int k = 0; k < L; ++k) {
      const float end = end_n, z_raw = z_n, d_k = d_n;
      const bool pin = pin_n > 0.5f;
      if (k + 1 < L) {
        const size_t o = (size_t)(k + 1) * R;
        end_n = ends_b[o];
        z_n = z[plan + o];
        pin_n = pins[plan + o];
        d_n = z_n > p.eps ? d[plan + o] : 0.f;
      }
      // Early-start semantics as in chain_kernel. An inactive task (no
      // work, or a window already elapsed) has fixed outputs: zero costs
      // and finish = start; only active ones run the closed form.
      const bool live = end > cur - p.eps;
      const float start = fminf(cur, end);
      float fin = start;
      if (live && z_raw > p.eps) {
        const TaskCost t = task_cost(ah, Cb, start, end, z_raw,
                                     fmaxf(d_k, 0.f), p);
        sc += t.sc;
        oc += t.oc;
        sw += t.sw;
        ow += t.ow;
        fin = t.fin;
      }
      if (pin) fin = end;
      if (z_raw > p.eps || pin) cur = fin;
    }
    const size_t i = ((size_t)b * S + s) * R + r;
    out[i] = sc;
    out[plane + i] = oc;
    out[2 * plane + i] = sw;
    out[3 * plane + i] = ow;
  }
}

// grid (ceil(R / kThreads), S, B); one thread per (bid, scenario, row).
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ A, const float* __restrict__ C,
             const float* __restrict__ H, const float* __restrict__ arrival,
             const float* __restrict__ ends, const float* __restrict__ z,
             const float* __restrict__ d, const float* __restrict__ pins,
             float* __restrict__ out, int B, int S, int Sp, int R, int L,
             Params p) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const size_t view = ((size_t)b * S + s) * (size_t)(p.n + 1);
  const GlobalAH ah{A + view, H + view};
  const float* Cb = C + view;
  const float* ends_b = ends + (size_t)b * L * R + r;
  const size_t plan = ((size_t)b * Sp + (Sp == 1 ? 0 : s)) * L * R + r;
  float cur = arrival[(size_t)b * R + r];
  float sc = 0.f, oc = 0.f, sw = 0.f, ow = 0.f;
  for (int k = 0; k < L; ++k) {
    const size_t o = (size_t)k * R;
    const float end = ends_b[o];
    const float z_raw = z[plan + o];
    const float d_k = fmaxf(d[plan + o], 0.f);
    const bool pin = pins[plan + o] > 0.5f;
    // Early-start semantics: the task runs in [min(cur, end), end]; a
    // task whose window already elapsed carries no cloud work.
    const bool live = end > cur - p.eps;
    const float start = fminf(cur, end);
    const TaskCost t = task_cost(ah, Cb, start, end, live ? z_raw : 0.f, d_k,
                                 p);
    sc += t.sc;
    oc += t.oc;
    sw += t.sw;
    ow += t.ow;
    const float fin = pin ? end : t.fin;
    if (z_raw > p.eps || pin) cur = fin;
  }
  const size_t plane = (size_t)B * S * R;
  const size_t i = ((size_t)b * S + s) * R + r;
  out[i] = sc;
  out[plane + i] = oc;
  out[2 * plane + i] = sw;
  out[3 * plane + i] = ow;
}

// grid (ceil(T / kThreads), S); one thread per (scenario, task).
__global__ void __launch_bounds__(kThreads)
task_kernel(const float* __restrict__ A, const float* __restrict__ C,
            const float* __restrict__ H, const float* __restrict__ start,
            const float* __restrict__ end, const float* __restrict__ z,
            const float* __restrict__ d, float* __restrict__ out, int S,
            int Sp, int T, Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= T) return;
  const int s = blockIdx.y;
  const size_t view = (size_t)s * (p.n + 1);
  const size_t plan = (size_t)(Sp == 1 ? 0 : s) * T + i;
  const float z_t = z[plan];
  const TaskCost t = task_cost(GlobalAH{A + view, H + view}, C + view,
                               start[i], end[i], z_t, d[plan], p);
  // ondemand_work as repro/engine/backend_pallas.py derives it.
  const float ow = p.p_od > 0.f
      ? t.oc / p.p_od
      : fmaxf(z_t - t.sw, 0.f) * (z_t > p.eps ? 1.f : 0.f);
  const size_t plane = (size_t)S * T;
  const size_t o = (size_t)s * T + i;
  out[o] = t.sc;
  out[plane + o] = t.oc;
  out[2 * plane + o] = t.sw;
  out[3 * plane + o] = ow;
  out[4 * plane + o] = t.fin;
}

}  // namespace

// The shared-memory chain route: blocks_per_pair blocks per (bid,
// scenario), as chain_plan (repro_torch/kernels/policy_cost.py) chooses
// them, trimmed to the pair's rows; the pair's A as dynamic shared memory.
extern "C" int policy_cost_chain_smem_launch(
    const float* A, const float* C, const float* arrival, const float* ends,
    const float* z, const float* d, const float* pins, float* out, int B,
    int S, int Sp, int R, int L, int n_slots, float slot, float inv_slot,
    float p_od, float flex_rel, float flex_abs, float eps,
    int blocks_per_pair, cudaStream_t stream) {
  if (R <= 0 || B <= 0 || S <= 0) return 0;
  if (blocks_per_pair < 1) return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)sizeof(float) * (n_slots + 1);
  cudaError_t err = cudaFuncSetAttribute(
      chain_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const Params p{n_slots, slot, inv_slot, p_od, flex_rel, flex_abs, eps};
  const int rows_blocks = (R + kSmemThreads - 1) / kSmemThreads;
  const dim3 grid(min(blocks_per_pair, rows_blocks), S, B);
  chain_smem_kernel<<<grid, kSmemThreads, smem_bytes, stream>>>(
      A, C, arrival, ends, z, d, pins, out, B, S, Sp, R, L, p);
  return (int)cudaGetLastError();
}

extern "C" int policy_cost_chain_launch(
    const float* A, const float* C, const float* H, const float* arrival,
    const float* ends, const float* z, const float* d, const float* pins,
    float* out, int B, int S, int Sp, int R, int L, int n_slots, float slot,
    float inv_slot, float p_od, float flex_rel, float flex_abs, float eps,
    cudaStream_t stream) {
  if (R <= 0 || B <= 0 || S <= 0) return 0;
  const Params p{n_slots, slot, inv_slot, p_od, flex_rel, flex_abs, eps};
  const dim3 grid((R + kThreads - 1) / kThreads, S, B);
  chain_kernel<<<grid, kThreads, 0, stream>>>(A, C, H, arrival, ends, z, d,
                                              pins, out, B, S, Sp, R, L, p);
  return (int)cudaGetLastError();
}

extern "C" int policy_cost_launch(
    const float* A, const float* C, const float* H, const float* start,
    const float* end, const float* z, const float* d, float* out, int S,
    int Sp, int T, int n_slots, float slot, float inv_slot, float p_od, float flex_rel,
    float flex_abs, float eps, cudaStream_t stream) {
  if (T <= 0 || S <= 0) return 0;
  const Params p{n_slots, slot, inv_slot, p_od, flex_rel, flex_abs, eps};
  const dim3 grid((T + kThreads - 1) / kThreads, S);
  task_kernel<<<grid, kThreads, 0, stream>>>(A, C, H, start, end, z, d, out,
                                             S, Sp, T, p);
  return (int)cudaGetLastError();
}
