// Closed-form task costs over a realized spot market, for sm_90a.
//
// Replaces the TPU kernels repro/kernels/policy_cost.py::policy_cost_chain
// (_chain_kernel) and ::policy_cost (_kernel). Plain C interface, loaded
// with ctypes by repro_torch/kernels/policy_cost.py, which also holds the
// plain PyTorch version of both functions, the chain route rule
// (chain_plan) and the task kernel's launch plan (task_plan).
//
// Each active task does two dependent binary searches (16 probes each at
// 33k slots) and ten point loads into its (bid, scenario)'s cumulative
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
// * task_tree_kernel, planned starts, one kernel at any horizon. Each task
//   is one closed form; what bounds the kernel is its instruction rate:
//   about 450 instructions a task, two thirds of them the two searches
//   and their address arithmetic. lower_bound over n1 entries probes a
//   binary tree of indices that depends on n1 alone, and the A search and
//   the H search walk the same tree. Each block keeps the tree's top
//   kTreeDepth levels in shared memory, breadth-first (root 0, children
//   2j+1 and 2j+2): A and H at each node's probe (H as h_cum computes it)
//   and the interval of each node one level below, 16 KB whatever the
//   horizon. Both searches
//   walk those levels in lockstep, a load, a compare and an offset per
//   level, then finish ATen's loop on the interval reached (at most
//   n1 >> kTreeDepth entries, 32 at Table 6's 33022) in A through L1/L2,
//   computing H per probe, for the same number of steps in every thread.
//   The probe sequence is lower_bound's, so results stay bit-equal where H
//   falls by an ulp. Deeper trees cost more to build (each block gathers
//   its nodes from L2) than their shorter loops save. The grid is
//   persistent (the launch plan fills the SMs once, each block on one
//   scenario); each block takes an even contiguous share of its
//   scenario's tasks, its threads stride over it and load the next task's
//   inputs while one is costed.
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
// The task kernel: block size, the blocks per SM its register budget is
// set for, and the levels of the search tree kept in shared memory.
constexpr int kTaskThreads = 1024;
constexpr int kTaskMinBlocks = 1;
constexpr int kTreeDepth = 10;

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

// ... or the task kernel's search tree in shared memory (see
// task_tree_kernel) for a search's first levels, and A in global memory,
// H computed, for the rest and for point loads.
struct TreeA {
  const char* ta;       // A at the nodes of the tree's first depth levels
  const char* th;       // H at them, computed as h_cum does
  const int2* leaf;     // [lo, hi) of the leaves, the nodes at level depth
  int depth;
  int nodes;            // the nodes above the leaves, 2^depth - 1
  int tail;             // the loop's steps after the tree, at most
  const float* A;
  float slot;
  __device__ __forceinline__ float a(int i) const { return __ldg(A + i); }
  __device__ __forceinline__ float h(int i) const {
    return (float)i * slot - __ldg(A + i);
  }
};

// p itself, opaque to the compiler: an address computed from it is one
// 32-bit index times 4 plus p, not a sum of 64-bit offsets redone per load.
__device__ __forceinline__ const float* opaque(const float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

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

// A task's two searches: the H target's count, then the A target's.
template <class AH>
__device__ __forceinline__ void search2(const AH& ah, int n1, float h_target,
                                        float a_target, int& cnt_h,
                                        int& cnt_a) {
  cnt_h = lower_bound<true>(ah, n1, h_target);
  cnt_a = lower_bound<false>(ah, n1, a_target);
}

// One step of lower_bound's loop against the value x probed at mid, where
// [lo, hi) is still open; branch-free, so a closed search may step too.
__device__ __forceinline__ void descend(float x, float v, int mid, int& lo,
                                        int& hi) {
  const bool open = lo < hi;
  const bool below = !(x >= v);
  lo = open && below ? mid + 1 : lo;
  hi = open && !below ? mid : hi;
}

// One level of the tree walk, on byte offsets (node j at 4j): node j's
// probe is x[j]; !(x[j] >= v) goes right, to 2j + 2, else left, to 2j + 1.
__device__ __forceinline__ unsigned child(const char* x, unsigned off,
                                          float v) {
  return 2 * off + (*reinterpret_cast<const float*>(x + off) >= v ? 4u : 8u);
}

// Both searches in lockstep, each lower_bound's exact probe sequence: the
// first depth probes walk the tree, the node reached gives the interval
// the rest of the loop probes in A. That interval holds at most
// n1 >> depth entries, so the loop takes at most the bit length of that
// many steps: a trip count the same for every thread.
__device__ __forceinline__ void search2(const TreeA& t, int n1, float h_target,
                                        float a_target, int& cnt_h,
                                        int& cnt_a) {
  unsigned off_h = 0, off_a = 0;
  if (t.depth == kTreeDepth) {
#pragma unroll
    for (int l = 0; l < kTreeDepth; ++l) {
      off_h = child(t.th, off_h, h_target);
      off_a = child(t.ta, off_a, a_target);
    }
  } else {
    for (int l = 0; l < t.depth; ++l) {
      off_h = child(t.th, off_h, h_target);
      off_a = child(t.ta, off_a, a_target);
    }
  }
  const int2 rh = t.leaf[(off_h >> 2) - t.nodes];
  const int2 ra = t.leaf[(off_a >> 2) - t.nodes];
  int lo_h = rh.x, hi_h = rh.y, lo_a = ra.x, hi_a = ra.y;
  for (int k = t.tail; k > 0; --k) {
    const int mid_h = min(lo_h + ((hi_h - lo_h) >> 1), n1 - 1);
    const int mid_a = min(lo_a + ((hi_a - lo_a) >> 1), n1 - 1);
    descend(t.h(mid_h), h_target, mid_h, lo_h, hi_h);
    descend(t.a(mid_a), a_target, mid_a, lo_a, hi_a);
  }
  cnt_h = lo_h;
  cnt_a = lo_a;
}

// The levels of the task kernel's tree: at most kTreeDepth, and only levels
// whose every node the loop reaches with a non-empty interval. The
// smallest interval at level l, always going right, is empty unless
// n1 >= 2^(l+1) - 1, so that is floor(log2(n1 + 1)) levels.
int tree_depth(int n1) {
  int levels = 0;
  while (levels < kTreeDepth && n1 + 1 >= (2 << levels)) ++levels;
  return levels;
}

// Shared memory of the tree, laid out for kTreeDepth levels whatever the
// depth: A at the nodes, H at the nodes, then the leaves' intervals; fixed
// offsets, so a probe's address is its node's plus a constant.
constexpr int kTreeNodes = (1 << kTreeDepth) - 1;
constexpr int kTreeBytes =
    2 * (int)sizeof(float) * kTreeNodes + (int)sizeof(int2) * (kTreeNodes + 1);
static_assert(kTreeBytes <= 48 * 1024,
              "the tree must fit the dynamic shared memory a launch gets "
              "without opting in");

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
  int cnt_h, cnt_a;
  search2(ah, n + 1, h_target, a_target, cnt_h, cnt_a);
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

// grid (blocks per scenario, S), kTaskThreads threads, kTreeBytes of
// dynamic shared memory; a block serves an even contiguous share of one
// scenario's tasks, its threads striding over it.
__global__ void __launch_bounds__(kTaskThreads, kTaskMinBlocks)
task_tree_kernel(const float* __restrict__ A, const float* __restrict__ C,
                 const float* __restrict__ start,
                 const float* __restrict__ end, const float* __restrict__ z,
                 const float* __restrict__ d, float* __restrict__ out, int S,
                 int Sp, int T, int depth, Params p) {
  extern __shared__ int2 smem[];
  const int nodes = (1 << depth) - 1;
  float* ta = reinterpret_cast<float*>(smem);
  float* th = ta + kTreeNodes;
  int2* leaf = smem + kTreeNodes;
  const int s = blockIdx.y;
  const int n1 = p.n + 1;
  const float* As = opaque(A + (size_t)s * n1);
  const float* zs = z + (size_t)(Sp == 1 ? 0 : s) * T;
  const float* ds = d + (size_t)(Sp == 1 ? 0 : s) * T;
  // The block's share of the scenario's tasks, as even as the grid
  // allows, strided over by its threads.
  const int t_end = (int)((long long)T * (blockIdx.x + 1) / gridDim.x);
  int i = (int)((long long)T * blockIdx.x / gridDim.x) + threadIdx.x;
  // The first task's inputs load while the tree is built.
  float start_n = 0.f, end_n = 0.f, z_n = 0.f, d_n = 0.f;
  if (i < t_end) {
    start_n = start[i];
    end_n = end[i];
    z_n = zs[i];
    d_n = ds[i];
  }
  // Node j's interval, walked from the root's [0, n1) along the bits of
  // j + 1 below its leading one (0 left, 1 right) as the loop splits it:
  // A and H at the probes of the nodes above the leaves, the intervals of
  // the leaves. No barrier between levels; every load sent before any
  // store, which would hold the next load behind it.
  constexpr int kPerThread =
      (2 * kTreeNodes + 1 + kTaskThreads - 1) / kTaskThreads;
  int lo[kPerThread], hi[kPerThread];
  float a[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int path = min(u * kTaskThreads + (int)threadIdx.x, 2 * nodes) + 1;
    lo[u] = 0;
    hi[u] = n1;
    for (int b = 30 - __clz(path); b >= 0; --b) {
      const int mid = lo[u] + ((hi[u] - lo[u]) >> 1);
      if ((path >> b) & 1) lo[u] = mid + 1; else hi[u] = mid;
    }
    a[u] = path <= nodes ? __ldg(As + lo[u] + ((hi[u] - lo[u]) >> 1)) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = u * kTaskThreads + threadIdx.x;
    if (j < nodes) {
      const int mid = lo[u] + ((hi[u] - lo[u]) >> 1);
      ta[j] = a[u];
      th[j] = (float)mid * p.slot - a[u];
    } else if (j <= 2 * nodes) {
      leaf[j - nodes] = make_int2(lo[u], hi[u]);
    }
  }
  __syncthreads();
  int tail = 0;   // the bit length of the largest leaf's n1 >> depth entries
  for (int left = n1 >> depth; left > 0; left >>= 1) ++tail;
  const TreeA ah{reinterpret_cast<const char*>(ta),
                 reinterpret_cast<const char*>(th), leaf, depth, nodes, tail,
                 As, p.slot};
  const float* Cs = opaque(C + (size_t)s * n1);
  const size_t plane = (size_t)S * T;
  float* o = out + (size_t)s * T;
  for (; i < t_end; i += kTaskThreads) {
    const float st = start_n, en = end_n, z_t = z_n, d_t = d_n;
    const int next = i + kTaskThreads;
    if (next < t_end) {
      start_n = start[next];
      end_n = end[next];
      z_n = zs[next];
      d_n = ds[next];
    }
    const TaskCost t = task_cost(ah, Cs, st, en, z_t, d_t, p);
    // ondemand_work as repro/engine/backend_pallas.py derives it.
    const float ow = p.p_od > 0.f
        ? t.oc / p.p_od
        : fmaxf(z_t - t.sw, 0.f) * (z_t > p.eps ? 1.f : 0.f);
    o[i] = t.sc;
    o[plane + i] = t.oc;
    o[2 * plane + i] = t.sw;
    o[3 * plane + i] = ow;
    o[4 * plane + i] = t.fin;
  }
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

// The task kernel's layout for n_slots: threads per block, blocks an SM
// holds (occupancy), tree levels and dynamic shared memory per block (the
// same at every horizon).
extern "C" int policy_cost_task_layout(int n_slots, int* out) {
  if (n_slots < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, task_tree_kernel, kTaskThreads, kTreeBytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = kTaskThreads;
  out[1] = blocks;
  out[2] = tree_depth(n_slots + 1);
  out[3] = kTreeBytes;
  return 0;
}

// Planned starts: blocks_per_scenario blocks per scenario, as task_plan
// (repro_torch/kernels/policy_cost.py) chooses them.
extern "C" int policy_cost_launch(
    const float* A, const float* C, const float* start, const float* end,
    const float* z, const float* d, float* out, int S, int Sp, int T,
    int n_slots, float slot, float inv_slot, float p_od, float flex_rel,
    float flex_abs, float eps, int blocks_per_scenario, cudaStream_t stream) {
  if (T <= 0 || S <= 0) return 0;
  if (blocks_per_scenario < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  const Params p{n_slots, slot, inv_slot, p_od, flex_rel, flex_abs, eps};
  const dim3 grid(blocks_per_scenario, S);
  task_tree_kernel<<<grid, kTaskThreads, kTreeBytes, stream>>>(
      A, C, start, end, z, d, out, S, Sp, T, tree_depth(n_slots + 1), p);
  return (int)cudaGetLastError();
}
