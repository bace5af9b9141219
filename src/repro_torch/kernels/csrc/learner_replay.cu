// Bandit and follow-the-leader learner replay (exp3, ucb1, egreedy, ftl)
// over a precomputed cost tensor, for sm_90a.
//
// Counterpart of the reference's repro/learn/replay.py::_scan_one: one
// jax.lax.scan per learner kind over the merged (sample, update) event
// stream, vmapped over scenarios x instances; the reference has no Pallas
// kernel for these learners. Plain C interface, loaded with ctypes by
// repro_torch/kernels/learner_replay.py, which holds the plain PyTorch
// version; the two take the same operations in the same order and agree
// bit for bit (exp and log aside, see below).
//
// A bandit learner's draw feeds its own later update (exp3's importance
// weight c / p, the one arm ucb1 and egreedy observe), so there is no
// trajectory to compute apart from the draws, as the Hedge kernel does.
// One warp walks the 2J events of one (scenario s, instance k) pair,
// b = s * K + k, every kind in one launch (the kind is per instance, so
// uniform across a warp):
// * the state (log-weights, sums, counts) lives in registers, policy
//   q = lane * NJ + i in slot i of lane q / NJ (contiguous, so the cdf is
//   an in-lane serial prefix plus one warp scan); slots past P hold -inf
//   log-weights and zero sums, counts, costs and probabilities;
// * a sample event computes the kind's probabilities, the cdf (in-lane
//   prefix + the exclusive Hillis-Steele scan of the lane totals),
//   normalizes it by its value at policy P - 1, counts the policies with
//   cdf / total <= u (numpy's searchsorted side="right", clamped to P - 1),
//   and writes the draw, its probability and the expected cost (an in-lane
//   serial sum and the xor butterfly, as every sum here);
// * an update event reads the draw back (lane 0 wrote it, a __syncwarp
//   earlier) and applies the kind's update (learners.py::update_state);
// * exp3's max is exact in any order: an in-lane fmaxf and redux.sync over
//   the lanes on the floats' order-preserving integer images; an argmin is
//   redux.sync min on the images of the lanes' best (value, lowest index)
//   pairs, then on the indices of the lanes that hold that value: ties go
//   to the lowest index as numpy's and torch's argmin. -0 is taken as +0;
// * exp and log are evaluated in double and rounded to float: the
//   correctly rounded result, which the plain version's double exp and log
//   give too (up to a double result within an ulp of a rounding midpoint).
// Built with -fmad=false: every product and sum rounds as in the plain
// version.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = 3.0e38f;    // learners.py's _NEG: untried arms
enum { kExp3 = 0, kUcb1 = 1, kEgreedy = 2, kFtl = 3 };

// The values per lane the kernel is built for (LANE_COUNTS in
// learner_replay.py); a launch takes the least that holds P.
constexpr int kLaneCounts[] = {1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32};

int lanes_for(int P) {
  for (int n : kLaneCounts)
    if (n * kWarp >= P) return n;
  return 0;
}

// The order-preserving integer image of a float, its own inverse; -0 is
// mapped as +0.
__device__ __forceinline__ int ordered(int i) {
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int key(float x) {
  return ordered(__float_as_int(x == 0.f ? 0.f : x));
}

__device__ __forceinline__ float warp_max(float v) {
  return __int_as_float(ordered(__reduce_max_sync(kFull, key(v))));
}

// In-lane serial sum, then the xor butterfly (every lane gets lane 0's).
template <int NJ>
__device__ __forceinline__ float lane_sum(const float (&x)[NJ]) {
  float acc = x[0];
#pragma unroll
  for (int i = 1; i < NJ; ++i) acc = acc + x[i];
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    acc = acc + __shfl_xor_sync(kFull, acc, o);
  return acc;
}

// x of policy q (0 <= q < 32 * NJ), on every lane.
template <int NJ>
__device__ __forceinline__ float pick(const float (&x)[NJ], int q) {
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < NJ; ++i)
    if (i == q % NJ) mine = x[i];
  return __shfl_sync(kFull, mine, q / NJ);
}

// The kind's sampling distribution at exploration rate g into p
// (learners.py::sample_probs), 0 past P.
template <int NJ>
__device__ __forceinline__ void probs(int kind, const float (&lw)[NJ],
                                      const float (&sm)[NJ],
                                      const float (&cn)[NJ], float g, int P,
                                      int lane, float (&p)[NJ]) {
  const int q0 = lane * NJ;
  if (kind == kExp3) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < NJ; ++i) m = fmaxf(m, lw[i]);
    m = warp_max(m);
    float w[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) w[i] = (float)exp((double)(lw[i] - m));
    const float T = lane_sum(w);
#pragma unroll
    for (int i = 0; i < NJ; ++i)
      p[i] = q0 + i < P ? (1.f - g) * (w[i] / T) + g / (float)P : 0.f;
    return;
  }
  float lt = 0.f;
  if (kind == kUcb1) {
    const float t = fmaxf(lane_sum(cn), 1.f);
    lt = (float)log((double)t);
  }
  float best = INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    if (q0 + i >= P) continue;
    float score = sm[i];
    if (kind != kFtl) {
      const float cs = fmaxf(cn[i], 1.f);
      const float mean = sm[i] / cs;
      score = cn[i] < 0.5f ? -kNeg
              : kind == kUcb1 ? mean - sqrtf(2.f * lt / cs) : mean;
    }
    if (score < best) {      // strict: the lane's lowest index on ties
      best = score;
      bi = q0 + i;
    }
  }
  const int top = __reduce_min_sync(kFull, key(best));
  const int a = __reduce_min_sync(kFull, key(best) == top ? bi : INT_MAX);
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const float one = q0 + i == a ? 1.f : 0.f;
    p[i] = q0 + i >= P ? 0.f
           : kind == kEgreedy ? (1.f - g) * one + g / (float)P : one;
  }
}

// grid S * K blocks of one warp; block b runs instance b = s * K + k.
template <int NJ>
__global__ void __launch_bounds__(kWarp)
learner_kernel(const float* __restrict__ C, const float* __restrict__ etas,
               const float* __restrict__ gammas, const float* __restrict__ u,
               const int* __restrict__ ev_kind, const int* __restrict__ ev_j,
               const int* __restrict__ kinds, int* chosen, float* p_chosen,
               float* __restrict__ expected, float* __restrict__ weights,
               float* __restrict__ logw_out, float* __restrict__ sums_out,
               float* __restrict__ counts_out, int K, int J, int P,
               float logw0) {
  const int b = blockIdx.x;
  const int s = b / K, k = b % K;
  const int lane = threadIdx.x;
  const int kind = kinds[k];
  const float* Cs = C + (size_t)s * J * P;
  const float* eta = etas + (size_t)k * J;
  const float* gam = gammas + (size_t)k * J;
  const float* us = u + (size_t)s * J;
  int* ch = chosen + (size_t)b * J;
  float* pch = p_chosen + (size_t)b * J;
  float* ex = expected + (size_t)b * J;
  const int q0 = lane * NJ;
  float lw[NJ], sm[NJ], cn[NJ], p[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    lw[i] = q0 + i < P ? logw0 : -INFINITY;
    sm[i] = 0.f;
    cn[i] = 0.f;
  }
  for (int e = 0; e < 2 * J; ++e) {
    const int j = ev_j[e];
    const float* row = Cs + (size_t)j * P;
    if (ev_kind[e] == 0) {
      probs(kind, lw, sm, cn, gam[j], P, lane, p);
      float cdf[NJ];
      cdf[0] = p[0];
#pragma unroll
      for (int i = 1; i < NJ; ++i) cdf[i] = cdf[i - 1] + p[i];
      float incl = cdf[NJ - 1];
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = incl + v;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int i = 0; i < NJ; ++i) cdf[i] = excl + cdf[i];
      const float total = pick(cdf, P - 1);
      const float uj = us[j];
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < NJ; ++i)
        cnt += q0 + i < P && cdf[i] / total <= uj ? 1 : 0;
      const int c = min((int)__reduce_add_sync(kFull, (unsigned)cnt), P - 1);
      const float pc = pick(p, c);
      float x[NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i)
        x[i] = p[i] * (q0 + i < P ? row[q0 + i] : 0.f);
      const float ec = lane_sum(x);
      if (lane == 0) {
        ch[j] = c;
        pch[j] = pc;
        ex[j] = ec;
      }
      __syncwarp();
    } else {
      const int c = ch[j];
      const float pc = pch[j];
      const float val = row[c];
      if (kind == kExp3) {
        const float y = eta[j] * (val / pc);
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          if (q0 + i == c) lw[i] = lw[i] - y;
          m = fmaxf(m, lw[i]);
        }
        m = warp_max(m);
#pragma unroll
        for (int i = 0; i < NJ; ++i) lw[i] = lw[i] - m;
      } else if (kind == kFtl) {
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          if (q0 + i < P) sm[i] = sm[i] + row[q0 + i];
      } else {
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          if (q0 + i == c) {
            sm[i] = sm[i] + val;
            cn[i] = cn[i] + 1.f;
          }
      }
    }
  }
  probs(kind, lw, sm, cn, J > 0 ? gam[J - 1] : 0.f, P, lane, p);
  const size_t o = (size_t)b * P;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int q = q0 + i;
    if (q < P) {
      weights[o + q] = p[i];
      logw_out[o + q] = lw[i];
      sums_out[o + q] = sm[i];
      counts_out[o + q] = cn[i];
    }
  }
}

}  // namespace

// C: (S, J, P); etas, gammas: (K, J); u: (S, J); ev_kind, ev_j: (2J,);
// kinds: (K,) codes (exp3 0, ucb1 1, egreedy 2, ftl 3); outputs chosen,
// p_chosen, expected (S*K, J) and weights, logw, sums, counts (S*K, P).
// nj must be the least of kLaneCounts that holds P (lanes() in
// learner_replay.py): the layout fixes the order of every sum.
extern "C" int learner_replay_launch(
    const float* C, const float* etas, const float* gammas, const float* u,
    const int* ev_kind, const int* ev_j, const int* kinds, int* chosen,
    float* p_chosen, float* expected, float* weights, float* logw,
    float* sums, float* counts, int S, int K, int J, int P, int nj,
    float logw0, cudaStream_t stream) {
  if (S <= 0 || K <= 0) return 0;
  if (P < 1 || P > 1024 || J < 0 || nj != lanes_for(P) ||
      (long long)S * K > INT_MAX)
    return (int)cudaErrorInvalidValue;
#define LEARNER_NJ(N)                                                    \
  case N:                                                                \
    learner_kernel<N><<<S * K, kWarp, 0, stream>>>(                      \
        C, etas, gammas, u, ev_kind, ev_j, kinds, chosen, p_chosen,      \
        expected, weights, logw, sums, counts, K, J, P, logw0);          \
    break;
  switch (nj) {
    LEARNER_NJ(1) LEARNER_NJ(2) LEARNER_NJ(3) LEARNER_NJ(4) LEARNER_NJ(5)
    LEARNER_NJ(6) LEARNER_NJ(7) LEARNER_NJ(8) LEARNER_NJ(12) LEARNER_NJ(16)
    LEARNER_NJ(24) LEARNER_NJ(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LEARNER_NJ
  return (int)cudaGetLastError();
}
