// Bandit and follow-the-leader learner replay (exp3, ucb1, egreedy, ftl)
// over a precomputed cost tensor, for sm_90a.
//
// Counterpart of the reference's repro/learn/replay.py::_scan_one: one
// jax.lax.scan per learner kind over the merged (sample, update) event
// stream, vmapped over scenarios x instances; the reference has no Pallas
// kernel for these learners. Plain C interface, loaded with ctypes by
// repro_torch/kernels/learner_replay.py, which holds the plain PyTorch
// version and computes the schedule below; the two versions take the same
// operations in the same order and agree bit for bit (exp and log aside,
// see below).
//
// What bounds the replay is latency, not bytes or operations (0.0081 ms of
// operations at Table 6's r = 1200 launch). The serial chain is made of the
// J updates only: a sample changes no state, and the draw of job j feeds
// nothing before job j's update (the update warp's step, in the SASS, is
// what chip_smoke.py reads as the dependency floor). At Table 6 a job
// samples ~1350 updates before its own update (build_events: median 1352,
// largest 1475), so its draw can be taken from a copy of the state long
// before the update needs it, off the chain. One block per (scenario s,
// instance k), b = s * K + k, every kind in one launch (the kind is per
// instance, so uniform across a block), split by warp:
// * warp 0, the update warp, walks the J updates in stream order with the
//   state in registers (policy q = lane * NJ + i in slot i of lane q / NJ;
//   slots past P hold -inf log-weights and zero sums and counts) and
//   applies each (learners.py::update_state): exp3 lw[c] -= y then the
//   shift by the max (an in-lane fmaxf and redux.sync over the lanes on the
//   floats' order-preserving integer images: exact in any order); ucb1 and
//   egreedy one slot of sums and counts; ftl the whole cost row, loaded
//   kRowsAhead updates ahead into registers (a cp.async ring in shared
//   memory measured slower at Table 6's P 175; PERF.md).
//   Job j's draw (c, and y = eta * (val / p) for exp3 or val = C[j, c])
//   comes from its sample's record. The warp takes the updates in chunks
//   of 32, one per lane: a chunk's schedule entries load a chunk ahead and
//   its records half a chunk ahead, for the updates whose samples are done
//   by then (at Table 6, all of them), so an update reads its draw with a
//   shuffle. After every update that some sample reads (a "snapshot
//   point"), the warp copies the state into a ring of R snapshots in shared
//   memory and publishes it;
// * kSampleWarps sample warps take the samples in stream order, round
//   robin (sample i on warp i % kSampleWarps). Each reads its snapshot from
//   the ring, computes the kind's probabilities, the cdf (in-lane prefix +
//   the exclusive Hillis-Steele scan of the lane totals), normalizes it by
//   its value at policy P - 1, counts the policies with cdf / total <= u
//   (numpy's searchsorted side="right", clamped to P - 1), and writes the
//   draw, its probability, the expected cost (an in-lane serial sum and the
//   xor butterfly, as every sum here) and the record. The next sample's
//   cost row, u, eta and gamma are loaded while a sample runs.
// The state a sample reads is the one the serial walk has when it gets
// there, so the trace, the probabilities and the final state are the serial
// walk's, bit for bit.
//
// The schedule (learner_replay.py::schedule, computed on the device from
// ev_kind and ev_j) gives per sample its job and the snapshot it reads, per
// update its job and its job's sample index, per state whether a snapshot
// is taken there, and per snapshot the index of the last sample that reads
// it. Handoff, through shared-memory counters written with st.release and
// read with ld.acquire (cta scope):
// * progress[w]: the smallest sample index of warp w not yet done (its
//   records are written, its snapshot read); every sample below the least
//   of them is done;
// * published: the number of snapshots in the ring; snapshot m is readable
//   iff published > m, from slot m % R.
// Ordering: a warp's lane 0 releases a counter after a __syncwarp, which
// orders every lane's snapshot reads or stores (and lane 0's records)
// before it. A sample warp's lanes each ld.acquire `published` before
// reading the slot. In the update warp lane w acquires progress[w] alone,
// so a __syncwarp follows every such read, before any lane loads a record
// or overwrites a ring slot: the acquires of the other lanes then order
// those accesses too.
// Three waits, and why none can deadlock:
// 1. sample i waits for published > m(i), its snapshot;
// 2. update n, where its draw did not load ahead, waits for every sample
//    up to its job's, s_n, to be done;
// 3. before publishing snapshot t >= R into slot t % R, the update warp
//    waits for every sample up to last(t - R) to be done, the readers of
//    the slot's previous snapshot.
// Samples read snapshots in stream order, and a sample precedes its job's
// update, so every sample up to s_n reads a state the update warp has
// published by the time it waits in (2); the samples (3) waits for read
// snapshots t - R and older, all published. So every wait is on samples
// whose snapshots already exist, which finish without any further step of
// the waiter: the update warp always progresses, and with it the samples.
// With an update right after its own sample (lag 0) the pipeline
// degenerates to the serial walk and stays correct. A stream that is not a
// permutation of one sample and one later update per job could break this
// argument: the schedule's flag rejects it, and the kernel then traps, so
// that the launch fails at the next synchronization. A wait that spins for
// ~10 s traps too, so that a fault here ends the launch with an error
// instead of holding the card.
//
// exp and log are evaluated in double and rounded to float: the correctly
// rounded result, which the plain version's double exp and log give too
// (up to a double result within an ulp of a rounding midpoint). Built with
// -fmad=false: every product and sum rounds as in the plain version.

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
// Sample warps: of 7, 11 and 15, the count with the least time over
// Table 6's two launches (a sweep on the card; PERF.md). 16 warps of at
// most 128 registers fill the SM's register file.
constexpr int kSampleWarps = 15;
constexpr int kThreads = kWarp * (1 + kSampleWarps);
// Snapshot ring: as many slots of two (32 * NJ) float arrays as fit in
// kRingBytes (384 at P <= 32, 64 at Table 6's P 175, 12 at P 1024).
constexpr int kRingBytes = 96 * 1024;
constexpr int kHeaderInts = 16;    // progress[kSampleWarps], published
static_assert(kSampleWarps + 1 <= kHeaderInts, "header too small");

template <int NJ>
constexpr int kRingSlots = kRingBytes / (2 * kWarp * NJ * 4);
template <int NJ>
constexpr size_t kSmemBytes =
    4 * ((size_t)kHeaderInts + (size_t)kRingSlots<NJ> * 2 * kWarp * NJ);
// ftl's cost rows in flight in the update warp's registers.
template <int NJ>
constexpr int kRowsAhead = NJ <= 2 ? 8 : NJ <= 8 ? 4 : NJ <= 16 ? 2 : 1;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
               : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;"
               :: "r"(smem_addr(p)), "r"(v) : "memory");
}

// One round of a wait: a short sleep, and a trap after kSpinLimit rounds
// (at least ~10 s), so that a fault in the handoff ends the launch with an
// error instead of holding the card.
constexpr long long kSpinLimit = 1ll << 28;
__device__ __forceinline__ void backoff(long long& spins) {
  if (++spins > kSpinLimit) __trap();
  __nanosleep(32);
}

// a[k] of an int array for a warp-uniform, non-decreasing k: lane l holds
// a[base + l], the next 32 entries load (coalesced) 32 steps before use.
struct Ahead {
  const int* a;
  int n, base, cur, nxt;
  __device__ Ahead(const int* a_, int n_, int lane) : a(a_), n(n_), base(0) {
    cur = lane < n ? __ldg(a + lane) : 0;
    nxt = kWarp + lane < n ? __ldg(a + kWarp + lane) : 0;
  }
  __device__ __forceinline__ int at(int k, int lane) {
    while (k >= base + kWarp) {
      base += kWarp;
      cur = nxt;
      const int q = base + kWarp + lane;
      nxt = q < n ? __ldg(a + q) : 0;
    }
    return __shfl_sync(kFull, cur, k - base);
  }
};

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
// (learners.py::sample_probs), 0 past P. The state: exp3 log-weights lw,
// the others sums sm and (ucb1, egreedy) counts cn.
template <int NJ, int KIND>
__device__ __forceinline__ void probs(const float (&lw)[NJ],
                                      const float (&sm)[NJ],
                                      const float (&cn)[NJ], float g, int P,
                                      int lane, float (&p)[NJ]) {
  const int q0 = lane * NJ;
  if constexpr (KIND == kExp3) {
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
  } else {
    float lt = 0.f;
    if constexpr (KIND == kUcb1) {
      const float t = fmaxf(lane_sum(cn), 1.f);
      lt = (float)log((double)t);
    }
    float best = INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      if (q0 + i >= P) continue;
      float score = sm[i];
      if constexpr (KIND != kFtl) {
        const float cs = fmaxf(cn[i], 1.f);
        const float mean = sm[i] / cs;
        score = cn[i] < 0.5f ? -kNeg
                : KIND == kUcb1 ? mean - sqrtf(2.f * lt / cs) : mean;
      }
      if (score < best) {    // strict: the lane's lowest index on ties
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
             : KIND == kEgreedy ? (1.f - g) * one + g / (float)P : one;
    }
  }
}

struct Args {
  const float* C;          // (S, J, P)
  const float* etas;       // (K, J)
  const float* gammas;     // (K, J)
  const float* u;          // (S, J)
  // schedule (learner_replay.py::schedule)
  const int* smp_j;        // (J,) job of sample i
  const int* smp_snap;     // (J,) snapshot sample i reads
  const int* upd_j;        // (J,) job of update n
  const int* upd_s;        // (J,) sample index of that job
  const int* has_snap;     // (J + 1,) a snapshot is taken at state t
  const int* snap_last;    // (J,) last sample index reading snapshot m
  const int* kinds;        // (K,)
  int* chosen;             // (S*K, J), also read back by the update warp
  float* p_chosen;
  float* expected;
  float* record;           // (S*K, J): exp3 y, ucb1 and egreedy C[j, c]
  float* weights;          // (S*K, P)
  float* logw;
  float* sums;
  float* counts;
  int K, J, P;
  float logw0;
};

// Shared memory: the counters and the snapshot ring (slot m % R holds two
// arrays of 32 * NJ floats, element i of lane l at i * 32 + l: exp3 its
// log-weights, ucb1 and egreedy sums then counts, ftl sums).
template <int NJ>
struct Smem {
  int* progress;
  int* published;
  float* ring;
  __device__ explicit Smem(unsigned char* base)
      : progress((int*)base), published((int*)base + kSampleWarps),
        ring((float*)base + kHeaderInts) {}
};

template <int NJ, int KIND>
__device__ void sample_warp(const Args& a, const Smem<NJ>& sh, int b, int w,
                            int lane) {
  constexpr int R = kRingSlots<NJ>;
  const int J = a.J, P = a.P, s = b / a.K, k = b % a.K;
  const int q0 = lane * NJ;
  const float* Cs = a.C + (size_t)s * J * P;
  const float* eta = a.etas + (size_t)k * J;
  const float* gam = a.gammas + (size_t)k * J;
  const float* us = a.u + (size_t)s * J;
  int i = w;
  if (i >= J) return;
  // This sample's job, snapshot, cost row and scalars; the next one's job
  // and snapshot.
  int j = __ldg(a.smp_j + i), m = __ldg(a.smp_snap + i);
  float row[NJ];
#pragma unroll
  for (int t = 0; t < NJ; ++t)
    row[t] = q0 + t < P ? __ldg(Cs + (size_t)j * P + q0 + t) : 0.f;
  float uj = __ldg(us + j), gj = __ldg(gam + j), ej = __ldg(eta + j);
  int jn = 0, mn = 0, seen = 0;
  if (i + kSampleWarps < J) {
    jn = __ldg(a.smp_j + i + kSampleWarps);
    mn = __ldg(a.smp_snap + i + kSampleWarps);
  }
  for (;;) {
    // Loads of the next sample, used by the next iteration.
    const bool more = i + kSampleWarps < J;
    float nrow[NJ];
    float nu = 0.f, ng = 0.f, ne = 0.f;
    int jnn = 0, mnn = 0;
#pragma unroll
    for (int t = 0; t < NJ; ++t)
      nrow[t] = more && q0 + t < P ? __ldg(Cs + (size_t)jn * P + q0 + t)
                                   : 0.f;
    if (more) {
      nu = __ldg(us + jn);
      ng = __ldg(gam + jn);
      ne = __ldg(eta + jn);
      if (i + 2 * kSampleWarps < J) {
        jnn = __ldg(a.smp_j + i + 2 * kSampleWarps);
        mnn = __ldg(a.smp_snap + i + 2 * kSampleWarps);
      }
    }
    // The snapshot this sample reads (`seen`: snapshots known published).
    for (long long spins = 0; m >= seen;) {
      seen = ld_acquire(sh.published);
      if (m >= seen) backoff(spins);
    }
    const float* slot = sh.ring + (size_t)(m % R) * 2 * kWarp * NJ;
    float lw[NJ], sm[NJ], cn[NJ], p[NJ];
#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      if constexpr (KIND == kExp3) lw[t] = slot[t * kWarp + lane];
      else sm[t] = slot[t * kWarp + lane];
      if constexpr (KIND == kUcb1 || KIND == kEgreedy)
        cn[t] = slot[(NJ + t) * kWarp + lane];
    }
    probs<NJ, KIND>(lw, sm, cn, gj, P, lane, p);
    float cdf[NJ];
    cdf[0] = p[0];
#pragma unroll
    for (int t = 1; t < NJ; ++t) cdf[t] = cdf[t - 1] + p[t];
    float incl = cdf[NJ - 1];
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = incl + v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int t = 0; t < NJ; ++t) cdf[t] = excl + cdf[t];
    const float total = pick(cdf, P - 1);
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < NJ; ++t)
      cnt += q0 + t < P && cdf[t] / total <= uj ? 1 : 0;
    const int c = min((int)__reduce_add_sync(kFull, (unsigned)cnt), P - 1);
    const float pc = pick(p, c);
    float x[NJ];
#pragma unroll
    for (int t = 0; t < NJ; ++t) x[t] = p[t] * row[t];
    const float ec = lane_sum(x);
    const float val = pick(row, c);
    if (lane == 0) {
      const size_t o = (size_t)b * J + j;
      a.chosen[o] = c;
      a.p_chosen[o] = pc;
      a.expected[o] = ec;
      if constexpr (KIND == kExp3) a.record[o] = ej * (val / pc);
      else if constexpr (KIND != kFtl) a.record[o] = val;
    }
    // Every lane has read the snapshot; lane 0's records are written.
    __syncwarp();
    if (lane == 0) st_release(sh.progress + w, i + kSampleWarps);
    if (!more) break;
    i += kSampleWarps;
    j = jn;
    m = mn;
    jn = jnn;
    mn = mnn;
#pragma unroll
    for (int t = 0; t < NJ; ++t) row[t] = nrow[t];
    uj = nu;
    gj = ng;
    ej = ne;
  }
}

// The lane's NJ costs of job j's row, 0 past P.
template <int NJ>
__device__ __forceinline__ void load_row(const float* Cs, int j, int P,
                                         int lane, float (&r)[NJ]) {
#pragma unroll
  for (int t = 0; t < NJ; ++t) {
    const int q = lane * NJ + t;
    r[t] = q < P ? __ldg(Cs + (size_t)j * P + q) : 0.f;
  }
}

template <int NJ, int KIND>
__device__ void update_warp(const Args& a, const Smem<NJ>& sh, int b,
                            int lane) {
  constexpr int R = kRingSlots<NJ>;
  const int J = a.J, P = a.P, s = b / a.K, k = b % a.K;
  const int q0 = lane * NJ;
  const float* Cs = a.C + (size_t)s * J * P;
  const int* ch = a.chosen + (size_t)b * J;
  const float* rec = a.record + (size_t)b * J;
  float lw[NJ], sm[NJ], cn[NJ];
#pragma unroll
  for (int t = 0; t < NJ; ++t) {
    lw[t] = q0 + t < P ? a.logw0 : -INFINITY;
    sm[t] = 0.f;
    cn[t] = 0.f;
  }
  // Every sample below `done` is done: the least of the sample warps'
  // progress counters, read again only when a wait needs more. Lane w
  // acquires warp w's counter; the __syncwarp then orders every lane's
  // later loads of records and stores to the ring after those acquires.
  int done = 0;
  auto refresh = [&]() {
    done = __reduce_min_sync(
        kFull, lane < kSampleWarps ? ld_acquire(sh.progress + lane)
                                   : INT_MAX);
    __syncwarp();
  };
  auto wait_upto = [&](int i) {      // until every sample <= i is done
    for (long long spins = 0; i >= done;) {
      refresh();
      if (i >= done) backoff(spins);
    }
  };
  Ahead last(a.snap_last, J, lane);
  int t_pub = 0;           // snapshots published
  // Copy the state into slot t_pub % R once the readers of the slot's
  // previous snapshot are done, then publish it.
  auto publish = [&]() {
    if (t_pub >= R) wait_upto(last.at(t_pub - R, lane));
    float* slot = sh.ring + (size_t)(t_pub % R) * 2 * kWarp * NJ;
#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      slot[t * kWarp + lane] = KIND == kExp3 ? lw[t] : sm[t];
      if constexpr (KIND == kUcb1 || KIND == kEgreedy)
        slot[(NJ + t) * kWarp + lane] = cn[t];
    }
    __syncwarp();
    ++t_pub;
    if (lane == 0) st_release(sh.published, t_pub);
  };
  if (J > 0 && __ldg(a.has_snap)) publish();

  // The updates go in chunks of 32: lane l holds update base + l's job,
  // its sample, whether a snapshot follows it and its draw (c = -1 until
  // loaded), for this chunk (0) and the next (1). A chunk's entries load a
  // chunk ahead, its draws half a chunk ahead, for the updates whose
  // samples are done by then; an update whose draw was not loaded waits
  // for its sample and loads it.
  int j0, s0, f0, j1, s1, f1, c0 = -1, c1 = -1;
  float v0 = 0.f, v1 = 0.f;
  auto entries = [&](int base, int& j_, int& s_, int& f_) {
    const int n = base + lane;
    j_ = n < J ? __ldg(a.upd_j + n) : 0;
    s_ = n < J ? __ldg(a.upd_s + n) : -1;
    f_ = n < J ? __ldg(a.has_snap + 1 + n) : 0;
  };
  auto draws = [&](int j_, int s_, int& c_, float& v_) {
    if (__reduce_max_sync(kFull, s_) >= done) refresh();
    c_ = -1;
    if (s_ >= 0 && s_ < done) {
      c_ = ch[j_];
      v_ = rec[j_];
    }
  };
  entries(0, j0, s0, f0);
  entries(kWarp, j1, s1, f1);
  // ftl: the rows of the next kRowsAhead updates, row[0] the next one's.
  constexpr int D = kRowsAhead<NJ>;
  float row[D][NJ];
  if constexpr (KIND == kFtl) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < J) load_row(Cs, __shfl_sync(kFull, j0, d), P, lane, row[d]);
  } else {
    draws(j0, s0, c0, v0);
  }
  // The draw of the update at hand, read while the one before it runs.
  int c = __shfl_sync(kFull, c0, 0);
  float v = __shfl_sync(kFull, v0, 0);
  for (int base = 0; base < J; base += kWarp) {
    const int len = min(kWarp, J - base);
    for (int u = 0; u < len; ++u) {
      const int n = base + u;
      if constexpr (KIND == kFtl) {
#pragma unroll
        for (int t = 0; t < NJ; ++t)
          if (q0 + t < P) sm[t] = sm[t] + row[0][t];
#pragma unroll
        for (int d = 0; d + 1 < D; ++d)
#pragma unroll
          for (int t = 0; t < NJ; ++t) row[d][t] = row[d + 1][t];
        const int q = u + D;     // update n + D (chunk 1 past 31)
        if (n + D < J)
          load_row(Cs, __shfl_sync(kFull, q < kWarp ? j0 : j1, q % kWarp), P,
                   lane, row[D - 1]);
      } else {
        if (u == kWarp / 2) draws(j1, s1, c1, v1);
        if (c < 0) {
          const int j = __shfl_sync(kFull, j0, u);
          wait_upto(__shfl_sync(kFull, s0, u));
          c = ch[j];
          v = rec[j];
        }
        const int cu = c;
        const float vu = v;
        const int un = u + 1;    // the next update's draw (chunk 1 past 31)
        c = __shfl_sync(kFull, un < kWarp ? c0 : c1, un % kWarp);
        v = __shfl_sync(kFull, un < kWarp ? v0 : v1, un % kWarp);
        if constexpr (KIND == kExp3) {
          float mx = -INFINITY;
#pragma unroll
          for (int t = 0; t < NJ; ++t) {
            if (q0 + t == cu) lw[t] = lw[t] - vu;
            mx = fmaxf(mx, lw[t]);
          }
          mx = warp_max(mx);
#pragma unroll
          for (int t = 0; t < NJ; ++t) lw[t] = lw[t] - mx;
        } else {
#pragma unroll
          for (int t = 0; t < NJ; ++t)
            if (q0 + t == cu) {
              sm[t] = sm[t] + vu;
              cn[t] = cn[t] + 1.f;
            }
        }
      }
      if (__shfl_sync(kFull, f0, u)) publish();
    }
    j0 = j1;
    s0 = s1;
    f0 = f1;
    c0 = c1;
    v0 = v1;
    c1 = -1;
    entries(base + 2 * kWarp, j1, s1, f1);
  }
  float p[NJ];
  probs<NJ, KIND>(lw, sm, cn, J > 0 ? __ldg(a.gammas + (size_t)k * J + J - 1)
                                    : 0.f, P, lane, p);
  const size_t o = (size_t)b * P;
#pragma unroll
  for (int t = 0; t < NJ; ++t) {
    const int q = q0 + t;
    if (q < P) {
      a.weights[o + q] = p[t];
      a.logw[o + q] = KIND == kExp3 ? lw[t] : a.logw0;
      a.sums[o + q] = KIND == kExp3 ? 0.f : sm[t];
      a.counts[o + q] = KIND == kUcb1 || KIND == kEgreedy ? cn[t] : 0.f;
    }
  }
}

template <int NJ, int KIND>
__device__ __forceinline__ void run(const Args& a, const Smem<NJ>& sh, int b,
                                    int warp, int lane) {
  if (warp == 0)
    update_warp<NJ, KIND>(a, sh, b, lane);
  else
    sample_warp<NJ, KIND>(a, sh, b, warp - 1, lane);
}

// grid S * K blocks of kThreads; block b runs instance b = s * K + k.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
learner_block_kernel(Args a, const int* __restrict__ sched_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<NJ> sh(smem);
  const int b = blockIdx.x;
  if (!__ldg(sched_ok)) __trap();    // not a valid stream
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (threadIdx.x < kSampleWarps) sh.progress[threadIdx.x] = threadIdx.x;
  if (threadIdx.x == 0) *sh.published = 0;
  __syncthreads();
  switch (__ldg(a.kinds + b % a.K)) {
    case kExp3: run<NJ, kExp3>(a, sh, b, warp, lane); break;
    case kUcb1: run<NJ, kUcb1>(a, sh, b, warp, lane); break;
    case kEgreedy: run<NJ, kEgreedy>(a, sh, b, warp, lane); break;
    default: run<NJ, kFtl>(a, sh, b, warp, lane); break;
  }
}

template <int NJ>
int launch(const Args& a, const int* ok, int blocks, cudaStream_t stream) {
  const size_t smem = kSmemBytes<NJ>;
  cudaError_t e = cudaFuncSetAttribute(
      learner_block_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  learner_block_kernel<NJ><<<blocks, kThreads, smem, stream>>>(a, ok);
  return (int)cudaGetLastError();
}

}  // namespace

// C: (S, J, P); etas, gammas: (K, J); u: (S, J); sched: the schedule's
// int32 arrays back to back (smp_j, smp_snap, upd_j, upd_s: J each;
// has_snap: J + 1; snap_last: J; ok: 1), as learner_replay.py::schedule
// lays them out; kinds: (K,) codes (exp3 0, ucb1 1, egreedy 2, ftl 3);
// outputs chosen, p_chosen, expected (S*K, J), weights, logw, sums, counts
// (S*K, P); record: (S*K, J) scratch. nj must be the least of kLaneCounts
// that holds P (lanes() in learner_replay.py): the layout fixes the order
// of every sum.
extern "C" int learner_replay_launch(
    const float* C, const float* etas, const float* gammas, const float* u,
    const int* sched, const int* kinds, int* chosen, float* p_chosen,
    float* expected, float* record, float* weights, float* logw, float* sums,
    float* counts, int S, int K, int J, int P, int nj, float logw0,
    cudaStream_t stream) {
  if (S <= 0 || K <= 0) return 0;
  if (P < 1 || P > 1024 || J < 0 || nj != lanes_for(P) ||
      (long long)S * K > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a{C, etas, gammas, u, sched, sched + J, sched + 2 * J,
               sched + 3 * J, sched + 4 * J, sched + 5 * J + 1, kinds,
               chosen, p_chosen, expected, record, weights, logw, sums,
               counts, K, J, P, logw0};
  const int* ok = sched + 6 * J + 1;
#define LEARNER_NJ(N) \
  case N: return launch<N>(a, ok, S * K, stream);
  switch (nj) {
    LEARNER_NJ(1) LEARNER_NJ(2) LEARNER_NJ(3) LEARNER_NJ(4) LEARNER_NJ(5)
    LEARNER_NJ(6) LEARNER_NJ(7) LEARNER_NJ(8) LEARNER_NJ(12) LEARNER_NJ(16)
    LEARNER_NJ(24) LEARNER_NJ(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LEARNER_NJ
}
