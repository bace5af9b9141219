// Flash attention backward (FlashAttention-2's), for sm_90a.
//
// No TPU kernel of the reference computes it: the reference's backward is
// the custom_vjp bwd of repro/models/layers.py::flash_attention_train
// (_flash_train_bwd), a blockwise jnp function XLA compiles. This file is
// its hand-written counterpart; kernels/flash_attention.py::flash_backward
// is the plain version (the same blockwise math in torch ops) that CPU and
// meta tensors take. Plain C interface, loaded with ctypes.
//
// Inputs read through their element strides (head dim contiguous): q, out
// and dout (B, Sq, H, dh), k and v (B, Sk, K, dh), lse (B, H, Sq) float32
// from the forward. Outputs dq, dk, dv in the inputs' dtype. Query head h
// reads kv head h / (H / K) (GQA); the H / K heads of a group are summed
// into dk and dv inside one block. Masks as the forward's (bad = key past
// Sk | k > q when causal | (q - k) >= window unless k < prefix): a masked
// score is the finite -1e30, so p = exp(s - lse) is exactly 0 there.
//
// Three launches, no atomics (bit-deterministic from run to run):
//   1. flash_bwd_delta: delta = rowsum(dout * out), float32 (B, H, Sq).
//   2. dk and dv: one block per (batch, kv head, 64-key tile); it walks the
//      group's query heads and every query tile that can reach the key tile
//      (the causal and window skips of whole tiles), recomputes
//      S = Q K^T scale and P = exp(S - lse), and accumulates dV += P^T dO and
//      dK += dS^T Q in float32, dS = P (dO V^T - delta) scale. It writes dk
//      and dv once.
//   3. dq: one block per (batch, query head, 64-query tile) recomputes S, P
//      and dP over the key tiles the tile reaches and accumulates dQ = dS K.
//
// Two routes (kernels/flash_attention.py::backward_tensor_core_route):
// bfloat16 with dh 64, 96 or 128 and 16-byte aligned pointers and strides
// takes the tensor-core kernels (mma.sync m16n8k16, bf16 operands from
// shared memory by ldmatrix, float32 accumulators; P and dS rounded to bf16
// as the second products' A operands, as FlashAttention-2 does); every
// other call takes the CUDA-core kernels (float32 math, any dh up to 128).
//
// Bound: operations, 10 dh multiply-add pairs per visible (query, key) pair
// and query head (flash_backward_work; 0.695 ms at tinyllama's training
// shape at 989 TFLOP/s). What the design does about it: every product on
// the tensor cores in the bf16 route, the operands staged once per tile in
// shared memory (cp.async, double-buffered), S and dP kept in registers and
// turned into the next products' A operands without a trip through memory.
// Left for later: wgmma and TMA, a producer warp, and dq folded into the
// dk/dv pass (it would need atomics or a reduction over key tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Element strides (batch, seq, head) of the eight tensors.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, db, ds, dh_;
  long long dqb, dqs, dqh, dkb, dks, dkh, dvb, dvs, dvh;
};

struct Mask {
  int Sq, Sk, causal, window, prefix;
  __device__ __forceinline__ bool bad(int qp, int kp) const {
    bool b = kp >= Sk || qp >= Sq;
    if (causal) b |= kp > qp;
    if (window > 0) b |= (qp - kp) >= window && kp >= prefix;
    return b;
  }
  // Whether no pair of query rows [q_lo, q_lo + bq) and keys
  // [k_lo, k_lo + bk) is visible.
  __device__ __forceinline__ bool skip(int q_lo, int bq, int k_lo,
                                       int bk) const {
    if (causal && k_lo > q_lo + bq - 1) return true;
    return window > 0 && q_lo - (k_lo + bk - 1) >= window && k_lo >= prefix;
  }
};

// ---- 1. delta ---------------------------------------------------------------

// One warp per (b * H + h, row); lanes stride the head dim, summed in a fixed
// order by shuffles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int H, int Sq, int dh, Strides st) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= Sq) return;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const T* ob = o + b * st.ob + (long long)row * st.os + h * st.oh;
  const T* db = dout + b * st.db + (long long)row * st.ds + h * st.dh_;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc += load_f32(ob + d) * load_f32(db + d);
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o2);
  if (lane == 0) delta[(long long)blockIdx.y * Sq + row] = acc;
}

// ---- CUDA-core kernels ------------------------------------------------------
//
// Tiles of 32 keys and 32 queries in float32 shared memory, rows DP + 1
// apart. Thread t owns row t / 4 of its tile and the columns t % 4 + 4 j of
// the head dim (DP / 4 of them), and, of the 32 x 32 score tile, its row's
// columns 8 (t % 4) .. 8 (t % 4) + 7.

constexpr int kBT = 32;

template <typename T, int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src,
                                              long long ld, int rv, int dh) {
  for (int i = threadIdx.x; i < kBT * DP; i += kThreads) {
    const int r = i / DP, d = i - r * DP;
    dst[r * (DP + 1) + d] =
        (r < rv && d < dh) ? load_f32(src + (long long)r * ld + d) : 0.f;
  }
}

// One block per (b * K + kv head, 32-key tile).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int K, int dh, Strides st,
                     Mask mk, float scale) {
  constexpr int LD = DP + 1, NC = DP / 4;
  extern __shared__ float sm[];
  float* ks = sm;                  // [32][LD] keys
  float* vs = ks + kBT * LD;       // values
  float* qs = vs + kBT * LD;       // queries
  float* dos = qs + kBT * LD;      // dout
  float* ps = dos + kBT * LD;      // [32 keys][33] P^T
  float* gs = ps + kBT * (kBT + 1);  // dS^T
  float* rs = gs + kBT * (kBT + 1);  // lse[32], delta[32]
  const int tid = threadIdx.x, kr = tid >> 2, part = tid & 3;
  const int b = blockIdx.y / K, kvh = blockIdx.y - b * K, grp = H / K;
  const int k_lo = blockIdx.x * kBT;
  const int kv_rows = min(kBT, mk.Sk - k_lo);
  load_rows_f32<T, DP>(ks, k + b * st.kb + (long long)k_lo * st.ks + kvh * st.kh,
                       st.ks, kv_rows, dh);
  load_rows_f32<T, DP>(vs, v + b * st.vb + (long long)k_lo * st.vs + kvh * st.vh,
                       st.vs, kv_rows, dh);
  float adk[NC], adv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) adk[j] = adv[j] = 0.f;
  const int n_qt = (mk.Sq + kBT - 1) / kBT;
  for (int r = 0; r < grp; ++r) {
    const int h = kvh * grp + r;
    const float* lse_h = lse + ((long long)b * H + h) * mk.Sq;
    const float* dl_h = delta + ((long long)b * H + h) * mk.Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_lo = qt * kBT;
      if (mk.skip(q_lo, kBT, k_lo, kBT)) continue;
      __syncthreads();             // the previous tile's readers are done
      const int q_rows = min(kBT, mk.Sq - q_lo);
      load_rows_f32<T, DP>(qs, q + b * st.qb + (long long)q_lo * st.qs + h * st.qh,
                           st.qs, q_rows, dh);
      load_rows_f32<T, DP>(dos, dout + b * st.db + (long long)q_lo * st.ds +
                                    h * st.dh_, st.ds, q_rows, dh);
      if (tid < kBT) {
        rs[tid] = tid < q_rows ? lse_h[q_lo + tid] : 0.f;
        rs[kBT + tid] = tid < q_rows ? dl_h[q_lo + tid] : 0.f;
      }
      __syncthreads();
      float s[8], dp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
      for (int d = 0; d < DP; ++d) {
        const float kd = ks[kr * LD + d], vd = vs[kr * LD + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] += kd * qs[(part * 8 + j) * LD + d];
          dp[j] += vd * dos[(part * 8 + j) * LD + d];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = part * 8 + j;
        const float x = mk.bad(q_lo + qi, k_lo + kr) ? kNegInf : s[j] * scale;
        const float p = expf(x - rs[qi]);
        ps[kr * (kBT + 1) + qi] = p;
        gs[kr * (kBT + 1) + qi] = p * (dp[j] - rs[kBT + qi]) * scale;
      }
      __syncthreads();
      for (int qq = 0; qq < kBT; ++qq) {
        const float p = ps[kr * (kBT + 1) + qq], g = gs[kr * (kBT + 1) + qq];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          adv[j] += p * dos[qq * LD + part + 4 * j];
          adk[j] += g * qs[qq * LD + part + 4 * j];
        }
      }
    }
  }
  if (kr >= kv_rows) return;
  T* dkb = dk + b * st.dkb + (long long)(k_lo + kr) * st.dks + kvh * st.dkh;
  T* dvb = dv + b * st.dvb + (long long)(k_lo + kr) * st.dvs + kvh * st.dvh;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int d = part + 4 * j;
    if (d < dh) {
      store_from_f32(dkb + d, adk[j]);
      store_from_f32(dvb + d, adv[j]);
    }
  }
}

// One block per (b * H + h, 32-query tile).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int K, int dh, Strides st, Mask mk, float scale) {
  constexpr int LD = DP + 1, NC = DP / 4;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kBT * LD;
  float* ks = dos + kBT * LD;
  float* vs = ks + kBT * LD;
  float* gs = vs + kBT * LD;       // [32 queries][33] dS
  const int tid = threadIdx.x, qr = tid >> 2, part = tid & 3;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, kvh = h / (H / K);
  const int q_lo = blockIdx.x * kBT;
  const int q_rows = min(kBT, mk.Sq - q_lo);
  load_rows_f32<T, DP>(qs, q + b * st.qb + (long long)q_lo * st.qs + h * st.qh,
                       st.qs, q_rows, dh);
  load_rows_f32<T, DP>(dos, dout + b * st.db + (long long)q_lo * st.ds +
                                h * st.dh_, st.ds, q_rows, dh);
  const long long row = ((long long)b * H + h) * mk.Sq + q_lo + qr;
  const float lse_r = qr < q_rows ? lse[row] : 0.f;
  const float dl_r = qr < q_rows ? delta[row] : 0.f;
  float adq[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) adq[j] = 0.f;
  const int n_kt = (mk.Sk + kBT - 1) / kBT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * kBT;
    if (mk.skip(q_lo, kBT, k_lo, kBT)) continue;
    __syncthreads();
    const int kv_rows = min(kBT, mk.Sk - k_lo);
    load_rows_f32<T, DP>(ks, k + b * st.kb + (long long)k_lo * st.ks + kvh * st.kh,
                         st.ks, kv_rows, dh);
    load_rows_f32<T, DP>(vs, v + b * st.vb + (long long)k_lo * st.vs + kvh * st.vh,
                         st.vs, kv_rows, dh);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < DP; ++d) {
      const float qd = qs[qr * LD + d], od = dos[qr * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] += qd * ks[(part * 8 + j) * LD + d];
        dp[j] += od * vs[(part * 8 + j) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ki = part * 8 + j;
      const float x = mk.bad(q_lo + qr, k_lo + ki) ? kNegInf : s[j] * scale;
      const float p = expf(x - lse_r);
      gs[qr * (kBT + 1) + ki] = p * (dp[j] - dl_r) * scale;
    }
    __syncthreads();
    for (int kk = 0; kk < kBT; ++kk) {
      const float g = gs[qr * (kBT + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) adq[j] += g * ks[kk * LD + part + 4 * j];
    }
  }
  if (qr >= q_rows) return;
  T* dqb = dq + b * st.dqb + (long long)(q_lo + qr) * st.dqs + h * st.dqh;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int d = part + 4 * j;
    if (d < dh) store_from_f32(dqb + d, adq[j]);
  }
}

// ---- tensor-core kernels ----------------------------------------------------
//
// bf16 tiles in shared memory, row-major with rows DH + 8 elements apart
// (16-byte aligned rows, conflict-free ldmatrix). Warp w owns rows
// 16 w .. 16 w + 15 of its block's 64-row tile (keys in the dk/dv kernel,
// queries in the dq kernel). mma.sync m16n8k16 fragments, g = lane / 4,
// t = lane % 4: A holds rows g, g + 8 at columns 2t, 2t + 1 (+8); B holds
// column g at rows 2t, 2t + 1 (+8); the f32 accumulator rows g, g + 8 at
// columns 2t, 2t + 1, which is also the A layout of the next product.

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (rows m0 .. m0 + 15, columns k0 .. k0 + 15) of a row-major
// tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// The B fragments of two n8 tiles (n0 .. n0 + 15) at depth k0 .. k0 + 15 of
// a tile stored n-major (row n holds the depth): (r0, r1) tile n0, (r2, r3)
// tile n0 + 8.
__device__ __forceinline__ void frag_b_nmajor(uint32_t (&r)[4], const bf16* t,
                                              int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}
// The same from a tile stored k-major (row k holds the n columns).
__device__ __forceinline__ void frag_b_kmajor(uint32_t (&r)[4], const bf16* t,
                                              int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, t + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// The accumulators of two n8 tiles as the A fragment of depth 16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows x DH bf16 into a [rows][DH + 8] tile by 16-byte cp.async; rows past
// rv zero-filled.
template <int ROWS, int DH>
__device__ __forceinline__ void load_tile_tc(bf16* dst, const bf16* src,
                                             long long ld, int rv) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    bf16* d = dst + r * (DH + 8) + c;
    if (r < rv)
      cp_async16(d, src + (long long)r * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int DH>
__host__ __device__ constexpr int dkv_bq() { return DH <= 64 ? 64 : 32; }

template <int DH>
__host__ __device__ constexpr int dkv_smem() {
  return (2 * 64 + 4 * dkv_bq<DH>()) * (DH + 8) * 2 + 4 * dkv_bq<DH>() * 4;
}
template <int DH>
__host__ __device__ constexpr int dq_smem() {
  return 6 * 64 * (DH + 8) * 2;
}

// One block per (b * K + kv head, 64-key tile). Query tiles of BQ rows
// (64 at dh 64, 32 above: the dk and dv accumulators take 2 dh / 4 registers
// a thread) stream through a double-buffered ring with their lse and delta.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int K,
                 Strides st, Mask mk, float scale) {
  constexpr int BQ = dkv_bq<DH>(), LDS = DH + 8;
  constexpr int NQ = BQ / 8, ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + 64 * LDS;
  bf16* qs = vs + 64 * LDS;                    // [2][BQ][LDS]
  bf16* dos = qs + 2 * BQ * LDS;               // [2][BQ][LDS]
  float* rows = reinterpret_cast<float*>(dos + 2 * BQ * LDS);  // [2][2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / K, kvh = blockIdx.y - b * K, grp = H / K;
  const int k_lo = blockIdx.x * 64;

  // The query tiles that reach this key tile: [qa, qb].
  const int n_qt = (mk.Sq + BQ - 1) / BQ;
  int qa = mk.causal ? k_lo / BQ : 0, qb = n_qt - 1;
  if (mk.window > 0 && k_lo >= mk.prefix)
    qb = min(qb, (k_lo + 63 + mk.window - 1) / BQ);
  const int per = qb - qa + 1;
  const int n_it = per > 0 ? grp * per : 0;

  load_tile_tc<64, DH>(ks, k + b * st.kb + (long long)k_lo * st.ks + kvh * st.kh,
                       st.ks, mk.Sk - k_lo);
  load_tile_tc<64, DH>(vs, v + b * st.vb + (long long)k_lo * st.vs + kvh * st.vh,
                       st.vs, mk.Sk - k_lo);
  auto load = [&](int it, int buf) {
    const int h = kvh * grp + it / per, q_lo = (qa + it % per) * BQ;
    const int rv = mk.Sq - q_lo;
    load_tile_tc<BQ, DH>(qs + buf * BQ * LDS,
                         q + b * st.qb + (long long)q_lo * st.qs + h * st.qh,
                         st.qs, rv);
    load_tile_tc<BQ, DH>(dos + buf * BQ * LDS,
                         dout + b * st.db + (long long)q_lo * st.ds + h * st.dh_,
                         st.ds, rv);
    const long long r0 = ((long long)b * H + h) * mk.Sq + q_lo;
    float* rs = rows + buf * 2 * BQ;
    for (int i = tid; i < BQ; i += kThreads) {
      rs[i] = i < rv ? lse[r0 + i] : 0.f;
      rs[BQ + i] = i < rv ? delta[r0 + i] : 0.f;
    }
  };
  if (n_it > 0) load(0, 0);
  cp_async_commit();

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  const int key0 = k_lo + warp * 16 + g;       // this thread's keys: +0, +8

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();                           // tile it is in; it - 1 is done
    if (it + 1 < n_it) load(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int buf = it & 1;
    const bf16* qt = qs + buf * BQ * LDS;
    const bf16* dt = dos + buf * BQ * LDS;
    const float* rs = rows + buf * 2 * BQ;
    const int q_lo = (qa + it % per) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp.
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, ks, LDS, warp * 16, kk * 16);
      frag_a(av, vs, LDS, warp * 16, kk * 16);
#pragma unroll
      for (int jq = 0; jq < NQ / 2; ++jq) {
        uint32_t bq[4], bd[4];
        frag_b_nmajor(bq, qt, LDS, jq * 16, kk * 16);
        frag_b_nmajor(bd, dt, LDS, jq * 16, kk * 16);
        mma_bf16(s[2 * jq], ak, bq[0], bq[1]);
        mma_bf16(s[2 * jq + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * jq], av, bd[0], bd[1]);
        mma_bf16(dp[2 * jq + 1], av, bd[2], bd[3]);
      }
    }
    // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale.
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const int kp = key0 + 8 * (e >> 1);
        const float x = mk.bad(q_lo + qi, kp) ? kNegInf : s[j][e] * scale;
        const float p = expf(x - rs[qi]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - rs[BQ + qi]) * scale;
      }
    // dV += P^T dO and dK += dS^T Q, the queries as the depth.
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t ap[4], ad[4];
      acc_to_a(ap, s[2 * kq], s[2 * kq + 1]);
      acc_to_a(ad, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int jd = 0; jd < ND / 2; ++jd) {
        uint32_t bo[4], bq[4];
        frag_b_kmajor(bo, dt, LDS, jd * 16, kq * 16);
        frag_b_kmajor(bq, qt, LDS, jd * 16, kq * 16);
        mma_bf16(adv[2 * jd], ap, bo[0], bo[1]);
        mma_bf16(adv[2 * jd + 1], ap, bo[2], bo[3]);
        mma_bf16(adk[2 * jd], ad, bq[0], bq[1]);
        mma_bf16(adk[2 * jd + 1], ad, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + 8 * r;
    if (row >= mk.Sk) continue;
    bf16* dkr = dk + b * st.dkb + (long long)row * st.dks + kvh * st.dkh;
    bf16* dvr = dv + b * st.dvb + (long long)row * st.dvs + kvh * st.dvh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkr + d) =
          __floats2bfloat162_rn(adk[j][2 * r], adk[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + d) =
          __floats2bfloat162_rn(adv[j][2 * r], adv[j][2 * r + 1]);
    }
  }
}

// One block per (b * H + h, 64-query tile), the tiles with the most causal
// key tiles first. K and V tiles of 64 keys stream through a double-buffered
// ring; Q and dO stay.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int H, int K, Strides st, Mask mk,
                float scale) {
  constexpr int LDS = DH + 8, ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + 64 * LDS;
  bf16* ks = dos + 64 * LDS;                   // [2][64][LDS]
  bf16* vs = ks + 2 * 64 * LDS;                // [2][64][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, kvh = h / (H / K);
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * 64;

  // The key tiles this block reads: [0, n_pre) and [hi, n_tiles), as the
  // forward's.
  int n_tiles = (mk.Sk + 63) / 64;
  if (mk.causal) n_tiles = min(n_tiles, (q_lo + 63) / 64 + 1);
  int n_pre = 0, hi = 0;
  if (mk.window > 0) {
    n_pre = min((mk.prefix + 63) / 64, n_tiles);
    int first = 0;
    while (first < n_tiles && first * 64 + 63 < q_lo - mk.window + 1) ++first;
    hi = max(n_pre, first);
  }
  const int n_iter = n_pre + n_tiles - hi;
  auto k_lo_of = [&](int i) { return (i < n_pre ? i : hi + i - n_pre) * 64; };

  load_tile_tc<64, DH>(qs, q + b * st.qb + (long long)q_lo * st.qs + h * st.qh,
                       st.qs, mk.Sq - q_lo);
  load_tile_tc<64, DH>(dos, dout + b * st.db + (long long)q_lo * st.ds + h * st.dh_,
                       st.ds, mk.Sq - q_lo);
  auto load = [&](int i, int buf) {
    const int k_lo = k_lo_of(i);
    load_tile_tc<64, DH>(ks + buf * 64 * LDS,
                         k + b * st.kb + (long long)k_lo * st.ks + kvh * st.kh,
                         st.ks, mk.Sk - k_lo);
    load_tile_tc<64, DH>(vs + buf * 64 * LDS,
                         v + b * st.vb + (long long)k_lo * st.vs + kvh * st.vh,
                         st.vs, mk.Sk - k_lo);
  };
  if (n_iter > 0) load(0, 0);
  cp_async_commit();

  const int row0 = q_lo + warp * 16 + g;       // this thread's rows: +0, +8
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = ((long long)b * H + h) * mk.Sq + row;
    lse_r[r] = row < mk.Sq ? lse[at] : 0.f;
    dl_r[r] = row < mk.Sq ? delta[at] : 0.f;
  }
  float adq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;

  for (int i = 0; i < n_iter; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_iter) load(i + 1, (i + 1) & 1);
    cp_async_commit();
    const bf16* kt = ks + (i & 1) * 64 * LDS;
    const bf16* vt = vs + (i & 1) * 64 * LDS;
    const int k_lo = k_lo_of(i);

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a(aq, qs, LDS, warp * 16, kk * 16);
      frag_a(ao, dos, LDS, warp * 16, kk * 16);
#pragma unroll
      for (int jk = 0; jk < 4; ++jk) {
        uint32_t bk[4], bv[4];
        frag_b_nmajor(bk, kt, LDS, jk * 16, kk * 16);
        frag_b_nmajor(bv, vt, LDS, jk * 16, kk * 16);
        mma_bf16(s[2 * jk], aq, bk[0], bk[1]);
        mma_bf16(s[2 * jk + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * jk], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * jk + 1], ao, bv[2], bv[3]);
      }
    }
    // dS = exp(S scale - lse) (dP - delta) scale, into s.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = k_lo + 8 * j + 2 * t + (e & 1);
        const float x = mk.bad(row0 + 8 * r, kp) ? kNegInf : s[j][e] * scale;
        const float p = expf(x - lse_r[r]);
        s[j][e] = p * (dp[j][e] - dl_r[r]) * scale;
      }
    // dQ += dS K, the keys as the depth.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < ND / 2; ++jd) {
        uint32_t bk[4];
        frag_b_kmajor(bk, kt, LDS, jd * 16, kk * 16);
        mma_bf16(adq[2 * jd], a, bk[0], bk[1]);
        mma_bf16(adq[2 * jd + 1], a, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= mk.Sq) continue;
    bf16* dqr = dq + b * st.dqb + (long long)row * st.dqs + h * st.dqh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * j + 2 * t) =
          __floats2bfloat162_rn(adq[j][2 * r], adq[j][2 * r + 1]);
  }
}

// ---- launch -----------------------------------------------------------------

template <typename Kern>
int set_smem(Kern kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int H,
                 int Sq, int dh, const Strides& st, cudaStream_t stream) {
  const dim3 grid((Sq + kThreads / 32 - 1) / (kThreads / 32), B * H);
  flash_bwd_delta<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, Sq, dh,
      st);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_core(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk,
                void* dv, int B, int H, int K, int dh, const Strides& st,
                const Mask& mk, float scale, cudaStream_t stream) {
  const int ld = DP + 1;
  const int smem_kv = (4 * kBT * ld + 2 * kBT * (kBT + 1) + 2 * kBT) * 4;
  const int smem_q = (4 * kBT * ld + kBT * (kBT + 1)) * 4;
  int err = set_smem(flash_bwd_dkv_kernel<T, DP>, smem_kv);
  if (err) return err;
  flash_bwd_dkv_kernel<T, DP><<<dim3((mk.Sk + kBT - 1) / kBT, B * K), kThreads,
                                smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, K, dh, st, mk, scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(flash_bwd_dq_kernel<T, DP>, smem_q))) return err;
  flash_bwd_dq_kernel<T, DP><<<dim3((mk.Sq + kBT - 1) / kBT, B * H), kThreads,
                               smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, K, dh, st, mk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_core_dh(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int H, int K, int dh,
                   const Strides& st, const Mask& mk, float scale,
                   cudaStream_t s) {
  if (dh <= 32)
    return launch_core<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K,
                              dh, st, mk, scale, s);
  if (dh <= 64)
    return launch_core<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K,
                              dh, st, mk, scale, s);
  return launch_core<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K,
                             dh, st, mk, scale, s);
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int H, int K, const Strides& st, const Mask& mk,
              float scale, cudaStream_t stream) {
  const int smem_kv = dkv_smem<DH>(), smem_q = dq_smem<DH>();
  int err = set_smem(flash_bwd_dkv_tc<DH>, smem_kv);
  if (err) return err;
  flash_bwd_dkv_tc<DH><<<dim3((mk.Sk + 63) / 64, B * K), kThreads, smem_kv,
                         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, K, st, mk, scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(flash_bwd_dq_tc<DH>, smem_q))) return err;
  flash_bwd_dq_tc<DH><<<dim3((mk.Sq + 63) / 64, B * H), kThreads, smem_q,
                        stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), H, K, st, mk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, out, dout, dq, dk, dv alike); tc: 1
// for the tensor-core kernels (bfloat16, dh 64, 96 or 128, 16-byte aligned
// pointers of q, k, v and dout and their batch, seq and head strides but
// those of dims of size 1), 0 for the CUDA-core ones. lse: float32 (B, H, Sq) contiguous; delta: float32
// (B, H, Sq) contiguous scratch. strides: 24 element strides, (batch, seq,
// head) of q, k, v, out, dout, dq, dk, dv in that order. Returns the CUDA
// error of a launch (0 on success) or cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int tc, int B, int H, int K, int Sq, int Sk, int dh,
    const long long* strides, int causal, int window, int prefix, float scale,
    void* stream) {
  if (dh < 1 || dh > 128 || K < 1 || H % K != 0 || Sq < 1 || Sk < 1 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides st{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15],
                   s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23]};
  const Mask mk{Sq, Sk, causal, window, prefix};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    if (tc) return (int)cudaErrorInvalidValue;
    if ((err = launch_delta<float>(o, dout, delta, B, H, Sq, dh, st, cs)))
      return err;
    return launch_core_dh<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                                 K, dh, st, mk, scale, cs);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if ((err = launch_delta<bf16>(o, dout, delta, B, H, Sq, dh, st, cs)))
    return err;
  if (!tc)
    return launch_core_dh<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                                K, dh, st, mk, scale, cs);
  if (dh == 64)
    return launch_tc<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K, st,
                         mk, scale, cs);
  if (dh == 96)
    return launch_tc<96>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K, st,
                         mk, scale, cs);
  if (dh == 128)
    return launch_tc<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K, st,
                          mk, scale, cs);
  return (int)cudaErrorInvalidValue;
}
