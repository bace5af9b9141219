// Mamba-2 SSD chunked scan (state-space duality), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (_kernel).
// Plain C interface, loaded with ctypes by repro_torch/kernels/ssd_scan.py,
// which also holds the plain PyTorch version.
//
// The TPU kernel carried the (N, P) inter-chunk state in VMEM scratch across
// a sequential chunk grid dimension. A GPU grid has no order, so here one
// block owns one (batch b, head h) and loops over the chunks itself, with the
// state in shared memory (128 x 64 f32 = 32 KB at the mamba2 widths). Per
// chunk of Q = min(chunk, S) steps, with cum = cumsum(A * dt) and
// xdt = x * dt (rows past S are the TPU kernel's dt = 0 padding):
//   Y     = (C B^T  .*  L) xdt  +  exp(cum) .* (C state),
//           L[l, s] = exp(cum[l] - cum[s]) for l >= s, else 0;
//   state = exp(cum[Q-1]) state  +  (B .* exp(cum[Q-1] - cum))^T xdt.
// Head h reads group h / (H / G) of B and C. The products run on 64 x 64
// tiles staged in shared memory, each of the 256 threads computing a 4 x 4
// register tile from float4 loads; the causal tiles of C B^T above the
// diagonal are skipped. Dims N and P are zero padded to multiples of 64 in
// shared memory, Q to a multiple of 64. Math in f32 on the CUDA cores, but
// cum and its differences in f64: at mamba2's decay rates |cum| reaches a
// few thousand within a chunk, where an f32 cumsum loses 1e-4 absolute and
// the decay factors exp(cum[l] - cum[s]) a part in 1e4. x is f32 or bf16
// and y is written in its type; the final state is written as (P, N), as
// the TPU kernel's transpose does.
//
// Bound at the mamba2 serve shape: operations (about 16 GFLOP of f32
// products, 0.24 ms at 67 TFLOP/s, against about 100 MB of inputs and
// outputs, 0.03 ms at 3.35 TB/s). One block per (b, h) gives 320 blocks of
// about 137 KB of shared memory, one per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 64;          // tile rows and columns
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int kLD = kT + 4;     // row stride of the transposed tiles

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[i][j] += sum_k At[k][r0 + i] * Bk[k][c0 + j], i, j < 4.
__device__ __forceinline__ void mma4x4(const float* At, int lda,
                                       const float* Bk, int ldb, int kn,
                                       int r0, int c0, float acc[4][4]) {
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(At + kk * lda + r0);
    const float4 b = *reinterpret_cast<const float4*>(Bk + kk * ldb + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

__device__ __forceinline__ void zero4x4(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// PT: P padded to 64 (PT = 1) or 128 (PT = 2).
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int G,
                int N, int Q, int NP) {
  constexpr int PP = PT * kT;   // padded P
  constexpr int LDS = PP + 4;   // row stride of the state
  extern __shared__ __align__(16) float smem[];
  const int QP = (Q + kT - 1) / kT * kT;
  float* st = smem;             // [NP][LDS]  state, n-major
  double* cum = reinterpret_cast<double*>(st + NP * LDS);  // [QP] cumsum(A dt)
  float* ct = reinterpret_cast<float*>(cum + QP);  // [NP][kLD] C tile, n-major;
                                                   // B * decay, s-major
  float* bt = ct + NP * kLD;    // [NP][kLD]  B tile, n-major
  float* xs = bt + NP * kLD;    // [kT][PP]   xdt tile, s-major
  float* mt = xs + kT * PP;     // [kT][kLD]  (C B^T .* L) tile, s-major
  __shared__ double warp_sums[kThreads / 32];

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const float a_h = A[h];
  const long long bS = (long long)b * S;

  for (int i = tid; i < NP * LDS; i += kThreads) st[i] = 0.f;

  auto x_at = [&](int t, int p) -> float {       // x[b, t, h, p] * dt[b, t, h]
    return load_f32(x + ((bS + t) * H + h) * P + p) * dt[(bS + t) * H + h];
  };
  auto bc_at = [&](const float* M, int t, int n) -> float {
    return M[((bS + t) * G + g) * N + n];
  };
  // xs[s][p] = xdt of chunk rows s0 + s (zero past the chunk, S and P).
  auto load_xdt = [&](int t0, int s0) {
    for (int i = tid; i < kT * PP; i += kThreads) {
      const int s = i / PP, p = i - s * PP;
      const int l = s0 + s;
      xs[i] = (l < Q && t0 + l < S && p < P) ? x_at(t0 + l, p) : 0.f;
    }
  };

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    // cum = inclusive cumsum of A * dt over the chunk, 256 rows at a time.
    double carry = 0.0;
    for (int base = 0; base < QP; base += kThreads) {
      const int l = base + tid;
      double v = (l < Q && t0 + l < S) ? a_h * dt[(bS + t0 + l) * H + h] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
      }
      if (lane == 31) warp_sums[warp] = v;
      __syncthreads();
      double off = carry, total = 0.0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        if (w < warp) off += warp_sums[w];
        total += warp_sums[w];
      }
      if (l < QP) cum[l] = v + off;
      carry += total;
      __syncthreads();
    }
    const double cum_end = cum[QP - 1];

    // Y, one tile of 64 chunk rows at a time.
    for (int l0 = 0; l0 < QP; l0 += kT) {
      __syncthreads();
      for (int i = tid; i < kT * NP; i += kThreads) {
        const int l = i / NP, n = i - l * NP;
        ct[n * kLD + l] = (l0 + l < Q && t0 + l0 + l < S && n < N)
                              ? bc_at(Cm, t0 + l0 + l, n) : 0.f;
      }
      __syncthreads();
      float yacc[PT][4][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        zero4x4(yacc[pt]);
        if (c > 0) {              // the state entering chunk 0 is zero
          mma4x4(ct, kLD, st + pt * kT, LDS, NP, tr * 4, tc * 4, yacc[pt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = expf((float)cum[l0 + tr * 4 + i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) yacc[pt][i][j] *= e;
          }
        }
      }
      for (int s0 = 0; s0 <= l0; s0 += kT) {
        __syncthreads();
        for (int i = tid; i < kT * NP; i += kThreads) {
          const int s = i / NP, n = i - s * NP;
          bt[n * kLD + s] = (s0 + s < Q && t0 + s0 + s < S && n < N)
                                ? bc_at(Bm, t0 + s0 + s, n) : 0.f;
        }
        load_xdt(t0, s0);
        __syncthreads();
        float cb[4][4];
        zero4x4(cb);
        mma4x4(ct, kLD, bt, kLD, NP, tr * 4, tc * 4, cb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tc * 4 + j;
          float col[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = l0 + tr * 4 + i;
            col[i] = l >= s ? cb[i][j] * expf((float)(cum[l] - cum[s])) : 0.f;
          }
          *reinterpret_cast<float4*>(mt + (tc * 4 + j) * kLD + tr * 4) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
        __syncthreads();
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
          mma4x4(mt, kLD, xs + pt * kT, PP, kT, tr * 4, tc * 4, yacc[pt]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + tr * 4 + i;
        if (l >= Q || t0 + l >= S) continue;
        T* yrow = y + ((bS + t0 + l) * H + h) * P;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = pt * kT + tc * 4 + j;
            if (p < P) store_from_f32(yrow + p, yacc[pt][i][j]);
          }
      }
    }

    // state <- exp(cum_end) state + (B .* exp(cum_end - cum))^T xdt.
    __syncthreads();
    const float ce = expf((float)cum_end);
    for (int n0 = 0; n0 < NP; n0 += kT)
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            st[(n0 + tr * 4 + i) * LDS + pt * kT + tc * 4 + j] *= ce;
    for (int s0 = 0; s0 < QP; s0 += kT) {
      __syncthreads();
      for (int i = tid; i < kT * NP; i += kThreads) {
        const int s = i / NP, n = i - s * NP;
        const int l = s0 + s;
        ct[s * NP + n] = (l < Q && t0 + l < S && n < N)
                             ? bc_at(Bm, t0 + l, n) * expf((float)(cum_end - cum[l]))
                             : 0.f;
      }
      load_xdt(t0, s0);
      __syncthreads();
      for (int n0 = 0; n0 < NP; n0 += kT)
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          float upd[4][4];
          zero4x4(upd);
          mma4x4(ct, NP, xs + pt * kT, PP, kT, n0 + tr * 4, tc * 4, upd);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              st[(n0 + tr * 4 + i) * LDS + pt * kT + tc * 4 + j] += upd[i][j];
        }
    }
    __syncthreads();
  }

  float* so = state_out + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    so[i] = st[n * LDS + p];
  }
}

template <typename T, int PT>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, void* y, float* state_out, int Bb, int S, int H,
           int P, int G, int N, int Q, cudaStream_t stream) {
  const int NP = (N + kT - 1) / kT * kT;
  const int QP = (Q + kT - 1) / kT * kT;
  const size_t smem = sizeof(float) * ((size_t)NP * (PT * kT + 4) + 2 * QP +
                                       2 * (size_t)NP * kLD + kT * PT * kT +
                                       kT * kLD);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, PT><<<Bb * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, static_cast<T*>(y), state_out,
      S, H, P, G, N, Q, NP);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, void* y, float* state_out, int Bb, int S, int H,
             int P, int G, int N, int Q, cudaStream_t stream) {
  if (P <= kT)
    return launch<T, 1>(x, dt, A, Bm, Cm, y, state_out, Bb, S, H, P, G, N, Q,
                        stream);
  return launch<T, 2>(x, dt, A, Bm, Cm, y, state_out, Bb, S, H, P, G, N, Q,
                      stream);
}

}  // namespace

// x/y (Bb, S, H, P) in dtype (0 float32, 1 bfloat16); dt (Bb, S, H),
// A (H,), B/C (Bb, S, G, N) and state_out (Bb, H, P, N) float32, all
// contiguous. Q: the chunk length. Returns the CUDA error of the launch.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const float* Bm, const float* Cm, void* y,
                               float* state_out, int dtype, int Bb, int S,
                               int H, int P, int G, int N, int Q,
                               void* stream) {
  if (P < 1 || P > 2 * kT || N < 1 || G < 1 || H % G != 0 || Q < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, dt, A, Bm, Cm, y, state_out, Bb, S, H, P, G, N,
                           Q, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state_out, Bb, S, H,
                                   P, G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
