// Flash attention forward (online softmax over key tiles), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (_kernel). Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py, which also holds the plain
// PyTorch version.
//
// One block per (batch b, query head h, tile of 64 query rows); it walks the
// key tiles in order, carrying the running max m, the running sum l and the
// (64, dh) accumulator in registers, which is what the TPU kernel carried in
// VMEM scratch across its sequential kv grid dimension. Query head h reads
// kv head h / (H / K) (GQA), so K/V are never repeated in memory. Masks as
// the TPU kernel: a masked score is the finite -1e30, the running max starts
// at -inf, l is clamped at 1e-30; bad = key padding | k > q when causal |
// (q - k) >= window unless k < prefix. Whole key tiles that are strictly in
// the future (causal) or entirely behind the window without prefix keys are
// skipped.
//
// Layout: q/o (B, Sq, H, dh) and k/v (B, Sk, K, dh) read through element
// strides (the head dim contiguous), so the (B*H, S, dh) layout of the TPU
// kernel is the same kernel with B = 1, H = B*H, K = B*K.
//
// Math: f32 on the CUDA cores; bf16 inputs are widened on load, the output
// is written in the input type. Each of the 128 threads owns 4 query rows and
// 8 key columns of the (64, 64) score tile (a 4 x 8 register tile fed from
// d-major shared-memory tiles by float4 loads), and 4 rows x dh/8 columns of
// the accumulator. Bound at the serve shape: operations (about 17 GFLOP of
// products in the causal half at 989 TFLOP/s of bf16 tensor-core rate is
// 17 us; 38 MB of q/k/v/o at 3.35 TB/s is 11 us). This kernel runs at the
// CUDA cores' f32 rate and is far from that bound; wgmma, TMA and a
// pipelined tile ring are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLDT = kBQ + 4;  // row stride of the d-major and key-major tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// DP: the head dim rounded up to 32, 64 or 128 (zero padded in shared memory).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int K,
                 int Sq, int Sk, int dh, Strides st, int causal, int window,
                 int prefix, float scale) {
  constexpr int DG = DP / 32;    // float4 column groups of the accumulator
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [DP][kLDT] query tile, d-major
  float* kt = qt + DP * kLDT;    // [DP][kLDT] key tile, d-major
  float* vt = kt + DP * kLDT;    // [kBK][DP]  value tile, key-major
  float* pt = vt + kBK * DP;     // [kBK][kLDT] probabilities, key-major

  const int tid = threadIdx.x;
  const int rg = tid >> 3;       // rows rg*4 .. rg*4+3
  const int cg = tid & 7;        // columns cg*4+{0..3} and 32+cg*4+{0..3}
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / K);
  const int q_lo = blockIdx.x * kBQ;

  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  T* ob = o + b * st.ob + h * st.oh;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i - r * DP;
    qt[d * kLDT + r] = (q_lo + r < Sq && d < dh)
                           ? load_f32(qb + (long long)(q_lo + r) * st.qs + d)
                           : 0.f;
  }

  float m[4], l[4], acc[4][4 * DG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DG; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q_lo + kBQ - 1) / kBK + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k_lo = tile * kBK;
    if (window > 0 && k_lo + kBK - 1 < q_lo - window + 1 && k_lo >= prefix)
      continue;                  // entirely behind the window, no prefix keys
    __syncthreads();             // the previous tile's readers are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i - r * DP;
      const bool in = k_lo + r < Sk && d < dh;
      kt[d * kLDT + r] =
          in ? load_f32(kb + (long long)(k_lo + r) * st.ks + d) : 0.f;
      vt[r * DP + d] =
          in ? load_f32(vb + (long long)(k_lo + r) * st.vs + d) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLDT + rg * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(kt + d * kLDT + cg * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(kt + d * kLDT + 32 + cg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += av[i] * bv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k_lo + (j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4);
        bool bad = kp >= Sk;
        if (causal) bad |= kp > qp;
        if (window > 0) bad |= (qp - kp) >= window && kp >= prefix;
        s[i][j] = bad ? kNegInf : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 8 threads of a row group are neighbouring lanes of one warp.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * DG; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4;
      *reinterpret_cast<float4*>(pt + c * kLDT + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * kLDT + rg * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vt + c * DP + g * 32 + cg * 4);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g * 4 + e] += pv[i] * vv[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + rg * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 32 + cg * 4 + e;
        if (d < dh)
          store_from_f32(ob + (long long)row * st.os + d, acc[i][g * 4 + e] / den);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int Sq, int Sk, int dh, const Strides& st, int causal,
           int window, int prefix, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * DP * kLDT + kBK * DP + kBK * kLDT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, Sq, Sk, dh, st,
      causal, window, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int H, int K, int Sq, int Sk, int dh, const Strides& st,
              int causal, int window, int prefix, float scale,
              cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, o, B, H, K, Sq, Sk, dh, st, causal, window,
                         prefix, scale, stream);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, B, H, K, Sq, Sk, dh, st, causal, window,
                         prefix, scale, stream);
  return launch<T, 128>(q, k, v, o, B, H, K, Sq, Sk, dh, st, causal, window,
                        prefix, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike). strides: 12 element
// strides, (batch, seq, head) of q, k, v and o in that order. Returns the
// CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype, int B,
                                      int H, int K, int Sq, int Sk, int dh,
                                      const long long* strides, int causal,
                                      int window, int prefix, float scale,
                                      void* stream) {
  if (dh < 1 || dh > 128 || K < 1 || H % K != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, o, B, H, K, Sq, Sk, dh, st, causal,
                            window, prefix, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Sk, dh, st,
                                    causal, window, prefix, scale, s);
  return (int)cudaErrorInvalidValue;
}
