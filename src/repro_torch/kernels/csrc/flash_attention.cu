// Flash attention forward (online softmax over key tiles), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (_kernel). Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py, which also holds the plain
// PyTorch version and the rule that picks one of the two kernels below.
//
// Both kernels: one block per (batch b, query head h, tile of 64 query
// rows); it walks the key tiles in order, carrying the running max m, the
// running sum l and the (64, dh) accumulator in registers, which is what the
// TPU kernel carried in VMEM scratch across its sequential kv grid
// dimension. Query head h reads kv head h / (H / K) (GQA), so K/V are never
// repeated in memory. Masks as the TPU kernel: a masked score is the finite
// -1e30, the running max starts at -inf, l is clamped at 1e-30; bad = key
// padding | k > q when causal | (q - k) >= window unless k < prefix. Whole
// key tiles that are strictly in the future (causal) or entirely behind the
// window without prefix keys are skipped.
//
// flash_fwd_kernel (flash_attention_launch), any float32 or bfloat16 input
// with dh <= 128:
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
// CUDA cores' f32 rate and is far from that bound.
//
// flash_fwd_tc (flash_attention_tc_launch), bfloat16 with dh 64, 96 or 128
// and 16-byte aligned pointers and strides: both products on the tensor
// cores, see the note above it.
//
// Both kernels also write the per-row log-sum-exp, m + log l in float32,
// into lse (B, H, Sq) when the pointer is not null: the residual of the
// reference's training forward (repro/models/layers.py::_flash_train_fwd),
// which the backward (kernels/flash_attention.py::flash_backward) reads.
// With a null pointer they store nothing more than the output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int K, int Sq, int Sk, int dh,
                 Strides st, int causal, int window, int prefix, float scale) {
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
    // m and l are whole-row values in every thread of the row group.
    if (lse != nullptr && cg == 0)
      lse[(long long)blockIdx.y * Sq + row] = m[i] + logf(den);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int K, int Sq, int Sk, int dh, const Strides& st,
           int causal, int window, int prefix, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * DP * kLDT + kBK * DP + kBK * kLDT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, K, Sq, Sk, dh,
      st, causal, window, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int K, int Sq, int Sk, int dh,
              const Strides& st, int causal, int window, int prefix,
              float scale, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, H, K, Sq, Sk, dh, st, causal,
                         window, prefix, scale, stream);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, H, K, Sq, Sk, dh, st, causal,
                         window, prefix, scale, stream);
  return launch<T, 128>(q, k, v, o, lse, B, H, K, Sq, Sk, dh, st, causal,
                        window, prefix, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike). lse: null, or float32
// (B, H, Sq) contiguous for the log-sum-exp. strides: 12 element strides,
// (batch, seq, head) of q, k, v and o in that order. Returns the CUDA error
// of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int B,
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
    return launch_dh<float>(q, k, v, o, static_cast<float*>(lse), B, H, K,
                            Sq, Sk, dh, st, causal, window, prefix, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B,
                                    H, K, Sq, Sk, dh, st, causal, window,
                                    prefix, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// flash_fwd_tc: the tensor-core kernel.
//
// Bound: operations, as above (17 us at the serve shape at 989 TFLOP/s of
// bf16 tensor-core rate). What the design does about it:
// - Both products on the tensor cores with warpgroup wgmma: S = Q K^T as
//   m64n64k16 (dh/16 k-steps) with Q and K from shared memory, both K-major;
//   O += P V as m64n{dh}k16 (4 k-steps of 16 keys) with P, rounded to bf16,
//   as the register A operand (the f32 accumulator layout of one wgmma is
//   the register A layout of the next) and V from shared memory, MN-major
//   (imm-trans-b). Sums, the softmax and the accumulator stay f32.
// - Tiles arrive by TMA: Q once, K and V into a ring of kStages stages, one
//   "full" mbarrier per stage with its expected byte count. Thread 0 issues
//   the loads of tile i + kStages as soon as every warp's products on tile i
//   have retired (wgmma.wait_group 0, then __syncthreads), so the next tile
//   is in flight while the warpgroup computes.
// - 128-byte swizzle in the tensor maps and in the wgmma descriptors alike:
//   a TMA box is 64 rows x 64 bf16 columns (128 bytes, the swizzle's span),
//   8 KB, 1024-byte aligned; at dh 128 a tile is two such boxes (columns 0-63
//   and 64-127).
// - dh 96 runs dh 128's tile: the tensor maps' innermost dim is 96, so the
//   second box's columns 96-127 lie outside the tensor and TMA fills them
//   with zeros (the transaction still counts the whole box). Q K^T takes
//   the 6 k-steps of the real columns; P V runs at n128 and its columns
//   96-127 come out zero; the epilogue stores 96 columns. The P V product
//   does 4/3 of its minimal work, the kernel 7/6 of both products'. K-major descriptors step 32 bytes per k-step inside a box
//   and 8 KB from box to box; the MN-major V descriptor steps 2 KB (16 keys)
//   per k-step, its leading byte offset (8 KB) reaching the second box.
// - Tensor maps are 4-D (dh, heads, seq, batch) with the tensor's own byte
//   strides, built on the host at each launch (cuTensorMapEncodeTiled,
//   fetched through the runtime, so no -lcuda); dims, strides and boxes come
//   from the Python wrapper. Rows past Sq or Sk arrive as zeros; keys past Sk
//   are also masked.
// - The elementwise mask runs only on tiles that need it (the causal
//   diagonal, the ragged Sk tail, the window edge); exp2 on the
//   special-function unit with log2(e) and the scale folded into one
//   multiply-add on unmasked tiles.
// - One warpgroup of 128 threads per block: warp w holds score and output
//   rows 16w + lane/4 and 16w + lane/4 + 8; row max and sum reduce over the
//   4 lanes of a quad. Output in bf16 from registers through its strides.
// - The block waits on each product, so the card's throughput comes from
//   several blocks per SM taking turns: at dh 64 a block holds 41 KB of
//   shared memory and 90 registers a thread, five blocks per SM. A third
//   ring stage would cost one of them. Blocks are ordered so that the query
//   tiles with the most causal key tiles start first.
// Left for later: a producer warp beside two consumer warpgroups with
// ping-pong softmax (overlapping one group's exp2 with the other's wgmma), a
// 128-row query tile, and a TMA store of the output.

namespace tc {

constexpr int kBQ = 64;                // query rows per block (one wgmma M)
constexpr int kBK = 64;                // keys per tile
constexpr int kThreads = 128;          // one warpgroup
constexpr int kStages = 2;             // K/V ring depth
constexpr int kBoxCols = 64;           // bf16 columns per TMA box: 128 bytes
constexpr int kBoxBytes = 64 * 128;    // one box: 64 rows x 128 bytes
constexpr int kAlign = 1024;           // the 128-byte swizzle's repeat
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count)
               : "memory");
}

// Arrives on the barrier and makes its phase wait for this many bytes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete. A phase that never
// completes (a lost TMA load) ends the kernel with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operand registers
// across the asynchronous region between a wgmma and its wait, or from
// reusing them there.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// 2^x on the special-function unit (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, f32) = [d +] a (64 x 16) b (16 x 64): a and b bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = [d +] a (64 x 16) b (16 x 64): a bf16 in registers, b bf16
// in shared memory, MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) = [d +] a (64 x 16) b (16 x 128): a bf16 in registers, b bf16
// in shared memory, MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The online softmax of one 64 x 64 score tile in the wgmma accumulator
// layout: s[4j + 2r + e] is query row row0 + 8r and key k_lo + 8j + 2 t4 + e.
// Scales (log2 domain) and masks s in place, updates the running max m and
// this thread's part of the running sum l, returns in corr the factors for
// the accumulator's two rows and packs P in bf16 into the register A operand
// of the P V product: p[kk] holds keys 16kk .. 16kk + 15.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&p)[4][4], float (&m)[2], float (&l)[2],
    float (&corr)[2], int row0, int t4, int k_lo, int q_lo, int Sk,
    int causal, int window, int prefix, float scale_log2) {
  // The elementwise mask only where the tile needs it: the causal diagonal,
  // the ragged Sk tail, the window edge.
  const bool need_mask =
      k_lo + kBK > Sk || (causal && k_lo + kBK - 1 > q_lo) ||
      (window > 0 && q_lo + kBQ - 1 - k_lo >= window &&
       k_lo + kBK - 1 >= prefix);
  // Unmasked tiles fold the scale into the exponent's multiply-add (the row
  // max commutes with a positive scale); masked ones scale first.
  const float sc = need_mask ? 1.f : scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * r + e];
        if (need_mask) {
          const int kp = k_lo + 8 * j + 2 * t4 + e;
          bool bad = kp >= Sk;
          if (causal) bad |= kp > qp;
          if (window > 0) bad |= (qp - kp) >= window && kp >= prefix;
          x = bad ? kNegInf : x * scale_log2;
          s[4 * j + 2 * r + e] = x;
        }
        mx = fmaxf(mx, x);
      }
    if (!need_mask) mx *= scale_log2;
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = ex2(fmaf(s[4 * j + 2 * r + e], sc, -m_new));
        s[4 * j + 2 * r + e] = x;
        sum += x;
      }
    l[r] = l[r] * corr[r] + sum;
  }
  // The accumulator layout of S is the register A layout of P: rows row0
  // and row0 + 8, keys 16kk + 2 t4 (+1) and 16kk + 8 + 2 t4 (+1).
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      p[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 64)
    wgmma_rs_n64(d, a, db, 1);
  else
    wgmma_rs_n128(d, a, db, 1);
}

// DS: the head dim (64, 96 or 128); DH: the tile's columns, DS rounded up to
// whole 64-column boxes.
template <int DS, int DH = (DS + kBoxCols - 1) / kBoxCols * kBoxCols>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
             int K, int Sq, int Sk, long long o_sb, long long o_ss, long long o_sh, int causal,
             int window, int prefix, float scale_log2) {
  constexpr int NB = DH / kBoxCols;            // boxes per tile: 1 or 2
  constexpr int kTile = NB * kBoxBytes;        // one Q, K or V tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // ring, then Q

  // Tiles: Q, then K and V of each stage, each on a 1024-byte boundary.
  const uint32_t q_s = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1);
  const uint32_t ring = q_s + kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Blocks start in index order, heads fastest: the query tiles with the
  // most causal key tiles go first, the short ones fill the tail.
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / K);

  // The key tiles this block reads: [0, n_pre) and [hi, n_tiles), the tiles
  // in between lying entirely behind the window with no prefix key.
  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q_lo + kBQ - 1) / kBK + 1);
  int n_pre = 0, hi = 0;
  if (window > 0) {
    n_pre = min((prefix + kBK - 1) / kBK, n_tiles);
    int first = 0;
    while (first < n_tiles && first * kBK + kBK - 1 < q_lo - window + 1)
      ++first;
    hi = max(n_pre, first);
  }
  const int n_iter = n_pre + n_tiles - hi;
  auto k_lo_of = [&](int i) { return (i < n_pre ? i : hi + i - n_pre) * kBK; };

  auto kv_load = [&](int i) {                  // thread 0 only
    const uint32_t bar = smem_u32(&bars[i % kStages]);
    const uint32_t k_s = ring + (i % kStages) * 2 * kTile;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(k_s + c * kBoxBytes, &kmap, bar, c * kBoxCols, kvh,
                  k_lo_of(i), b);
      tma_load_4d(k_s + kTile + c * kBoxBytes, &vmap, bar, c * kBoxCols, kvh,
                  k_lo_of(i), b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar = smem_u32(&bars[kStages]);
    mbar_expect_tx(bar, kTile);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load_4d(q_s + c * kBoxBytes, &qmap, bar, c * kBoxCols, h, q_lo, b);
    for (int i = 0; i < min(kStages, n_iter); ++i) kv_load(i);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q_lo + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  float acc[DH / 2], s[32];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t a[4][4];

  mbar_wait(smem_u32(&bars[kStages]), 0);
  for (int i = 0; i < n_iter; ++i) {
    const uint32_t k_s = ring + (i % kStages) * 2 * kTile;
    const uint32_t v_s = k_s + kTile;
    mbar_wait(smem_u32(&bars[i % kStages]), (i / kStages) & 1);
    __syncwarp();                          // converged for the .aligned wgmma

    // S = Q K^T (64 x 64, f32)
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, desc_sw128(q_s + off, 16, 1024),
                   desc_sw128(k_s + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    softmax_tile(s, a, m, l, corr, row0, t4, k_lo_of(i), q_lo, Sk, causal,
                 window, prefix, scale_log2);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= corr[r];
        acc[4 * j + 2 * r + 1] *= corr[r];
      }

    // O += P V: P in bf16 as the register A operand, 16 keys per k-step.
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DH>(acc, a[kk], desc_sw128(v_s + kk * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);                         // a was read by the P V product

    __syncthreads();                       // every warp is done with tile i
    if (tid == 0 && i + kStages < n_iter) kv_load(i + kStages);
  }

  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    // The running max is of scores scaled into the log2 domain: back to
    // natural logs. m is the quad's whole-row max in each of its lanes.
    if (lse != nullptr && t4 == 0)
      lse[(long long)blockIdx.x * Sq + row] = (m[r] + log2f(den)) * kLn2;
#pragma unroll
    for (int j = 0; j < DS / 8; ++j) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + 8 * j + 2 * t4) = v2;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// layout: dims[4] (dh, heads, seq, batch), byte strides[3] (heads, seq,
// batch), box[4], boxes per tile.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
           const long long* layout) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(layout[i]);
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(layout[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(layout[7 + i]);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : -2;
}

template <int DS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int K, int Sq, int Sk, const long long* layouts,
           const long long* o_strides, int causal, int window, int prefix,
           float scale, cudaStream_t stream) {
  constexpr int NB = (DS + kBoxCols - 1) / kBoxCols;   // boxes per tile
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* lay = layouts + 12 * i;
    if (lay[0] != DS || lay[7] != kBoxCols || lay[8] != 1 || lay[9] != kBQ ||
        lay[10] != 1 || lay[11] != NB)
      return (int)cudaErrorInvalidValue;
    const int rc = encode(fn, &maps[i], ptrs[i], lay);
    if (rc != 0) return rc;
  }
  const int smem = kAlign + (1 + 2 * kStages) * NB * kBoxBytes;
  // The shared-memory limit is set once for each device.
  static unsigned long long configured = 0;    // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        flash_fwd_tc<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc<DS><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, H, K, Sq,
      Sk, o_strides[0], o_strides[1], o_strides[2], causal, window, prefix,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

// bfloat16 q, k, v and o, dh 64, 96 or 128. layouts: 3 x 12 values, the
// tensor maps of q, k and v: dims (dh, heads, seq, batch), byte strides of
// heads, seq and batch, the box (64, 1, 64, 1) and the boxes per tile
// (dh / 64 rounded up).
// o_strides: the element strides (batch, seq, head) of o. lse: null, or
// float32 (B, H, Sq) contiguous for the log-sum-exp. Returns 0 on
// success, the CUDA error of the launch, -1 when the driver has no
// cuTensorMapEncodeTiled and -2 when it refuses a tensor map.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int H, int K, int Sq, int Sk,
                                         int dh,
                                         const long long* layouts,
                                         const long long* o_strides,
                                         int causal, int window, int prefix,
                                         float scale, void* stream) {
  if (K < 1 || H % K != 0 || Sq < 1 || Sk < 1 || (Sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return tc::launch<64>(q, k, v, o, static_cast<float*>(lse), B, H, K, Sq,
                          Sk, layouts, o_strides, causal, window, prefix,
                          scale, s);
  if (dh == 96)
    return tc::launch<96>(q, k, v, o, static_cast<float*>(lse), B, H, K, Sq,
                          Sk, layouts, o_strides, causal, window, prefix,
                          scale, s);
  if (dh == 128)
    return tc::launch<128>(q, k, v, o, static_cast<float*>(lse), B, H, K, Sq,
                           Sk, layouts, o_strides, causal, window, prefix,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}
