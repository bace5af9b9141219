// Mamba-2 SSD chunked scan (state-space duality), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (_kernel).
// Plain C interface, loaded with ctypes by repro_torch/kernels/ssd_scan.py,
// which also holds the plain PyTorch version and the launch plan (grids and
// the scratch it allocates). Shared memory is sized here alone.
//
// The TPU kernel carried the (N, P) inter-chunk state in VMEM across a
// sequential chunk grid dimension. Here the scan is split into chunk-parallel
// passes, as Mamba-2's own GPU algorithm does; with cum = cumsum(A * dt)
// within a chunk of Q = min(chunk, S) steps (rows past S are the TPU kernel's
// dt = 0 padding), per (batch b, head h, chunk c):
//   1. ssd_chunk_state, one block per (b, h, c, 64 state rows): cum in f64
//      (to scratch, scaled by log2(e)) and the chunk's own state
//      (B .* exp(cum_end - cum) .* dt)^T x, (N, P), to scratch;
//   2. ssd_cb, one block per (b, c, g, causal 64 x 64 tile): C B^T of group
//      g, computed once per group and not once per head (mamba2 has 80
//      heads on one group), its causal tiles to scratch, where the chunk
//      scan reads them from L2;
//   3. ssd_state_pass, one block per (b, h, 32 state rows): the state
//      passing S_c = exp(cum_end_c) S_{c-1} + state_c, sequential over the
//      chunks in registers; slot c of the scratch takes S_c once its own
//      state is read, and the final state goes out as (P, N), the TPU
//      kernel's transpose. A separate pass: no block waits on another, and
//      the reads grow as the number of chunks, not as its square;
//   4. ssd_chunk_scan, one block per (b, h, c, 64 rows), the longest causal
//      row tiles first:
//      Y = exp(cum) .* (C S_{c-1})  +  (C B^T .* L .* dt) x,
//      L[l, s] = exp(cum[l] - cum[s]) for l >= s, else 0.
// At the mamba2 serve shape (B 4, S 1024, H 80, chunk 256) passes 1 and 4
// spread 2560 and 5120 blocks of 128 threads over the 132 SMs (1280 (b, h, c)
// work tiles), where one block per (b, h) gave 320.
//
// Products: mma.sync m16n8k8 on the tensor cores in TF32, split for f32
// accuracy (3xTF32): each f32 operand v is hi + lo, hi = tf32(v) and
// lo = tf32(v - hi), and a * b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi
// in f32 accumulators. A single TF32 pass misses the reference's 1e-4 bars
// by far (about 1e-2 on y at mamba2's widths). dt is folded into the other
// operand of x, so a bfloat16 x is exact in TF32 and its products take two
// passes (a_lo x + a_hi x); a float32 x is split as well. Each warp owns 16
// output rows and all P columns, so every exp of L is taken once. Tiles are
// fed by cp.async into a ring of kStages (the next 32-deep step loads while
// this one multiplies) with the step's cum and dt rows, so that shared
// memory does not grow with the chunk, and padded for conflict-free
// fragment loads; a bfloat16 x tile is read by ldmatrix.trans. x is read
// through its strides (the model's x is a strided view), by 16-byte copies
// where the pointer, strides and P allow it, else element by element. cum
// and its differences cum[l] - cum[s] are f64 before the exp (cum is stored
// scaled by log2(e), and the exps are base 2; ex2.approx in the chunk
// scan): at mamba2's decay rates |cum| reaches a few thousand within a
// chunk, where an f32 cumsum loses 1e-4 absolute.
//
// Bound at the mamba2 serve shape: operations. Of the 14.9 GFLOP, the 10.8
// whose other operand is the bfloat16 x need a three-way bf16 split of their
// f32 operand for f32 accuracy (0.033 ms at 989 TFLOP/s / 3); C B^T and
// C S_{c-1} need 3xTF32 (4.2 GFLOP, 0.025 ms at 495 TFLOP/s / 3): 0.058 ms
// in all, against about 100 MB of inputs and outputs (0.030 ms at
// 3.35 TB/s). The scratch (chunk states, 42 MB; C B^T, 2.6 MB; cum, 2.6 MB)
// adds device-memory and L2 traffic that the bound does not count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps x 16 output rows
constexpr int kBM = 64;             // output rows of a block
constexpr int kBK = 32;             // depth of one pipeline step
constexpr int kStages = 2;          // tiles in the cp.async ring
constexpr int kLdRow = kBK + 8;     // [64][32] row-major f32 tiles (8 mod 32)
constexpr int kLdCol = kBM + 4;     // [32][64] k-major f32 tiles (4 mod 32)
constexpr int kPassRows = 32;       // state rows of a state-pass block

// Row stride, in elements, of a k-major [32][PW] tile of T: f32 rows 4 words
// past a multiple of 32 (conflict-free fragment loads), bf16 rows a multiple
// of 16 bytes (ldmatrix).
template <typename T, int PW>
__host__ __device__ constexpr int ld_kmajor() {
  return sizeof(T) == 2 ? PW + 8 : PW + 4;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two neighbouring elements, 8 (f32) or 4 (bf16) bytes aligned.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^v, about two ulps (MUFU.EX2).
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// ---- 3xTF32 on mma.sync.m16n8k8 -----------------------------------------
//
// Fragments of one 8-deep k slab: thread (g = lane / 4, t = lane % 4) holds
// A rows g and g + 8 and B column g at the k slots t and t + 4. Slot t is
// taken as the slab's row 2t and slot t + 4 as row 2t + 1 in both operands
// (the product does not depend on the order of k), so each thread's two k
// values are neighbours: one 8-byte load of a row-major f32 tile, and the
// pair that ldmatrix.trans hands out from a k-major bf16 tile.

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a b: a the 16 x 8 row-major fragment, b the 8 x 8 column fragment.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

// a = {(g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)}.
__device__ __forceinline__ FragA split_a(const float (&a)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], f.hi[i], f.lo[i]);
  return f;
}

// The A values of rows r0, r0 + 8 at slab columns kk + 2t, kk + 2t + 1 of a
// row-major f32 tile.
__device__ __forceinline__ void frag_a_rows(const float* t, int ld, int r0,
                                            int kk, int tq, float (&a)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(t + r0 * ld + kk + 2 * tq);
  const float2 v =
      *reinterpret_cast<const float2*>(t + (r0 + 8) * ld + kk + 2 * tq);
  a[0] = u.x;
  a[1] = v.x;
  a[2] = u.y;
  a[3] = v.y;
}

// b[j] = rows kk + 2t, kk + 2t + 1 of column 8 (j0 + j) + g, j < 8, of a
// k-major tile.
__device__ __forceinline__ void frag_b8(const float* t, int ld, int kk, int j0,
                                        float (&b)[8][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float* r = t + (kk + 2 * tq) * ld + j0 * 8 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b[j][0] = r[j * 8];
    b[j][1] = r[ld + j * 8];
  }
}
__device__ __forceinline__ void frag_b8(const __nv_bfloat16* t, int ld, int kk,
                                        int j0, float (&b)[8][2]) {
  // Two ldmatrix.x4.trans, four 8 x 8 tiles each: lane i gives the address
  // of row i % 8 of tile i / 8 and gets (row 2t, col g) in its low half and
  // (row 2t + 1, col g) in its high half; a bf16 widens to f32 by a shift.
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* p =
        t + (kk + (lane & 7)) * ld + (j0 + 4 * h + (lane >> 3)) * 8;
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    uint32_t r[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b[4 * h + q][0] = __uint_as_float(r[q] << 16);
      b[4 * h + q][1] = __uint_as_float(r[q] & 0xffff0000u);
    }
  }
}

// acc[m][j] += a_m b_j at f32 accuracy for the MT row tiles m and NT n-tiles
// j of a warp, eight tiles of b at a time from fb(j0, b). Each pass runs
// over all MT x 8 tiles in turn, so independent products separate two that
// share an accumulator. kExactB: b is exact in TF32 (widened bf16), so its
// lo part is zero and that pass is skipped.
template <bool kExactB, int MT, int NT, typename FB>
__device__ __forceinline__ void mma3_rows(float (&acc)[MT][NT][4],
                                          const FragA (&a)[MT], FB fb) {
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += 8) {
    float b[8][2];
    fb(j0, b);
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kExactB)
          bh[j][i] = __float_as_uint(b[j][i]);
        else
          split_tf32(b[j][i], bh[j][i], bl[j][i]);
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_tf32(acc[m][j0 + j], a[m].lo, bh[j][0], bh[j][1]);
    if (!kExactB) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_tf32(acc[m][j0 + j], a[m].hi, bl[j][0], bl[j][1]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_tf32(acc[m][j0 + j], a[m].hi, bh[j][0], bh[j][1]);
  }
}

// ---- cp.async tile staging -------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[r * ld_dst + c] = src[r * ld_src + c] for r < ROWS, c < COLS; zero
// where r >= rv or c >= cv. vec: src 16-byte aligned, ld_src and cv
// multiples of 16 bytes (cp.async); else element by element.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* src,
                                          long long ld_src, int rv, int cv,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  static_assert(COLS % V == 0, "tile width");
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * COLS / V; i += kThreads) {
      const int r = i / (COLS / V), c = (i - r * (COLS / V)) * V;
      T* d = dst + r * ld_dst + c;
      if (r < rv && c < cv)
        cp_async16(d, src + r * ld_src + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i - r * COLS;
      dst[r * ld_dst + c] =
          (r < rv && c < cv) ? src[r * ld_src + c] : from_f32<T>(0.f);
    }
  }
}

// The ring: load(k, buf) stages step k, compute(k, buf) consumes it; a
// barrier at the top of each step makes step k visible to every thread and
// frees the buffer that step k - 1 used for the load of step k + kStages - 1.
// pipeline_start issues the first kStages - 1 loads, so that a kernel can
// overlap them with work of its own before pipeline_run.
template <typename Load>
__device__ __forceinline__ void pipeline_start(int nk, Load load) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
}

template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline_run(int nk, Load load,
                                             Compute compute) {
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int kn = k + kStages - 1;
    if (kn < nk) load(kn, kn % kStages);
    cp_async_commit();
    compute(k, k % kStages);
  }
  cp_async_wait<0>();
}

template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nk, Load load, Compute compute) {
  pipeline_start(nk, load);
  pipeline_run(nk, load, compute);
}

struct Dims {
  int S, H, G, N, P, Q, QP, nc, PS;
  long long sxb, sxs, sxh;   // x strides in elements (the p stride is 1)
};

__device__ __forceinline__ int chunk_rows(const Dims& d, int c) {
  return min(d.Q, d.S - c * d.Q);
}

constexpr double kLog2e = 1.4426950408889634;
constexpr int kRowBytes = kBK * (8 + 4);   // a step's log2-scaled cum and dt

// A step's rows s0 .. s0 + 31 of the chunk's log2-scaled cum (f64, from the
// scratch) and of dt (dt_h: the chunk's row 0 of its head, rows ld apart;
// zero past the chunk's Qv rows), by cp.async.
__device__ __forceinline__ void load_rows(double* c2s, float* dts,
                                          const double* cum2,
                                          const float* dt_h, int ld, int s0,
                                          int Qv) {
  const int t = threadIdx.x;
  if (t < kBK / 2) {
    cp_async16(c2s + 2 * t, cum2 + s0 + 2 * t);
  } else if (t >= kBK && t < 2 * kBK) {
    const int r = t - kBK;
    if (s0 + r < Qv)
      cp_async4(dts + r, dt_h + (long long)(s0 + r) * ld);
    else
      dts[r] = 0.f;
  }
}

// Shared memory of one ring stage of each kernel, in bytes. None depends on
// the chunk length.
template <typename T, int PW>
__host__ __device__ constexpr int chunk_state_stage() {
  return kBK * kLdCol * 4 + kBK * ld_kmajor<T, PW>() * (int)sizeof(T) +
         kRowBytes;
}
template <int PW>
__host__ __device__ constexpr int chunk_scan_stage() {
  return kBM * kLdRow * 4 + kBK * ld_kmajor<float, PW>() * 4 + kRowBytes;
}
__host__ __device__ constexpr int cb_stage() { return 2 * kBM * kLdRow * 4; }

// ---- 1. chunk states --------------------------------------------------------

// One block per (b * H + h) * nc + c (grid x) and 64 state rows (grid y).
template <typename T, int PW>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                double* __restrict__ cum_out, float* __restrict__ states,
                Dims d, int vec_x, int vec_bc) {
  constexpr int NT = PW / 8;
  constexpr int kLdX = ld_kmajor<T, PW>();
  constexpr int kStage = chunk_state_stage<T, PW>();
  constexpr int kXOff = kBK * kLdCol * 4;                  // x tile
  constexpr int kRowOff = kXOff + kBK * kLdX * (int)sizeof(T);  // cum, dt
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double warp_sums[kThreads / 32 + 1];          // + cum_end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x / d.nc, c = blockIdx.x - bh * d.nc;
  const int n0 = blockIdx.y * kBM;
  const int b = bh / d.H, h = bh - b * d.H, g = h / (d.H / d.G);
  const int t0 = c * d.Q, Qv = chunk_rows(d, c);
  const long long row0 = (long long)b * d.S + t0;
  const float a_h = A[h];
  double* cum2 = cum_out + ((long long)bh * d.nc + c) * d.QP;

  // cum = inclusive f64 cumsum of the f32 products A * dt over the chunk,
  // stored scaled by log2(e). Every row block of the chunk computes the
  // whole of it (QP values, little against its products), writes it and
  // reads it back for its steps (cp.async, after a barrier). The row blocks
  // of a chunk thus write the same addresses at once; that is safe because
  // they run the same operations in the same order on the same inputs, so
  // the bytes are identical, and no block reads a row before its own write
  // of it. Writing only from one row block would let the others read rows
  // not yet written, as blocks are not ordered.
  double carry = 0.0;
  for (int base = 0; base < d.QP; base += kThreads) {
    const int l = base + tid;
    double v = (double)(a_h * (l < Qv ? dt[(row0 + l) * d.H + h] : 0.f));
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
    if (l < d.QP) {
      const double c2 = (v + off) * kLog2e;
      cum2[l] = c2;
      if (l == d.QP - 1) warp_sums[kThreads / 32] = c2;
    }
    carry += total;
    __syncthreads();
  }
  const double ce2 = warp_sums[kThreads / 32];   // the chunk's last row

  const T* xb = x + b * d.sxb + (long long)t0 * d.sxs + h * d.sxh;
  const float* Bn = Bm + (row0 * d.G + g) * d.N + n0;
  const long long ldb = (long long)d.G * d.N;
  auto load = [&](int k, int buf) {
    unsigned char* st = smem + buf * kStage;
    const int s0 = k * kBK, rv = min(kBK, Qv - s0);
    load_tile<kBK, kBM>(reinterpret_cast<float*>(st), kLdCol, Bn + s0 * ldb,
                        ldb, rv, min(kBM, d.N - n0), vec_bc);
    load_tile<kBK, PW>(reinterpret_cast<T*>(st + kXOff), kLdX,
                       xb + s0 * d.sxs, d.sxs, rv, d.P, vec_x);
    double* c2s = reinterpret_cast<double*>(st + kRowOff);
    load_rows(c2s, reinterpret_cast<float*>(c2s + kBK), cum2,
              dt + row0 * d.H + h, d.H, s0, Qv);
  };
  float acc[1][NT][4] = {};
  const int r0 = warp * 16 + gq;
  auto compute = [&](int, int buf) {
    const unsigned char* st = smem + buf * kStage;
    const float* bt = reinterpret_cast<const float*>(st);   // [s][n]
    const T* xt = reinterpret_cast<const T*>(st + kXOff);
    const double* c2s = reinterpret_cast<const double*>(st + kRowOff);
    const float* dts = reinterpret_cast<const float*>(c2s + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int s = kk + 2 * tq;               // A = (B .* w)^T: (n, s)
      // w = exp(cum_end - cum) dt, the decay to the chunk's end.
      const double2 cs = *reinterpret_cast<const double2*>(c2s + s);
      const float2 ds = *reinterpret_cast<const float2*>(dts + s);
      const float w0 = exp2f((float)(ce2 - cs.x)) * ds.x;
      const float w1 = exp2f((float)(ce2 - cs.y)) * ds.y;
      const float* b0 = bt + s * kLdCol + r0;
      const float a[4] = {b0[0] * w0, b0[8] * w0, b0[kLdCol] * w1,
                          b0[kLdCol + 8] * w1};
      const FragA fa[1] = {split_a(a)};
      mma3_rows<sizeof(T) == 2>(acc, fa, [&](int j0, float (&bf)[8][2]) {
        frag_b8(xt, kLdX, kk, j0, bf);
      });
    }
  };
  pipeline((Qv + kBK - 1) / kBK, load, compute);

  float* out = states + ((long long)bh * d.nc + c) * d.N * d.PS;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int n = n0 + r0 + 8 * h2, p = j * 8 + 2 * tq;   // PS is even
      if (n < d.N && p < d.PS)
        *reinterpret_cast<float2*>(out + (long long)n * d.PS + p) =
            make_float2(acc[0][j][2 * h2], acc[0][j][2 * h2 + 1]);
    }
}

// ---- 2. C B^T once per group ------------------------------------------------

// One block per causal 64 x 64 tile (i, j), j <= i, of one (b, c, g): grid
// x = ((b * nc + c) * G + g) * ntiles + i (i + 1) / 2 + j. The tiles are
// stored in that order, 64 x 64 each, so the scratch holds the causal half.
__global__ void __launch_bounds__(kThreads)
ssd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
       float* __restrict__ cb, Dims d, int vec_bc) {
  constexpr int kStage = cb_stage();
  extern __shared__ __align__(16) unsigned char smem[];
  const int t64 = d.QP / kBM, ntiles = t64 * (t64 + 1) / 2;
  const int bcg = blockIdx.x / ntiles, tile = blockIdx.x - bcg * ntiles;
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= tile) ++i;
  const int j = tile - i * (i + 1) / 2;
  const int b = bcg / (d.nc * d.G), cg = bcg - b * d.nc * d.G;
  const int c = cg / d.G, g = cg - c * d.G;
  const int t0 = c * d.Q, Qv = chunk_rows(d, c);
  const int l0 = i * kBM, s0 = j * kBM;
  if (l0 >= Qv) return;                        // rows the scan never reads

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const long long ld = (long long)d.G * d.N;
  const float* Cl = Cm + (((long long)b * d.S + t0 + l0) * d.G + g) * d.N;
  const float* Bs = Bm + (((long long)b * d.S + t0 + s0) * d.G + g) * d.N;
  auto load = [&](int k, int buf) {
    float* st = reinterpret_cast<float*>(smem + buf * kStage);
    const int n0 = k * kBK, cv = min(kBK, d.N - n0);
    load_tile<kBM, kBK>(st, kLdRow, Cl + n0, ld, Qv - l0, cv, vec_bc);
    load_tile<kBM, kBK>(st + kBM * kLdRow, kLdRow, Bs + n0, ld, Qv - s0, cv,
                        vec_bc);
  };
  float acc[1][8][4] = {};
  const int r0 = warp * 16 + gq;
  auto compute = [&](int, int buf) {
    const float* ct = reinterpret_cast<const float*>(smem + buf * kStage);
    const float* bt = ct + kBM * kLdRow;       // [s][n]: the n-major operand
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      float a[4];
      frag_a_rows(ct, kLdRow, r0, kk, tq, a);
      const FragA fa[1] = {split_a(a)};
      mma3_rows<false>(acc, fa, [&](int j0, float (&bf)[8][2]) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float2 v = *reinterpret_cast<const float2*>(
              bt + ((j0 + jn) * 8 + gq) * kLdRow + kk + 2 * tq);
          bf[jn][0] = v.x;
          bf[jn][1] = v.y;
        }
      });
    }
  };
  pipeline((d.N + kBK - 1) / kBK, load, compute);

  float* out = cb + (long long)blockIdx.x * kBM * kBM;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      store2(out + (r0 + 8 * h2) * kBM + jn * 8 + 2 * tq, acc[0][jn][2 * h2],
             acc[0][jn][2 * h2 + 1]);
}

// ---- 3. state passing -------------------------------------------------------

// One block per b * H + h (grid x) and 32 state rows (grid y). Each thread
// carries up to kPassVec float4 of the block's 32 x PS state rows in
// registers and, per chunk, loads all of them before it stores any, so the
// loads of a chunk are in flight together. Slot c of the scratch takes S_c,
// the state leaving chunk c (the one entering chunk c + 1), once its own
// state has been read: each store waits on its load's data and never on an
// older load of the same address, and the last slot, which no chunk reads,
// is not written.
constexpr int kPassVec = kPassRows * 128 / 4 / kThreads;

__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const double* __restrict__ cum,
               float* __restrict__ state_out, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);   // [kPassRows][PS + 1]
  const int bh = blockIdx.x, n0 = blockIdx.y * kPassRows;
  const int ldt = d.PS + 1, vrow = d.PS / 4;
  const int nvec = min(kPassRows, d.N - n0) * vrow;   // float4 of valid rows
  float4 s[kPassVec];
#pragma unroll
  for (int i = 0; i < kPassVec; ++i) s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < d.nc; ++c) {
    const long long chunk = (long long)bh * d.nc + c;
    float4* v = reinterpret_cast<float4*>(states + (chunk * d.N + n0) * d.PS);
    const float e = exp2f((float)cum[chunk * d.QP + d.QP - 1]);
#pragma unroll
    for (int i = 0; i < kPassVec; ++i) {
      const int k = threadIdx.x + i * kThreads;
      if (k >= nvec) continue;
      const float4 u = v[k];
      s[i] = make_float4(s[i].x * e + u.x, s[i].y * e + u.y,
                         s[i].z * e + u.z, s[i].w * e + u.w);
    }
    if (c + 1 < d.nc) {
#pragma unroll
      for (int i = 0; i < kPassVec; ++i) {
        const int k = threadIdx.x + i * kThreads;
        if (k < nvec) v[k] = s[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPassVec; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k >= nvec) continue;
    const int r = k / vrow, p = (k - r * vrow) * 4;
    float* t = tile + r * ldt + p;
    t[0] = s[i].x;
    t[1] = s[i].y;
    t[2] = s[i].z;
    t[3] = s[i].w;
  }
  __syncthreads();
  float* out = state_out + (long long)bh * d.P * d.N;
  for (int e = threadIdx.x; e < kPassRows * d.P; e += kThreads) {
    const int p = e / kPassRows, r = e - p * kPassRows;
    if (n0 + r < d.N) out[(long long)p * d.N + n0 + r] = tile[r * ldt + p];
  }
}

// ---- 4. chunk scan ----------------------------------------------------------

// One block per (b * H + h) * nc + c (grid x) and 64 rows (grid y, the
// longest causal row tiles first).
template <typename T, int PW>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const double* __restrict__ cum, const float* __restrict__ states,
               T* __restrict__ y, Dims d, int vec_x, int vec_bc) {
  constexpr int NT = PW / 8;
  constexpr int kLdS = ld_kmajor<float, PW>();
  constexpr int kLdX = ld_kmajor<T, PW>();
  constexpr int kStage = chunk_scan_stage<PW>();
  constexpr int kBOff = kBM * kLdRow * 4;                  // S or x tile
  constexpr int kRowOff = kBOff + kBK * kLdS * 4;          // cum, dt
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x / d.nc, c = blockIdx.x - bh * d.nc;
  const int i = gridDim.y - 1 - blockIdx.y, l0 = i * kBM;
  const int b = bh / d.H, h = bh - b * d.H, g = h / (d.H / d.G);
  const int t0 = c * d.Q, Qv = chunk_rows(d, c);
  if (l0 >= Qv) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)b * d.S + t0;
  const long long chunk = (long long)bh * d.nc + c;
  const double* cum2 = cum + chunk * d.QP;     // log2-scaled

  const int ns = c > 0 ? (d.N + kBK - 1) / kBK : 0;   // the state enters
  const int nd = (min(l0 + kBM, Qv) + kBK - 1) / kBK;  // s < l0 + 64
  const long long ldc = (long long)d.G * d.N;
  const float* Cl = Cm + ((row0 + l0) * d.G + g) * d.N;
  // S_{c-1}: slot c - 1 (read only when c > 0).
  const float* Sc = states + (c > 0 ? chunk - 1 : chunk) * d.N * d.PS;
  // C B^T row tile i: causal tiles (i, 0 .. i), 64 x 64 each.
  const float* CBl = cb + ((((long long)b * d.nc + c) * d.G + g) *
                               (gridDim.y * (gridDim.y + 1) / 2) +
                           i * (i + 1) / 2) * kBM * kBM;
  const T* xc = x + b * d.sxb + (long long)t0 * d.sxs + h * d.sxh;
  auto load = [&](int k, int buf) {
    unsigned char* st = smem + buf * kStage;
    float* at = reinterpret_cast<float*>(st);
    float* bt = reinterpret_cast<float*>(st + kBOff);
    if (k < ns) {                            // C (l, n) and S_{c-1} (n, p)
      const int n0 = k * kBK;
      load_tile<kBM, kBK>(at, kLdRow, Cl + n0, ldc, Qv - l0,
                          min(kBK, d.N - n0), vec_bc);
      load_tile<kBK, PW>(bt, kLdS, Sc + (long long)n0 * d.PS, d.PS,
                         min(kBK, d.N - n0), d.PS, true);
    } else {                                 // C B^T (l, s), x (s, p), rows s
      const int s0 = (k - ns) * kBK;
      load_tile<kBM, kBK>(at, kLdRow, CBl + (s0 / kBM) * kBM * kBM + s0 % kBM,
                          kBM, kBM, kBK, true);
      load_tile<kBK, PW>(reinterpret_cast<T*>(bt), kLdX, xc + s0 * d.sxs,
                         d.sxs, Qv - s0, d.P, vec_x);
      double* c2s = reinterpret_cast<double*>(st + kRowOff);
      load_rows(c2s, reinterpret_cast<float*>(c2s + kBK), cum2,
                dt + row0 * d.H + h, d.H, s0, Qv);
    }
  };
  pipeline_start(ns + nd, load);
  float acc[1][NT][4] = {};
  const int r0 = warp * 16 + gq;
  const int la = l0 + r0, lb = la + 8;        // this thread's rows
  const double ca = cum2[la], cbl = cum2[lb];
  auto compute = [&](int k, int buf) {
    const unsigned char* st = smem + buf * kStage;
    const float* at = reinterpret_cast<const float*>(st);
    const float* bt = reinterpret_cast<const float*>(st + kBOff);
    if (k < ns) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        float a[4];
        frag_a_rows(at, kLdRow, r0, kk, tq, a);
        const FragA fa[1] = {split_a(a)};
        mma3_rows<false>(acc, fa, [&](int j0, float (&bf)[8][2]) {
          frag_b8(bt, kLdS, kk, j0, bf);
        });
      }
      return;
    }
    if (k == ns && ns > 0) {                 // C S_{c-1} is done: exp(cum)
      const float ea = exp2_approx((float)ca), eb = exp2_approx((float)cbl);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[0][j][0] *= ea;
        acc[0][j][1] *= ea;
        acc[0][j][2] *= eb;
        acc[0][j][3] *= eb;
      }
    }
    const T* xt = reinterpret_cast<const T*>(bt);
    const double* c2s = reinterpret_cast<const double*>(st + kRowOff);
    const float* dts = reinterpret_cast<const float*>(c2s + kBK);
    const int s0 = (k - ns) * kBK;
    const bool diag = s0 + kBK > l0;         // the step holds l < s pairs
    // M = C B^T .* exp(cum[l] - cum[s]) .* dt[s], zero above the diagonal.
    auto m_at = [&](float v, int l, double cl, double cs, float dts_s,
                    int s) -> float {
      const float m = v * exp2_approx((float)(cl - cs)) * dts_s;
      return diag && s > l ? 0.f : m;
    };
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      float v[4];
      frag_a_rows(at, kLdRow, r0, kk, tq, v);
      const int s = kk + 2 * tq, sa = s0 + s;
      const double2 cs = *reinterpret_cast<const double2*>(c2s + s);
      const float2 ds = *reinterpret_cast<const float2*>(dts + s);
      const float a[4] = {m_at(v[0], la, ca, cs.x, ds.x, sa),
                          m_at(v[1], lb, cbl, cs.x, ds.x, sa),
                          m_at(v[2], la, ca, cs.y, ds.y, sa + 1),
                          m_at(v[3], lb, cbl, cs.y, ds.y, sa + 1)};
      const FragA fa[1] = {split_a(a)};
      mma3_rows<sizeof(T) == 2>(acc, fa, [&](int j0, float (&bf)[8][2]) {
        frag_b8(xt, kLdX, kk, j0, bf);
      });
    }
  };
  pipeline_run(ns + nd, load, compute);

  const bool pairs = (d.P & 1) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int l = h2 ? lb : la, p = j * 8 + 2 * tq;
      if (l >= Qv || p >= d.P) continue;
      T* yp = y + ((row0 + l) * d.H + h) * d.P + p;
      const float v0 = acc[0][j][2 * h2], v1 = acc[0][j][2 * h2 + 1];
      if (pairs) {
        store2(yp, v0, v1);
      } else {
        yp[0] = from_f32<T>(v0);
        if (p + 1 < d.P) yp[1] = from_f32<T>(v1);
      }
    }
}

// ---- launch -----------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int PW>
void smem_bytes(int PS, int (&smem)[4]) {
  smem[0] = kStages * chunk_state_stage<T, PW>();
  smem[1] = kStages * cb_stage();
  smem[2] = kPassRows * (PS + 1) * 4;
  smem[3] = kStages * chunk_scan_stage<PW>();
}

template <typename T, int PW>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, void* y, float* state_out, double* cum, float* cb,
           float* states, int Bb, const Dims& d, int vec_x, int vec_bc,
           cudaStream_t stream) {
  int smem[4];
  smem_bytes<T, PW>(d.PS, smem);
  const T* xt = static_cast<const T*>(x);
  const int T64 = d.QP / kBM;
  const unsigned bhc = (unsigned)Bb * d.H * d.nc;
  int err = set_smem(ssd_chunk_state<T, PW>, smem[0]);
  if (err) return err;
  ssd_chunk_state<T, PW><<<dim3(bhc, (d.N + kBM - 1) / kBM), kThreads,
                           smem[0], stream>>>(xt, dt, A, Bm, cum, states, d,
                                              vec_x, vec_bc);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(ssd_cb, smem[1]))) return err;
  ssd_cb<<<dim3((unsigned)Bb * d.nc * d.G * (T64 * (T64 + 1) / 2)), kThreads,
           smem[1], stream>>>(Bm, Cm, cb, d, vec_bc);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(ssd_state_pass, smem[2]))) return err;
  ssd_state_pass<<<dim3((unsigned)Bb * d.H, (d.N + kPassRows - 1) / kPassRows),
                   kThreads, smem[2], stream>>>(states, cum, state_out, d);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(ssd_chunk_scan<T, PW>, smem[3]))) return err;
  ssd_chunk_scan<T, PW><<<dim3(bhc, T64), kThreads, smem[3], stream>>>(
      xt, dt, Cm, cb, cum, states, static_cast<T*>(y), d, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, void* y, float* state_out, double* cum,
             float* cb, float* states, int Bb, const Dims& d, int vec_x,
             int vec_bc, cudaStream_t s) {
  if (d.P <= 64)
    return launch<T, 64>(x, dt, A, Bm, Cm, y, state_out, cum, cb, states, Bb,
                         d, vec_x, vec_bc, s);
  return launch<T, 128>(x, dt, A, Bm, Cm, y, state_out, cum, cb, states, Bb,
                        d, vec_x, vec_bc, s);
}

}  // namespace

// x (Bb, S, H, P) in dtype (0 float32, 1 bfloat16) read through the element
// strides x_strides = (batch, seq, head), its p stride 1; y (Bb, S, H, P)
// contiguous in the same dtype; dt (Bb, S, H), A (H,), B/C (Bb, S, G, N)
// float32 contiguous; state_out (Bb, H, P, N) float32. Scratch, allocated by
// the caller: cum (Bb, H, nc, QP) float64, cb (Bb, nc, G, QP, QP) float32,
// states (Bb, H, nc, N, PS) float32. plan = (Q, QP, nc, PS). vec_x /
// vec_bc: x / B and C may be read by 16-byte copies. Returns 0, a CUDA error
// of a launch, or cudaErrorInvalidValue.
extern "C" int ssd_scan_launch(const void* x, const long long* x_strides,
                               const float* dt, const float* A,
                               const float* Bm, const float* Cm, void* y,
                               float* state_out, double* cum, float* cb,
                               float* states, int dtype, int Bb, int S, int H,
                               int P, int G, int N, const int* plan,
                               int vec_x, int vec_bc, void* stream) {
  if (P < 1 || P > 128 || N < 1 || G < 1 || H % G != 0 || Bb < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  Dims d{S,       H,       G,       N,       P,
         plan[0], plan[1], plan[2], plan[3], x_strides[0],
         x_strides[1], x_strides[2]};
  if (d.Q < 1 || d.QP % kBM || d.QP < d.Q || d.PS % 4 || d.PS < P ||
      d.nc != (S + d.Q - 1) / d.Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, dt, A, Bm, Cm, y, state_out, cum, cb, states,
                           Bb, d, vec_x, vec_bc, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state_out, cum, cb,
                                   states, Bb, d, vec_x, vec_bc, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the four passes (chunk states, C B^T,
// state passing, chunk scan) for x of dtype and P columns, into smem[4].
// Returns 0, or cudaErrorInvalidValue.
extern "C" int ssd_scan_smem(int dtype, int P, int* smem) {
  if (P < 1 || P > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int PS = (P + 3) / 4 * 4;
  int s[4];
  if (dtype == 0 && P <= 64)
    smem_bytes<float, 64>(PS, s);
  else if (dtype == 0)
    smem_bytes<float, 128>(PS, s);
  else if (P <= 64)
    smem_bytes<__nv_bfloat16, 64>(PS, s);
  else
    smem_bytes<__nv_bfloat16, 128>(PS, s);
  for (int i = 0; i < 4; ++i) smem[i] = s[i];
  return 0;
}
