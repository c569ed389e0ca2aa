// Dense flash attention (FlashAttention-2 forward, causal or full, GQA) for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_kernel` at :25, pallas_call
// at :84).
//
//   q    (B, H, S, hd)   bf16 or fp32
//   k, v (B, K, T, hd)   same dtype, H % K == 0; query head h reads KV head
//                        h / (H/K)
//   out  (B, H, S, hd)   q's dtype
//
// Math, as the Pallas body: scores in fp32 from the inputs upcast, times
// hd**-0.5 after the product; with `causal` the ABSOLUTE mask row >= col
// (no offset when S != T), masked with the finite -2e38 (with -inf,
// (-inf) - (-inf) would be NaN); the online softmax state (m, l, acc) in
// fp32, carried over the KV tiles in order; each tile's probabilities cast
// to v's dtype before the PV product, which accumulates in fp32; out =
// acc / max(l, 1e-30) cast to q's dtype.
//
// Design. The TPU walks a (batch, head, q-block, kv-block) grid with 128 x
// 128 tiles and the kv axis sequential, the state in VMEM scratch. Here one
// block owns one (batch, head, 64-query tile) and walks the KV tiles of 64
// keys in order itself: the state never leaves the block, and no partial
// softmax is combined across blocks. The q, K and V tiles are staged in
// shared memory as fp32 (q and K rows padded by one float, so the score loop
// reads them without bank conflicts), 115 KB at hd 128; the 128 x 128 fp32
// tiles of the TPU (192 KB for q, k and v alone) would not leave room for
// the score tile. 256 threads as a 16 x 16 grid: thread (ty, tx) owns query
// rows ty + 16i (i < 4), score columns tx + 16j (j < 4) and output columns
// tx + 16c (c < hd/16); a row's 16 threads are one half-warp, so its max and
// sum are five shuffles. Every row's first KV tile holds column 0, which no
// mask hides, so the running max never starts on masked scores alone;
// tiles wholly above the diagonal are skipped, and the query tiles are
// launched last-first so the longest causal walks start first. Rows and
// columns past S and T are zero-filled and masked; offsets are 64-bit.
//
// Bound on an H100 SXM: operations. 4 * hd flops per (query, key) pair a
// head attends (the QK and PV products) against reading q, K, V and writing
// out once: at B=1, S=T=2048, H=32, hd=128 causal, 34.4 GFLOP against 42 MB,
// far above the ~295 flop/byte ridge in bf16. This first kernel runs those
// flops as fp32 FMAs from shared memory (the card's 67 TFLOP/s fp32 rate is
// its ceiling, not the 989 TFLOP/s of bf16 tensor cores); mma / wgmma for
// the two products are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per KV tile
constexpr float kNegInf = -2.0e38f;   // the JAX package's finite NEG_INF

// x rounded to T and back: the probabilities' cast to v's dtype.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Stage a tile of 64 rows x HD elements starting at `src` (rows of HD
// contiguous elements) into shared memory as fp32 with row stride `ld`;
// rows at or past `valid` are zero. Neighbouring threads take neighbouring
// elements, so the reads coalesce and the writes hit distinct banks.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int valid, int tid) {
  static_assert(kBQ == kBK, "one staging shape for q, K and V tiles");
  const int n = min(valid, kBQ) * HD;
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    dst[r * ld + (e - r * HD)] = e < n ? to_f32(src[e]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int S, int T_len, int causal, float scale) {
  constexpr int kLd = HD + 1;         // q and K row stride in shared memory
  constexpr int kCols = HD / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // (kBQ, kLd)
  float* ks = qs + kBQ * kLd;         // (kBK, kLd)
  float* vs = ks + kBK * kLd;         // (kBK, HD)
  float* ps = vs + kBK * HD;          // (kBQ, kBK + 1) probabilities

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);

  const T* qb = q + ((size_t)b * H + h) * S * HD;
  const T* kb = k + ((size_t)b * K + kvh) * T_len * HD;
  const T* vb = v + ((size_t)b * K + kvh) * T_len * HD;
  stage<T, HD>(qs, kLd, qb + (size_t)q0 * HD, S - q0, tid);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    // the last row of this tile that exists sees columns up to itself
    const int last_row = min(q0 + kBQ, S) - 1;
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                  // the previous tile's reads are done
    stage<T, HD>(ks, kLd, kb + (size_t)k0 * HD, T_len - k0, tid);
    stage<T, HD>(vs, HD, vb + (size_t)k0 * HD, T_len - k0, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < T_len && (!causal || row >= col);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                  // the probability tile is complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[(size_t)row * HD + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (hd + 1) + (size_t)kBK * hd +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int T_len, int causal, float scale,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = smem_bytes(HD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, S, T_len, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int S, int T_len, int hd, int causal, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, S, T_len, causal,
                                  scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, S, T_len, causal,
                                  scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, S, T_len, causal,
                                  scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, S, T_len, causal,
                                    scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16; hd in {16, 32, 64, 128}. Returns
// cudaGetLastError() after the launch.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int B, int H, int K,
                           int S, int T_len, int hd, int causal, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, H, K, S, T_len, hd,
                                    causal, scale, s);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, H, K, S, T_len, hd, causal,
                            scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
