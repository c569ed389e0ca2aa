// Device helpers shared by the attention kernels (paged_decode.cu,
// paged_verify.cu, flash_attention.cu): conversion between the storage
// dtypes (fp32, bf16) and fp32, warp reductions, cp.async, and the combine
// pass of a split-KV paged kernel. build.library_path hashes every header
// of this directory into each library's name, so an edit here rebuilds them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

constexpr float kNegInf = -2.0e38f;   // the JAX package's finite NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The four 32-bit words of a 16-byte vector as fp32 values of type T:
// four floats, or eight bf16 (low half first).
__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ void store_vec(const uint4& x, float* dst) {
  constexpr int kPer = 4 / sizeof(T);      // values per 32-bit word
  unpack(x.x, dst, T());
  unpack(x.y, dst + kPer, T());
  unpack(x.z, dst + 2 * kPer, T());
  unpack(x.w, dst + 3 * kPer, T());
}

// Two neighbouring elements as fp32 (4- or 8-byte aligned).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with `valid`
// false nothing is read and the 16 bytes are zero-filled (src-size 0), so
// `src` need only be some valid address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Live pages of a sequence of `len` tokens with a table `npg` wide: only
// entries j < ceil(len / page) are ever read (the rest may be garbage).
__device__ __forceinline__ int live_pages(int len, int page, int npg) {
  return min((len + page - 1) / page, npg);
}

// The combine pass of a split-KV paged attention kernel. Split s of
// (sequence b, KV head kvh) covered live pages [s*chunk, (s+1)*chunk) and
// left, for each of its R = G*Q rows (row r = g*Q + qi), its running max m,
// denominator l and unnormalised output acc (fp32) at
//   part_acc[(((b*K + kvh)*n_split + s)*R + r)*hd + d]
//   part_ml [(((b*K + kvh)*n_split + s)*R + r)*2 + {0: m, 1: l}].
// One thread per output element (grid ceil(B*K*R*hd / 256) blocks of 256)
// visits only the live splits s < ceil(n_live / chunk), which every split
// kernel wrote (a split past the live pages exits before writing, and its
// unwritten scratch is never read), in a fixed order, so a run gives the
// same bits every time:
//   M = max_s m_s, starting from split 0's m, never from -inf;
//   out = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30).
// A split whose positions all lie past row r's causal limit left m_s =
// -2e38 (the finite mask), l_s = its slot count and acc_s = its sum of v:
// all finite, and weighted by exp(-2e38 - M) = 0, since split 0 holds
// position 0, which every row sees, so M is a real score. The output goes
// to out[((b*Q + qi)*H + kvh*G + g)*hd + d] in T (Q = 1 is the decode
// layout (B, H, hd)).
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
split_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int32_t* __restrict__ lens, T* __restrict__ out,
                     int B, int Q, int H, int K, int hd, int page, int npg,
                     int chunk, int n_split) {
  const int G = H / K;
  const int R = G * Q;
  const size_t e = (size_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (e >= (size_t)B * K * R * hd) return;
  const int d = (int)(e % hd);
  const size_t row = e / hd;             // ((b*K + kvh)*R + r)
  const int r = (int)(row % R);
  const int kvh = (int)(row / R % K);
  const int b = (int)(row / R / K);
  const int g = r / Q;
  const int qi = r - g * Q;
  const int n_sp = (live_pages(lens[b], page, npg) + chunk - 1) / chunk;
  const size_t first = ((size_t)b * K + kvh) * n_split * R + r;  // split 0
  float res = 0.f;
  if (n_sp > 0) {
    // (unrolled, so the loads of several splits are in flight together)
    float M = part_ml[2 * first];
#pragma unroll 4
    for (int s = 1; s < n_sp; ++s)
      M = fmaxf(M, part_ml[2 * (first + (size_t)s * R)]);
    float num = 0.f, den = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_sp; ++s) {
      const size_t at = first + (size_t)s * R;
      const float w = expf(part_ml[2 * at] - M);
      num += w * part_acc[at * hd + d];
      den += w * part_ml[2 * at + 1];
    }
    res = num / fmaxf(den, 1e-30f);
  }
  out[(((size_t)b * Q + qi) * H + (size_t)kvh * G + g) * hd + d] =
      from_f32<T>(res);
}
