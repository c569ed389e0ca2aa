// Device helpers shared by the attention kernels (paged_decode.cu,
// paged_verify.cu, flash_attention.cu): conversion between the storage
// dtypes (fp32, bf16) and fp32, warp reductions, cp.async, and the combine
// pass of a split-KV paged kernel. build.library_path hashes every header
// of this directory into each library's name, so an edit here rebuilds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// The combine pass of a split-KV paged attention kernel (paged_decode.cu
// at Q = 1, paged_verify.cu). Split s of (sequence b, KV head kvh) covered
// live pages [s*chunk, (s+1)*chunk) and left, for each of its R = G*Q rows
// (row r = g*Q + qi), its running max m, denominator l and unnormalised
// output acc (fp32) at
//   part_acc[(((b*K + kvh)*n_split + s)*R + r)*hd + d]
//   part_ml [(((b*K + kvh)*n_split + s)*R + r)*2 + {0: m, 1: l}].
// Only the live splits s < ceil(n_live / chunk) wrote theirs (a split past
// the live pages exits before writing). One warp per output row
// (b*K + kvh)*R + r. The work is a chain of round trips to L2, so they are
// issued together: a lane reads lens[b], split `lane`'s (m, l) and its 4
// (or 8) columns of the first kPre splits' acc before knowing which splits
// are live (a dead split's garbage is read and never used: it is selected
// away, not multiplied by 0, since 0 * NaN is NaN). Then, over the live
// splits in split order:
//   M = max_s m_s;  den = sum_s exp(m_s - M) l_s;
//   out = sum_s exp(m_s - M) acc_s / max(den, 1e-30).
// A split whose positions all lie past row r's causal limit left m_s =
// -2e38 (the finite mask), l_s = its slot count and acc_s = its sum of v:
// all finite, and weighted by exp(-2e38 - M) = 0, since split 0 holds
// position 0, which every row sees, so M is a real score. No atomics: a run
// gives the same bits every time. The output goes to
// out[((b*Q + qi)*H + kvh*G + g)*hd + d] in T (Q = 1 is the decode layout
// (B, H, hd)); hd <= 256. kOneQuery fixes Q = 1 at compile time, the decode
// kernel's case, which also gives the two callers' combines distinct names
// in a profile.
constexpr int kCombineWarps = 8;
constexpr int kPre = 16;             // splits whose acc a lane loads up front

template <typename T, bool kOneQuery>
__global__ void __launch_bounds__(kCombineWarps * 32)
split_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int32_t* __restrict__ lens, T* __restrict__ out,
                     int B, int n_q, int H, int K, int hd, int page, int npg,
                     int chunk, int n_split) {
  const int Q = kOneQuery ? 1 : n_q;
  const int G = H / K;
  const int R = G * Q;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (row >= (size_t)B * K * R) return;  // row = (b*K + kvh)*R + r
  const int r = (int)(row % R);
  const int kvh = (int)(row / R % K);
  const int b = (int)(row / R / K);
  const size_t first = row / R * n_split * R + r;  // split 0's row
  const float* ml = part_ml + 2 * first;           // split s at ml[2*s*R]
  const float* ac = part_acc + first * hd;         // split s at ac[s*R*hd]
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // one round trip: lens, the (m, l) of split `lane`, the first kPre
  // splits' acc (two groups of 4 columns a lane)
  const int len = lens[b];
  float m0 = kNegInf, l0 = 0.f;
  if (lane < n_split) {
    m0 = ml[2 * (size_t)lane * R];
    l0 = ml[2 * (size_t)lane * R + 1];
  }
  float4 pre[kPre][2];
#pragma unroll
  for (int s = 0; s < kPre; ++s)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int d = 4 * lane + 128 * k;
      pre[s][k] = s < n_split && d < hd
                      ? *reinterpret_cast<const float4*>(
                            ac + (size_t)s * R * hd + d)
                      : zero4;
    }

  const int n_sp = (live_pages(len, page, npg) + chunk - 1) / chunk;
  float M = lane < n_sp ? m0 : kNegInf;
  for (int s = lane + 32; s < n_sp; s += 32)
    M = fmaxf(M, ml[2 * (size_t)s * R]);
  M = warp_max(M);
  const float w0 = lane < n_sp ? expf(m0 - M) : 0.f;
  float den = lane < n_sp ? w0 * l0 : 0.f;
  for (int s = lane + 32; s < n_sp; s += 32)
    den += expf(ml[2 * (size_t)s * R] - M) * ml[2 * (size_t)s * R + 1];
  den = warp_sum(den);

  float4 num[2] = {zero4, zero4};
  auto add = [&](float w, const float4& x, int k) {
    num[k].x = fmaf(w, x.x, num[k].x);
    num[k].y = fmaf(w, x.y, num[k].y);
    num[k].z = fmaf(w, x.z, num[k].z);
    num[k].w = fmaf(w, x.w, num[k].w);
  };
#pragma unroll
  for (int s = 0; s < kPre; ++s) {
    const float w = __shfl_sync(0xffffffffu, w0, s);
    if (s < n_sp) {                  // (the same for the whole warp)
      add(w, pre[s][0], 0);
      add(w, pre[s][1], 1);
    }
  }
#pragma unroll 4
  for (int s = kPre; s < n_sp; ++s) {
    const float w = s < 32 ? __shfl_sync(0xffffffffu, w0, s)
                           : expf(ml[2 * (size_t)s * R] - M);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int d = 4 * lane + 128 * k;
      if (d < hd)
        add(w, *reinterpret_cast<const float4*>(ac + (size_t)s * R * hd + d),
            k);
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const int g = r / Q;
  const int qi = r - g * Q;
  T* o = out + (((size_t)b * Q + qi) * H + (size_t)kvh * G + g) * hd;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int d = 4 * lane + 128 * k;
    if (d < hd) {
      o[d] = from_f32<T>(num[k].x * inv);
      o[d + 1] = from_f32<T>(num[k].y * inv);
      o[d + 2] = from_f32<T>(num[k].z * inv);
      o[d + 3] = from_f32<T>(num[k].w * inv);
    }
  }
}

// Launch split_combine_kernel on `stream`: one warp per output row.
template <typename T, bool kOneQuery>
void launch_split_combine(const void* part_acc, const void* part_ml,
                          const void* lens, void* out, int B, int Q, int H,
                          int K, int hd, int page, int npg, int chunk,
                          int n_split, cudaStream_t stream) {
  const size_t rows = (size_t)B * Q * H;
  split_combine_kernel<T, kOneQuery>
      <<<(unsigned)((rows + kCombineWarps - 1) / kCombineWarps),
         kCombineWarps * 32, 0, stream>>>(
          static_cast<const float*>(part_acc),
          static_cast<const float*>(part_ml),
          static_cast<const int32_t*>(lens), static_cast<T*>(out), B, Q, H,
          K, hd, page, npg, chunk, n_split);
}
