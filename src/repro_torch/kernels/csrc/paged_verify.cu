// Paged multi-query verify attention for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel `paged_verify` of src/repro/kernels/paged_verify.py
// (body `_kernel` at :43, pallas_call at :130): the target model's half of
// draft-k/verify-1 speculative decoding. Q = k+1 candidate positions per
// sequence attend a paged KV pool in one call, GQA, fp32 online softmax,
// scale hd**-0.5, with a causal edge PER QUERY.
//
//   q        (B, Q, H, hd)       bf16 or fp32
//   k_pages  (P, page, K, hd)    same dtype (one layer of the pool)
//   v_pages  (P, page, K, hd)
//   table    (B, NPG) int32      entries at or past ceil(len/page) are garbage
//   lens     (B,) int32 >= Q     TOTAL valid tokens, the Q candidates included
//   out      (B, Q, H, hd)       q's dtype
//
// Query qi of sequence b sees positions < lens[b] - Q + qi + 1: the committed
// tokens, the candidates before it and itself. Head h = kvh*G + g.
//
// Design: paged_decode.cu's walk, widened to Q queries. One block owns one
// (sequence, KV head) and its R = G*Q query rows, row r = g*Q + qi, as the
// Pallas body folds them. The TPU kernel walks a (batch, page) grid in order
// and clamps its index map at the last live page; here a block reads its own
// lens[b], copies the live table entries j < ceil(len/page) (at most NPG)
// into shared memory and loops over those pages only, so an entry past the
// ragged edge is never dereferenced (on the card a garbage page id would be
// an illegal address). Each page's K and V tile for this head is read from
// device memory once, as 16-byte vectors into registers while the previous
// page is computed, then staged in shared memory as fp32 (slots at or past
// len zeroed, rows padded by four floats so the score loop reads without
// bank conflicts) and read there by all R rows: the Q candidates share every
// K/V byte. Scores take four threads per (row, slot) and mask at the row's
// own limit; the online softmax takes one warp per row; the PV update takes
// one thread per (row, dim) output element, two at a time, its accumulator
// in shared memory. Pages are visited in order and every row sees position 0
// (its limit is >= 1), so each row's first page holds a valid score and the
// finite -2e38 mask never enters the running max alone. The probabilities
// stay fp32 into the PV product, as in the Pallas body (paged_verify.py:
// 80-88).
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each live K and V element is
// read once, sum_b len_b * K * hd * 2 * itemsize bytes, against 4*G*Q flops
// per element pair: at G=4, Q=4 that is 64 flops per pair, 16 per bf16
// byte, still far under the ~295 flop/byte ridge. This design reads that
// minimum (each page tile once per block, shared by the G*Q rows) but, like
// paged_decode.cu, walks a sequence's pages in order inside one block: B*K
// blocks (64 at B=8, K=8) fill under half of the 132 SMs. Split-KV over
// pages and mma for the R x page score tile are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 4;            // threads per score
constexpr float kNegInf = -2.0e38f;   // the JAX package's finite NEG_INF

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One page's K and V rows for one head, in flight in registers: 16-byte
// vectors, at most kMaxVec of each per thread (page * hd * sizeof(T) <=
// 16 * kMaxVec * kThreads bytes; the wrapper checks it).
constexpr int kMaxVec = 2;

template <typename T>
__device__ __forceinline__ void load_tile(uint4 (&kr)[kMaxVec],
                                          uint4 (&vr)[kMaxVec],
                                          const T* kp, const T* vp, int base,
                                          int len, int hd, int page,
                                          size_t slot_stride, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  const int row_vecs = hd / kVec;
  const int nvec = page * row_vecs;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    kr[i] = make_uint4(0, 0, 0, 0);    // slots at or past len stay zero
    vr[i] = make_uint4(0, 0, 0, 0);
    const int v = tid + i * kThreads;
    if (v < nvec) {
      const int t = v / row_vecs;
      const int d = (v - t * row_vecs) * kVec;
      if (base + t < len) {
        kr[i] = *reinterpret_cast<const uint4*>(kp + t * slot_stride + d);
        vr[i] = *reinterpret_cast<const uint4*>(vp + t * slot_stride + d);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(const uint4 (&kr)[kMaxVec],
                                           const uint4 (&vr)[kMaxVec],
                                           float* k_s, float* v_s, int ld,
                                           int hd, int page, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  const int row_vecs = hd / kVec;
  const int nvec = page * row_vecs;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int v = tid + i * kThreads;
    if (v < nvec) {
      const int t = v / row_vecs;
      const int d = (v - t * row_vecs) * kVec;
      store_vec<T>(kr[i], k_s + t * ld + d);
      store_vec<T>(vr[i], v_s + t * ld + d);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    int Q, int H, int K, int hd, int page, int npg,
                    float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int R = G * Q;               // query rows of this block, g*Q + qi
  const int ld = hd + 4;             // padded rows: conflict-free score reads
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* k_s = smem;                 // (page, ld)
  float* v_s = k_s + page * ld;      // (page, ld)
  float* q_s = v_s + page * ld;      // (R, hd)
  float* acc = q_s + R * hd;         // (R, hd) unnormalised output
  float* p_s = acc + R * hd;         // (R, page) scores, then probabilities
  float* m_s = p_s + R * page;       // (R,) running max
  float* l_s = m_s + R;              // (R,) running denominator
  float* a_s = l_s + R;              // (R,) this page's rescale factor
  int32_t* bt_s = reinterpret_cast<int32_t*>(a_s + R);  // (live pages,)

  const int len = lens[b];
  const int n_live = min((len + page - 1) / page, npg);
  // row r = g*Q + qi is query head kvh*G + g of candidate qi:
  // q[b, qi, kvh*G + g, :]
  for (int e = tid; e < R * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const int g = r / Q;
    const int qi = r - g * Q;
    q_s[e] = to_f32(q[(((size_t)b * Q + qi) * H + (size_t)kvh * G + g) * hd
                      + d]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // the live table entries only (j < ceil(len / page)); never the garbage
  // past the ragged edge
  const int32_t* bt = table + (size_t)b * npg;
  for (int j = tid; j < n_live; j += kThreads) bt_s[j] = bt[j];
  __syncthreads();

  const size_t slot_stride = (size_t)K * hd;
  const T* k_head = k_pages + (size_t)kvh * hd;
  const T* v_head = v_pages + (size_t)kvh * hd;
  uint4 kr[kMaxVec], vr[kMaxVec];
  if (n_live > 0) {
    const size_t tile = (size_t)bt_s[0] * page * slot_stride;
    load_tile(kr, vr, k_head + tile, v_head + tile, 0, len, hd, page,
              slot_stride, tid);
  }
  for (int j = 0; j < n_live; ++j) {
    const int base = j * page;
    store_tile<T>(kr, vr, k_s, v_s, ld, hd, page, tid);
    __syncthreads();
    if (j + 1 < n_live) {
      // the next live page's loads fly while this page is computed
      const size_t tile = (size_t)bt_s[j + 1] * page * slot_stride;
      load_tile(kr, vr, k_head + tile, v_head + tile, base + page, len, hd,
                page, slot_stride, tid);
    }

    // scores: four neighbouring threads per (row, slot), each over every
    // fourth element of hd, summed by two shuffles (all lanes take part:
    // the trip count is the same for the whole block)
    for (int s0 = 0; s0 < R * page; s0 += kThreads / kParts) {
      const int s_i = s0 + tid / kParts;
      const int part = tid % kParts;
      float a0 = 0.f, a1 = 0.f;
      if (s_i < R * page) {
        const int r = s_i / page;
        const int t = s_i - r * page;
        const float* qr = q_s + r * hd + part;
        const float* kt = k_s + t * ld + part;
#pragma unroll 4
        for (int d = 0; d < hd; d += 2 * kParts) {   // hd % 8 == 0
          a0 += qr[d] * kt[d];
          a1 += qr[d + kParts] * kt[d + kParts];
        }
      }
      float s = a0 + a1;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (s_i < R * page && part == 0) {
        const int r = s_i / page;
        const int t = s_i - r * page;
        const int limit = len - Q + (r % Q) + 1;   // this query's causal edge
        p_s[s_i] = base + t < limit ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[r * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(p_s[r * page + t] - m_new);
        p_s[r * page + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // PV: two output elements per thread at a time, two independent sums
    for (int e = tid; e < R * hd; e += 2 * kThreads) {
      const int e2 = e + kThreads;
      const bool two = e2 < R * hd;
      const int r = e / hd;
      const int d = e - r * hd;
      const int r2 = two ? e2 / hd : r;
      const int d2 = two ? e2 - r2 * hd : d;
      const float* pr = p_s + r * page;
      const float* pr2 = p_s + r2 * page;
      float a = acc[e] * a_s[r];
      float a2 = two ? acc[e2] * a_s[r2] : 0.f;
      for (int t = 0; t < page; ++t) {
        const float* vt = v_s + t * ld;
        a += pr[t] * vt[d];
        a2 += pr2[t] * vt[d2];
      }
      acc[e] = a;
      if (two) acc[e2] = a2;
    }
    __syncthreads();
  }

  __syncthreads();
  for (int e = tid; e < R * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const int g = r / Q;
    const int qi = r - g * Q;
    out[(((size_t)b * Q + qi) * H + (size_t)kvh * G + g) * hd + d] =
        from_f32<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lens, void* out, int B, int Q,
           int H, int K, int hd, int page, int npg, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_verify_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), Q, H, K, hd,
      page, npg, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch needs, in bytes (the wrapper checks it against the
// card's 227 KB per block before launching).
size_t paged_verify_smem_bytes(int Q, int H, int K, int hd, int page,
                               int npg) {
  const size_t R = (size_t)(H / K) * Q;
  return sizeof(float) * (2 * (size_t)page * (hd + 4) + 2 * R * hd +
                          R * page + 3 * R + (size_t)npg);
}

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
int paged_verify_launch(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* table,
                        const void* lens, void* out, int B, int Q, int H,
                        int K, int hd, int page, int npg, float scale,
                        void* stream) {
  const size_t smem = paged_verify_smem_bytes(Q, H, K, hd, page, npg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, out, B, Q,
                                 H, K, hd, page, npg, scale, smem, s);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lens, out, B, Q, H, K,
                         hd, page, npg, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
