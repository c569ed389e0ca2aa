// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `paged_decode` of src/repro/kernels/paged_decode.py
// (body `_kernel`, pallas_call at :122): single-query GQA attention of one
// decode step over a paged KV pool, fp32 online softmax, scale hd**-0.5.
//
//   q        (B, H, hd)          bf16 or fp32
//   k_pages  (P, page, K, hd)    same dtype (one layer of the pool)
//   v_pages  (P, page, K, hd)
//   table    (B, NPG) int32      entries at or past ceil(len/page) are garbage
//   lens     (B,) int32 >= 1
//   out      (B, H, hd)          q's dtype
//
// Design. One block owns one (sequence, KV head) and its G = H/K query
// heads. The TPU kernel walks a (batch, page) grid in order and clamps its
// index map so steps past the ragged edge re-use the resident tile; here a
// block reads its own seq_lens[b], copies the live table entries j <
// ceil(len/page) into shared memory and loops over those pages only, so an
// entry past the edge is never dereferenced (on the card a garbage page id would be an
// illegal address). Each page's K and V tile for this head is read from
// device memory once, as 16-byte vectors into registers, while the previous
// page is being computed, then staged in shared memory as fp32 (slots at or
// past len zeroed, rows padded by four floats so the score loop reads
// without bank conflicts) and read there by all G heads. Scores take four
// threads per (head, slot); the online softmax takes one warp per head; the
// PV update takes one thread per (head, dim) output element, two at a time,
// its accumulator in shared memory. The probabilities stay fp32 into the PV
// product, as in the Pallas body (paged_decode.py:76-79).
//
// Bound on an H100 SXM (3.35 TB/s): the work is memory-bound — each live
// K and V element is read once, sum_b len_b * K * hd * 2 * itemsize bytes,
// against 4*G flops per element pair, well under the ~295 flop/byte ridge.
// This design reads that minimum (each page tile once per block, shared by
// the G heads) and keeps one page's loads in flight, but it walks a
// sequence's pages in order inside one block: B*K blocks (64 at B=8, K=8)
// fill under half of the 132 SMs, and each page costs four barriers of
// latency. Split-KV over pages (more blocks, and the second pass
// `split_combine_kernel` of common.cuh, as paged_verify.cu takes it), deeper
// cp.async/TMA pipelines and mma for the scores are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 4;            // threads per score

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
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    int H, int K, int hd, int page, int npg, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int ld = hd + 4;             // padded rows: conflict-free score reads
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* k_s = smem;                 // (page, ld)
  float* v_s = k_s + page * ld;      // (page, ld)
  float* q_s = v_s + page * ld;      // (G, hd)
  float* acc = q_s + G * hd;         // (G, hd) unnormalised output
  float* p_s = acc + G * hd;         // (G, page) scores, then probabilities
  float* m_s = p_s + G * page;       // (G,) running max
  float* l_s = m_s + G;              // (G,) running denominator
  float* a_s = l_s + G;              // (G,) this page's rescale factor
  int32_t* bt_s = reinterpret_cast<int32_t*>(a_s + G);  // (live pages,)

  const int len = lens[b];
  const int n_live = live_pages(len, page, npg);
  // the G query heads of KV head kvh are rows kvh*G .. kvh*G+G-1 of q[b]
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    q_s[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
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

    // scores: four neighbouring threads per (head, slot), each over every
    // fourth element of hd, summed by two shuffles (all lanes take part:
    // the trip count is the same for the whole block)
    for (int r0 = 0; r0 < G * page; r0 += kThreads / kParts) {
      const int r = r0 + tid / kParts;
      const int part = tid % kParts;
      float s0 = 0.f, s1 = 0.f;
      if (r < G * page) {
        const int g = r / page;
        const int t = r - g * page;
        const float* qg = q_s + g * hd + part;
        const float* kt = k_s + t * ld + part;
#pragma unroll 4
        for (int d = 0; d < hd; d += 2 * kParts) {   // hd % 8 == 0
          s0 += qg[d] * kt[d];
          s1 += qg[d + kParts] * kt[d + kParts];
        }
      }
      float s = s0 + s1;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (r < G * page && part == 0) {
        const int t = r % page;
        p_s[r] = base + t < len ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[g * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(p_s[g * page + t] - m_new);
        p_s[g * page + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: two output elements per thread at a time, two independent sums
    for (int e = tid; e < G * hd; e += 2 * kThreads) {
      const int e2 = e + kThreads;
      const bool two = e2 < G * hd;
      const int g = e / hd;
      const int d = e - g * hd;
      const int g2 = two ? e2 / hd : g;
      const int d2 = two ? e2 - g2 * hd : d;
      const float* pg = p_s + g * page;
      const float* pg2 = p_s + g2 * page;
      float a = acc[e] * a_s[g];
      float a2 = two ? acc[e2] * a_s[g2] : 0.f;
      for (int t = 0; t < page; ++t) {
        const float* vt = v_s + t * ld;
        a += pg[t] * vt[d];
        a2 += pg2[t] * vt[d2];
      }
      acc[e] = a;
      if (two) acc[e2] = a2;
    }
    __syncthreads();
  }

  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    ob[e] = from_f32<T>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lens, void* out, int B, int H,
           int K, int hd, int page, int npg, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), H, K, hd,
      page, npg, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch needs, in bytes (the wrapper checks it against the
// card's 227 KB per block before launching).
size_t paged_decode_smem_bytes(int H, int K, int hd, int page, int npg) {
  const int G = H / K;
  return sizeof(float) * (2 * (size_t)page * (hd + 4) + 2 * (size_t)G * hd +
                          (size_t)G * page + 3 * (size_t)G + (size_t)npg);
}

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
int paged_decode_launch(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* table,
                        const void* lens, void* out, int B, int H, int K,
                        int hd, int page, int npg, float scale, void* stream) {
  const size_t smem = paged_decode_smem_bytes(H, K, hd, page, npg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, out, B, H,
                                 K, hd, page, npg, scale, smem, s);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lens, out, B, H, K, hd,
                         page, npg, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
