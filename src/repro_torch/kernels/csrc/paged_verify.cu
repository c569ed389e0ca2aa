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
// Design: split-KV, two kernels per call. The TPU kernel walks a (batch,
// page) grid in order, carrying the softmax state in VMEM; on the card one
// block per (sequence, KV head) walked ~21 pages one after the other with
// four barriers per page, 32 blocks on 132 SMs at the captured verify step:
// latency, not bytes. Here the grid is (K, B, n_split): block (kvh, b, s)
// owns live pages [s*chunk, (s+1)*chunk) of sequence b and the R = G*Q query
// rows of KV head kvh (row r = g*Q + qi, as the Pallas body folds them). It
// reads its own lens[b] on the device; a block whose range starts at or past
// the live pages ceil(len/page) exits at once, and only live table entries
// are read, so an entry past the ragged edge is never dereferenced (on the
// card a garbage page id would be an illegal address). Its pages go through
// shared memory in rounds of `ppr` pages (64 slots of bf16 at hd 128, 16 KB
// of K and 16 KB of V): cp.async copies the next round into the other stage
// of a two-stage ring while this round is computed, so a round of 64 slots
// costs the four barriers one 16-slot page cost before. Slots past len or
// past the block's pages are zero-filled, so every value in the ring is
// finite. Per round the block does little arithmetic, so what bounds it is
// instructions: a score item is (4 rows, 1 slot), its K row read 16 bytes
// at a time once for the 4 rows, with no shuffle reduction (K and V rows
// are padded by 16 bytes, so neighbouring slots hit distinct banks); the
// online softmax takes one warp per row; a PV item is (4 rows, 2
// neighbouring columns), each V pair read once for the 4 rows and the
// probabilities four slots at a time, the accumulator in shared memory.
// The probabilities stay fp32 into the PV product, as in the Pallas body
// (paged_verify.py:80-88). The block writes its (m, l, acc) per row to fp32
// scratch that the wrapper allocates, and `split_combine_kernel`
// (common.cuh) merges the live splits in a fixed order, with no atomics.
//
// Split sizes (kernels/paged_verify.py `split_plan`, from the shapes and the
// card's SM count only, never from lens: reading lens on the host would cost
// the engine a device sync): chunk is a multiple of ppr, the smallest that
// keeps B*K*n_split within 4 blocks per SM (4 x 132 on an H100 SXM). At the captured verify step (B=4, K=8, NPG=32, lens
// 318-348) that is chunk = 4 pages, n_split = 8: 256 blocks, 184 live, each
// one round. A split writes R*hd*4 bytes of partials (8 KB at R=16, hd 128)
// for its 32 KB of bf16 K and V; the combine reads them back from L2, and
// at this step the kernel is bound by latency, not by those bytes.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each live K and V element is
// read once, sum_b len_b * K * hd * 2 * itemsize bytes, against 4*G*Q flops
// per element pair: at G=4, Q=4 that is 64 flops per pair, 16 per bf16
// byte, far under the ~295 flop/byte ridge. mma for the R x slots score
// tile is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;             // query rows per thread item

// Shared-memory row strides (elements): K and V rows padded by 16 bytes, so
// threads on neighbouring slots reading one 16-byte chunk hit distinct
// banks; p rows padded to a multiple of 4, so four slots read as a float4.
template <typename T> __host__ __device__ inline int kv_ld(int hd) {
  return hd + 16 / (int)sizeof(T);
}
__host__ __device__ inline int p_ld(int slots) { return (slots + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
paged_verify_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int32_t* __restrict__ table,
                          const int32_t* __restrict__ lens,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int Q, int H, int K,
                          int hd, int page, int npg, int ppr, int chunk,
                          float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int len = lens[b];
  const int n_live = live_pages(len, page, npg);
  const int p0 = sp * chunk;
  if (p0 >= n_live) return;          // past the live pages: nothing to do
  const int p1 = min(p0 + chunk, n_live);

  const int G = H / K;
  const int R = G * Q;               // query rows of this block, g*Q + qi
  const int n_rb = (R + kRows - 1) / kRows;   // row blocks of kRows rows
  const int Rp = n_rb * kRows;       // rows, padded
  const int SR = ppr * page;         // slots per round
  const int ldk = kv_ld<T>(hd);
  const int ldp = p_ld(SR);
  const int row_chunks = hd / kVec;  // 16-byte chunks per K/V row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  T* k_s = reinterpret_cast<T*>(smem_raw);      // (2, SR, ldk) raw ring
  T* v_s = k_s + 2 * SR * ldk;                  // (2, SR, ldk)
  float* q_s = reinterpret_cast<float*>(v_s + 2 * SR * ldk);  // (Rp, hd)
  float* acc = q_s + Rp * hd;        // (Rp, hd) unnormalised output
  float* p_s = acc + Rp * hd;        // (Rp, ldp) scores, then probabilities
  float* m_s = p_s + Rp * ldp;       // (Rp,) running max
  float* l_s = m_s + Rp;             // (Rp,) running denominator
  float* a_s = l_s + Rp;             // (Rp,) this round's rescale factor
  int32_t* bt_s = reinterpret_cast<int32_t*>(a_s + Rp);  // (p1 - p0,)

  // row r = g*Q + qi is query head kvh*G + g of candidate qi:
  // q[b, qi, kvh*G + g, :]; the padding rows are zero
  for (int r = warp; r < Rp; r += kWarps) {
    const int g = r / Q;
    const T* qr = q + (((size_t)b * Q + (r - g * Q)) * H +
                       (size_t)kvh * G + g) * hd;
    for (int d = lane; d < hd; d += 32) {
      q_s[r * hd + d] = r < R ? to_f32(qr[d]) : 0.f;
      acc[r * hd + d] = 0.f;
    }
    if (lane == 0) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
      a_s[r] = 1.f;
    }
  }
  // this split's live table entries only (p0 <= j < p1 <= ceil(len/page))
  const int32_t* bt = table + (size_t)b * npg;
  for (int j = p0 + tid; j < p1; j += kThreads) bt_s[j - p0] = bt[j];
  __syncthreads();

  const size_t slot_stride = (size_t)K * hd;
  const T* k_head = k_pages + (size_t)kvh * hd;
  const T* v_head = v_pages + (size_t)kvh * hd;
  // round i covers pages p0 + i*ppr .. ; a slot past len or past p1 is
  // zero-filled
  auto issue = [&](int i) {
    const int stage = i & 1;
    const uint32_t kd = smem_u32(k_s + (size_t)stage * SR * ldk);
    const uint32_t vd = smem_u32(v_s + (size_t)stage * SR * ldk);
    const int pr = p0 + i * ppr;
    for (int e = tid; e < SR * row_chunks; e += kThreads) {
      const int t = e / row_chunks;
      const int c = e - t * row_chunks;
      const int j = pr + t / page;
      const int slot = t - (t / page) * page;
      const bool ok = j < p1 && j * page + slot < len;
      const size_t off = ok ? ((size_t)bt_s[j - p0] * page + slot) *
                                      slot_stride + (size_t)c * kVec
                            : 0;
      const uint32_t so = (uint32_t)(t * ldk + c * kVec) * sizeof(T);
      cp_async16(kd + so, k_head + off, ok);
      cp_async16(vd + so, v_head + off, ok);
    }
    cp_async_commit();
  };

  const int n_rounds = (p1 - p0 + ppr - 1) / ppr;
  issue(0);
  for (int i = 0; i < n_rounds; ++i) {
    if (i + 1 < n_rounds)
      issue(i + 1);                  // the next round flies while this one
    else                             // is computed
      cp_async_commit();             // (an empty group keeps the count)
    cp_async_wait<1>();
    __syncthreads();
    const T* kt_s = k_s + (size_t)(i & 1) * SR * ldk;
    const T* vt_s = v_s + (size_t)(i & 1) * SR * ldk;
    const int base = (p0 + i * ppr) * page;    // position of slot 0
    const int end = min(p1 * page, len);       // first position not here

    // scores: one item per (row block, slot); its K row is read once, 16
    // bytes at a time, for the block's kRows query rows
    for (int it = tid; it < n_rb * SR; it += kThreads) {
      const int rb = it / SR;
      const int t = it - rb * SR;
      const float* q0 = q_s + rb * kRows * hd;
      const T* kr = kt_s + t * ldk;
      float a[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) a[j] = 0.f;
      for (int c = 0; c < row_chunks; ++c) {
        float kf[kVec];
        store_vec<T>(*reinterpret_cast<const uint4*>(kr + c * kVec), kf);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float4* qc =
              reinterpret_cast<const float4*>(q0 + j * hd + c * kVec);
#pragma unroll
          for (int x = 0; x < kVec / 4; ++x) {
            const float4 qv = qc[x];
            a[j] = fmaf(qv.x, kf[4 * x], a[j]);
            a[j] = fmaf(qv.y, kf[4 * x + 1], a[j]);
            a[j] = fmaf(qv.z, kf[4 * x + 2], a[j]);
            a[j] = fmaf(qv.w, kf[4 * x + 3], a[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = rb * kRows + j;
        // this query's causal edge: positions < len - Q + qi + 1
        const int limit = min(end, len - Q + r % Q + 1);
        if (r < R) p_s[r * ldp + t] = base + t < limit ? a[j] * scale
                                                       : kNegInf;
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < SR; t += 32) mx = fmaxf(mx, p_s[r * ldp + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < SR; t += 32) {
        const float p = expf(p_s[r * ldp + t] - m_new);
        p_s[r * ldp + t] = p;
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

    // PV: one item per (row block, two neighbouring output columns); each
    // V pair is read once for the block's kRows rows, and their
    // probabilities four slots at a time
    const int half = hd / 2;
    for (int it = tid; it < n_rb * half; it += kThreads) {
      const int rb = it / half;
      const int d = 2 * (it - rb * half);
      const int r0 = rb * kRows;
      float x[kRows][2];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float al = a_s[r0 + j];
        x[j][0] = acc[(r0 + j) * hd + d] * al;
        x[j][1] = acc[(r0 + j) * hd + d + 1] * al;
      }
      int t = 0;
      for (; t + 4 <= SR; t += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = load_pair(vt_s + (t + u) * ldk + d);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float4 p =
              *reinterpret_cast<const float4*>(p_s + (r0 + j) * ldp + t);
          x[j][0] = fmaf(p.x, v[0].x, x[j][0]);
          x[j][1] = fmaf(p.x, v[0].y, x[j][1]);
          x[j][0] = fmaf(p.y, v[1].x, x[j][0]);
          x[j][1] = fmaf(p.y, v[1].y, x[j][1]);
          x[j][0] = fmaf(p.z, v[2].x, x[j][0]);
          x[j][1] = fmaf(p.z, v[2].y, x[j][1]);
          x[j][0] = fmaf(p.w, v[3].x, x[j][0]);
          x[j][1] = fmaf(p.w, v[3].y, x[j][1]);
        }
      }
      for (; t < SR; ++t) {
        const float2 v = load_pair(vt_s + t * ldk + d);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float p = p_s[(r0 + j) * ldp + t];
          x[j][0] = fmaf(p, v.x, x[j][0]);
          x[j][1] = fmaf(p, v.y, x[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        acc[(r0 + j) * hd + d] = x[j][0];
        acc[(r0 + j) * hd + d + 1] = x[j][1];
      }
    }
    __syncthreads();   // this stage is free for round i + 2's copies
  }

  // this split's partial: (m, l) and acc per row, fp32
  const size_t first = (((size_t)b * K + kvh) * n_split + sp) * R;
  for (int e = tid; e < R * hd; e += kThreads)
    part_acc[first * hd + e] = acc[e];
  for (int r = tid; r < R; r += kThreads) {
    part_ml[2 * (first + r)] = m_s[r];
    part_ml[2 * (first + r) + 1] = l_s[r];
  }
}

template <typename T>
size_t smem_bytes(int R, int hd, int page, int ppr, int chunk) {
  const size_t SR = (size_t)ppr * page;
  const size_t Rp = (size_t)(R + kRows - 1) / kRows * kRows;
  return 4 * SR * kv_ld<T>(hd) * sizeof(T) +
         sizeof(float) * (2 * Rp * hd + Rp * p_ld((int)SR) + 3 * Rp) +
         sizeof(int32_t) * (size_t)chunk;
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lens, void* part_acc,
           void* part_ml, void* out, int B, int Q, int H, int K, int hd,
           int page, int npg, int ppr, int chunk, int n_split, float scale,
           cudaStream_t stream) {
  auto kernel = paged_verify_split_kernel<T>;
  const size_t smem = smem_bytes<T>((H / K) * Q, hd, page, ppr, chunk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(K, B, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), Q, H, K, hd, page, npg, ppr, chunk,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_split_combine<T, false>(part_acc, part_ml, lens, out, B, Q, H, K, hd,
                                page, npg, chunk, n_split, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a split block needs, in bytes (the wrapper checks it
// against the card's 227 KB per block before launching).
size_t paged_verify_smem_bytes(int Q, int H, int K, int hd, int page,
                               int ppr, int chunk, int itemsize) {
  const int R = (H / K) * Q;
  return itemsize == 2 ? smem_bytes<__nv_bfloat16>(R, hd, page, ppr, chunk)
                       : smem_bytes<float>(R, hd, page, ppr, chunk);
}

// dtype: 0 = fp32, 1 = bf16. part_acc: (B, K, n_split, G*Q, hd) fp32 and
// part_ml: (B, K, n_split, G*Q, 2) fp32 scratch. Launches the split kernel
// and the combine; returns cudaGetLastError() after them.
int paged_verify_launch(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* table,
                        const void* lens, void* part_acc, void* part_ml,
                        void* out, int B, int Q, int H, int K, int hd,
                        int page, int npg, int ppr, int chunk, int n_split,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, part_acc,
                                 part_ml, out, B, Q, H, K, hd, page, npg, ppr,
                                 chunk, n_split, scale, s);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lens, part_acc, part_ml,
                         out, B, Q, H, K, hd, page, npg, ppr, chunk, n_split,
                         scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
