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
// Bound on an H100 SXM (3.35 TB/s): memory. Each live K and V element is
// read once, sum_b len_b * K * hd * 2 * itemsize bytes, against 4*G flops
// per element pair (16 at G = 4), far under the ~295 flop/byte ridge; so
// no tensor cores (their 64-row tiles would be 1/16 full at G = 4). At a
// decode step the bytes are few (5.5 MB at B=4, ~330 tokens, K=8, hd 128,
// bf16: 1.6 us), so what costs is latency: how many blocks are in flight,
// how many dependent round trips a block makes before its first copy, and
// how many barriers per byte it pays.
//
// Design: split-KV, two kernels per call. The TPU kernel walks a (batch, page)
// grid in order; one block per (sequence, KV head) walking its pages in order
// would fill 32 of 132 SMs at B=4, K=8. Here the grid is (K, B, n_split): block
// (kvh, b, s) owns live pages [s*chunk, (s+1)*chunk) of sequence b for the G =
// H/K query heads of KV head kvh. In its first round trip it reads lens[b], its
// chunk's table entries (in bounds of the table row whatever their contents)
// and q together; only then does it mask: a block whose range starts at or past
// the live pages ceil(len/page) exits, and an entry at or past them is never
// dereferenced (on the card a garbage page id would be an illegal address). Its
// pages go through shared memory in rounds of `ppr` pages (32 slots of bf16 at
// hd 128, 8 KB of K and 8 KB of V): cp.async 16-byte copies straight into a
// three-stage ring of raw K/V rows (padded by 16 bytes, so neighbouring slots
// hit distinct banks; as many stages as the block has rounds, if fewer), two
// rounds in flight while one is computed, three barriers per round. Slots past
// len or past the block's pages are zero-filled, so every value in the ring is
// finite. Scores: four lanes per slot (lane / 8 picks the quarter of hd, so the
// eight lanes of a shared-memory phase read eight slots), each lane's K chunk
// read once for a block of 4 query rows (all G = 4 heads at once), two shuffles
// to sum the quarters. Softmax: one warp per row. PV: an item is (4 rows, 2
// neighbouring columns, one of n_sg slot groups), each V pair read once for the
// 4 rows; the groups keep their own accumulators in shared memory and are
// summed once, in a fixed order, at the block's end. The probabilities stay
// fp32 into the PV product, as in the Pallas body (paged_decode.py:72-79). The
// block writes its (m, l, acc) per row to fp32 scratch that the wrapper
// allocates, and `split_combine_kernel` (common.cuh, shared with paged_verify)
// merges the live splits at Q = 1, one warp per output row and one round trip
// to memory for up to 16 splits, with no atomics.
// (Merging in the split kernel instead, by the last split to arrive on a
// counter, was slower at a decode step on an H100: the merge then sits on the
// critical path behind the fence and the atomic; see PERF.md.)
//
// Split sizes (kernels/paged_decode.py `split_plan` with decode's limits,
// from the shapes and the card's SM count only, never from lens: reading
// lens on the host would cost the engine a device sync): chunk is a
// multiple of ppr, the smallest that keeps B*K*n_split within 8 blocks per
// SM. At a captured decode step (B=4, K=8, NPG=32, bf16, ~21 live pages a
// row) that is ppr = 2, chunk = 2, n_split = 16: 512 blocks, ~350 with
// work, each one round; at B=8 with lens up to 3001 (NPG 188) chunk = 12,
// n_split = 16: 1024 blocks, each up to six rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;             // query rows per thread item
constexpr int kParts = 4;            // lanes per score (quarters of hd)
constexpr int kSlotsPerWarp = 32 / kParts;
constexpr int kStages = 3;           // ring depth: two rounds in flight

// Shared-memory row strides (elements): K and V rows padded by 16 bytes;
// p rows padded to a multiple of 4, so four slots read as a float4.
template <typename T> __host__ __device__ inline int kv_ld(int hd) {
  return hd + 16 / (int)sizeof(T);
}
__host__ __device__ inline int p_ld(int slots) { return (slots + 3) & ~3; }

// Ring stages a block allocates: kStages, or as many as its chunk has
// rounds (a stage past them would never be touched), so that blocks of
// one round take a third of the shared memory and more of them fit an SM.
__host__ __device__ inline int ring_stages(int rounds) {
  return rounds < kStages ? rounds : kStages;
}

// PV slot groups: enough (4 rows, 2 columns) items for the block's threads.
__host__ __device__ inline int n_groups(int n_rb, int hd) {
  const int n = kThreads / (n_rb * (hd / 2));
  return n > 1 ? n : 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int32_t* __restrict__ table,
                          const int32_t* __restrict__ lens,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int K, int hd,
                          int page, int npg, int ppr, int chunk,
                          float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = H / K;
  const int n_rb = (G + kRows - 1) / kRows;   // row blocks of kRows rows
  const int Rp = n_rb * kRows;       // rows, padded
  const int SR = ppr * page;         // slots per round
  const int ldk = kv_ld<T>(hd);
  const int ldp = p_ld(SR);
  const int row_chunks = hd / kVec;  // 16-byte chunks per K/V row
  const int n_cp = hd / 2;           // PV column pairs
  const int n_sg = n_groups(n_rb, hd);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int n_st = ring_stages(chunk / ppr);
  T* k_s = reinterpret_cast<T*>(smem_raw);      // (n_st, SR, ldk) ring
  T* v_s = k_s + n_st * SR * ldk;               // (n_st, SR, ldk)
  float* q_s = reinterpret_cast<float*>(v_s + n_st * SR * ldk);  // (Rp, hd)
  float* acc = q_s + Rp * hd;        // (n_sg, Rp, hd) unnormalised output
  float* p_s = acc + n_sg * Rp * hd; // (Rp, ldp) scores, then probabilities
  float* m_s = p_s + Rp * ldp;       // (Rp,) running max
  float* l_s = m_s + Rp;             // (Rp,) running denominator
  float* a_s = l_s + Rp;             // (Rp,) this round's rescale factor
  int32_t* bt_s = reinterpret_cast<int32_t*>(a_s + Rp);  // (chunk,)

  // one round trip: lens[b], this split's table entries (in bounds of the
  // row, whatever they hold) and q, all loads in flight together
  const int p0 = sp * chunk;
  const int len = lens[b];
  const int32_t* bt = table + (size_t)b * npg;
  for (int j = tid; j < chunk; j += kThreads)
    bt_s[j] = p0 + j < npg ? bt[p0 + j] : 0;
  // the G query heads of KV head kvh are rows kvh*G .. kvh*G+G-1 of q[b],
  // read 16 bytes at a time; the padding rows are zero
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int v = tid; v < Rp * row_chunks; v += kThreads) {
    uint4 w = make_uint4(0, 0, 0, 0);
    if (v < G * row_chunks) w = *reinterpret_cast<const uint4*>(qb + v * kVec);
    store_vec<T>(w, q_s + v * kVec);
  }
  for (int e = tid; e < n_sg * Rp * hd; e += kThreads) acc[e] = 0.f;
  for (int r = tid; r < Rp; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    a_s[r] = 1.f;
  }
  // the padding rows' probabilities (never scored) stay zero
  for (int e = G * ldp + tid; e < Rp * ldp; e += kThreads) p_s[e] = 0.f;
  const int n_live = live_pages(len, page, npg);
  if (p0 >= n_live) return;          // past the live pages: nothing to do
  const int p1 = min(p0 + chunk, n_live);   // entries >= p1 stay unread
  __syncthreads();

  const size_t slot_stride = (size_t)K * hd;
  const T* k_head = k_pages + (size_t)kvh * hd;
  const T* v_head = v_pages + (size_t)kvh * hd;
  // round i covers pages p0 + i*ppr .. ; a slot past len or past p1 is
  // zero-filled
  auto issue = [&](int i) {
    const int stage = i % kStages;
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
  };

  const int n_rounds = (p1 - p0 + ppr - 1) / ppr;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_rounds) issue(i);
    cp_async_commit();               // (an empty group keeps the count)
  }
  for (int i = 0; i < n_rounds; ++i) {
    cp_async_wait<kStages - 2>();    // round i has landed (for this thread)
    __syncthreads();                 // ... for all; round i-1 is done with
    if (i + kStages - 1 < n_rounds)  // its stage, which round i+2 now takes
      issue(i + kStages - 1);
    cp_async_commit();
    const T* kt_s = k_s + (size_t)(i % kStages) * SR * ldk;
    const T* vt_s = v_s + (size_t)(i % kStages) * SR * ldk;
    const int base = (p0 + i * ppr) * page;    // position of slot 0
    const int end = min(p1 * page, len);       // first position not here

    // scores: lane = part*8 + slot in the warp's eight; a lane's 16-byte K
    // chunks (every fourth of the row) are read once for kRows query rows;
    // the quarters are summed by two shuffles (the trip counts are the
    // same for the whole warp)
    const int part = lane / kSlotsPerWarp;
    for (int t0 = 0; t0 < SR; t0 += kWarps * kSlotsPerWarp) {
      const int t = t0 + warp * kSlotsPerWarp + lane % kSlotsPerWarp;
      const T* kr = kt_s + min(t, SR - 1) * ldk;
      for (int rb = 0; rb < n_rb; ++rb) {
        const float* q0 = q_s + rb * kRows * hd;
        float a[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) a[j] = 0.f;
        for (int c = part; c < row_chunks; c += kParts) {
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
          a[j] += __shfl_xor_sync(0xffffffffu, a[j], kSlotsPerWarp);
          a[j] += __shfl_xor_sync(0xffffffffu, a[j], 2 * kSlotsPerWarp);
        }
        if (part == 0 && t < SR) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int r = rb * kRows + j;
            if (r < G) p_s[r * ldp + t] = base + t < end ? a[j] * scale
                                                         : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < G; r += kWarps) {
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

    // PV: item (slot group, row block, column pair); neighbouring threads
    // take neighbouring column pairs, and a group's slots are a contiguous
    // run of the round read four at a time
    const int span = (((SR + n_sg - 1) / n_sg) + 3) & ~3;
    for (int it = tid; it < n_sg * n_rb * n_cp; it += kThreads) {
      const int cp = it % n_cp;
      const int rb = it / n_cp % n_rb;
      const int sg = it / n_cp / n_rb;
      const int d = 2 * cp;
      const int r0 = rb * kRows;
      float* ac = acc + ((size_t)sg * Rp + r0) * hd + d;
      float x[kRows][2];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float al = a_s[r0 + j];
        x[j][0] = ac[j * hd] * al;
        x[j][1] = ac[j * hd + 1] * al;
      }
      const int t_end = min(SR, (sg + 1) * span);
      int t = sg * span;
      for (; t + 4 <= t_end; t += 4) {
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
      for (; t < t_end; ++t) {
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
        ac[j * hd] = x[j][0];
        ac[j * hd + 1] = x[j][1];
      }
    }
  }
  __syncthreads();

  // this split's partial: (m, l) and acc per row, fp32, the slot groups'
  // accumulators summed in group order
  const size_t first = (((size_t)b * K + kvh) * n_split + sp) * G;
  for (int e = tid; e < G * hd; e += kThreads) {
    float s = acc[e];
    for (int sg = 1; sg < n_sg; ++sg) s += acc[(size_t)sg * Rp * hd + e];
    part_acc[first * hd + e] = s;
  }
  for (int r = tid; r < G; r += kThreads) {
    part_ml[2 * (first + r)] = m_s[r];
    part_ml[2 * (first + r) + 1] = l_s[r];
  }
}

template <typename T>
size_t smem_bytes(int G, int hd, int page, int ppr, int chunk) {
  const size_t SR = (size_t)ppr * page;
  const int n_rb = (G + kRows - 1) / kRows;
  const size_t Rp = (size_t)n_rb * kRows;
  return 2 * (size_t)ring_stages(chunk / ppr) * SR * kv_ld<T>(hd) *
             sizeof(T) +
         sizeof(float) * ((1 + (size_t)n_groups(n_rb, hd)) * Rp * hd +
                          Rp * p_ld((int)SR) + 3 * Rp) +
         sizeof(int32_t) * (size_t)chunk;
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lens, void* part_acc,
           void* part_ml, void* out, int B, int H, int K, int hd,
           int page, int npg, int ppr, int chunk, int n_split, float scale,
           cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<T>;
  const size_t smem = smem_bytes<T>(H / K, hd, page, ppr, chunk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(K, B, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, K, hd, page, npg, ppr, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_split_combine<T, true>(part_acc, part_ml, lens, out, B, 1, H, K, hd,
                                page, npg, chunk, n_split, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a split block needs, in bytes (the wrapper checks it
// against the card's 227 KB per block before launching).
size_t paged_decode_smem_bytes(int H, int K, int hd, int page, int ppr,
                               int chunk, int itemsize) {
  const int G = H / K;
  return itemsize == 2 ? smem_bytes<__nv_bfloat16>(G, hd, page, ppr, chunk)
                       : smem_bytes<float>(G, hd, page, ppr, chunk);
}

// dtype: 0 = fp32, 1 = bf16. part_acc: (B, K, n_split, G, hd) fp32 and
// part_ml: (B, K, n_split, G, 2) fp32 scratch. Launches the split kernel
// and the combine; returns cudaGetLastError() after them.
int paged_decode_launch(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* table,
                        const void* lens, void* part_acc, void* part_ml,
                        void* out, int B, int H, int K, int hd, int page,
                        int npg, int ppr, int chunk, int n_split, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, part_acc,
                                 part_ml, out, B, H, K, hd, page, npg, ppr,
                                 chunk, n_split, scale, s);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lens, part_acc, part_ml,
                         out, B, H, K, hd, page, npg, ppr, chunk, n_split,
                         scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
