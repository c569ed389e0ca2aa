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
// Math, as the Pallas body: scores in fp32 from the inputs' products, times
// hd**-0.5 after the product; with `causal` the ABSOLUTE mask row >= col
// (no offset when S != T), masked with the finite -2e38 (with -inf,
// (-inf) - (-inf) would be NaN); the online softmax state (m, l, acc) in
// fp32, carried over the KV tiles in order; out = acc / max(l, 1e-30) cast
// to q's dtype. Each tile's probabilities enter the PV product in v's dtype,
// as the JAX oracle rounds them (src/repro/kernels/ref.py:20); the Pallas
// body's `p.astype(v.dtype)` is a no-op there, since its v is already fp32.
//
// Each block owns one (batch, head, query tile) and walks the KV tiles of 64
// keys in order inside it: the state never leaves the block and no partial
// softmax is combined across blocks. Every row's first KV tile holds column
// 0, which no mask hides, so the running max never starts on masked scores
// alone; tiles wholly above the diagonal are skipped, and the query tiles
// are launched last-first so the longest causal walks start first. Rows and
// columns past S and T are zero-filled and masked; offsets are 64-bit.
//
// Bound on an H100 SXM: operations. 4 * hd flops per (query, key) pair a
// head attends (the QK and PV products) against reading q, K, V and writing
// out once: at B=1, S=T=2048, H=32, hd=128 causal, 34.4 GFLOP against 42 MB,
// far above the ~295 flop/byte ridge in bf16.
//
// bf16: both products on the tensor cores (`flash_attention_bf16`), the
// loads on the Tensor Memory Accelerator. A block of four warpgroups owns
// 192 query rows: warpgroup 0 is the producer, whose one thread issues
// every TMA load (the q tiles once, then each K and V tile into a
// four-stage ring, waiting on a stage's `empty` mbarrier before it reuses
// it, so three tiles fly ahead of the one computed); warpgroups 1-3 are
// consumers of 64 rows each, which wait on a stage's `full` mbarrier (the
// copies' transaction count) and release the stage on its `empty` one when
// their products are done. No block-wide barrier couples them, so one
// consumer's softmax runs beside another's products, and the loads cost
// the consumers no instructions. setmaxnreg moves registers from the
// producer (24) to the consumers (160): compiled for 512 threads they would
// spill. TMA writes each 64-row x 64-column box as 64 rows of 128 bytes in
// the 128-byte swizzle (16-byte chunk j of row r at r*128 + ((j ^ (r % 8))
// * 16) of a 1024-byte-aligned 8 KB block), the layout the wgmma
// descriptors name; hd 128 takes two boxes per tile, and hd < 64 one box
// whose columns past hd (and any row past S or T) TMA fills with zeros.
// S = Q K^T is a chain of wgmma m64n64k16 from shared memory, both
// operands K-major, fp32 accumulators in registers. Each thread holds
// parts of two rows of S (the accumulator layout: rows w*16 + lane/4 and
// +8 of warp w), so a row's max and sum are two quad shuffles; the softmax
// runs in base 2 (log2 e folded into the scale), and only tiles past T or
// across the diagonal are masked. p is rounded to bf16 in registers and,
// in the accumulator's own layout, is the register A operand of the PV
// wgmma m64n{hd}k16, whose B operand V stays in shared memory MN-major
// (the transpose flag). The block shape (kConsumers, kStages, setmaxnreg)
// is the fastest that chip_smoke.py times on the card beside it, and the
// loads on TMA beat a cp.async ring behind a block-wide barrier per tile
// (PERF.md §6). The fp32 path stays the FMA kernel below: TF32 would
// not hold fp32's 2e-5 tolerance.
//
// fp32: `flash_attention_fp32`, one 64-query tile per block, 256 threads as
// a 16 x 16 grid; q, K and V tiles staged in shared memory as fp32 (q and K
// rows padded by one float, so the score loop reads them without bank
// conflicts), 115 KB at hd 128; thread (ty, tx) owns query rows ty + 16i
// (i < 4), score columns tx + 16j (j < 4) and output columns tx + 16c
// (c < hd/16); a row's 16 threads are one half-warp, so its max and sum are
// five shuffles. Its ceiling is the card's 67 TFLOP/s fp32 FMA rate.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per fp32 block
constexpr int kBK = 64;               // keys per KV tile

// ---------------------------------------------------------------- bf16

constexpr int kWgThreads = 128;       // one warpgroup
constexpr int kConsumers = 3;         // consumer warpgroups, 64 rows each
constexpr int kBQ2 = 64 * kConsumers; // query rows per bf16 block
constexpr int kBf16Threads = kWgThreads * (1 + kConsumers);  // + producer
constexpr int kStages = 4;            // K/V ring depth
constexpr int kBlockBytes = 64 * 128; // 64 rows x 128 bytes: one swizzle block

// D (64 x 64, fp32) (+)= A (64 x 16) * B (64 x 16)^T, both bf16 in shared
// memory, K-major, 128-byte swizzle; scale_d = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) * B (16 x 64, bf16
// in shared memory, MN-major, 128-byte swizzle: the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) * B (16 x 128, bf16
// in shared memory, MN-major, 128-byte swizzle: the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the points where it is issued and waited.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// A wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major operand (rows of the tile along M or N, hd along K): k-step kk
// takes 16 columns = 32 bytes, at byte (kk % 4) * 32 of block kk / 4; eight
// rows are 1024 bytes apart (SBO); LBO is unused with this swizzle.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (V: keys along K, hd along N): k-step kk takes keys
// 16kk .. 16kk+15, rows 2048 bytes further on; eight keys are 1024 bytes
// apart (SBO); the next 64 columns of hd are the next block (LBO).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kBlockBytes, 1024);
}

// mbarriers in shared memory (addresses from smem_u32).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory; its
// bytes count against the barrier's expected transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ out, int H, int K, int S,
                     int T_len, int causal, float scale) {
  constexpr int kCB = HD < 64 ? 1 : HD / 64;   // swizzle blocks per tile
  constexpr int kN = 64 * kCB;                 // PV width: hd padded to 64
  constexpr int kTile = kCB * kBlockBytes;     // bytes of one 64-row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_t = base;                       // kConsumers q tiles
  const uint32_t k_t = base + kConsumers * kTile;  // K ring: kStages tiles
  const uint32_t v_t = k_t + kStages * kTile;      // V ring: kStages tiles
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t empty0 = smem_u32(&bars[1 + kStages]);  // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;      // 0: the producer, then consumers
  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ2;  // longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    // the last row of this block that exists sees columns up to itself
    const int last_row = min(q0 + kBQ2, S) - 1;
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kConsumers * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    // the producer: one thread keeps the ring full; tile t goes to stage
    // t % kStages once the consumers have released tile t - kStages there
    if (tid == 0) {
      mbar_expect_tx(q_full, kConsumers * kTile);
      for (int c = 0; c < kConsumers; ++c)
        for (int cb = 0; cb < kCB; ++cb)
          tma_load_3d(q_t + c * kTile + cb * kBlockBytes, &tm_q, q_full,
                      cb * 64, q0 + c * 64, b * H + h);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * st, (t / kStages - 1) & 1);
        mbar_expect_tx(full0 + 8 * st, 2 * kTile);
        for (int cb = 0; cb < kCB; ++cb) {
          tma_load_3d(k_t + st * kTile + cb * kBlockBytes, &tm_k,
                      full0 + 8 * st, cb * 64, t * kBK, b * K + kvh);
          tma_load_3d(v_t + st * kTile + cb * kBlockBytes, &tm_v,
                      full0 + 8 * st, cb * 64, t * kBK, b * K + kvh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  const int cw = wg - 1;
  const int wtid = tid - wg * kWgThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int wq0 = q0 + cw * 64;
  const uint32_t my_q = q_t + cw * kTile;
  // this thread's rows of the 64-row fragment: row0 and row0 + 8
  const int row0 = wq0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float scale2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kBK;
    mbar_wait(full0 + 8 * st, (t / kStages) & 1);    // tile t has landed
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!causal || k0 <= wq0 + 63) {
      // S = Q K^T, 64 x 64, fp32
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc(my_q, kk),
                     kmajor_desc(k_t + st * kTile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // s[j*4 + i*2 + e] is row row0 + 8i, column k0 + j*8 + col0 + e; the
      // mask is needed only on a tile past T or across the diagonal
      const bool masked = k0 + kBK > T_len || (causal && k0 + kBK - 1 > wq0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + j * 8 + col0 + e;
            float& x = s[j * 4 + i * 2 + e];
            x = !masked || (col < T_len && (!causal || row >= col))
                    ? x * scale2 : kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j * 4 + i * 2 + e];
            x = exp2f(x - m_new);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          acc[j * 4 + i * 2] *= alpha;
          acc[j * 4 + i * 2 + 1] *= alpha;
        }
      }
      // p in bf16 as the A fragments of the four k-steps of PV: k-step kk
      // takes keys 16kk .. 16kk+15, i.e. S's n8 blocks 2kk and 2kk+1
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // acc += P V, 64 x kN, fp32
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = mnmajor_desc(v_t + st * kTile, kk);
        if constexpr (kN == 64) wgmma_rs_n64(acc, pa[kk], dv);
        else wgmma_rs_n128(acc, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    mbar_arrive(empty0 + 8 * st);     // this warpgroup is done with stage st
  }

  __nv_bfloat16* ob = out + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * HD + j * 8 +
                                         col0) =
          __floats2bfloat162_rn(acc[j * 4 + i * 2] * inv,
                                acc[j * 4 + i * 2 + 1] * inv);
  }
}

template <int HD>
constexpr size_t bf16_smem_bytes() {
  // the q tiles, the K and V rings, and room to align them to 1024 bytes
  return (kConsumers + 2 * kStages) * (HD < 64 ? 1 : HD / 64) * kBlockBytes +
         1024;
}

// A 3-D tensor map over `mats` row-major (rows, hd) bf16 matrices, boxes of
// 64 rows x 64 columns in the 128-byte swizzle; rows and columns past the
// matrix (hd < 64 included) read as zero. Returns 0 or a CUresult.
int make_map(CUtensorMap* map, const void* base, int hd, int rows,
             int mats) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * 2 * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                     const_cast<void*>(base), dims, strides, box, step,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 256;

// Stage a tile of 64 rows x HD floats starting at `src` (rows of HD
// contiguous elements) into shared memory with row stride `ld`; rows at or
// past `valid` are zero. Neighbouring threads take neighbouring elements,
// so the reads coalesce and the writes hit distinct banks.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int valid, int tid) {
  static_assert(kBQ == kBK, "one staging shape for q, K and V tiles");
  const int n = min(valid, kBQ) * HD;
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    dst[r * ld + (e - r * HD)] = e < n ? src[e] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fp32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int H, int K, int S, int T_len, int causal,
                     float scale) {
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

  const float* qb = q + ((size_t)b * H + h) * S * HD;
  const float* kb = k + ((size_t)b * K + kvh) * T_len * HD;
  const float* vb = v + ((size_t)b * K + kvh) * T_len * HD;
  stage<HD>(qs, kLd, qb + (size_t)q0 * HD, S - q0, tid);

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
    stage<HD>(ks, kLd, kb + (size_t)k0 * HD, T_len - k0, tid);
    stage<HD>(vs, HD, vb + (size_t)k0 * HD, T_len - k0, tid);
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
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
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

  float* ob = out + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[(size_t)row * HD + tx + 16 * c] = acc[i][c] * inv;
  }
}

size_t fp32_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (hd + 1) + (size_t)kBK * hd +
                          (size_t)kBQ * (kBK + 1));
}


template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int H, int K, int S, int T_len, int causal, float scale,
           cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((S + kBQ2 - 1) / kBQ2, H, B);
    CUtensorMap mq, mk, mv;
    int err = make_map(&mq, q, HD, S, B * H);
    if (err == 0) err = make_map(&mk, k, HD, T_len, B * K);
    if (err == 0) err = make_map(&mv, v, HD, T_len, B * K);
    if (err != 0) return err;
    auto kernel = flash_attention_bf16<HD>;
    constexpr size_t smem = bf16_smem_bytes<HD>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kBf16Threads, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, K, S, T_len, causal,
        scale);
  } else {
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    auto kernel = flash_attention_fp32<HD>;
    const size_t smem = fp32_smem_bytes(HD);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), H, K, S,
        T_len, causal, scale);
  }
  return (int)cudaGetLastError();
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, out, B, H, K, S, T_len,
                               causal, scale, s);
    case 32: return launch<32>(dtype, q, k, v, out, B, H, K, S, T_len,
                               causal, scale, s);
    case 64: return launch<64>(dtype, q, k, v, out, B, H, K, S, T_len,
                               causal, scale, s);
    case 128: return launch<128>(dtype, q, k, v, out, B, H, K, S, T_len,
                                 causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
