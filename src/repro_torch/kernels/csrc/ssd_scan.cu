// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `ssd_scan` of src/repro/kernels/ssd_scan.py (body
// `_kernel` at :29, pallas_call at :86).
//
//   x    (B, H, S, P)  fp32
//   dt   (B, H, S)     fp32, post-softplus
//   a    (H,)          fp32, < 0
//   Bm   (B, G, S, N)  fp32, group g serves heads g*H/G .. (g+1)*H/G - 1
//   Cm   (B, G, S, N)  fp32
//   y    (B, H, S, P)  fp32; zero initial state; S % chunk == 0
//
// Math, per chunk of Q = chunk tokens, with the state h (P, N) entering it:
//   cum   = cumsum(dt * a)                                  (Q,), <= 0
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) (C_i . h_p) over p                 (the state's part)
//   h_out = exp(cum_end) h + sum_j exp(cum_end - cum_j) dt_j x_j B_j^T
// exp is only ever taken of a difference that is <= 0 (cum falls along the
// chunk): never exp(cum_i) * exp(-cum_j), whose second factor overflows fp32
// once cum passes -88 (at chunk 256 with dt*|a| up to 0.8, cum reaches
// -205).
//
// Bound on an H100 SXM: operations. The scan itself needs 4*N*P flops per
// (token, head) (the state update and its readout) plus N*P per chunk and
// head; B=2, H=48, S=2048, P=64, N=128 is 6.4 GFLOP, 96 us at the 67
// TFLOP/s of fp32 outside the tensor cores, 39 us at the 495/3 TFLOP/s of
// 3xTF32 on them, against ~31 us for its ~105 MB at 3.35 TB/s. The chunked
// form below does ~1.6x that work at chunk 256 (C B^T, and the masked
// (C B^T o L) x of each chunk on its tiles on or below the diagonal). Its
// products run on the tensor cores in 3xTF32 (each operand split into a
// TF32 hi and lo part, three products), close to fp32: plain TF32, with
// its 10-bit mantissa, would not hold the scan to rtol 5e-4. What holds it
// under its peak is latency, not the math (on an H100 80GB HBM3 at 700 W
// the same passes on fp32 FMAs took only ~10% longer, PERF.md): a
// block's steps (copy a tile pair, wait, barrier, 64 k of products) leave
// its 4 warps idle between them.
//
// Design: the GPU form that the JAX docstring names, four kernels tied by
// global memory, all but one step of the state passing parallel over
// (batch, head, chunk, tile). The TPU walks (batch, head, chunk) with the
// chunk axis in order, because its grid runs in order; one block per
// (batch, head) walking 8 chunks would fill 96 of 132 SMs and recompute
// C B^T for each of a group's heads.
//   1. ssd_cb_kernel, per (batch, group, chunk, 64 x 64 tile on or below
//      the diagonal): CB[i][j] = C_i . B_j, once per group, not per head
//      (Mamba2-780m has G = 1 for 48 heads; 4 MB at chunk 256, read back
//      from L2 by every head).
//   2. ssd_state_kernel, per (batch, head, chunk, 64 x 64 tile of (N, P)):
//      the chunk's cumsum of dt*a (one warp's shuffle scan; the tile-0
//      block writes it out for passes 3 and 4) and the chunk's own state
//      s_c[n][p] = sum_j B_j[n] exp(cum_end - cum_j) dt_j x_j[p].
//   3. ssd_pass_kernel, per (batch, head, 4 state elements): h_0 = 0, h_c =
//      exp(cum_end of c-1) h_{c-1} + s_{c-1}, in chunk order, written over
//      s_c in place (eight chunks' loads in flight at a time).
//   4. ssd_out_kernel, per (batch, head, chunk, 64-row tile I, 64-column P
//      tile): y_I = diag(exp(cum_i)) C_I h_c^T + sum_{J<=I} M_IJ x_J, with
//      M_IJ[i][j] = CB[i][j] exp(cum_i - cum_j) dt_j on j <= i, else 0.
// Every product is a 64 x 64 output tile over k-runs of 64 staged in
// shared memory, one tile pair (37 KB with the chunk's dt and cumsum).
// Tiles are copied with cp.async, 16 bytes at a time where rows are
// 16-byte aligned (4 bytes elsewhere), zero-filled past the edges; the
// per-element factors (the x rows' weights, M's decay and mask) are
// applied by each thread to the pieces it copied, once they land. 128
// threads, each warp a 32 x 32 quarter of the tile as 2 x 4 mma.m16n8k8
// tiles, load their fragments from rows of 68 floats (no bank conflict),
// A k-major (passes 1 and 2) or row-major (pass 4, so C_I and M are staged
// as they lie), B k-major. Float sums use no atomics, so a run gives the
// same bits every time. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 64;                // tile edge: rows, columns and k-run
constexpr int kLd = kT + 4;           // staged row stride (floats)
constexpr int kTile = kT * kLd;       // floats of one staged tile
constexpr int kVecs = kT * kT / 4 / kThreads;   // 16-byte pieces a thread
                                                // stages of a tile
constexpr int kPassChunks = 8;        // state passing: loads in flight
constexpr int kMinBlocks = 4;         // resident blocks per SM (<= 128 regs)

// A chunk's state in st: N*P floats, padded to a multiple of 4.
__host__ __device__ inline int padded4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global to shared memory, asynchronously: `bytes` (0..cp size) are read
// from src and the rest of the cp size is zero-filled, so src need only be
// some valid address when bytes is 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Piece u of a thread's share of a 64 x 64 tile: row v / 16, columns
// 4 * (v % 16) .. + 3, v = tid + u * kThreads (neighbouring threads on
// neighbouring 16 bytes of a row).
__device__ __forceinline__ int vec_row(int tid, int u) {
  return (tid + u * kThreads) >> 4;
}
__device__ __forceinline__ int vec_col(int tid, int u) {
  return ((tid + u * kThreads) & 15) << 2;
}

// dst[r][c] = src[r * ld + c] for r < rows, c < cols; zero elsewhere in
// the 64 x 64 tile. 16-byte copies where rows are 16-byte aligned, else
// 4-byte ones; either way the thread copies its pieces (vec_row, vec_col).
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      size_t ld, int rows, int cols,
                                      int tid) {
  const bool vec =
      (ld & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll 2
  for (int u = 0; u < kVecs; ++u) {
    const int r = vec_row(tid, u), c = vec_col(tid, u);
    const int n = r < rows ? max(0, min(4, cols - c)) : 0;
    const float* at = src + (size_t)r * ld + c;
    if (vec) {
      cp_async16(dst + r * kLd + c, n ? at : src, 4 * n);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async4(dst + r * kLd + c + q, q < n ? at + q : src, q < n);
    }
  }
}

// dst[k][r] = src[r * ld + k] for r < rows, k < cols; zero elsewhere
// (4-byte copies; the C B^T pass only)
__device__ __forceinline__ void stage_t(float* __restrict__ dst,
                                        const float* __restrict__ src,
                                        size_t ld, int rows, int cols,
                                        int tid) {
#pragma unroll 2
  for (int u = 0; u < kT * kT / kThreads; ++u) {
    const int e = tid + u * kThreads;
    const int r = e / kT, k = e % kT;
    const bool ok = r < rows && k < cols;
    cp_async4(dst + k * kLd + r, ok ? src + (size_t)r * ld + k : src, ok);
  }
}

// The tile product on the tensor cores in 3xTF32: each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and acc += lo_a hi_b +
// hi_a lo_b + hi_a hi_b (the lo x lo term, ~2^-22 of the product, is
// dropped), close to fp32. Four warps, each a 32 x 32 quarter of the 64 x
// 64 output tile: 2 x 4 mma.m16n8k8 tiles, acc[mt][nt][c] at row
// acc_row(mt, c) and column acc_col(nt, c) of the block's tile.
__device__ __forceinline__ int acc_row(int tid, int mt, int c) {
  return 32 * ((tid >> 5) >> 1) + 16 * mt + ((tid & 31) >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int acc_col(int tid, int nt, int c) {
  return 32 * ((tid >> 5) & 1) + 8 * nt + 2 * (tid & 3) + (c & 1);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

using Acc = float[2][4][4];

// acc += A B over the k-run of 64. kNN false: A staged k-major, As[k][row];
// kNN true: A row-major, As[row][k]. B is Bs[k][col] either way. Fragment
// loads are conflict-free with rows of 68 floats.
template <bool kNN>
__device__ __forceinline__ void tile_fma(Acc& acc,
                                         const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         int tid) {
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rm = 32 * ((tid >> 5) >> 1), cn = 32 * ((tid >> 5) & 1);
  auto A = [&](int r, int k) {
    return kNN ? As[r * kLd + k] : As[k * kLd + r];
  };
#pragma unroll 2
  for (int k0 = 0; k0 < kT; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = rm + 16 * mt + g;
      split_tf32(A(r, k0 + t), ah[mt][0], al[mt][0]);
      split_tf32(A(r + 8, k0 + t), ah[mt][1], al[mt][1]);
      split_tf32(A(r, k0 + t + 4), ah[mt][2], al[mt][2]);
      split_tf32(A(r + 8, k0 + t + 4), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = cn + 8 * nt + g;
      split_tf32(Bs[(k0 + t) * kLd + n], bh[nt][0], bl[nt][0]);
      split_tf32(Bs[(k0 + t + 4) * kLd + n], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(acc[mt][nt], al[mt], bh[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
}

// The k-steps of a block's product, one tile pair in shared memory (so
// that several blocks fit an SM and hide each other's copies): a thread issues
// step s's copies, waits for its own, applies `fix` to the pieces it
// copied (visible to it once landed), and a barrier makes the tiles
// visible to all; a second barrier after the products frees them for step
// s+1. `load(s, A, B)` issues step s's copies; `after(s)` runs once step
// s's products are in acc.
template <bool kNN, typename Load, typename Fix, typename After>
__device__ __forceinline__ void run_steps(Acc& acc, float* smem,
                                          int n_steps, int tid, Load load,
                                          Fix fix, After after) {
  float* As = smem;
  float* Bs = smem + kTile;
  for (int s = 0; s < n_steps; ++s) {
    load(s, As, Bs);
    cp_async_commit();
    cp_async_wait_all();
    fix(s, As, Bs);
    __syncthreads();
    tile_fma<kNN>(acc, As, Bs, tid);
    after(s);
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
}

// Write the tile: out[r * ld + c] for r < rows, c < cols of the 64 x 64
// output tile.
__device__ __forceinline__ void store_tile(const Acc& acc,
                                           float* __restrict__ out, size_t ld,
                                           int rows, int cols, int tid) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = acc_row(tid, mt, c), col = acc_col(tid, nt, c);
        if (r < rows && col < cols) out[(size_t)r * ld + col] = acc[mt][nt][c];
      }
}

// The chunk's dt (dts) and cumsum of dt * a (cum), Q values each, one warp
// scanning 32 at a time; ends in a barrier.
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int Q,
                             float* __restrict__ dts, float* __restrict__ cum,
                             int tid) {
  for (int i = tid; i < Q; i += kThreads) dts[i] = dt[i];
  __syncthreads();
  if (tid < 32) {
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + tid;
      float v = i < Q ? dts[i] * a : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += u;
      }
      v += carry;
      if (i < Q) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// 1. CB[b, g, c][i][j] = C_i . B_j for the tile pair (I, J), J <= I.
// grid (nt*(nt+1)/2, nc, B*G)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= (int)blockIdx.x) ++I;
  const int J = blockIdx.x - I * (I + 1) / 2;
  const int c = blockIdx.y, nc = gridDim.y;
  const size_t bg = blockIdx.z;
  const int i0 = I * kT, j0 = J * kT;
  const int ni = min(kT, Q - i0), nj = min(kT, Q - j0);
  const float* Cb = Cm + (bg * S + (size_t)c * Q + i0) * N;
  const float* Bb = Bm + (bg * S + (size_t)c * Q + j0) * N;
  Acc acc;
  zero(acc);
  run_steps<false>(
      acc, smem, (N + kT - 1) / kT, tid,
      [&](int s, float* As, float* Bs) {
        const int n0 = s * kT, nn = min(kT, N - n0);
        stage_t(As, Cb + n0, N, ni, nn, tid);
        stage_t(Bs, Bb + n0, N, nj, nn, tid);
      },
      [](int, float*, float*) {}, [](int) {});
  store_tile(acc, cb + (bg * nc + c) * Q * Q + (size_t)i0 * Q + j0,
                    Q, ni, nj, tid);
}

// 2. The chunk's cumsum (written to cum by the tile-0 block) and its own
// state st[b, h, c][n][p] = sum_j B_j[n] exp(cum_end - cum_j) dt_j x_j[p].
// grid (ceil(N/64) * ceil(P/64), nc, B*H)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ Bm,
                 float* __restrict__ st, float* __restrict__ cum_g, int H,
                 int G, int S, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* dts = smem + 2 * kTile;      // (Q,)
  float* w = dts + Q;                 // (Q,) cum, then the weights w_j
  const int tid = threadIdx.x;
  const int nP = (P + kT - 1) / kT;
  const int n0 = blockIdx.x / nP * kT, p0 = blockIdx.x % nP * kT;
  const int c = blockIdx.y, nc = gridDim.y;
  const size_t bh = blockIdx.z;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const size_t bg = (size_t)b * G + h / (H / G);
  const size_t t0 = (size_t)c * Q;    // the chunk's first token
  const float* Bb = Bm + (bg * S + t0) * N + n0;
  const float* xb = x + (bh * S + t0) * P + p0;
  const int nn = min(kT, N - n0), np = min(kT, P - p0);
  auto load = [&](int s, float* As, float* Bs) {
    const int j0 = s * kT, nj = min(kT, Q - j0);
    stage(As, Bb + (size_t)j0 * N, N, nj, nn, tid);
    stage(Bs, xb + (size_t)j0 * P, P, nj, np, tid);
  };

  chunk_cumsum(dt + bh * S + t0, a[h], Q, dts, w, tid);
  if (blockIdx.x == 0)
    for (int i = tid; i < Q; i += kThreads) cum_g[bh * S + t0 + i] = w[i];
  const float cum_end = w[Q - 1];
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads)
    w[i] = expf(cum_end - w[i]) * dts[i];
  __syncthreads();

  Acc acc;
  zero(acc);
  run_steps<false>(
      acc, smem, (Q + kT - 1) / kT, tid, load,
      [&](int s, float*, float* Bs) {   // x_j scaled by w_j, own pieces
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          const int k = vec_row(tid, u), cc = vec_col(tid, u);
          const float wk = s * kT + k < Q ? w[s * kT + k] : 0.f;
          float4* v = reinterpret_cast<float4*>(Bs + k * kLd + cc);
          float4 x = *v;
          x.x *= wk;
          x.y *= wk;
          x.z *= wk;
          x.w *= wk;
          *v = x;
        }
      },
      [](int) {});
  store_tile(
      acc, st + (bh * nc + c) * padded4(N * P) + (size_t)n0 * P + p0, P, nn,
      np, tid);
}

// 3. The states entering each chunk, in chunk order, over st in place:
// st[c] <- h_c, h_0 = 0, h_{c+1} = exp(cum_end of c) h_c + s_c; a thread
// takes four neighbouring elements (a chunk's state is padded to a
// multiple of 4 floats) and kPassChunks chunks' loads at a time.
// grid (ceil(NPp / 4 / 128), B*H)
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ cum_g,
                int S, int NPp, int Q, int nc) {
  const size_t bh = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (4 * v >= NPp) return;
  float4* s = reinterpret_cast<float4*>(st + bh * nc * NPp) + v;
  const size_t stride = NPp / 4;                 // float4s per chunk
  const float* cum = cum_g + bh * S + Q - 1;     // chunk c ends at c*Q + Q-1
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassChunks) {
    float4 sc[kPassChunks];
    float dec[kPassChunks];
#pragma unroll
    for (int u = 0; u < kPassChunks; ++u) {
      const int c = c0 + u;
      sc[u] = c < nc ? s[c * stride] : h;
      dec[u] = c < nc ? expf(cum[(size_t)c * Q]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPassChunks; ++u) {
      if (c0 + u < nc) {
        s[(c0 + u) * stride] = h;
        h.x = fmaf(dec[u], h.x, sc[u].x);
        h.y = fmaf(dec[u], h.y, sc[u].y);
        h.z = fmaf(dec[u], h.z, sc[u].z);
        h.w = fmaf(dec[u], h.w, sc[u].w);
      }
    }
  }
}

// 4. y for one 64-row tile I of a chunk and one 64-column P tile:
// diag(exp(cum_i)) C_I h_c^T, then + sum_{J<=I} M_IJ x_J. The steps are
// the state's part over N (none in chunk 0, whose h is 0), then one per J.
// grid (ceil(Q/64) * ceil(P/64), nc, B*H)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ st, const float* __restrict__ cum_g,
               float* __restrict__ y, int H, int G, int S, int P, int N,
               int Q) {
  extern __shared__ __align__(16) float smem[];
  float* dts = smem + 2 * kTile;      // (Q,)
  float* cum = dts + Q;               // (Q,)
  const int tid = threadIdx.x;
  const int nP = (P + kT - 1) / kT;
  const int I = blockIdx.x / nP, p0 = blockIdx.x % nP * kT;
  const int c = blockIdx.y, nc = gridDim.y;
  const size_t bh = blockIdx.z;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const size_t bg = (size_t)b * G + h / (H / G);
  const size_t t0 = (size_t)c * Q;
  const int i0 = I * kT;
  const int ni = min(kT, Q - i0), np = min(kT, P - p0);
  const int n_inter = c > 0 ? (N + kT - 1) / kT : 0;
  const float* Cb = Cm + (bg * S + t0 + i0) * N;
  const float* hb = st + (bh * nc + c) * padded4(N * P) + p0;
  const float* cbc = cb + (bg * nc + c) * Q * Q;
  const float* xb = x + (bh * S + t0) * P + p0;

  auto load = [&](int s, float* As, float* Bs) {
    if (s < n_inter) {                // C_I and h_c over n
      const int n0 = s * kT, nn = min(kT, N - n0);
      stage(As, Cb + n0, N, ni, nn, tid);
      stage(Bs, hb + (size_t)n0 * P, P, nn, np, tid);
      return;
    }
    const int j0 = (s - n_inter) * kT, nj = min(kT, Q - j0);
    stage(As, cbc + (size_t)i0 * Q + j0, Q, ni, nj, tid);   // CB_IJ
    stage(Bs, xb + (size_t)j0 * P, P, nj, np, tid);
  };
  for (int i = tid; i < i0 + ni; i += kThreads) {
    dts[i] = dt[bh * S + t0 + i];
    cum[i] = cum_g[bh * S + t0 + i];
  }
  __syncthreads();

  Acc acc;
  zero(acc);
  run_steps<true>(
      acc, smem, n_inter + I + 1, tid, load,
      [&](int s, float* As, float*) {  // M_IJ = CB o exp(cum_i - cum_j) dt_j
        if (s < n_inter) return;       // on j <= i, else 0; own pieces
        const int j0 = (s - n_inter) * kT;
#pragma unroll 2
        for (int u = 0; u < kVecs; ++u) {
          const int i = vec_row(tid, u), jc = vec_col(tid, u);
          const int gi = i0 + i;
          float* m = As + i * kLd + jc;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gj = j0 + jc + q;
            m[q] = gj <= gi && i < ni
                       ? m[q] * expf(cum[gi] - cum[gj]) * dts[gj]
                       : 0.f;
          }
        }
      },
      [&](int s) {                     // the state's part, times exp(cum_i)
        if (s + 1 != n_inter) return;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int i = acc_row(tid, mt, c);
            const float wi = i < ni ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              acc[mt][nt][c] *= wi;
              acc[mt][nt][c + 1] *= wi;
            }
          }
      });
  store_tile(acc, y + (bh * S + t0 + i0) * P + p0, P, ni, np, tid);
}

// shared memory of the state and output kernels: two tiles, then dt and
// cum of the chunk (the CB kernel uses the tiles only)
size_t smem_floats(int Q) { return 2 * (size_t)kTile + 2 * (size_t)Q; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shared memory a block needs, in bytes (the wrapper checks it against the
// card's 227 KB per block before launching).
size_t ssd_scan_smem_bytes(int chunk) {
  return sizeof(float) * smem_floats(chunk);
}

// cb: (B, G, S/chunk, chunk, chunk), st: (B, H, S/chunk, N*P padded to a
// multiple of 4) and cum: (B, H, S) fp32 scratch. Launches the four
// passes in order on the stream; returns the first launch error, or
// cudaGetLastError() after the last.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* Bm, const void* Cm, void* y, void* cb,
                    void* st, void* cum, int B, int H, int G, int S, int P,
                    int N, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Q = chunk, nc = S / Q;
  const int nt = (Q + kT - 1) / kT;
  const int nN = (N + kT - 1) / kT, nP = (P + kT - 1) / kT;
  const size_t tiles = sizeof(float) * 2 * kTile;
  const size_t smem = ssd_scan_smem_bytes(chunk);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Bf = static_cast<const float*>(Bm);
  const auto* Cf = static_cast<const float*>(Cm);
  auto* cbf = static_cast<float*>(cb);
  auto* stf = static_cast<float*>(st);
  auto* cumf = static_cast<float*>(cum);
  cudaError_t err;
  if ((err = allow_smem(ssd_cb_kernel, tiles)) != cudaSuccess ||
      (err = allow_smem(ssd_state_kernel, smem)) != cudaSuccess ||
      (err = allow_smem(ssd_out_kernel, smem)) != cudaSuccess)
    return (int)err;

  ssd_cb_kernel<<<dim3(nt * (nt + 1) / 2, nc, B * G), kThreads, tiles, s>>>(
      Bf, Cf, cbf, S, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3(nN * nP, nc, B * H), kThreads, smem, s>>>(
      xf, dtf, static_cast<const float*>(a), Bf, stf, cumf, H, G, S, P, N,
      Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int npp = padded4(N * P);
  ssd_pass_kernel<<<dim3((npp / 4 + kThreads - 1) / kThreads, B * H),
                    kThreads, 0, s>>>(stf, cumf, S, npp, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_out_kernel<<<dim3(nt * nP, nc, B * H), kThreads, smem, s>>>(
      xf, dtf, Cf, cbf, stf, cumf, static_cast<float*>(y), H, G, S, P, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
