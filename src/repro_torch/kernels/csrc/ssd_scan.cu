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
// Design. The TPU walks a (batch, head, chunk) grid with the chunk axis in
// order and the whole chunk's Q x Q block in VMEM. Here one block owns one
// (batch, head) and walks its chunks in order, h staying in shared memory
// from chunk to chunk. A chunk's x, B, C and Q x Q block do not fit in 227 KB
// of shared memory at Mamba2-780m's widths (P 64, N 128, chunk 256: 64 + 128
// + 128 + 256 KB), so the chunk's rows are taken 64 at a time: for row tile
// I, C_I is staged once, the state's part is added from h, and the column
// tiles J <= I stream B_J and x_J through shared memory; the 64 x 64 block
// M = (C_I B_J^T) o L o dt_J is formed there and multiplied into the row
// tile's outputs, which stay in registers. When J == I (the last time B_J and
// x_J are staged) x_J is scaled by exp(cum_end - cum_j) dt_j and its
// contribution to the next state is added to a second (P, N) accumulator,
// which replaces h at the chunk's end. The chunk's cumsum is one warp's
// shuffle scan. 256 threads as a 16 x 16 grid: thread (ty, tx) owns rows
// ty + 16i (i < 4) of a tile, columns tx + 16j of M (j < 4) and of y
// (j < P/16, P <= 128); the state update takes 4 x 4 (p, n) micro tiles.
// Every product is an fp32 FMA: no TF32, whose 10-bit mantissa would not
// hold the scan to rtol 5e-4. Offsets are 64-bit.
//
// Bound on an H100 SXM: operations. Counting the chunked form's work (C B^T
// once per group, the lower triangle of M x, C h and the state update), B=2,
// S=2048, H=48, P=64, N=128, chunk 256 is ~10 GFLOP of fp32 against ~105 MB
// read and written once: ~0.15 ms at 67 TFLOP/s against ~31 us at 3.35 TB/s.
// One block per (batch, head) gives 96 blocks for that shape on 132 SMs;
// splitting P across blocks (the state's rows are independent) and mma for
// the three products are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 64;                // rows (and columns) of an M tile
constexpr int kMaxPc = 8;             // y columns per thread: P <= 128

struct Layout {                       // shared memory, in floats
  int ldn, ldm;                       // row strides of the N-wide and M tiles
  int h, hn, c, b, x, m, cum, dt, total;
};

__host__ __device__ inline Layout layout(int P, int N, int Q) {
  Layout L;
  L.ldn = N | 1;                      // odd: rows land on distinct banks
  L.ldm = kR + 1;
  L.h = 0;                            // (P, ldn) state entering the chunk
  L.hn = L.h + P * L.ldn;             // (P, ldn) next state's sum
  L.c = L.hn + P * L.ldn;             // (kR, ldn) C rows of tile I
  L.b = L.c + kR * L.ldn;             // (kR, ldn) B rows of tile J
  L.x = L.b + kR * L.ldn;             // (kR, P) x rows of tile J
  L.m = L.x + kR * P;                 // (kR, ldm) M block
  L.cum = L.m + kR * L.ldm;           // (Q,) cumsum of dt * a
  L.dt = L.cum + Q;                   // (Q,) dt
  L.total = L.dt + Q;
  return L;
}

// Copy `rows` rows of `width` contiguous floats into shared memory with row
// stride `ld`; rows from `valid` on are zero.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int width, int valid, int tid) {
  const int n = valid * width;
  for (int e = tid; e < kR * width; e += kThreads) {
    const int r = e / width;
    dst[r * ld + (e - r * width)] = e < n ? src[e] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y, int H,
                int G, int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  const Layout L = layout(P, N, Q);
  float* hs = smem + L.h;
  float* hn = smem + L.hn;
  float* cs = smem + L.c;
  float* bs = smem + L.b;
  float* xs = smem + L.x;
  float* ms = smem + L.m;
  float* cum = smem + L.cum;
  float* dts = smem + L.dt;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float ah = a[h];
  const int pc = (P + 15) / 16;       // y columns per thread in use
  const int nq4 = (N + 3) / 4;        // n micro-tile columns

  const float* xb = x + ((size_t)b * H + h) * S * P;
  const float* dtb = dt + ((size_t)b * H + h) * S;
  const float* Bb = Bm + ((size_t)b * G + g) * S * N;
  const float* Cb = Cm + ((size_t)b * G + g) * S * N;
  float* yb = y + ((size_t)b * H + h) * S * P;

  for (int e = tid; e < P * L.ldn; e += kThreads) hs[e] = hn[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- the chunk's dt and cumsum(dt * a), one warp scanning 32 at a time
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) dts[i] = dtb[c0 + i];
    __syncthreads();
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? dts[i] * ah : 0.f;
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
    const float cum_end = cum[Q - 1];

    for (int i0 = 0; i0 < Q; i0 += kR) {
      const int nr = min(kR, Q - i0);
      stage(cs, L.ldn, Cb + (size_t)(c0 + i0) * N, N, nr, tid);
      __syncthreads();

      // the state's part: exp(cum_i) * sum_n C_i[n] h[p][n]
      float acc[4][kMaxPc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = i0 + ty + 16 * i < Q ? expf(cum[i0 + ty + 16 * i])
                                            : 0.f;
#pragma unroll
        for (int j = 0; j < kMaxPc; ++j) {
          acc[i][j] = 0.f;
          if (j < pc && tx + 16 * j < P && c0 > 0) {
            const float* hp = hs + (tx + 16 * j) * L.ldn;
            const float* ci = cs + (ty + 16 * i) * L.ldn;
            float sum = 0.f;
            for (int n = 0; n < N; ++n) sum = fmaf(ci[n], hp[n], sum);
            acc[i][j] = w * sum;
          }
        }
      }

      for (int j0 = 0; j0 <= i0; j0 += kR) {
        const int nc = min(kR, Q - j0);
        __syncthreads();              // the previous tile's reads are done
        stage(bs, L.ldn, Bb + (size_t)(c0 + j0) * N, N, nc, tid);
        stage(xs, P, xb + (size_t)(c0 + j0) * P, P, nc, tid);
        __syncthreads();

        // M = (C_I B_J^T) o exp(cum_i - cum_j) o dt_j on j <= i, else 0
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * L.ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * L.ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = ty + 16 * i, gi = i0 + ri;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cj = tx + 16 * j, gj = j0 + cj;
            ms[ri * L.ldm + cj] =
                (ri < nr && cj < nc && gj <= gi)
                    ? s[i][j] * expf(cum[gi] - cum[gj]) * dts[gj]
                    : 0.f;
          }
        }
        __syncthreads();

        // y_I += M x_J
        for (int jj = 0; jj < nc; ++jj) {
          float mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = ms[(ty + 16 * i) * L.ldm + jj];
#pragma unroll
          for (int j = 0; j < kMaxPc; ++j) {
            if (j < pc && tx + 16 * j < P) {
              const float xv = xs[jj * P + tx + 16 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(mv[i], xv,
                                                           acc[i][j]);
            }
          }
        }

        if (j0 == i0) {
          // the last use of x_J and B_J: their part of the next state,
          // sum_j exp(cum_end - cum_j) dt_j x_j[p] B_j[n]
          __syncthreads();
          for (int e = tid; e < nc * P; e += kThreads) {
            const int jj = e / P;
            xs[e] *= expf(cum_end - cum[j0 + jj]) * dts[j0 + jj];
          }
          __syncthreads();
          const int tiles = ((P + 3) / 4) * nq4;
          for (int t = tid; t < tiles; t += kThreads) {
            const int pm = t / nq4, nm = t - pm * nq4;
            float u[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
            for (int jj = 0; jj < nc; ++jj) {
              float xv[4], bv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int p = pm * 4 + i;
                xv[i] = p < P ? xs[jj * P + p] : 0.f;
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int n = nm + nq4 * j;
                bv[j] = n < N ? bs[jj * L.ldn + n] : 0.f;
              }
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) u[i][j] = fmaf(xv[i], bv[j],
                                                           u[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int p = pm * 4 + i, n = nm + nq4 * j;
                if (p < P && n < N) hn[p * L.ldn + n] += u[i][j];
              }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = ty + 16 * i;
        if (ri >= nr) continue;
#pragma unroll
        for (int j = 0; j < kMaxPc; ++j)
          if (j < pc && tx + 16 * j < P)
            yb[(size_t)(c0 + i0 + ri) * P + tx + 16 * j] = acc[i][j];
      }
      __syncthreads();                // C_I's reads are done
    }

    // h <- exp(cum_end) h + the chunk's sum
    const float decay = expf(cum_end);
    for (int e = tid; e < P * L.ldn; e += kThreads) {
      hs[e] = fmaf(decay, hs[e], hn[e]);
      hn[e] = 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory a launch needs, in bytes (the wrapper checks it against the
// card's 227 KB per block before launching).
size_t ssd_scan_smem_bytes(int P, int N, int chunk) {
  return sizeof(float) * (size_t)layout(P, N, chunk).total;
}

// P <= 128. Returns cudaGetLastError() after the launch.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* Bm, const void* Cm, void* y, int B, int H,
                    int G, int S, int P, int N, int chunk, void* stream) {
  if (P > 16 * kMaxPc) return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_scan_smem_bytes(P, N, chunk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), H, G, S, P, N,
      chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
