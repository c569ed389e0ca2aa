// KV page gather / scatter for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels `page_gather` (`_gather_one`, pallas_call at
// :52) and `page_scatter` (`_scatter_one`, pallas_call at :86) of
// src/repro/kernels/page_copy.py: the device half of the host KV tier's copy
// path and of cross-region KV export / import.
//
//   pools  k_pages, v_pages  (L, P, page, K, hd)   bf16 or fp32
//   stacks k_stack, v_stack  (N, L, page, K, hd)   the pools' dtype
//   ids    (N,) int32, unique for a scatter
//
//   gather   stack[n, l] = pool[l, ids[n]]
//   scatter  pool[l, ids[n]] = stack[n, l]   (in place: the counterpart of
//            `input_output_aliases={2: 0}`; untouched pages are never read
//            or written)
//
// One (layer, page) tile is page*K*hd contiguous elements in both layouts
// (32 KB in bf16 at Llama-3.1-8B's 16 x 8 x 128), so a copy is N*L*2 tile
// moves with the addresses computed from the ids. The kernel is
// dtype-agnostic: it moves bytes.
//
// Design. The TPU walks an (N, L) grid in order and DMAs one tile per step,
// the ids scalar-prefetched into its index maps. Here the grid is
// (N*L, 2): one block per (page, layer, pool) tile, all in flight together.
// A block reads its own id, checks it against P (an id outside [0, P) is
// never dereferenced: on the card it would be an illegal address, where the
// TPU's DMA clamps; the tile is left unwritten and the caller checks ids on
// the host), and copies the tile with 16-byte vector loads and stores,
// kUnroll loads in flight per thread before their stores. Offsets are
// 64-bit: a full-width fp32 pool (32 x 1024 x 16 x 8 x 128 x 4 B = 2.1 GB)
// overflows int32 byte offsets.
//
// Bound on an H100 SXM (3.35 TB/s): pure data movement, 2 x N x L x tile
// bytes read and as many written, no arithmetic. The design reads each
// source byte once and writes each destination byte once, with coalesced
// 16-byte accesses and N*L*2 independent blocks (6400 at N=100, L=32) to
// keep the memory system busy. Duplicate ids in a scatter race between
// blocks (which write lands is undefined); callers pass unique ids, as the
// Pallas kernel requires.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// Copy one tile of `vecs` 16-byte vectors from `src` to `dst`.
__device__ __forceinline__ void copy_tile(const uint4* __restrict__ src,
                                          uint4* __restrict__ dst,
                                          int64_t vecs) {
  const int64_t step = (int64_t)kThreads * kUnroll;
  for (int64_t base = threadIdx.x; base < vecs; base += step) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i < vecs) r[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i < vecs) dst[i] = r[u];
    }
  }
}

// blockIdx.x = n * L + l, blockIdx.y = pool (0 = K, 1 = V). A gather
// reads the pools at ids[n] and writes the stacks; a scatter the reverse.
template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
page_copy_kernel(const uint4* __restrict__ k_src,
                 const uint4* __restrict__ v_src, uint4* __restrict__ k_dst,
                 uint4* __restrict__ v_dst, const int32_t* __restrict__ ids,
                 int L, int P, int64_t tile_vecs) {
  const int64_t nl = blockIdx.x;
  const int64_t n = nl / L;
  const int64_t l = nl - n * L;
  const int32_t id = ids[n];
  if (id < 0 || id >= P) return;
  const int64_t pool_off = (l * P + id) * tile_vecs;
  const int64_t stack_off = nl * tile_vecs;
  const bool v = blockIdx.y != 0;
  copy_tile((v ? v_src : k_src) + (kScatter ? stack_off : pool_off),
            (v ? v_dst : k_dst) + (kScatter ? pool_off : stack_off),
            tile_vecs);
}

template <bool kScatter>
int launch(const void* k_src, const void* v_src, void* k_dst, void* v_dst,
           const void* ids, int N, int L, int P, long long tile_bytes,
           void* stream) {
  if (N <= 0) return 0;
  dim3 grid((unsigned)((int64_t)N * L), 2);
  page_copy_kernel<kScatter><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k_src), static_cast<const uint4*>(v_src),
      static_cast<uint4*>(k_dst), static_cast<uint4*>(v_dst),
      static_cast<const int32_t*>(ids), L, P, tile_bytes / 16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tile_bytes = page*K*hd*itemsize, a multiple of 16, and every pointer
// 16-byte aligned (the wrapper checks both). Each returns
// cudaGetLastError() after its launch.

// Gather N tiles per pool into the stacks.
int page_gather_launch(const void* k_pages, const void* v_pages,
                       void* k_stack, void* v_stack, const void* ids, int N,
                       int L, int P, long long tile_bytes, void* stream) {
  return launch<false>(k_pages, v_pages, k_stack, v_stack, ids, N, L, P,
                       tile_bytes, stream);
}

// Scatter N tiles per pool from the stacks into the pools, in place.
int page_scatter_launch(void* k_pages, void* v_pages, const void* k_stack,
                        const void* v_stack, const void* ids, int N, int L,
                        int P, long long tile_bytes, void* stream) {
  return launch<true>(k_stack, v_stack, k_pages, v_pages, ids, N, L, P,
                      tile_bytes, stream);
}

}  // extern "C"
