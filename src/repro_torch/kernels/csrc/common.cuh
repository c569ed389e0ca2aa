// Device helpers shared by the attention kernels (paged_decode.cu,
// paged_verify.cu, flash_attention.cu): conversion between the storage
// dtypes (fp32, bf16) and fp32. build.library_path hashes every header of
// this directory into each library's name, so an edit here rebuilds them.
#pragma once

#include <cuda_bf16.h>

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
