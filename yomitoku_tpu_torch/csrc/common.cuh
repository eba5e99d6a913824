// Shared helpers for the port's CUDA kernels: element conversion between the
// storage type (float or bf16) and the f32 arithmetic every kernel does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

// Storage type codes of the plain C interface (match ops/_build.py).
enum { YT_F32 = 0, YT_BF16 = 1 };

// Error codes of the C interface beyond cudaError_t's (yt_error_string).
enum { YT_ERR_ROUTE = 1000, YT_ERR_TENSOR_MAP = 1001 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eight bf16 values in one 16-byte vector (element 0 in the low half of x).
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- shared-memory addresses

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
