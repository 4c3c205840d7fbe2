// Small device helpers shared by the vidcap_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace vidcap {

constexpr float kNeg = -1e30f;   // masked logit / score, as in the JAX package

// Round a float to bf16 (nearest even) and back: the bf16 rounding points of
// the reference precision chain.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats as a bf16 pair (round to nearest even), as stored in memory
__device__ __forceinline__ unsigned pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

// eight f32 at p (16-byte aligned) as eight bf16
__device__ __forceinline__ uint4 bf16x8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
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

// Order of the top-K: larger value first, then smaller index (lax.top_k's
// tie rule). True when (v1, i1) comes before (v2, i2).
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// acc[i] += part[i], element by element, in f32 with round-to-nearest. The
// tensor cores' own f32 accumulation rounds less exactly; chained over a deep
// product its error grows several times past an f32 GEMM's, so the kernels
// let it sum only 32-deep slices and add each slice here. This form takes
// wgmma accumulators (register arrays); the one below wmma fragments.
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N], const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

template <int N>
__device__ __forceinline__ void promote(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[N],
    const nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < acc[i].num_elements; ++e) acc[i].x[e] += part[i].x[e];
}

}  // namespace vidcap
