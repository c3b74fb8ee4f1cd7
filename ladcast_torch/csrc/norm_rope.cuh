// Shared device helpers of the norm+RoPE, fused-attention and flash
// backward kernels.
//
// A head row of D = 128 values is held by one warp, 4 contiguous values
// per lane, so an interleaved RoPE pair (2i, 2i+1) never crosses lanes and
// the mean of squares is one warp-shuffle reduction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace ladcast {

constexpr int kHeadDim = 128;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// bf16 planes that carry an fp32 value through the tensor cores' products
constexpr int kPlanes = 3;

// This lane's 4 values as kPlanes bf16 planes, `plane` elements apart from
// p: plane n holds the bf16 rounding to nearest of what the planes before
// it left (exact in fp32), so the planes sum to the value's 24 significant
// bits. v is consumed.
__device__ __forceinline__ void store_planes4(__nv_bfloat16* p, long long plane,
                                              float v[4]) {
#pragma unroll
  for (int n = 0; n < kPlanes; ++n) {
    const uint32_t lo = take_bf16x2(v[0], v[1]);
    *reinterpret_cast<uint2*>(p + n * plane) = make_uint2(lo, take_bf16x2(v[2], v[3]));
  }
}

// fp32 RMS-norm of the warp's 128-value row times the weight row, then the
// interleaved-pair rotation out[2i] = n[2i]*cos - n[2i+1]*sin,
// out[2i+1] = n[2i+1]*cos + n[2i]*sin. `wv`, `c`, `s` are this lane's 4
// values of the row's (D,) weight, cos and sin rows; every lane of the warp
// must call this.
__device__ __forceinline__ void norm_rope4(float v[4], const float wv[4],
                                           const float c[4], const float s[4],
                                           float eps) {
  float ss = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss * (1.0f / kHeadDim) + eps);
  const float n0 = v[0] * r * wv[0], n1 = v[1] * r * wv[1];
  const float n2 = v[2] * r * wv[2], n3 = v[3] * r * wv[3];
  v[0] = n0 * c[0] - n1 * s[0];
  v[1] = n1 * c[1] + n0 * s[1];
  v[2] = n2 * c[2] - n3 * s[2];
  v[3] = n3 * c[3] + n2 * s[3];
}

// The same with `w`, `cos`, `sin` pointing at the row's (D,) table rows.
__device__ __forceinline__ void norm_rope4(float v[4], const float* w,
                                           const float* cos, const float* sin,
                                           int lane, float eps) {
  float wv[4], c[4], s[4];
  load4(w + lane * 4, wv);
  load4(cos + lane * 4, c);
  load4(sin + lane * 4, s);
  norm_rope4(v, wv, c, s, eps);
}

}  // namespace ladcast
